"""Port parity for the sharded narrowband pipeline: doa_tpu_torch's
build_sharded_pipeline on gloo ranks (parallel.launch.spawn_ranks, one
process a rank, the kernels' plain versions on the CPU) against doa_tpu's
build_sharded_pipeline on the same mesh shape of the 8-device virtual
mesh, on tests/test_sharded.py's config and capture (ULA-8, S=512,
overlap 256, G=512, 62°/117°, 10 dB, seed 9); and the halo exchange of
ops/cuda/ring.py on tests/test_ring_pallas.py:17-37's plane: the default
route against the reference's ppermute rows, and kernel 13's plain
version, the ring (the kernel itself needs a card: chip_smoke.py, phase
14).

Each mesh shape spawns its ranks once (a module fixture runs every job of
the shape in one launch); the tests then read the ranks' results."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from doa_tpu.configs import (ArrayGeometry, BeamspaceSpec, DoaConfig,
                             Estimator, GridSpec1D, PRESETS,
                             WidebandSpec)
from doa_tpu.io import SourceSpec, synth_ula_iq
from doa_tpu.io.synthetic import synth_wideband_ura_iq
from doa_tpu.ops.pallas.ring import halo_exchange as halo_ref
from doa_tpu.ops.peaks import find_local_max, find_local_max_2d
from doa_tpu.parallel import MeshSpec as MeshSpecJ
from doa_tpu.parallel import build_sharded_pipeline as build_ref
from doa_tpu.parallel import distributed_covariance as dist_cov_ref
from doa_tpu.parallel import make_mesh as make_mesh_ref
from doa_tpu.parallel.mesh import SNAP_AXIS
from doa_tpu_torch.configs import GridSpec2D as GridSpec2DT, as_config
from doa_tpu_torch.parallel import MeshSpec, build_sharded_pipeline, make_mesh
from doa_tpu_torch.parallel.launch import run_jobs, spawn_ranks
from doa_tpu_torch.parallel.sharded import num_valid_windows
from torch_world import one_rank_mesh  # noqa: F401  (a fixture)

CFG = DoaConfig(
    geometry=ArrayGeometry(kind="ula", num_elements=8, norm_spacing=0.5),
    snapshot_size=512, overlap=256, num_sources=2,
    estimators=(Estimator.MUSIC, Estimator.CAPON),
    grid=GridSpec1D(num_points=512), num_max_vals=2)
T = 16384
SPECS = [(2, 1), (4, 1), (2, 2)]
G2 = GridSpec2DT(num_az=24, num_el=13, az_lo_deg=-90, az_hi_deg=90,
                 el_lo_deg=0, el_hi_deg=90)


def _capture():
    return synth_ula_iq(
        [SourceSpec(theta_deg=62.0), SourceSpec(theta_deg=117.0,
                                                freq_norm=0.3)],
        8, 0.5, T, snr_db=10, seed=9).astype(np.complex64)


CORRECTION = np.exp(1j * np.linspace(0, 0.3, 8)).astype(np.complex64)


def _spectra_1d():
    """(16, 512) peaky rows: two Lorentzians a row, a floor of noise, and
    rows with a single source and with a peak on a shard boundary."""
    rng = np.random.default_rng(3)
    g = np.arange(512)[None, :]
    c = rng.uniform(10, 500, (16, 2))
    c[3] = (255.4, 256.3)                     # across the (2, 2) boundary
    c[5, 1] = c[5, 0]                         # one source
    P = (1.0 / (((g - c[:, :1]) / 9) ** 2 + 1e-2)
         + 0.5 / (((g - c[:, 1:]) / 13) ** 2 + 1e-2)
         + 0.05 * rng.random((16, 512)))
    P[7] = np.linspace(1, 2, 512)             # no interior peak
    return P.astype(np.float32)


def _spectra_2d():
    """tests/test_sharded.py:407-453's inputs."""
    rng = np.random.default_rng(0)
    B, G = 16, 24 * 13
    az = np.linspace(-90, 90, 24)[None, :, None]
    el = np.linspace(0, 90, 13)[None, None, :]
    ca = rng.uniform(-60, 60, (B, 1, 1))
    ce = rng.uniform(20, 70, (B, 1, 1))
    return (1.0 / (((az - ca) / 30) ** 2 + ((el - ce) / 20) ** 2 + 1e-2)
            + 0.05 * rng.random((B, 24, 13))).astype(np.float32).reshape(B, G)


HALO_T, HALO_N, OVERLAP = 512, 4, 32


def _plane():
    return np.random.default_rng(0).standard_normal(
        (HALO_T, HALO_N)).astype(np.float32)


def _pipe_job(**over):
    build = over.pop("build", {})
    cfg = as_config(dataclasses.replace(CFG, **over))
    return ("pipeline", {"cfg": cfg, "x": _capture(),
                         "correction": CORRECTION, "build": build})


_ALL_FIVE = (Estimator.MUSIC, Estimator.MIN_NORM, Estimator.ROOT_MUSIC,
             Estimator.ESPRIT, Estimator.UNITARY_ESPRIT)
# tests/test_sharded.py:96-108, 247-264, 299-319 and 385-405 on the port's
# routes: the fast path with every estimator but Capon and Bartlett (the
# reference's under cov_impl="pallas"); the general path under "jacobi"
# (eigh's projector in both packages) with the same five; beamspace (5
# beams, the general path in both; the configs refuse min-norm and the
# grid-free estimators there) with MUSIC on the power subspace of BᴴRB,
# Capon and Bartlett
_ESTIMATOR_JOBS = {
    "estimators": {"estimators": _ALL_FIVE},
    "jacobi": {"estimators": _ALL_FIVE, "subspace_method": "jacobi"},
    "beamspace": {"estimators": (Estimator.MUSIC, Estimator.CAPON,
                                 Estimator.BARTLETT),
                  "beamspace": BeamspaceSpec(num_beams=5, center_deg=90.0)},
}


def _jobs():
    return {
        "fast": _pipe_job(),
        "fast_lean": _pipe_job(build={"return_spectra": False}),
        "fast_ring": _pipe_job(halo_impl="pallas"),
        "fast_local": ("pipeline_local", _pipe_job()[1]),
        "eigh": _pipe_job(subspace_method="eigh"),
        "eigh_ring": _pipe_job(subspace_method="eigh", halo_impl="pallas"),
        "merge_1d": ("merge_1d", {"P": _spectra_1d(), "k": 2,
                                  "x_rng": (0.0, 180.0), "refine": False}),
        "merge_1d_refine": ("merge_1d", {"P": _spectra_1d(), "k": 3,
                                         "x_rng": (0.0, 180.0),
                                         "refine": True}),
        "merge_2d": ("merge_2d", {"P": _spectra_2d(), "k": 2, "g2": G2,
                                  "refine": False}),
        "merge_2d_refine": ("merge_2d", {"P": _spectra_2d(), "k": 2,
                                         "g2": G2, "refine": True}),
        "cov": ("covariance", {"x": _capture()}),
        "halo_xla": ("halo", {"x": _plane(), "overlap": OVERLAP,
                              "impl": "xla"}),
        "halo_ring": ("halo", {"x": _plane(), "overlap": OVERLAP,
                               "impl": "pallas"}),
        **{name: _pipe_job(**over) for name, over in _ESTIMATOR_JOBS.items()},
    }


@pytest.fixture(scope="module")
def ranks():
    """Mesh shape → every rank's results of every job (one launch each)."""
    cache = {}

    def get(spec):
        if spec not in cache:
            cache[spec] = spawn_ranks(run_jobs, spec[0] * spec[1],
                                      (MeshSpec(*spec), _jobs()),
                                      device="cpu")
        return cache[spec]
    return get


def _assemble(outs, spec, job, key):
    """The global array of one output: rows in snap order; spectra's grid
    blocks side by side."""
    by = {(o["coords"]["snap"], o["coords"]["grid"]): o[job] for o in outs}
    rows = []
    for s in range(spec[0]):
        parts = [by[(s, g)][key] for g in range(spec[1])]
        rows.append(np.concatenate(parts, axis=1)
                    if key.startswith("spectrum") else parts[0])
    return np.concatenate(rows, axis=0)


def _ref_mesh(spec):
    return make_mesh_ref(MeshSpecJ(*spec), jax.devices()[:spec[0] * spec[1]])


def _sorted(a):
    return np.sort(np.asarray(a), -1)


def _assert_spectra(P, P_ref, B):
    """P/max P = dmin/den, and dmin sits at a MUSIC null where f32
    cancellation leaves relative noise, so each row carries its own scale
    (within 1e-2, as tests/test_torch_pipeline.py); the capture mean that
    seeds the warm start is summed over the ranks in another order than
    the reference's psum, which moves that scale by up to ~1.6e-3 here, so
    bins are held to the reference's own sharded-versus-single-device
    spectra bound (tests/test_sharded.py:379-381: rtol 5e-3, atol 2e-3)."""
    P, P_ref = P[:B], np.asarray(P_ref)[:B]
    row = np.median(P / P_ref, axis=-1, keepdims=True)
    np.testing.assert_allclose(row, 1.0, rtol=1e-2)
    np.testing.assert_allclose(P, P_ref, rtol=5e-3, atol=2e-3)


@pytest.mark.parametrize("spec", SPECS)
def test_fast_path_matches_reference(ranks, spec):
    """The fused sharded path with a correction and spectra: angles within
    1e-3° of doa_tpu's on the same mesh shape, spectra within the
    parity tolerance of _assert_spectra, escalation
    counts equal; call.local on each rank's block gives the same rows."""
    outs = ranks(spec)
    B = num_valid_windows(T, CFG)
    ref = build_ref(dataclasses.replace(CFG, cov_impl="pallas"),
                    _ref_mesh(spec))
    assert ref.fast
    r = ref(_capture(), correction=CORRECTION)
    for est in ("music", "capon"):
        a = _assemble(outs, spec, "fast", f"peak_angles_{est}")[:B]
        np.testing.assert_allclose(
            _sorted(a), _sorted(r[f"peak_angles_{est}"])[:B], atol=1e-3)
        _assert_spectra(_assemble(outs, spec, "fast", f"spectrum_{est}"),
                        r[f"spectrum_{est}"], B)
    for key in ("escalation_flagged", "escalation_overflow"):
        counts = {int(o["fast"][key]) for o in outs}
        assert counts == {int(r[key])}
    for o in outs:
        for key, v in o["fast"].items():
            np.testing.assert_array_equal(o["fast_local"][key], v)


@pytest.mark.parametrize("spec", SPECS)
def test_fast_peaks_only_matches_reference(ranks, spec):
    """return_spectra=False: no spectrum leaves a rank; on an unsharded
    grid K2 fuses the peaks into the scan (its plain version here), on a
    sharded one the merge runs; angles within 1e-3° of doa_tpu's."""
    outs = ranks(spec)
    B = num_valid_windows(T, CFG)
    ref = build_ref(dataclasses.replace(CFG, cov_impl="pallas"),
                    _ref_mesh(spec), return_spectra=False)
    r = ref(_capture(), correction=CORRECTION)
    assert not any(k.startswith("spectrum") for k in outs[0]["fast_lean"])
    for est in ("music", "capon"):
        a = _assemble(outs, spec, "fast_lean", f"peak_angles_{est}")[:B]
        np.testing.assert_allclose(
            _sorted(a), _sorted(r[f"peak_angles_{est}"])[:B], atol=1e-3)
    assert int(outs[0]["fast_lean"]["escalation_flagged"]) == int(
        r["escalation_flagged"])


@pytest.mark.parametrize("spec", SPECS)
def test_eigh_general_path_matches_reference(ranks, spec):
    """subspace_method="eigh" takes the general path (kernel 8's planes,
    correction, the eigh noise projector, Capon): angles within 1e-3° of
    doa_tpu's, spectra within _assert_spectra's tolerance."""
    outs = ranks(spec)
    B = num_valid_windows(T, CFG)
    cfg = dataclasses.replace(CFG, subspace_method="eigh")
    ref = build_ref(cfg, _ref_mesh(spec))
    assert not ref.fast
    r = ref(_capture(), correction=CORRECTION)
    for est in ("music", "capon"):
        a = _assemble(outs, spec, "eigh", f"peak_angles_{est}")[:B]
        np.testing.assert_allclose(
            _sorted(a), _sorted(r[f"peak_angles_{est}"])[:B], atol=1e-3)
        _assert_spectra(_assemble(outs, spec, "eigh", f"spectrum_{est}"),
                        r[f"spectrum_{est}"], B)
    assert "escalation_flagged" not in outs[0]["eigh"]


@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("job", list(_ESTIMATOR_JOBS))
def test_estimators_and_beamspace_match_reference(ranks, spec, job):
    """Min-norm, root-MUSIC, ESPRIT and Unitary ESPRIT on the fast path
    (from each rank's R = unembed(E); root-MUSIC on the power subspace's
    projector) and on the general path under "jacobi" (eigh's projector,
    as the reference's sharded path takes), and beamspace (the beam matrix
    replicated, the projected grid sharded, each rank's R projected):
    the reference's keys, angles within 1e-3° of doa_tpu's on the same
    mesh shape (the grid-free angles window by window, each sorted),
    spectra within _assert_spectra's tolerance."""
    outs = ranks(spec)
    B = num_valid_windows(T, CFG)
    cfg = dataclasses.replace(CFG, cov_impl="pallas", **_ESTIMATOR_JOBS[job])
    ref = build_ref(cfg, _ref_mesh(spec))
    assert ref.fast == (job == "estimators")
    r = ref(_capture(), correction=CORRECTION)
    assert sorted(outs[0][job]) == sorted(r)
    for key in r:
        if key.startswith("escalation"):
            assert {int(o[job][key]) for o in outs} == {int(r[key])}, key
            continue
        got = _assemble(outs, spec, job, key)[:B]
        if key.startswith("spectrum"):
            _assert_spectra(got, r[key], B)
        elif not key.startswith("peak_values"):
            np.testing.assert_allclose(_sorted(got), _sorted(r[key])[:B],
                                       atol=1e-3, err_msg=key)


@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("path", ["fast", "eigh"])
def test_halo_impls_equal_on_valid_windows(ranks, spec, path):
    """halo_impl="pallas" (kernel 13's ring; its plain version here)
    against the default "xla" ppermute: the same bits on every valid
    window; only the last rank's tail windows differ."""
    outs = ranks(spec)
    B = num_valid_windows(T, CFG)
    for key in outs[0][path]:
        if key.startswith("escalation"):
            for o in outs:
                assert int(o[path][key]) == int(o[f"{path}_ring"][key]), key
            continue
        a = _assemble(outs, spec, path, key)[:B]
        b = _assemble(outs, spec, f"{path}_ring", key)[:B]
        np.testing.assert_array_equal(a, b, err_msg=key)


@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("job,refine", [("merge_1d", False),
                                        ("merge_1d_refine", True)])
def test_local_peaks_merge_1d_matches_dense(ranks, spec, job, refine):
    """The O(k) column-halo merge against doa_tpu's dense find_local_max on
    the normalised rows (rtol 1e-6, atol 1e-5, as
    tests/test_sharded.py's 2-D merge), peaks on shard boundaries, a
    single-source row and a row without a peak included."""
    outs = ranks(spec)
    Pm = _spectra_1d()
    k = 3 if refine else 2
    v_r, l_r = find_local_max(jnp.asarray(Pm / Pm.max(-1, keepdims=True)),
                              k, 0.0, 180.0, refine=refine)
    v = np.concatenate([outs[s * spec[1]][job][0] for s in range(spec[0])])
    loc = np.concatenate([outs[s * spec[1]][job][1]
                          for s in range(spec[0])])
    np.testing.assert_allclose(v, np.asarray(v_r), rtol=1e-6)
    np.testing.assert_allclose(loc, np.asarray(l_r), atol=1e-5)


@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("job,refine", [("merge_2d", False),
                                        ("merge_2d_refine", True)])
def test_local_peaks_merge_2d_matches_dense(ranks, spec, job, refine):
    """tests/test_sharded.py:407-453 for the port: the az-row-halo merge
    against dense find_local_max_2d, rtol 1e-6 / atol 1e-5."""
    outs = ranks(spec)
    Pm = _spectra_2d()
    Pn = Pm / Pm.max(-1, keepdims=True)
    v_r, az_r, el_r = find_local_max_2d(
        jnp.asarray(Pn).reshape(16, 24, 13), 2, (-90.0, 90.0), (0.0, 90.0),
        refine=refine)
    v = np.concatenate([outs[s * spec[1]][job][0] for s in range(spec[0])])
    loc = np.concatenate([outs[s * spec[1]][job][1]
                          for s in range(spec[0])])
    np.testing.assert_allclose(v, np.asarray(v_r), rtol=1e-6)
    np.testing.assert_allclose(loc[..., 0], np.asarray(az_r), atol=1e-5)
    np.testing.assert_allclose(loc[..., 1], np.asarray(el_r), atol=1e-5)


@pytest.mark.parametrize("spec", SPECS)
def test_distributed_covariance_matches_reference(ranks, spec):
    """One (N, N) covariance of the whole capture from per-rank Grams and
    one psum, on every rank, against doa_tpu's distributed_covariance."""
    outs = ranks(spec)
    R = dist_cov_ref(_ref_mesh(spec))(_capture()).to_numpy()
    for o in outs:
        Rr, Ri = o["cov"]
        np.testing.assert_allclose(Rr + 1j * Ri, R, rtol=1e-5, atol=1e-6)


def _halo_reference(spec):
    """The reference's halo rows (T_loc + overlap a shard) on the same
    mesh shape → (n_snap, T_loc + overlap, N)."""
    out = jax.jit(jax.shard_map(
        lambda xl: halo_ref(xl, OVERLAP, SNAP_AXIS, impl="xla"),
        mesh=_ref_mesh(spec), in_specs=P(SNAP_AXIS, None),
        out_specs=P(SNAP_AXIS, None), check_vma=False))(_plane())
    return np.asarray(out).reshape(spec[0], HALO_T // spec[0] + OVERLAP,
                                   HALO_N)


@pytest.mark.parametrize("spec", SPECS)
def test_default_halo_matches_reference_ppermute(ranks, spec):
    """impl="xla": every rank's rows equal the reference's shard of its
    snap index bit for bit, the last shard's halo zeros."""
    ref = _halo_reference(spec)
    for o in ranks(spec):
        np.testing.assert_array_equal(o["halo_xla"][0],
                                      ref[o["coords"]["snap"]])
    assert not ref[-1, HALO_T // spec[0]:].any()


@pytest.mark.parametrize("spec", SPECS)
def test_ring_plain_version_wraps(ranks, spec):
    """halo_exchange(impl="pallas") on CPU tensors, kernel 13's plain
    version: bit-equal to the reference's ppermute rows on shards 0..n−2,
    shard 0's head rows on the last shard."""
    ref = _halo_reference(spec)
    x = _plane()
    n, T_loc = spec[0], HALO_T // spec[0]
    for o in ranks(spec):
        s = o["coords"]["snap"]
        ring = o["halo_ring"][0]
        assert ring.shape == (T_loc + OVERLAP, HALO_N)
        np.testing.assert_array_equal(ring[:T_loc], x[s * T_loc:][:T_loc])
        if s < n - 1:
            np.testing.assert_array_equal(ring, ref[s])
        else:
            np.testing.assert_array_equal(ring[T_loc:], x[:OVERLAP])


@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("job", ["halo_xla", "halo_ring"])
def test_successive_halo_results_do_not_alias(ranks, spec, job):
    """A halo_exchange result is a tensor of its own: the next exchange
    of the same shape (on the negated plane) gives the negated rows and
    leaves the first result as it was."""
    for o in ranks(spec):
        first, second = o[job]
        np.testing.assert_array_equal(second, -first)
        assert first[:OVERLAP].any()


def _c4_with(**over):
    return dataclasses.replace(PRESETS["c4_ula16_streaming"], **over)


def _c5_with(fusion):
    return dataclasses.replace(
        PRESETS["c5_ura64_wideband"],
        wideband=WidebandSpec(num_subbands=16, fractional_bw=0.1,
                              fusion=fusion))


# the configs this table once held outside the sharded slice, each now
# built on one rank
_OUTSIDE = {
    "wideband": lambda: PRESETS["c5_ura64_wideband"],
    "tops": lambda: _c5_with("tops"),
    "cssm": lambda: _c5_with("cssm"),
    "root_music": lambda: _c4_with(estimators=(Estimator.MUSIC,
                                               Estimator.ROOT_MUSIC)),
    "esprit": lambda: _c4_with(estimators=(Estimator.ESPRIT,)),
    "min_norm": lambda: _c4_with(estimators=(Estimator.MIN_NORM,)),
    "jacobi": lambda: _c4_with(subspace_method="jacobi"),
}


def _one_rank_capture(cfg):
    """A planted scene at full width and small depth: the c5 URA's two
    sources on 3 windows, or c4's 70°/110° on 40 windows."""
    if cfg.wideband.enabled:
        return synth_wideband_ura_iq(
            [SourceSpec(az_deg=-20.0, el_deg=30.0, freq_norm=0.0,
                        bandwidth_norm=0.5),
             SourceSpec(az_deg=35.0, el_deg=60.0, freq_norm=0.0,
                        bandwidth_norm=0.5)],
            (8, 8), 0.5, 3 * 1024, fractional_bw=0.1, snr_db=10,
            seed=4).astype(np.complex64)
    return synth_ula_iq([SourceSpec(theta_deg=70.0, freq_norm=0.1),
                         SourceSpec(theta_deg=110.0, freq_norm=0.3)],
                        16, 0.5, 41 * 512, snr_db=10,
                        seed=2).astype(np.complex64)


@pytest.mark.parametrize("name", list(_OUTSIDE))
def test_configs_outside_the_slice_raise(one_rank_mesh, name):
    """Each config the sharded pipeline refused (NotImplementedError, queue
    A) until it ported the EP wideband builders, the estimators and
    Jacobi now raises nothing: it runs on a mesh of one
    rank (no collective) and gives build_pipeline_torch's outputs on the
    same capture: the same fused or estimator keys, peak angles within
    1e-4° (pair-sorted az/el; the O(k) merge's refine rounds otherwise
    than find_local_max's) and the grid-free angles within 1e-4°. Under
    "jacobi" the sharded path takes eigh's projector, as the reference's,
    so it is held to the single-card pipeline under "eigh"."""
    from doa_tpu_torch.pipeline_torch import build_pipeline_torch
    cfg = as_config(_OUTSIDE[name]())
    x = _one_rank_capture(cfg)
    out = build_sharded_pipeline(cfg, one_rank_mesh)(x)
    single = (dataclasses.replace(cfg, subspace_method="eigh")
              if name == "jacobi" else cfg)
    res = build_pipeline_torch(single, device="cpu")(x)
    keys = {k[len("peak_angles_"):] for k in out
            if k.startswith("peak_angles_")}
    assert keys == set(res.peak_angles), (keys, list(res.peak_angles))
    for est, a_ref in res.peak_angles.items():
        a = out[f"peak_angles_{est}"][:a_ref.shape[0]]
        if a.dim() == 3:
            a, a_ref = (torch.take_along_dim(t, t[..., :1].argsort(-2), -2)
                        for t in (a, a_ref))
        else:
            a, a_ref = a.sort(-1).values, a_ref.sort(-1).values
        torch.testing.assert_close(a, a_ref, rtol=0, atol=1e-4)
    for key in ("root_music_angles", "esprit_angles",
                "unitary_esprit_angles"):
        want = getattr(res, key)
        assert (key in out) == (want is not None), key
        if want is not None:
            torch.testing.assert_close(out[key][:want.shape[0]], want,
                                       rtol=0, atol=1e-4)


def test_one_rank_mesh_equals_single_card_pipeline(one_rank_mesh):
    """A mesh of one rank runs in this process: no halo, no collective; the
    c4 preset's fused sharded path equals build_pipeline_torch bit for
    bit on 40 windows."""
    from doa_tpu_torch.pipeline_torch import build_pipeline_torch
    cfg = PRESETS["c4_ula16_streaming"]
    x = synth_ula_iq([SourceSpec(theta_deg=70.0, freq_norm=0.1),
                      SourceSpec(theta_deg=110.0, freq_norm=0.3)],
                     16, 0.5, 41 * 512, snr_db=10,
                     seed=2).astype(np.complex64)
    out = build_sharded_pipeline(cfg, one_rank_mesh, return_spectra=False)(x)
    res = build_pipeline_torch(cfg, device="cpu", return_spectra=False)(x)
    assert out["peak_angles_music"].shape == (40, 2)
    torch.testing.assert_close(out["peak_angles_music"],
                               res.peak_angles["music"], rtol=0, atol=0)
    assert int(out["escalation_flagged"]) == int(res.escalation_flagged)


def test_cuda_device_raises_without_a_card(one_rank_mesh):
    """The mesh, and with it the sharded pipeline, runs on the card unless
    the caller asks for the CPU: without a card it raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        build_sharded_pipeline(PRESETS["c4_ula16_streaming"],
                               make_mesh(MeshSpec(1, 1)))
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh(MeshSpec(1, 1), device="cuda")


def test_num_valid_windows_and_divisibility(one_rank_mesh):
    cfg = as_config(CFG)
    assert num_valid_windows(16384, cfg) == (16384 - 512) // 256 + 1
    assert num_valid_windows(100, cfg) == 0
    with pytest.raises(ValueError, match="divisible"):
        build_sharded_pipeline(CFG, one_rank_mesh)(_capture()[:1000])


def test_initialize_a_single_process():
    """multihost.initialize with one process forms its own group (a private
    file store) and a (1, 1) mesh on the CPU."""
    import torch.distributed as dist
    from doa_tpu_torch.parallel.multihost import initialize
    ctx = initialize(num_processes=1, device="cpu")
    try:
        assert (ctx.num_hosts, ctx.host_id, ctx.is_leader) == (1, 0, True)
        assert ctx.mesh.shape == {"snap": 1, "grid": 1}
        assert dist.get_backend() == "gloo"
    finally:
        dist.destroy_process_group()


def test_a_failing_rank_makes_the_launch_raise():
    """A rank that raises stops the launch with its traceback: the EP
    wideband layout's ValueError on a capture of 1000 samples, not a
    multiple of n_snap·S."""
    cfg = as_config(dataclasses.replace(
        CFG, wideband=WidebandSpec(num_subbands=8, fractional_bw=0.1)))
    jobs = {"bad": ("pipeline", {"cfg": cfg, "x": _capture()[:1000]})}
    with pytest.raises(RuntimeError, match="n_snap\\*S"):
        spawn_ranks(run_jobs, 2, (MeshSpec(2, 1), jobs), device="cpu")
