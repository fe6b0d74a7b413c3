"""Port parity for the EP-sharded wideband pipelines: doa_tpu_torch's
build_sharded_pipeline for incoherent fusion, "cssm", "cssm_auto" and
"tops" on gloo ranks (parallel.launch.spawn_ranks, one process a rank, the
kernels' plain versions on the CPU) against doa_tpu's
build_sharded_pipeline on the same mesh shape of the 8-device virtual
mesh, on tests/test_sharded.py's wideband configs and captures (ULA-8,
S = 256, F = 8, G = 128, synth_wideband_ula_iq).

The port's front end is the single card's, kernel 4 on each rank's
block at every F: its FFT form at F = 8, which matches the reference's
fast route (taken under cov_impl="pallas"), and its frames source at
F = 4 (TPACK = 8 at N = 8), where the reference takes its general route
(the DFT channelizer, then each subband's covariance windows): the same
windows, which the "general" case holds.

Each mesh shape spawns its ranks once (a module fixture runs every job
of the shape in one launch); the tests then read the ranks' results.
Angles are held within 5e-3° (sorted), spectra by
tests/test_torch_sharded.py's rule (each row's scale within 1e-2, bins
rtol 5e-3, atol 2e-3), TOPS's spectrum within 2e-3 of its maximum
(tests/test_torch_tops.py's pipeline bound)."""

import dataclasses

import jax
import numpy as np
import pytest

from doa_tpu.configs import (ArrayGeometry, DoaConfig, Estimator, GridSpec1D,
                             GridSpec2D, WidebandSpec)
from doa_tpu.io import SourceSpec
from doa_tpu.io.synthetic import synth_wideband_ula_iq, synth_wideband_ura_iq
from doa_tpu.parallel import MeshSpec as MeshSpecJ
from doa_tpu.parallel import build_sharded_pipeline as build_ref
from doa_tpu.parallel import make_mesh as make_mesh_ref
from doa_tpu_torch.configs import as_config
from doa_tpu_torch.parallel import MeshSpec, build_sharded_pipeline
from doa_tpu_torch.parallel.launch import run_jobs, spawn_ranks
from torch_world import one_rank_mesh  # noqa: F401  (a fixture)

SPECS = [(1, 2), (2, 2)]
ANGLE_TOL = 5e-3           # degrees, the wideband parity bound
CORRECTION = np.exp(1j * np.linspace(0, 0.4, 8)).astype(np.complex64)


def _cfg(fusion="incoherent", F=8, fbw=0.1, **over):
    """tests/test_sharded.py:142-155's config."""
    return DoaConfig(
        geometry=ArrayGeometry(kind="ula", num_elements=8, norm_spacing=0.5),
        snapshot_size=256, num_sources=2, estimators=(Estimator.MUSIC,),
        grid=GridSpec1D(num_points=128),
        wideband=WidebandSpec(num_subbands=F, fractional_bw=fbw,
                              fusion=fusion),
        num_max_vals=2, **over)


def _capture(fbw=0.1):
    """tests/test_sharded.py:156-159's scene on 32 windows of 256 (the
    fewest that warm-start the subspaces: the reference's Pallas kernels
    run in interpret mode here, at a cost a window)."""
    return synth_wideband_ula_iq(
        [SourceSpec(theta_deg=62.0, freq_norm=0.0, bandwidth_norm=0.5),
         SourceSpec(theta_deg=117.0, freq_norm=0.0, bandwidth_norm=0.5)],
        8, 0.5, 8 * 1024, snr_db=12, seed=7,
        fractional_bw=fbw).astype(np.complex64)


def _auto_cfg():
    """tests/test_sharded.py:327-333's cssm_auto config: ULA-16, S = 512,
    fractional bandwidth 0.3."""
    return dataclasses.replace(
        _cfg("cssm_auto", fbw=0.3),
        geometry=ArrayGeometry(kind="ula", num_elements=16, norm_spacing=0.5),
        snapshot_size=512)


def _auto_capture():
    return synth_wideband_ula_iq(
        [SourceSpec(theta_deg=65.0, freq_norm=0.0, bandwidth_norm=0.4),
         SourceSpec(theta_deg=115.0, freq_norm=0.0, bandwidth_norm=0.4)],
        16, 0.5, 16 * 512, fractional_bw=0.3, snr_db=10,
        seed=2).astype(np.complex64)


def _ura_cfg(fusion, num_az=60, num_el=31):
    """A 4×4 URA on c5's wideband path at a small grid: 60 × 31 splits
    into whole az rows over two grid ranks (the O(k) 2-D merge), 61 × 30
    does not (the gathered row and the 2-D peak rule)."""
    return DoaConfig(
        geometry=ArrayGeometry(kind="ura", num_elements=16, shape=(4, 4),
                               norm_spacing=0.5),
        snapshot_size=512, num_sources=2, estimators=(Estimator.MUSIC,),
        grid2d=GridSpec2D(num_az=num_az, num_el=num_el), num_max_vals=2,
        wideband=WidebandSpec(num_subbands=16, fractional_bw=0.1,
                              fusion=fusion))


def _ura_capture():
    """c5's two planted sources on the 4×4 URA, 32 windows of 512."""
    return synth_wideband_ura_iq(
        [SourceSpec(az_deg=-20.0, el_deg=30.0, freq_norm=0.0,
                    bandwidth_norm=0.5),
         SourceSpec(az_deg=35.0, el_deg=60.0, freq_norm=0.0,
                    bandwidth_norm=0.5)],
        (4, 4), 0.5, 32 * 512, fractional_bw=0.1, snr_db=10,
        seed=4).astype(np.complex64)


# name → (the config, the capture, the correction, build_sharded_pipeline's
# keyword arguments)
CASES = {
    "fast": (_cfg(), _capture, CORRECTION, {}),
    "fast_eigh": (_cfg(subspace_method="eigh"), _capture, None, {}),
    "general": (_cfg(F=4), _capture, CORRECTION, {}),
    "cssm": (_cfg("cssm"), _capture, None, {}),
    "cssm_auto": (_auto_cfg(), _auto_capture, None, {}),
    "tops": (_cfg("tops", fbw=0.4), lambda: _capture(0.4), None, {}),
    "fast_lean": (_cfg(), _capture, CORRECTION, {"return_spectra": False}),
    "cssm_lean": (_cfg("cssm"), _capture, None, {"return_spectra": False}),
    "tops_lean": (_cfg("tops", fbw=0.4), lambda: _capture(0.4), None,
                  {"return_spectra": False}),
    "ura_tops": (_ura_cfg("tops"), _ura_capture, None, {}),
    "ura_cssm": (_ura_cfg("cssm"), _ura_capture, None, {}),
    "ura_cssm_rows": (_ura_cfg("cssm", 61, 30), _ura_capture, None, {}),
}


# name → a config that the EP layout refuses on two grid ranks, as the
# reference does: F not divisible by the EP axis, and CSSM's grid not
# divisible by it
REFUSED = {
    "odd_subbands": dataclasses.replace(_cfg(F=5), snapshot_size=240),
    "odd_cssm_grid": dataclasses.replace(_cfg("cssm"),
                                         grid=GridSpec1D(num_points=127)),
}


def _jobs(spec):
    """The cases a mesh shape runs: the planar-array ones and the refused
    configs on (1, 2)."""
    jobs = {name: ("pipeline", {"cfg": as_config(cfg), "x": cap(),
                                "correction": c, "build": build})
            for name, (cfg, cap, c, build) in CASES.items()
            if spec == (1, 2) or not name.startswith("ura")}
    if spec == (1, 2):
        jobs.update((name, ("build_error", {"cfg": as_config(cfg)}))
                    for name, cfg in REFUSED.items())
    return jobs


@pytest.fixture(scope="module")
def ranks():
    """Mesh shape → every rank's results of every job (one launch each)."""
    cache = {}

    def get(spec):
        if spec not in cache:
            cache[spec] = spawn_ranks(run_jobs, spec[0] * spec[1],
                                      (MeshSpec(*spec), _jobs(spec)),
                                      device="cpu")
        return cache[spec]
    return get


@pytest.fixture(scope="module")
def reference():
    """(mesh shape, case) → doa_tpu's sharded outputs, as numpy."""
    cache = {}

    def get(spec, name):
        if (spec, name) not in cache:
            cfg, cap, c, build = CASES[name]
            if cfg.wideband.fusion == "incoherent":
                cfg = dataclasses.replace(cfg, cov_impl="pallas")
            mesh = make_mesh_ref(MeshSpecJ(*spec),
                                 jax.devices()[:spec[0] * spec[1]])
            pipe = build_ref(cfg, mesh, **build)
            assert getattr(pipe, "fast", False) == (name.startswith("fast"))
            cache[spec, name] = {k: np.asarray(v) for k, v in
                                 pipe(cap(), correction=c).items()}
        return cache[spec, name]
    return get


def _assemble(outs, spec, job, key):
    """The global array of one output: rows in snap order. Incoherent
    fusion's and TOPS's spectra are whole rows on every grid rank (grid
    rank 0's are taken); a CSSM spectrum's grid blocks sit side by side."""
    by = {(o["coords"]["snap"], o["coords"]["grid"]): o[job] for o in outs}
    split = (key.startswith("spectrum") and "cssm" in job
             and job != "ura_cssm_rows")
    rows = []
    for s in range(spec[0]):
        parts = [by[(s, g)][key] for g in range(spec[1])]
        rows.append(np.concatenate(parts, axis=1) if split else parts[0])
    return np.concatenate(rows, axis=0)


def _sorted(a):
    """Each window's angles in order: (B, k) by value, (B, k, 2) az/el
    pairs by azimuth."""
    if a.ndim == 3:
        return np.take_along_axis(a, np.argsort(a[..., 0], -1)[..., None],
                                  1)
    return np.sort(a, -1)


def _assert_angles(a, a_ref):
    assert a.shape == a_ref.shape
    np.testing.assert_allclose(_sorted(a), _sorted(a_ref), rtol=0,
                               atol=ANGLE_TOL)


def _assert_spectra(P, P_ref):
    """tests/test_torch_sharded.py's rule: each row carries its own scale
    (within 1e-2: P/max P = dmin/den, and dmin sits at a MUSIC null where
    f32 cancellation leaves relative noise), bins within the reference's
    sharded-versus-single-device bound (rtol 5e-3, atol 2e-3)."""
    assert P.shape == P_ref.shape
    row = np.median(P / P_ref, axis=-1, keepdims=True)
    np.testing.assert_allclose(row, 1.0, rtol=1e-2)
    np.testing.assert_allclose(P, P_ref, rtol=5e-3, atol=2e-3)


def _replicated_over_grid(outs, job):
    """Every grid rank of a snap row returns the same peaks."""
    for o in outs:
        for q in outs:
            if q["coords"]["snap"] == o["coords"]["snap"]:
                for key, v in o[job].items():
                    if key.startswith("peak"):
                        np.testing.assert_array_equal(q[job][key], v)


@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("job", ["fast", "fast_eigh", "general"])
def test_incoherent_matches_reference(ranks, reference, spec, job):
    """Incoherent fusion ("fast": kernel 5's partial fusion × F_loc under
    the power subspaces; "fast_eigh": each subband's eigh projector
    spectrum, summed; "general": F = 4, kernel 4's frames source and
    kernel 5) against doa_tpu's fast and general routes on the same mesh
    shape:
    angles within 5e-3°, the fused spectrum by _assert_spectra, the
    peaks the same on every grid rank."""
    outs, r = ranks(spec), reference(spec, job)
    assert sorted(outs[0][job]) == sorted(r) == [
        "peak_angles_music", "peak_values_music", "spectrum_music"]
    _assert_angles(_assemble(outs, spec, job, "peak_angles_music"),
                   r["peak_angles_music"])
    _assert_spectra(_assemble(outs, spec, job, "spectrum_music"),
                    r["spectrum_music"])
    _replicated_over_grid(outs, job)


@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("job", ["cssm", "cssm_auto"])
def test_cssm_matches_reference(ranks, reference, spec, job):
    """CSSM: the ranks' focused sums psum'd into R_coh, then the grid of
    its MUSIC scan sharded over the same axis (K3's plain version and the
    O(k) merge); cssm_auto's capture-mean covariances psum'd over time
    and its coarse spectrum over the subbands, so every rank focuses at
    the same angles. Angles within 5e-3° of doa_tpu's on the same mesh
    shape, the spectrum blocks by _assert_spectra."""
    outs, r = ranks(spec), reference(spec, job)
    assert sorted(outs[0][job]) == sorted(r)
    _assert_angles(_assemble(outs, spec, job, "peak_angles_music"),
                   r["peak_angles_music"])
    _assert_spectra(_assemble(outs, spec, job, "spectrum_music"),
                    r["spectrum_music"])
    _replicated_over_grid(outs, job)


@pytest.mark.parametrize("job", ["ura_tops", "ura_cssm", "ura_cssm_rows"])
def test_planar_array_matches_reference(ranks, reference, job):
    """A 4×4 URA on MeshSpec(1, 2): TOPS's and CSSM's az/el peaks (kernel
    6's plain version on TOPS's whole row; CSSM's grid split in whole az
    rows, the O(k) 2-D merge, or not, the gathered row) within 5e-3° of
    doa_tpu's, pair-sorted; the spectra by _assert_spectra (TOPS's within
    2e-3 of its maximum)."""
    spec = (1, 2)
    outs, r = ranks(spec), reference(spec, job)
    key = "tops" if job == "ura_tops" else "music"
    assert sorted(outs[0][job]) == sorted(r)
    _assert_angles(_assemble(outs, spec, job, f"peak_angles_{key}"),
                   r[f"peak_angles_{key}"])
    P = _assemble(outs, spec, job, f"spectrum_{key}")
    if key == "tops":
        np.testing.assert_allclose(P, r["spectrum_tops"], rtol=0, atol=2e-3)
    else:
        _assert_spectra(P, r["spectrum_music"])
    _replicated_over_grid(outs, job)


@pytest.mark.parametrize("spec", SPECS)
def test_tops_matches_reference(ranks, reference, spec):
    """TOPS: the reference band's subspaces on every rank, Σ CᴴC and the
    guard sum over each rank's subbands, one psum: angles within 5e-3°
    of doa_tpu's, the spectrum within 2e-3 of its maximum (1)."""
    outs, r = ranks(spec), reference(spec, "tops")
    assert sorted(outs[0]["tops"]) == sorted(r) == [
        "peak_angles_tops", "peak_values_tops", "spectrum_tops"]
    _assert_angles(_assemble(outs, spec, "tops", "peak_angles_tops"),
                   r["peak_angles_tops"])
    np.testing.assert_allclose(
        _assemble(outs, spec, "tops", "spectrum_tops"), r["spectrum_tops"],
        rtol=0, atol=2e-3)
    _replicated_over_grid(outs, "tops")


@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("job,full", [("fast_lean", "fast"),
                                      ("cssm_lean", "cssm"),
                                      ("tops_lean", "tops")])
def test_peaks_only_mode(ranks, reference, spec, job, full):
    """return_spectra=False (tests/test_sharded.py:483-511 and :546-551):
    no spectrum leaves a rank, and the peaks equal the spectra mode's
    (1e-5°) and doa_tpu's (5e-3°; its spectra mode's, which its own test
    holds to its peaks-only mode within 1e-5°)."""
    outs, r = ranks(spec), reference(spec, full)
    key = "peak_angles_tops" if full == "tops" else "peak_angles_music"
    assert not any(k.startswith("spectrum") for o in outs for k in o[job])
    assert sorted(outs[0][job]) == sorted(k for k in r
                                          if not k.startswith("spectrum"))
    a = _assemble(outs, spec, job, key)
    np.testing.assert_allclose(a, _assemble(outs, spec, full, key), rtol=0,
                               atol=1e-5)
    _assert_angles(a, r[key])


@pytest.mark.parametrize("job,match", [
    ("odd_subbands", "subbands 5 not divisible by EP axis 2"),
    ("odd_cssm_grid", "grid size 127 not divisible by TP axis 2")])
def test_ep_layout_refuses_what_the_reference_refuses(ranks, job, match):
    """On MeshSpec(1, 2) every rank's build raises the reference's
    ValueError (F % n_ep; CSSM's G % n_grid), and so does doa_tpu's on
    the same mesh shape."""
    assert {o[job] for o in ranks((1, 2))} == {match}
    with pytest.raises(ValueError, match="divisible"):
        build_ref(REFUSED[job], make_mesh_ref(MeshSpecJ(1, 2),
                                              jax.devices()[:2]))


def test_ep_layout_raises_where_the_reference_does(one_rank_mesh):
    """The reference's ValueErrors: S not divisible by F, and T not a
    multiple of n_snap·S on the EP path."""
    with pytest.raises(ValueError, match="divisible"):
        build_sharded_pipeline(
            dataclasses.replace(_cfg(), snapshot_size=250), one_rank_mesh)
    with pytest.raises(ValueError, match="n_snap\\*S"):
        build_sharded_pipeline(_cfg(), one_rank_mesh)(_capture()[:1000])
