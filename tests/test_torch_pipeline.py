"""Port parity for the whole slice: build_pipeline_torch on the CPU (the
kernels' plain versions) against doa_tpu's build_pipeline_tpu with its
Pallas kernels in interpret mode, on the same complex64 capture and
correction; plus the port's state, steering, embedding, precision scope,
import fence and device rules."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from doa_tpu.configs import (ArrayGeometry, DoaConfig, Estimator,
                             GridSpec1D, GridSpec2D, PRESETS, WidebandSpec)
from doa_tpu.cpx import Cpx, embed_hermitian as embed_jax
from doa_tpu.io import SourceSpec, synth_ula_iq
from doa_tpu.ops import steering as steer_jax
from doa_tpu.pipeline_tpu import build_pipeline_tpu
from doa_tpu_torch import cpx
from doa_tpu_torch.ops import steering
from doa_tpu_torch.pipeline_torch import build_pipeline_torch, load_state

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cfg(overlap=0, cov_dtype="float32"):
    return DoaConfig(
        geometry=ArrayGeometry(kind="ula", num_elements=8, norm_spacing=0.5),
        snapshot_size=256, overlap=overlap, num_sources=2,
        estimators=(Estimator.MUSIC,), grid=GridSpec1D(num_points=256),
        num_max_vals=2, cov_dtype=cov_dtype)


def _capture(B=40, seed=1):
    """B ≥ 32 windows at overlap 0, so both pipelines warm-start."""
    return synth_ula_iq([SourceSpec(theta_deg=60.0, freq_norm=0.1),
                         SourceSpec(theta_deg=110.0, freq_norm=0.3)],
                        8, 0.5, B * 256, snr_db=10,
                        seed=seed).astype(np.complex64)


def _correction(N=8, seed=0):
    rng = np.random.default_rng(seed)
    return ((1.0 + 0.1 * rng.standard_normal(N))
            * np.exp(1j * rng.uniform(-0.3, 0.3, N))).astype(np.complex64)


@pytest.mark.parametrize("overlap,return_spectra,cov_dtype", [
    (0, True, "float32"), (0, False, "float32"), (128, True, "float32"),
    (128, False, "float32"), (0, False, "int8"), (128, True, "int8")])
def test_slice_matches_reference(overlap, return_spectra, cov_dtype):
    """Angles within 1e-3°, equal escalation counts, and (with spectra)
    the same normalised spectra."""
    cfg = _cfg(overlap, cov_dtype)
    x = _capture()
    c = _correction()
    ref = build_pipeline_tpu(
        dataclasses.replace(cfg, cov_impl="pallas", scan_mode="pallas"),
        return_spectra=return_spectra)(x, c)
    pipe = build_pipeline_torch(cfg, device="cpu",
                                return_spectra=return_spectra)
    out = pipe(x, c)
    a_ref = np.asarray(ref.peak_angles["music"])
    a = out.peak_angles["music"].numpy()
    assert a.shape == a_ref.shape == ((x.shape[0] - 256) // (256 - overlap)
                                      + 1, 2)
    np.testing.assert_allclose(a, a_ref, atol=1e-3)
    assert int(out.escalation_flagged) == int(ref.escalation_flagged)
    assert int(out.escalation_overflow) == int(ref.escalation_overflow)
    if return_spectra:
        # P/max P = dmin/den: dmin sits at a MUSIC null, where f32
        # cancellation leaves ~1e-4-relative noise, so each row carries its
        # own scale (within 1e-2); after it, bins agree to 1e-4 relative,
        # and to 1e-3 absolute at the peaks (den there is a null too)
        P = out.spectra["music"].numpy()
        P_ref = np.asarray(ref.spectra["music"])
        row = np.median(P / P_ref, axis=-1, keepdims=True)
        np.testing.assert_allclose(row, 1.0, rtol=1e-2)
        np.testing.assert_allclose(P / row, P_ref, rtol=1e-4, atol=1e-3)
    else:
        assert out.spectra == {} and ref.spectra == {}


@pytest.mark.parametrize("return_spectra", [True, False])
def test_narrowband_2d_grid_matches_reference(return_spectra):
    """A 4×4 URA on an az/el grid: the narrowband path's spectrum kernel
    then the 2-D peaks (kernel on the card, its plain rule here) against
    the reference's Pallas scan and 2-D peaks kernel."""
    from doa_tpu.io import synth_ura_iq
    cfg = DoaConfig(
        geometry=ArrayGeometry(kind="ura", num_elements=16, shape=(4, 4),
                               norm_spacing=0.5),
        snapshot_size=128, num_sources=2, num_max_vals=2,
        estimators=(Estimator.MUSIC,),
        grid2d=GridSpec2D(num_az=25, num_el=13))
    x = synth_ura_iq([SourceSpec(az_deg=-20.0, el_deg=30.0, freq_norm=0.1),
                      SourceSpec(az_deg=35.0, el_deg=60.0, freq_norm=0.3)],
                     (4, 4), 0.5, 33 * 128, snr_db=10,
                     seed=5).astype(np.complex64)
    ref = build_pipeline_tpu(dataclasses.replace(
        cfg, cov_impl="pallas", scan_mode="pallas"),
        return_spectra=return_spectra)(x)
    out = build_pipeline_torch(cfg, device="cpu",
                               return_spectra=return_spectra)(x)
    a = out.peak_angles["music"].numpy()
    a_ref = np.asarray(ref.peak_angles["music"])
    assert a.shape == a_ref.shape == (33, 2, 2)
    order = lambda v: np.take_along_axis(  # noqa: E731
        v, np.argsort(v[..., 0], -1)[..., None], 1)
    np.testing.assert_allclose(order(a), order(a_ref), atol=1e-3)
    assert int(out.escalation_flagged) == int(ref.escalation_flagged)
    assert ("music" in out.spectra) == return_spectra


def test_interleaved_entry_takes_both_layouts():
    """call.interleaved accepts x[T, 2N] and doa_tpu's (T/TPACK, 2N·TPACK)
    — the same bytes — and agrees with the complex64 entry."""
    cfg = _cfg()
    x = _capture(B=8)
    pipe = build_pipeline_torch(cfg, device="cpu", return_spectra=False)
    a = pipe(x).peak_angles["music"]
    flat = x.view(np.float32)                          # (T, 16)
    a1 = pipe.interleaved(flat).peak_angles["music"]
    a2 = pipe.interleaved(torch.from_numpy(flat.reshape(-1, 128))
                          ).peak_angles["music"]
    torch.testing.assert_close(a1, a, rtol=0, atol=0)
    torch.testing.assert_close(a2, a, rtol=0, atol=0)
    assert pipe.fast_path
    # the port hands back its own config, equal to the one passed
    from doa_tpu_torch import configs as configs_t
    assert type(pipe.config) is configs_t.DoaConfig
    assert pipe.config == configs_t.as_config(cfg)


def test_load_state_with_reference_steering():
    """The port's steering is bit-equal to doa_tpu's; load_state takes
    doa_tpu's planes and a correction, and the pipeline built on that
    state matches the reference run with the same correction."""
    cfg = _cfg()
    c = _correction(seed=3)
    pipe_j = build_pipeline_tpu(dataclasses.replace(
        cfg, cov_impl="pallas", scan_mode="pallas"))
    A_re, A_im = (np.asarray(p) for p in pipe_j.steering_planes)
    own = build_pipeline_torch(cfg, device="cpu")
    np.testing.assert_array_equal(own.steering_planes[0].numpy(), A_re)
    np.testing.assert_array_equal(own.steering_planes[1].numpy(), A_im)
    state = load_state(A_re, A_im, c, device="cpu")
    pipe = build_pipeline_torch(cfg, device="cpu", state=state)
    x = _capture(B=36, seed=4)
    a_ref = np.asarray(pipe_j(x, c).peak_angles["music"])
    np.testing.assert_allclose(pipe(x).peak_angles["music"].numpy(), a_ref,
                               atol=1e-3)
    np.testing.assert_allclose(pipe(x, c).peak_angles["music"].numpy(),
                               a_ref, atol=1e-3)
    with pytest.raises(ValueError, match="grid"):
        build_pipeline_torch(dataclasses.replace(
            cfg, grid=GridSpec1D(num_points=128)),
                             device="cpu", state=state)


def test_steering_grids_bit_equal():
    geo = ArrayGeometry(kind="ula", num_elements=8, norm_spacing=0.5)
    grid = GridSpec1D(num_points=181)
    np.testing.assert_array_equal(steering.ula_grid(geo, grid),
                                  steer_jax.ula_grid(geo, grid))
    geo2 = ArrayGeometry(kind="ura", num_elements=16, shape=(4, 4))
    grid2 = GridSpec2D(num_az=19, num_el=10)
    np.testing.assert_array_equal(steering.ura_grid(geo2, grid2),
                                  steer_jax.ura_grid(geo2, grid2))


def test_embedding_matches_reference():
    rng = np.random.default_rng(2)
    Z = (rng.standard_normal((3, 5, 4))
         + 1j * rng.standard_normal((3, 5, 4))).astype(np.complex64)
    R = np.einsum("bti,btj->bij", Z, Z.conj())
    Rt = torch.from_numpy(R)
    E = cpx.embed_planes(Rt.real, Rt.imag)
    np.testing.assert_array_equal(E.numpy(),
                                  np.asarray(embed_jax(Cpx.from_complex(R))))
    torch.testing.assert_close(torch.complex(*cpx.unembed_planes(E)), Rt)
    v = torch.from_numpy(Z[0, 0])
    np.testing.assert_array_equal(cpx.embed_vector(v).numpy(),
                                  np.concatenate([Z[0, 0].real,
                                                  Z[0, 0].imag]))
    # E(C)·ṽ = embed of C·v
    np.testing.assert_allclose(
        (E[0] @ cpx.embed_vector(v)).numpy(),
        cpx.embed_vector(torch.from_numpy(R[0]) @ v).numpy(), rtol=1e-5,
        atol=1e-5)


def test_fp32_matmuls_scope():
    before = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32)
    with cpx.fp32_matmuls():
        assert not torch.backends.cuda.matmul.allow_tf32
        assert not torch.backends.cudnn.allow_tf32
    assert (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32) == before
    prec = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        with pytest.raises(RuntimeError, match="highest"):
            with cpx.fp32_matmuls():
                pass
    finally:
        torch.set_float32_matmul_precision(prec)


def test_port_never_imports_jax():
    """In a fresh interpreter every module of the port (the host side's
    cli, __main__, tracking, checkpoint, eval, io and utils among them),
    chip_smoke, exp_subspace_ns, exp_peaks2d and exp_wideband_cov
    (imported, not run) load neither jax nor any module of doa_tpu."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import doa_tpu_torch, chip_smoke, exp_subspace_ns, exp_peaks2d\n"
        "import exp_wideband_cov\n"
        "for m in pkgutil.walk_packages(doa_tpu_torch.__path__, "
        "'doa_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'doa_tpu' or "
        "m.startswith('doa_tpu.'))\n"
        "assert not bad, bad\n"
        "assert 'doa_tpu_torch.ops.wideband' in sys.modules\n"
        "assert 'doa_tpu_torch.parallel.sharded' in sys.modules\n"
        "assert 'doa_tpu_torch.ops.cuda.ring' in sys.modules\n"
        "for m in ('beamspace', 'hierarchical', 'model_order', 'tops'):\n"
        "    assert 'doa_tpu_torch.ops.' + m in sys.modules, m\n"
        "for m in ('music', 'capon', 'bartlett', 'covariance', 'beamform',\n"
        "          'crb'):\n"
        "    assert 'doa_tpu_torch.ops.' + m in sys.modules, m\n"
        "for m in ('cli', '__main__', 'tracking', 'checkpoint', 'eval',\n"
        "          'io.stream', 'io.socket_source', 'io.synthetic',\n"
        "          'utils.profiling', 'ops.cuda.track'):\n"
        "    assert 'doa_tpu_torch.' + m in sys.modules, m\n"
        "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_module_help_runs_without_jax():
    """`python -m doa_tpu_torch --help` exits 0 in a fresh interpreter
    and loads neither jax nor doa_tpu (the host side's entry point)."""
    code = (
        "import runpy, sys\n"
        "sys.argv = ['doa_tpu_torch', '--help']\n"
        "try:\n"
        "    runpy.run_module('doa_tpu_torch', run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert e.code == 0, e.code\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'doa_tpu' or "
        "m.startswith('doa_tpu.'))\n"
        "assert not bad, bad\n"
        "assert 'doa_tpu_torch.cli' in sys.modules\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "calibrate-elements" in out.stdout and "--device" not in (
        out.stderr)
    out = subprocess.run([sys.executable, "-m", "doa_tpu_torch", "--help"],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0 and "simulate" in out.stdout, out.stderr


def test_cuda_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        build_pipeline_torch(_cfg(), device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        load_state(np.ones((4, 8)), np.zeros((4, 8)), device="cuda")


@pytest.mark.parametrize("name", sorted(PRESETS))
def test_as_config_gives_the_ports_presets(name):
    """doa_tpu_torch.configs is a copy of doa_tpu.configs: as_config of
    each reference preset equals the port's own preset, class for
    class."""
    from doa_tpu_torch import configs as configs_t
    got = configs_t.as_config(PRESETS[name])
    assert type(got) is configs_t.DoaConfig
    assert got == configs_t.PRESETS[name]
    assert type(got.geometry) is configs_t.ArrayGeometry
    assert all(type(e) is configs_t.Estimator for e in got.estimators)
    assert configs_t.as_config(got) is got


def test_config_of_either_module_gives_the_same_result():
    """One config built with doa_tpu.configs and with the port's own gives
    the same DoaResult from build_pipeline_torch."""
    from doa_tpu_torch import configs as configs_t
    cfg_j = _cfg(overlap=128)
    cfg_t = configs_t.DoaConfig(
        geometry=configs_t.ArrayGeometry(kind="ula", num_elements=8,
                                         norm_spacing=0.5),
        snapshot_size=256, overlap=128, num_sources=2,
        estimators=(configs_t.Estimator.MUSIC,),
        grid=configs_t.GridSpec1D(num_points=256), num_max_vals=2)
    assert configs_t.as_config(cfg_j) == cfg_t
    x, c = _capture(B=12), _correction()
    out_j = build_pipeline_torch(cfg_j, device="cpu")(x, c)
    out_t = build_pipeline_torch(cfg_t, device="cpu")(x, c)
    for f in dataclasses.fields(out_t):
        a, b = getattr(out_j, f.name), getattr(out_t, f.name)
        if isinstance(a, dict):
            assert a.keys() == b.keys()
            for k in a:
                torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)
        elif isinstance(a, torch.Tensor):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
        else:
            assert a is None and b is None
    with pytest.raises(TypeError, match="DoaConfig"):
        configs_t.as_config(cfg_j.geometry)


def test_subbands_must_divide_the_snapshot():
    with pytest.raises(ValueError, match="divisible"):
        build_pipeline_torch(_c5_with(num_subbands=12), device="cpu")


def _c5_with(**wideband):
    c5 = PRESETS["c5_ura64_wideband"]
    return dataclasses.replace(
        c5, wideband=dataclasses.replace(c5.wideband, **wideband))


# each key names the preset its config comes from; beamspace, the
# hierarchical scans and the rest of single-card wideband, once listed
# here, are ported, and the case left holds the config the slice still
# refuses
_OUTSIDE = {
    "c2_ula8_2src": lambda: dataclasses.replace(
        PRESETS["c2_ula8_2src"], cov_dtype="int8", subspace_method="eigh"),
}


@pytest.mark.parametrize("name", list(_OUTSIDE))
def test_configs_outside_the_slice_raise(name):
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        build_pipeline_torch(_OUTSIDE[name](), device="cpu")


# the configs that test_configs_outside_the_slice_raise held until the
# rest of single-card wideband was ported, under the same keys: each
# builds on the CPU with the stages its plan names (c5's sizes are not
# run through either package here: tests/test_torch_tops.py and
# tests/test_torch_wideband_scans.py hold the paths at small sizes)
_ONCE_OUTSIDE = {
    "c5_tops": (lambda: _c5_with(fusion="tops"), {
        "covariance": "wideband_fft_gram", "peaks": "peaks2d"}),
    "c5_eigh": (lambda: dataclasses.replace(
        PRESETS["c5_ura64_wideband"], subspace_method="eigh"), {
        "covariance": "wideband_fft_gram", "peaks": "peaks2d"}),
    "c5_incoherent_esprit": (lambda: dataclasses.replace(
        PRESETS["c5_ura64_wideband"], estimators=(Estimator.MUSIC,
                                                  Estimator.ESPRIT)), {
        "covariance": "wideband_fft_gram", "subspace": "mgs_iterate",
        "fusion": "wideband_fusion", "peaks": "peaks2d"}),
    "c5_hierarchical": (lambda: dataclasses.replace(
        PRESETS["c5_ura64_wideband"], scan_mode="hierarchical",
        compute_dtype="int8"), {
        "covariance": "wideband_fft_gram", "subspace": "mgs_iterate",
        "peaks": "peaks2d"}),
    "c5_bf16_scan": (lambda: dataclasses.replace(
        PRESETS["c5_ura64_wideband"], compute_dtype="bfloat16"), {
        "covariance": "wideband_fft_gram", "subspace": "mgs_iterate",
        "peaks": "peaks2d"}),
    "c3_ula16_calib_smooth": (lambda: dataclasses.replace(
        PRESETS["c3_ula16_calib_smooth"], wideband=WidebandSpec(
            num_subbands=16, fractional_bw=0.1, fusion="cssm_auto")), None),
}


@pytest.mark.parametrize("name", list(_ONCE_OUTSIDE))
def test_configs_once_outside_the_slice_build(name):
    """Each builds on the CPU and its plan names the stages of its route
    (TOPS and the eigh projectors: the front end and kernel 6 alone;
    incoherent with ESPRIT: MUSIC's route, the estimator ignored as the
    reference does; the quantized scans: K4 and no kernel 5). The c3 key
    (cssm_auto with smoothing on a ULA) raises ValueError in both
    packages: the reference on its call, the port when it builds."""
    make, stages = _ONCE_OUTSIDE[name]
    cfg = make()
    if stages is None:
        x = np.zeros((cfg.snapshot_size, cfg.geometry.num_elements),
                     np.complex64)
        with pytest.raises(ValueError, match="does not match"):
            build_pipeline_tpu(cfg)(x)
        with pytest.raises(ValueError, match="subarray"):
            build_pipeline_torch(cfg, device="cpu")
        return
    call = build_pipeline_torch(cfg, device="cpu")
    assert call.plan.kernels == stages
    assert set(call.plan.values()) == {"plain"}


@pytest.mark.parametrize("name", ["c1_ula4_tone", "c2_ula8_2src",
                                  "c3_ula16_calib_smooth",
                                  "c4_ula16_streaming", "fast_bf16",
                                  "fast_int8"])
def test_presets_of_the_slice_build(name):
    cfg = PRESETS[name]
    pipe = build_pipeline_torch(cfg, device="cpu")
    assert pipe.steering_planes[0].shape == (
        cfg.grid.num_points, cfg.effective_num_elements)
    assert pipe.fast_path == (name != "c3_ula16_calib_smooth")


# --- the planes path (c3, eigh configs, planes input) and Capon/Bartlett ---

_C3_SOURCES = [SourceSpec(theta_deg=40.0, freq_norm=0.12),
               SourceSpec(theta_deg=70.0, freq_norm=0.12),   # coherent pair
               SourceSpec(theta_deg=100.0, freq_norm=0.3)]


def _c3_capture(B=24, seed=3):
    """validate_tpu.py's c3 scene, B windows of 1024 samples."""
    return synth_ula_iq(_C3_SOURCES, 16, 0.5, B * 1024, snr_db=10,
                        seed=seed).astype(np.complex64)


def _c2_capture(B=32, seed=2):
    """validate_tpu.py's c2 scene, B windows of 2048 samples."""
    return synth_ula_iq([SourceSpec(theta_deg=60.0, freq_norm=0.1),
                         SourceSpec(theta_deg=110.0, freq_norm=0.31)],
                        8, 0.5, B * 2048, snr_db=10,
                        seed=seed).astype(np.complex64)


def _assert_spectra_match(P, P_ref):
    """Normalised spectra P = dmin/den. dmin sits at a null, which f32
    cancellation resolves only to a few percent where the null is deep
    (S = 2048 at 10 dB), so each row carries its own scale (within 5e-2).
    After it, den's absolute f32 error ε shows in P as a relative error
    (ε/dmin)·P: bins agree to 1e-4·P + 5e-2·P² (P ≤ 1; the second term
    matters only near the peaks, which the angles check to 1e-3°)."""
    P, P_ref = P.numpy(), np.asarray(P_ref)
    row = np.median(P / P_ref, axis=-1, keepdims=True)
    np.testing.assert_allclose(row, 1.0, rtol=5e-2)
    assert np.all(np.abs(P / row - P_ref) <= 1e-4 * P_ref + 5e-2 * P_ref ** 2)


def _assert_matches(out, ref, keys, spectra, sort=False):
    """Angles within 1e-3° (each window's sorted, where two peaks of equal
    height may swap rank on rounding), equal escalation counts, and the
    same spectra when returned."""
    for key in keys:
        a = out.peak_angles[key].numpy()
        a_ref = np.asarray(ref.peak_angles[key])
        if sort:
            a, a_ref = np.sort(a, -1), np.sort(a_ref, -1)
        assert a.shape == a_ref.shape
        np.testing.assert_allclose(a, a_ref, atol=1e-3)
        if spectra:
            _assert_spectra_match(out.spectra[key], ref.spectra[key])
        else:
            assert key not in out.spectra
    assert int(out.escalation_flagged) == int(ref.escalation_flagged)
    assert int(out.escalation_overflow) == int(ref.escalation_overflow)


@pytest.mark.parametrize("return_spectra", [True, False])
def test_c3_planes_path_matches_reference(return_spectra):
    """c3 (calibration correction, FB, smoothing to L = 12, cold MGS,
    K3 or K2) against doa_tpu's planes path with its Pallas chunk kernel."""
    cfg = PRESETS["c3_ula16_calib_smooth"]
    x = _c3_capture()
    c = _correction(16, seed=1)
    ref = build_pipeline_tpu(dataclasses.replace(cfg, cov_impl="pallas"),
                             return_spectra=return_spectra)(x, c)
    pipe = build_pipeline_torch(cfg, device="cpu",
                                return_spectra=return_spectra)
    assert not pipe.fast_path
    out = pipe(x, c)
    assert out.peak_angles["music"].shape == (24, 3)
    _assert_matches(out, ref, ["music"], return_spectra)


def test_c3_eigh_overlap_matches_reference():
    """doa_tpu's test_tpu_path_overlap_and_smoothing config (c3 with
    subspace_method="eigh", overlap 512): the eigh noise projector and its
    dense denominator."""
    cfg = dataclasses.replace(PRESETS["c3_ula16_calib_smooth"], overlap=512,
                              subspace_method="eigh")
    x = synth_ula_iq([SourceSpec(theta_deg=70.0, freq_norm=0.1),
                      SourceSpec(theta_deg=100.0, freq_norm=0.1),
                      SourceSpec(theta_deg=40.0, freq_norm=0.33)],
                     16, 0.5, 16 * 1024, snr_db=15, seed=2,
                     correlated_pairs=[(0, 1)]).astype(np.complex64)
    ref = build_pipeline_tpu(dataclasses.replace(cfg, cov_impl="pallas"))(x)
    out = build_pipeline_torch(cfg, device="cpu")(x)
    assert out.peak_angles["music"].shape == (31, 3)
    _assert_matches(out, ref, ["music"], True)


@pytest.mark.parametrize("return_spectra", [True, False])
def test_c2_music_capon_matches_reference(return_spectra):
    """c2 on the fused path (K1, warm MGS, K3/K2) with Capon on
    R = unembed(E)."""
    cfg = PRESETS["c2_ula8_2src"]
    x = _c2_capture()
    c = _correction(8, seed=2)
    ref = build_pipeline_tpu(dataclasses.replace(cfg, cov_impl="pallas"),
                             return_spectra=return_spectra)(x, c)
    pipe = build_pipeline_torch(cfg, device="cpu",
                                return_spectra=return_spectra)
    assert pipe.fast_path
    out = pipe(x, c)
    assert out.peak_angles["capon"].shape == (32, 2)
    _assert_matches(out, ref, ["music", "capon"], return_spectra, sort=True)


@pytest.mark.parametrize("smooth", [False, True])
def test_bartlett_and_capon_newton_free_paths_match_reference(smooth):
    """Bartlett and Capon beside MUSIC, on the fused path (R from E) and
    on the planes path (R from kernel 8), with return_covariance: the
    covariance windows within 1e-5·max|R|."""
    cfg = dataclasses.replace(
        PRESETS["c3_ula16_calib_smooth"],
        estimators=(Estimator.MUSIC, Estimator.CAPON, Estimator.BARTLETT),
        **({} if smooth else dict(smoothing=dataclasses.replace(
            PRESETS["c3_ula16_calib_smooth"].smoothing, subarray_size=0))))
    x = _c3_capture(B=12, seed=5)
    c = _correction(16, seed=4)
    ref = build_pipeline_tpu(dataclasses.replace(cfg, cov_impl="pallas"),
                             return_covariance=True)(x, c)
    pipe = build_pipeline_torch(cfg, device="cpu", return_covariance=True)
    assert pipe.fast_path == (not smooth)
    out = pipe(x, c)
    _assert_matches(out, ref, ["music", "capon", "bartlett"], True,
                    sort=True)
    R_re, R_im = (np.asarray(p) for p in ref.covariance)
    n = 12 if smooth else 16
    assert out.covariance.shape == (12, n, n)
    assert out.covariance.dtype == torch.complex64
    scale = np.abs(R_re).max()
    np.testing.assert_allclose(out.covariance.real.numpy(), R_re, rtol=0,
                               atol=1e-5 * scale)
    np.testing.assert_allclose(out.covariance.imag.numpy(), R_im, rtol=0,
                               atol=1e-5 * scale)


@pytest.mark.parametrize("name", ["c3_ula16_calib_smooth", "c2_ula8_2src"])
def test_planes_input_matches_reference(name):
    """A (re, im) pair of f32[T, N] planes — numpy arrays, contiguous
    tensors and the strided views of one complex64 buffer — against doa_tpu
    on its Cpx input: on c3 the planes path, on c2 the fused path's planes
    route (f32 Grams through kernel 8, embedded, fused downstream)."""
    from doa_tpu.cpx import Cpx as CpxJ
    cfg = PRESETS[name]
    x = _c3_capture(B=12) if name.startswith("c3") else _c2_capture(B=12)
    c = _correction(cfg.geometry.num_elements, seed=6)
    ref = build_pipeline_tpu(dataclasses.replace(cfg, cov_impl="pallas"))(
        CpxJ.from_complex(x), c)
    pipe = build_pipeline_torch(cfg, device="cpu")
    xr = np.ascontiguousarray(x.real)
    xi = np.ascontiguousarray(x.imag)
    v = torch.from_numpy(x.view(np.float32)).view(x.shape[0], -1, 2)
    keys = [e.value for e in cfg.estimators]
    first = None
    for planes in ((xr, xi), (torch.from_numpy(xr), torch.from_numpy(xi)),
                   (v[..., 0], v[..., 1])):
        out = pipe(planes, c)
        _assert_matches(out, ref, keys, True, sort=True)
        if first is None:
            first = out
        else:
            for key in keys:
                torch.testing.assert_close(out.peak_angles[key],
                                           first.peak_angles[key])


def test_complex128_capture_matches_reference():
    """A complex128 numpy capture is cast to complex64 once and takes the
    planes route, as doa_tpu's split_c64 entry does."""
    cfg = PRESETS["c2_ula8_2src"]
    x = _c2_capture(B=12).astype(np.complex128)
    ref = build_pipeline_tpu(dataclasses.replace(cfg, cov_impl="pallas"))(x)
    out = build_pipeline_torch(cfg, device="cpu")(x)
    _assert_matches(out, ref, ["music", "capon"], True, sort=True)


def test_planes_config_serves_the_interleaved_entry():
    """A planes-path config (c3) serves call.interleaved: the float32
    capture is read as its two stride-2 planes and the answers are
    call(x)'s on the same complex64 capture, bit for bit."""
    pipe = build_pipeline_torch(PRESETS["c3_ula16_calib_smooth"],
                                device="cpu")
    x = _c3_capture(B=2)
    want = pipe(x)
    got = pipe.interleaved(x.view(np.float32))
    for key in ("peak_values", "peak_angles", "spectra"):
        torch.testing.assert_close(getattr(got, key)["music"],
                                   getattr(want, key)["music"], rtol=0,
                                   atol=0)
    assert pipe.interleaved.route == "planes"


@pytest.mark.parametrize("compute_dtype", ["bfloat16", "int8"])
def test_dense_quantized_scan_on_fused_path_matches_reference(compute_dtype):
    """scan_mode="dense" with a bfloat16/int8 compute_dtype on a fused
    config: the reference scans the subspace in that precision
    (music_denominator_subspace), not with its f32 scan kernel."""
    cfg = dataclasses.replace(_cfg(), scan_mode="dense",
                              compute_dtype=compute_dtype)
    x = _capture()
    # angles only: the quantized den reaches 0 at the peaks, where both
    # clamp it to tiny; the reference flushes the resulting denormal bins
    # of P/max P to zero
    ref = build_pipeline_tpu(dataclasses.replace(cfg, cov_impl="pallas"),
                             return_spectra=False)(x)
    out = build_pipeline_torch(cfg, device="cpu", return_spectra=False)(x)
    _assert_matches(out, ref, ["music"], False)


# --- slice 5: subspace_impl="pallas" (kernel 11), subspace_check (the
# guard), scan_capture, donate_inputs ---

def _assert_residual_match(out, ref):
    """subspace_residual f32[B]: the same replaced windows (≥ 1); the
    residual within 1e-4 relative + 1e-5 (a converged window's residual is
    f32 cancellation noise of ~1e-7)."""
    r = out.subspace_residual.numpy()
    r_ref = np.asarray(ref.subspace_residual)
    assert r.shape == r_ref.shape
    np.testing.assert_array_equal(r >= 1.0, r_ref >= 1.0)
    np.testing.assert_allclose(r, r_ref, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("return_spectra,schedule", [(True, "e1"),
                                                     (False, "e2")])
def test_subspace_impl_pallas_matches_reference(return_spectra, schedule):
    """subspace_impl="pallas": kernel 11's cold Newton–Schulz subspace
    (its plain version here) against the reference's Pallas subspace
    kernel in interpret mode, K3/K2 downstream: angles within 1e-3°,
    spectra as test_slice_matches_reference, escalation counts zeros."""
    cfg = dataclasses.replace(_cfg(128), subspace_impl="pallas",
                              power_schedule=schedule,
                              subspace_escalate=schedule == "e1")
    x, c = _capture(), _correction()
    ref = build_pipeline_tpu(
        dataclasses.replace(cfg, cov_impl="pallas", scan_mode="pallas"),
        return_spectra=return_spectra)(x, c)
    out = build_pipeline_torch(cfg, device="cpu",
                               return_spectra=return_spectra)(x, c)
    _assert_matches(out, ref, ["music"], return_spectra)
    assert out.escalation_flagged.dtype == torch.int32
    assert int(out.escalation_flagged) == int(out.escalation_overflow) == 0
    assert out.subspace_residual is None and ref.subspace_residual is None


@pytest.mark.parametrize("impl", ["auto", "pallas"])
def test_subspace_check_fused_route_matches_reference(impl):
    """subspace_check on the fused path (warm MGS, or kernel 11): the
    guarded subspace feeds the scans; angles, spectra, escalation counts
    and the residual as the reference."""
    cfg = dataclasses.replace(_cfg(), subspace_check=True,
                              subspace_impl=impl)
    x, c = _capture(), _correction()
    ref = build_pipeline_tpu(
        dataclasses.replace(cfg, cov_impl="pallas", scan_mode="pallas"))(x, c)
    out = build_pipeline_torch(cfg, device="cpu")(x, c)
    _assert_matches(out, ref, ["music"], True)
    _assert_residual_match(out, ref)


def test_subspace_check_planes_route_matches_reference():
    """subspace_check on the planes path (c3: cold MGS of the smoothed
    E(R), guarded on E(R))."""
    cfg = dataclasses.replace(PRESETS["c3_ula16_calib_smooth"],
                              subspace_check=True)
    x, c = _c3_capture(B=12), _correction(16, seed=1)
    ref = build_pipeline_tpu(dataclasses.replace(cfg, cov_impl="pallas"))(x,
                                                                          c)
    pipe = build_pipeline_torch(cfg, device="cpu")
    assert not pipe.fast_path
    out = pipe(x, c)
    _assert_matches(out, ref, ["music"], True)
    _assert_residual_match(out, ref)


@pytest.mark.parametrize("impl", ["auto", "pallas"])
def test_subspace_check_hard_scene_matches_reference(impl):
    """tests/test_power_subspace.py's guard scene (amplitude 30 : 1 at
    60°/110°, 20 dB, power_iters=4, c2 with MUSIC only): the guarded
    angles as the reference's (1e-3°) and within 0.2° of the eigh run; the
    4-iteration Newton–Schulz subspace fails the guard in every window
    and takes eigh's."""
    x = synth_ula_iq(
        [SourceSpec(theta_deg=60.0, freq_norm=0.1, amplitude=30.0),
         SourceSpec(theta_deg=110.0, freq_norm=0.31, amplitude=1.0)],
        8, 0.5, 16 * 2048, snr_db=20, seed=6).astype(np.complex64)
    base = dataclasses.replace(PRESETS["c2_ula8_2src"],
                               estimators=(Estimator.MUSIC,), power_iters=4,
                               subspace_impl=impl)
    guard = dataclasses.replace(base, subspace_check=True)
    # peaks only: the dominant source's nulls are ~1e-33 of the peak
    ref = build_pipeline_tpu(dataclasses.replace(guard, cov_impl="pallas"),
                             return_spectra=False)(x)
    out = build_pipeline_torch(guard, device="cpu", return_spectra=False)(x)
    _assert_matches(out, ref, ["music"], False, sort=True)
    _assert_residual_match(out, ref)
    a_eigh = build_pipeline_torch(dataclasses.replace(
        base, subspace_method="eigh"), device="cpu")(x).peak_angles["music"]
    np.testing.assert_allclose(
        np.sort(out.peak_angles["music"].numpy(), -1),
        np.sort(a_eigh.numpy(), -1), atol=0.2)
    if impl == "pallas":
        assert bool((out.subspace_residual >= 1.0).all())


def _scan_capture_case(wideband):
    """tests/test_streaming_tracking.py's scan_capture cases → (cfg,
    blocks (M, T_blk, 2N) float32, hop)."""
    N, S = 8, 256
    if wideband:
        from doa_tpu.configs import WidebandSpec
        from doa_tpu.io.synthetic import synth_wideband_ula_iq
        OV = 128
        cfg = DoaConfig(
            geometry=ArrayGeometry(kind="ula", num_elements=N,
                                   norm_spacing=0.5),
            snapshot_size=S, overlap=OV, num_sources=2,
            estimators=(Estimator.MUSIC,), grid=GridSpec1D(num_points=181),
            wideband=WidebandSpec(num_subbands=8, fractional_bw=0.1),
            num_max_vals=2)
        M, T_blk = 3, 8 * (S - OV)
        x = synth_wideband_ula_iq(
            [SourceSpec(theta_deg=62.0, freq_norm=0.0, bandwidth_norm=0.5),
             SourceSpec(theta_deg=111.0, freq_norm=0.0,
                        bandwidth_norm=0.5)],
            N, 0.5, M * T_blk, fractional_bw=0.1, snr_db=15, seed=3)
    else:
        OV = 64                       # hop = 192 does not divide overlap
        cfg = DoaConfig(
            geometry=ArrayGeometry(kind="ula", num_elements=N,
                                   norm_spacing=0.5),
            snapshot_size=S, overlap=OV, num_sources=2,
            estimators=(Estimator.MUSIC,), grid=GridSpec1D(num_points=361),
            num_max_vals=2, scan_mode="pallas")
        M, T_blk = 3, 5 * (S - OV)
        x = synth_ula_iq([SourceSpec(theta_deg=70.0, freq_norm=0.12),
                          SourceSpec(theta_deg=120.0, freq_norm=0.3)],
                         N, 0.5, M * T_blk, snr_db=15, seed=9)
    blocks = np.ascontiguousarray(x.astype(np.complex64)).view(
        np.float32).reshape(M, T_blk, 2 * N)
    return cfg, blocks, S - OV


@pytest.mark.parametrize("wideband", [False, True])
def test_scan_capture_matches_reference_and_per_block_calls(wideband):
    """call.scan_capture against the reference's scan_capture (angles
    within 1e-3°; the reference takes its (M, T_blk/TPACK, 2N·TPACK)
    layout, the port both layouts) and, as
    tests/test_streaming_tracking.py, against per-block calls: blocks
    1..M−1 equal call.interleaved on the block with its carry, block 0
    beyond prefix_windows equals the plain call on block 0."""
    from doa_tpu.ops.pallas.cov_embedded import interleave_factor
    cfg, blocks, hop = _scan_capture_case(wideband)
    M, T_blk, n2 = blocks.shape
    tp = interleave_factor(n2 // 2)
    ref = build_pipeline_tpu(dataclasses.replace(cfg, cov_impl="pallas"),
                             return_spectra=False)
    out_ref = ref.scan_capture(blocks.reshape(M, T_blk // tp, n2 * tp))
    pipe = build_pipeline_torch(cfg, device="cpu", return_spectra=False)
    out = pipe.scan_capture(blocks)
    assert set(out) == {"peak_values", "peak_angles"}
    angs = out["peak_angles"]["music"].numpy()
    assert angs.shape == (M, (T_blk + pipe.scan_capture.prefix_windows * hop
                              - cfg.snapshot_size) // hop + 1, 2)
    np.testing.assert_allclose(angs, np.asarray(
        out_ref["peak_angles"]["music"]), atol=1e-3)
    assert pipe.scan_capture.prefix_windows == ref.scan_capture.prefix_windows
    # the reference's layout, as a torch tensor: the same numbers
    again = pipe.scan_capture(torch.from_numpy(
        blocks.reshape(M, T_blk // tp, n2 * tp)))
    torch.testing.assert_close(again["peak_angles"]["music"],
                               out["peak_angles"]["music"], rtol=0, atol=0)
    C = hop * -(-cfg.overlap // hop)
    for m in range(1, M):
        xb = np.concatenate([blocks[m - 1][-C:], blocks[m]]) if C else \
            blocks[m]
        r = pipe.interleaved(xb).peak_angles["music"].numpy()
        np.testing.assert_allclose(angs[m], r, atol=1e-4)
    n_pre = pipe.scan_capture.prefix_windows
    r0 = pipe.interleaved(blocks[0]).peak_angles["music"].numpy()
    np.testing.assert_allclose(angs[0, n_pre:], r0[:angs.shape[1] - n_pre],
                               atol=1e-4)


def test_scan_capture_checks():
    cfg, blocks, hop = _scan_capture_case(False)
    pipe = build_pipeline_torch(cfg, device="cpu")
    with pytest.raises(ValueError, match="hop"):
        pipe.scan_capture(blocks[:, :-8])
    with pytest.raises(ValueError, match="fused"):
        build_pipeline_torch(PRESETS["c3_ula16_calib_smooth"],
                             device="cpu").scan_capture(blocks)
    wb_cfg, _, _ = _scan_capture_case(True)
    with pytest.raises(ValueError, match="overlap"):
        build_pipeline_torch(dataclasses.replace(wb_cfg, overlap=100),
                             device="cpu").scan_capture(blocks)


def test_donate_inputs_gives_equal_results():
    cfg = dataclasses.replace(_cfg(), subspace_check=True)
    x = _capture(B=12)
    a = build_pipeline_torch(cfg, device="cpu")(x)
    b = build_pipeline_torch(cfg, device="cpu", donate_inputs=True)(x)
    for f in dataclasses.fields(a):
        u, v = getattr(a, f.name), getattr(b, f.name)
        if isinstance(u, dict):
            for k in u:
                torch.testing.assert_close(u[k], v[k], rtol=0, atol=0)
        elif isinstance(u, torch.Tensor):
            torch.testing.assert_close(u, v, rtol=0, atol=0)
        else:
            assert u is None and v is None


@pytest.mark.parametrize("name", ["c2_ula8_2src", "c4_ula16_streaming"])
def test_as_config_carries_subspace_impl_and_check(name):
    from doa_tpu_torch import configs as configs_t
    cfg = dataclasses.replace(PRESETS[name], subspace_impl="pallas",
                              subspace_check=True, subspace_tol=0.03)
    got = configs_t.as_config(cfg)
    assert (got.subspace_impl, got.subspace_check, got.subspace_tol) == (
        "pallas", True, 0.03)
    assert got == dataclasses.replace(configs_t.PRESETS[name],
                                      subspace_impl="pallas",
                                      subspace_check=True, subspace_tol=0.03)
    assert build_pipeline_torch(cfg, device="cpu").config == got


def _route_case(overlap):
    """ULA-8, S = 256, K = 2, G = 256, 64 windows: 60° at amplitude 1.0
    and 68° at 0.3 (tones 0.1 and 0.3), 10 dB, seed 5."""
    S, B = 256, 64
    cfg = DoaConfig(
        geometry=ArrayGeometry(kind="ula", num_elements=8, norm_spacing=0.5),
        snapshot_size=S, overlap=overlap, num_sources=2,
        estimators=(Estimator.MUSIC,), grid=GridSpec1D(num_points=256),
        num_max_vals=2)
    x = synth_ula_iq([SourceSpec(theta_deg=60.0, amplitude=1.0,
                                 freq_norm=0.1),
                      SourceSpec(theta_deg=68.0, amplitude=0.3,
                                 freq_norm=0.3)],
                     8, 0.5, (B - 1) * (S - overlap) + S, snr_db=10,
                     seed=5).astype(np.complex64)
    return cfg, x


@pytest.mark.parametrize("overlap,fused", [(252, False), (248, True)])
def test_route_rule_matches_reference(overlap, fused):
    """The reference's route rule, TPACK | gcd(S, hop): at overlap 252
    (hop 4, gcd 4, TPACK 8) both packages take the planes route and its
    cold subspace; at 248 (gcd 8) both take the fused route and its warm
    start. Angles within 1e-3°, equal escalation counts; call.interleaved
    gives call(x)'s angles on either route."""
    cfg, x = _route_case(overlap)
    ref_pipe = build_pipeline_tpu(dataclasses.replace(cfg, cov_impl="pallas"))
    assert (ref_pipe.jitted_ilv is not None) == fused
    ref = ref_pipe(x)
    pipe = build_pipeline_torch(cfg, device="cpu")
    assert pipe.fast_path == fused
    out = pipe(x)
    a = out.peak_angles["music"].numpy()
    assert a.shape == (64, 2)
    np.testing.assert_allclose(a, np.asarray(ref.peak_angles["music"]),
                               atol=1e-3)
    assert int(out.escalation_flagged) == int(ref.escalation_flagged)
    assert int(out.escalation_overflow) == int(ref.escalation_overflow)
    # the interleaved entry serves either route with call(x)'s answers;
    # scan_capture still takes the fused route alone
    xil = x.view(np.float32)
    np.testing.assert_array_equal(
        pipe.interleaved(xil).peak_angles["music"].numpy(), a)
    if not fused:
        with pytest.raises(ValueError, match="gcd"):
            pipe.scan_capture(xil.reshape(2, -1, 16))


def test_wideband_outside_the_reference_fast_rule_matches_reference():
    """ULA-8 (TPACK 8) with F = 4 subbands, incoherent: F % TPACK ≠ 0, so
    the reference channelizes the complex stream (pipeline_tpu.py:172-176)
    while the port runs its FFT-channelizer front end (kernel 4's route);
    40 windows (warm start), a correction; pair-sorted angles within
    5e-3°."""
    from doa_tpu.configs import WidebandSpec
    from doa_tpu.io.synthetic import synth_wideband_ula_iq
    cfg = DoaConfig(
        geometry=ArrayGeometry(kind="ula", num_elements=8, norm_spacing=0.5),
        snapshot_size=256, num_sources=2, num_max_vals=2,
        estimators=(Estimator.MUSIC,), grid=GridSpec1D(num_points=256),
        wideband=WidebandSpec(num_subbands=4, fractional_bw=0.1))
    x = synth_wideband_ula_iq(
        [SourceSpec(theta_deg=t, freq_norm=0.0, bandwidth_norm=0.5)
         for t in (62.0, 111.0)], 8, 0.5, 40 * 256, fractional_bw=0.1,
        snr_db=15, seed=3).astype(np.complex64)
    c = _correction()
    ref_pipe = build_pipeline_tpu(dataclasses.replace(cfg, cov_impl="pallas"))
    assert not ref_pipe.wb_fast
    ref = ref_pipe(x, c)
    out = build_pipeline_torch(cfg, device="cpu")(x, c)
    a = np.sort(out.peak_angles["music"].numpy(), -1)
    assert a.shape == (40, 2)
    np.testing.assert_allclose(
        a, np.sort(np.asarray(ref.peak_angles["music"]), -1), atol=5e-3)


def test_scan_capture_int8_takes_int8_blocks_only():
    """Under cov_dtype="int8" scan_capture raises on float blocks, as the
    reference (its covariance kernel takes int8 only), and runs int8
    blocks: each block equal to call.interleaved on that block with its
    carry."""
    from doa_tpu_torch.io.native import quantize_interleaved_int8
    cfg = _cfg(overlap=128, cov_dtype="int8")
    x = _capture(B=12).view(np.float32).reshape(-1, 16)
    pipe = build_pipeline_torch(cfg, device="cpu", return_spectra=False)
    with pytest.raises(ValueError, match="int8"):
        pipe.scan_capture(x.reshape(3, -1, 16))
    q = quantize_interleaved_int8(torch.from_numpy(x))[0]
    out = pipe.scan_capture(q.reshape(3, -1, 16))["peak_angles"]["music"]
    T_blk = q.shape[0] // 3
    for m in (1, 2):
        r = pipe.interleaved(q[m * T_blk - 128:(m + 1) * T_blk])
        torch.testing.assert_close(out[m], r.peak_angles["music"], rtol=0,
                                   atol=0)
