"""Port parity for the incoherent wideband scans the reference keeps off
its fusion kernel (compute_dtype bfloat16 / int8 on the power subspaces;
subspace_method eigh / jacobi; hierarchical with a quantized coarse
scan), the coherent paths under a quantized compute_dtype, the
complex-stream functions of ops/wideband.py, and the configs the
reference itself refuses (smoothing on a wideband ULA), against doa_tpu
on the same numpy inputs.

The pipelines run ULA-8, F = 8, S = 256, G = 256 on the 62°/111° scene of
tests/test_torch_cssm.py (15 windows); the reference takes its Pallas
front end in interpret mode on an odd window count."""

import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from doa_tpu.configs import (ArrayGeometry, DoaConfig, Estimator, GridSpec1D,
                             SmoothingSpec, WidebandSpec)
from doa_tpu.cpx import Cpx, embed_hermitian, unembed_hermitian
from doa_tpu.io.synthetic import SourceSpec, synth_wideband_ula_iq
from doa_tpu.ops import cpx_ops as cpx_ops_jax
from doa_tpu.ops import wideband as wideband_jax
from doa_tpu.ops.steering import _ula_steering_np, grid_angles_1d
from doa_tpu.pipeline_tpu import build_pipeline_tpu
from doa_tpu_torch.ops import wideband
from doa_tpu_torch.ops.cuda import wideband_cov
from doa_tpu_torch.pipeline_torch import build_pipeline_torch, kernel_routes

ANGLE_TOL = 5e-3       # degrees, the wideband parity bound (test_torch_cssm)
TRUTH = (62.0, 111.0)
# the reference's own bounds on its quantized wideband scans: the median
# within 1.5° (bfloat16) and 3.0° (int8) of the scene
# (tests/test_wideband_fast.py:208)
QUANT_MEDIAN_TOL = {"bfloat16": 1.5, "int8": 3.0}


def _cfg(fusion="incoherent", **over):
    kw = dict(
        geometry=ArrayGeometry(kind="ula", num_elements=8, norm_spacing=0.5),
        snapshot_size=256, num_sources=2, num_max_vals=2,
        estimators=(Estimator.MUSIC,), grid=GridSpec1D(num_points=256),
        wideband=WidebandSpec(num_subbands=8, fractional_bw=0.1,
                              fusion=fusion))
    kw.update(over)
    return DoaConfig(**kw)


def _capture(T, seed=3):
    return synth_wideband_ula_iq(
        [SourceSpec(theta_deg=t, freq_norm=0.0, bandwidth_norm=0.5)
         for t in TRUTH], 8, 0.5, T, fractional_bw=0.1, snr_db=15,
        seed=seed).astype(np.complex64)


def _steering(cfg):
    theta = grid_angles_1d(cfg.grid)
    return wideband_jax.wideband_steering_stack(
        cfg, lambda d: _ula_steering_np(theta, cfg.geometry.num_elements, d)
    ).astype(np.complex64)


# --- the pipelines -----------------------------------------------------------

# name → (fusion, config overrides)
_CASES = {
    "incoherent_bf16": ("incoherent", dict(compute_dtype="bfloat16")),
    "incoherent_int8": ("incoherent", dict(compute_dtype="int8")),
    "incoherent_eigh": ("incoherent", dict(
        subspace_method="eigh",
        estimators=(Estimator.MUSIC, Estimator.CAPON,
                    Estimator.ROOT_MUSIC))),
    "incoherent_jacobi": ("incoherent", dict(subspace_method="jacobi")),
    "hierarchical_bf16": ("incoherent", dict(compute_dtype="bfloat16",
                                             scan_mode="hierarchical")),
    "cssm_bf16": ("cssm", dict(compute_dtype="bfloat16")),
    "cssm_auto_bf16": ("cssm_auto", dict(compute_dtype="bfloat16")),
}


@pytest.mark.parametrize("name", list(_CASES))
def test_scans_off_kernel_5_match_reference(name):
    """Each config through build_pipeline_torch on the CPU against
    build_pipeline_tpu on 15 windows: the same keys (the fused "music"
    alone under incoherent fusion, whatever the estimators), the same
    escalation counts (None for incoherent), sorted angles within 5e-3°.

    Under a quantized compute_dtype a window's inputs to the scan can sit
    one bfloat16 or int8 rounding apart in the two packages (their
    subspaces agree to FP32 rounding), which moves that window's refined
    peak: such windows are counted, each held within one grid step
    (0.706°), at most 2 of the 15 (measured: incoherent bf16 1 window at
    6.9e-3°; the rest within 5e-3°), and each package's median within the
    reference's own bound of the scene. Float configs hold every window."""
    fusion, over = _CASES[name]
    cfg = _cfg(fusion, **over)
    x = _capture(15 * 256)
    ref = build_pipeline_tpu(dataclasses.replace(cfg, cov_impl="pallas"))(x)
    out = build_pipeline_torch(cfg, device="cpu")(x)
    assert list(out.peak_angles) == list(ref.peak_angles)
    assert list(out.spectra) == list(ref.spectra)
    if fusion == "incoherent":
        assert list(out.peak_angles) == ["music"]
        assert out.escalation_flagged is None
        assert out.root_music_angles is None and ref.root_music_angles is None
    else:
        assert int(out.escalation_flagged) == int(ref.escalation_flagged)
    a = np.sort(out.peak_angles["music"].numpy(), -1)
    a_ref = np.sort(np.asarray(ref.peak_angles["music"]), -1)
    assert a.shape == a_ref.shape == (15, 2)
    err = np.abs(a - a_ref).max(-1)
    dt = cfg.compute_dtype
    if dt == "float32":
        assert err.max() <= ANGLE_TOL, err
        return
    off = np.nonzero(err > ANGLE_TOL)[0]
    assert len(off) <= 2 and err.max() <= 180.0 / 255, (off, err)
    for ang in (a, a_ref):
        med = np.median(ang, 0)
        assert np.abs(med - TRUTH).max() < QUANT_MEDIAN_TOL[dt], med


@pytest.mark.parametrize("fusion", ["incoherent", "tops", "cssm_auto"])
def test_smoothing_on_a_wideband_ula_raises_in_both_packages(fusion):
    """Spatial smoothing on a wideband ULA under incoherent, TOPS and
    cssm_auto: the reference scans the L-element subarray's steering
    against the N-element subband covariances and fails in its einsum
    (ValueError on the call); the port raises ValueError when it builds.
    "cssm" smooths R_coh after focusing and runs in both."""
    cfg = _cfg(fusion, smoothing=SmoothingSpec(subarray_size=6))
    x = _capture(3 * 256)
    with pytest.raises(ValueError, match="does not match"):
        build_pipeline_tpu(dataclasses.replace(cfg, cov_impl="pallas"))(x)
    with pytest.raises(ValueError, match="subarray"):
        build_pipeline_torch(cfg, device="cpu")


@pytest.mark.parametrize("name,stages", [
    ("incoherent_bf16", {"covariance", "subspace"}),
    ("incoherent_int8", {"covariance", "subspace"}),
    ("incoherent_eigh", {"covariance"}),
    ("incoherent_jacobi", {"covariance"}),
    ("hierarchical_bf16", {"covariance", "subspace"}),
    ("cssm_bf16", {"covariance", "subspace"}),
    ("cssm_auto_bf16", {"covariance", "coarse_subspace", "subspace"}),
])
def test_plan_names_no_fusion_stage_off_kernel_5(name, stages):
    """The plan of each config: the front end, K4 where the power
    subspaces run, and no kernel 5 ("fusion") and no scan kernel (the
    quantized and projector scans are torch ops, as XLA in the
    reference); kernel 5 stays on the FP32 power path."""
    fusion, over = _CASES[name]
    assert set(kernel_routes(_cfg(fusion, **over))) == stages
    assert set(kernel_routes(_cfg())) == {"covariance", "subspace", "fusion"}


# --- the scans on the same inputs ------------------------------------------

def _E_sub(cfg, x):
    N, F = cfg.geometry.num_elements, cfg.wideband.num_subbands
    return wideband_cov.wideband_cov_embedded(
        torch.from_numpy(x.view(np.float32)), torch.ones(N), torch.zeros(N),
        N=N, F=F, snapshot_size=cfg.snapshot_size)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_power_and_projector_scans_match_reference(dtype):
    """The fused means of power_spectra on the reference's own subspaces
    and of projector_spectra on its own projectors (both from its
    _subband_spectra / noise_projector_cpx on one E_sub) against the
    reference's fused spectra: the same rounded inputs, sums in another
    order, within 1e-4 of the maximum (a subband's normaliser is 1/min
    den, and den cancels at the peaks); the port's eigh projectors within
    1e-5 of the reference's; subband_den_minima within 1e-5·N of the
    minima of the reference's FP32 den (its hierarchical normaliser)."""
    cfg = _cfg(compute_dtype=dtype)
    E = _E_sub(cfg, _capture(5 * 256))
    A = _steering(cfg)
    Aj = Cpx.from_complex(A)
    Ej = jnp.asarray(E.numpy())
    P_sub, V = wideband_jax._subband_spectra(None, Aj, None, cfg, E_sub=Ej)
    Xr, Xi = (torch.from_numpy(np.ascontiguousarray(p))
              for p in (A.real, A.imag))
    As_emb = torch.cat([Xr, Xi], -1)
    Vt = torch.from_numpy(np.array(V)).transpose(-1, -2)
    P = wideband.fused_mean(wideband.power_spectra(Vt, As_emb, dtype), 8)
    np.testing.assert_allclose(P.numpy(), np.asarray(P_sub).mean(0),
                               rtol=0, atol=1e-4)
    den = jax.vmap(lambda v, a: cpx_ops_jax.music_denominator_subspace(
        v, a))(V, Aj)
    dmin = np.maximum(np.asarray(jnp.min(jnp.maximum(den, 0.0), -1)),
                      np.finfo(np.float32).tiny)
    np.testing.assert_allclose(
        wideband.subband_den_minima(Vt, As_emb).numpy(), dmin, rtol=0,
        atol=1e-5 * 8)
    M = jax.vmap(lambda r: cpx_ops_jax.noise_projector_cpx(r, 2))(
        unembed_hermitian(Ej))
    Mr, Mi = (torch.from_numpy(np.array(p)) for p in (M.re, M.im))
    Mr_t, Mi_t = wideband.subband_noise_projectors(E, 2)
    for got, want in ((Mr_t, Mr), (Mi_t, Mi)):
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    cfg_e = dataclasses.replace(cfg, subspace_method="eigh")
    P_sub_e, _ = wideband_jax._subband_spectra(None, Aj, None, cfg_e,
                                               E_sub=Ej)
    P_e = wideband.fused_mean(
        wideband.projector_spectra(Mr, Mi, Xr, Xi, dtype), 8)
    np.testing.assert_allclose(P_e.numpy(), np.asarray(P_sub_e).mean(0),
                               rtol=0, atol=1e-4)


# --- the complex-stream functions --------------------------------------------

def test_channelizer_and_subband_covariances_match_reference():
    """dft_matrix bit for bit; channelize_cpx within 1e-5 of max|y|;
    subband_covariances within 2e-5 of max|R| at overlap 0 and at an
    overlap of 64 samples (8 subband samples a window)."""
    cfg = _cfg()
    x = _capture(5 * 256 + 40)
    np.testing.assert_array_equal(wideband.dft_matrix(8),
                                  wideband_jax.dft_matrix(8))
    W = wideband.dft_matrix(8)
    Wj, xj = Cpx.from_complex(W), Cpx.from_complex(x)
    Wt, xt = torch.from_numpy(W), torch.from_numpy(x)
    y = wideband.channelize_cpx(xt, Wt).numpy()
    y_ref = wideband_jax.channelize_cpx(xj, Wj).to_numpy()
    assert y.shape == y_ref.shape == (8, x.shape[0] // 8, 8)
    np.testing.assert_allclose(y, y_ref, rtol=0,
                               atol=1e-5 * np.abs(y_ref).max())
    for ov in (0, 64):
        c = dataclasses.replace(cfg, overlap=ov)
        R = wideband.subband_covariances(xt, Wt, c).numpy()
        R_ref = wideband_jax.subband_covariances(xj, Wj, c).to_numpy()
        assert R.shape == R_ref.shape
        np.testing.assert_allclose(R, R_ref, rtol=0,
                                   atol=2e-5 * np.abs(R_ref).max())


@pytest.mark.parametrize("warm", [False, True])
def test_subband_subspaces_match_reference(warm):
    """subband_subspaces on the same R: the embedded f32[F, B, 2N, 2K] of
    the reference's layout, its projector V Vᵀ within 1e-4 (cold: each
    subband's MGS with the detector armed; warm: 40 windows, the capture
    mean's start)."""
    cfg = _cfg(subspace_warm_start=warm)
    B = 40 if warm else 5
    x = _capture(B * 256)
    W = wideband.dft_matrix(8)
    R = wideband_jax.subband_covariances(Cpx.from_complex(x),
                                         Cpx.from_complex(W), cfg)
    V_ref = np.asarray(wideband_jax.subband_subspaces(R, cfg))
    V = wideband.subband_subspaces(torch.from_numpy(R.to_numpy()), cfg)
    assert tuple(V.shape) == V_ref.shape == (8, B, 16, 4)
    P = V @ V.transpose(-1, -2)
    P_ref = V_ref @ np.swapaxes(V_ref, -1, -2)
    np.testing.assert_allclose(P.numpy(), P_ref, rtol=0, atol=1e-4)


@pytest.mark.parametrize("method", ["power", "eigh"])
def test_subband_spectra_and_wideband_music_match_reference(method):
    """_subband_spectra (stream entry) and wideband_music_cpx (stream and
    E_sub entries) against the reference's on one capture: the fused
    spectra within 2e-4 (tests/test_torch_cssm.py's incoherent bound),
    each subband's own within 2e-3 (its pipeline bound: one subband's
    normaliser 1/min den is not averaged with the others');
    _subband_spectra's V None off the power path, as the reference's."""
    cfg = _cfg(subspace_method=method)
    x = _capture(5 * 256, seed=6)
    A = _steering(cfg)
    W = wideband.dft_matrix(8)
    Aj, Wj, xj = (Cpx.from_complex(a) for a in (A, W, x))
    At, Wt, xt = (torch.from_numpy(a) for a in (A, W, x))
    P_sub_ref, V_ref = wideband_jax._subband_spectra(xj, Aj, Wj, cfg)
    P_sub, V = wideband._subband_spectra(xt, At, Wt, cfg)
    assert (V is None) == (V_ref is None) == (method != "power")
    np.testing.assert_allclose(P_sub.numpy(), np.asarray(P_sub_ref),
                               rtol=2e-3, atol=2e-3)
    P_ref = np.asarray(wideband_jax.wideband_music_cpx(xj, Aj, Wj, cfg))
    P = wideband.wideband_music_cpx(xt, At, Wt, cfg).numpy()
    np.testing.assert_allclose(P, P_ref, rtol=2e-4, atol=2e-4)
    R = wideband_jax.subband_covariances(xj, Wj, cfg)
    E = torch.from_numpy(np.array(embed_hermitian(R)))
    P_e = wideband.wideband_music_cpx(None, At, None, cfg, E_sub=E).numpy()
    np.testing.assert_allclose(P_e, P_ref, rtol=2e-4, atol=2e-4)
