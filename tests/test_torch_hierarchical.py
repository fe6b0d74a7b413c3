"""Port parity of the hierarchical (coarse → refine) scans:
doa_tpu_torch's ops/hierarchical.py (the denominators at data-dependent
angles, the ULA and URA refines, MUSIC and Capon coarse → refine) and
ops/wideband.py's wideband_music_hierarchical against doa_tpu's on the
same numpy inputs, and build_pipeline_torch under scan_mode="hierarchical"
against build_pipeline_tpu on the fused, planes, coherent and incoherent
routes (the reference's Pallas kernels in interpret mode)."""

import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import golden
from doa_tpu.configs import (ArrayGeometry, DoaConfig, Estimator,
                             GridSpec1D, GridSpec2D, PRESETS, WidebandSpec)
from doa_tpu.cpx import Cpx
from doa_tpu.io import SourceSpec, synth_ula_iq, synth_ura_iq
from doa_tpu.io.synthetic import synth_wideband_ula_iq, synth_wideband_ura_iq
from doa_tpu.ops import cpx_ops as cj
from doa_tpu.ops import hierarchical as hier_jax
from doa_tpu.ops import wideband as wideband_jax
from doa_tpu.ops.steering import ura_grid
from doa_tpu.pipeline_tpu import build_pipeline_tpu
from doa_tpu_torch.ops import hierarchical, wideband
from doa_tpu_torch.ops.cuda.wideband_scan import (
    wideband_fused_spectrum, wideband_fused_spectrum_plain)
from doa_tpu_torch.pipeline_torch import build_pipeline_torch

URA_TRUTH = [(-29.37, 21.52), (41.18, 54.77)]   # tests/test_hierarchical.py
URA_G2 = dict(num_az=46, num_el=24, az_lo_deg=-90, az_hi_deg=90,
              el_lo_deg=0, el_hi_deg=90)


def _t(a):
    return torch.from_numpy(np.array(a))


def _ula_scene(thetas=(61.43, 108.91), N=16, B=6, S=2048, snr=15, seed=3):
    """Covariances of a ULA scene, their embedded power subspace V (the
    reference's layout; the port's Vt is its transpose) and a 1° grid."""
    x = golden.synthetic_ula_iq(list(thetas), N, 0.5, B * S, snr_db=snr,
                                seed=seed)
    R = golden.sample_covariance(golden.frame_samples(x, S, 0)).astype(
        np.complex64)
    V = np.array(cj.signal_subspace_embedded(Cpx.from_complex(R),
                                             len(thetas), iters=16))
    A = golden.ula_steering(np.linspace(0, 180, 181), N, 0.5).astype(
        np.complex64)
    return R, V, A


def _ura_scene(B=4):
    """tests/test_hierarchical.py:121-150's 8×8 URA scene and its 4° grid."""
    x = synth_ura_iq([SourceSpec(az_deg=a, el_deg=e, freq_norm=f)
                      for (a, e), f in zip(URA_TRUTH, (0.1, 0.3))],
                     (8, 8), 0.5, B * 1024, snr_db=15, seed=0)
    R = golden.sample_covariance(golden.frame_samples(x, 1024, 0)).astype(
        np.complex64)
    V = np.array(cj.signal_subspace_embedded(Cpx.from_complex(R), 2,
                                             iters=16))
    g2 = GridSpec2D(**URA_G2)
    geo = ArrayGeometry(kind="ura", num_elements=64, norm_spacing=0.5,
                        shape=(8, 8))
    A = ura_grid(geo, g2).astype(np.complex64)
    return R, V, A, g2


def _emb(A):
    return torch.cat([_t(A.real), _t(A.imag)], dim=-1)


def _Vt(V):
    return _t(V).transpose(-1, -2).contiguous()


def _pair_sorted(a):
    a = np.asarray(a)
    return np.take_along_axis(a, np.argsort(a[..., 0], -1)[..., None], 1)


# --- the pieces -----------------------------------------------------------

def test_denominators_at_angles_match_reference():
    """ula_denominator_at and ura_denominator_at at data-dependent angles
    within 1e-5·N of the reference's, and at grid angles within
    tests/test_hierarchical.py's bound of the dense scan."""
    R, V, A = _ula_scene()
    rng = np.random.default_rng(0)
    theta = rng.uniform(0, 180, (V.shape[0], 2, 33)).astype(np.float32)
    d = hierarchical.ula_denominator_at(_Vt(V), _t(theta), 0.5).numpy()
    d_j = np.asarray(hier_jax.ula_denominator_at(jnp.asarray(V),
                                                 jnp.asarray(theta), 0.5))
    np.testing.assert_allclose(d, d_j, rtol=0, atol=16e-5)
    grid = np.broadcast_to(np.linspace(0, 180, 181, dtype=np.float32),
                           (V.shape[0], 181))
    den_grid = np.asarray(cj.music_denominator_subspace(
        jnp.asarray(V), Cpx.from_complex(A)))
    np.testing.assert_allclose(
        hierarchical.ula_denominator_at(_Vt(V), _t(grid), 0.5).numpy(),
        den_grid, rtol=1e-3, atol=2e-3)
    _, Vu, _, _ = _ura_scene()
    az = rng.uniform(-90, 90, (Vu.shape[0], 2, 9, 9)).astype(np.float32)
    el = rng.uniform(0, 90, (Vu.shape[0], 2, 9, 9)).astype(np.float32)
    d = hierarchical.ura_denominator_at(_Vt(Vu), _t(az), _t(el), (8, 8),
                                        0.5).numpy()
    d_j = np.asarray(hier_jax.ura_denominator_at(
        jnp.asarray(Vu), jnp.asarray(az), jnp.asarray(el), (8, 8), 0.5))
    np.testing.assert_allclose(d, d_j, rtol=0, atol=64e-5)


def test_refines_match_reference():
    """refine_peaks_ula and refine_peaks_ura from the same coarse angles
    within 1e-3° of the reference's."""
    _, V, _ = _ula_scene()
    coarse = np.tile(np.float32([61.0, 109.0]), (V.shape[0], 1))
    r = hierarchical.refine_peaks_ula(_Vt(V), _t(coarse), 0.5).numpy()
    r_j = np.asarray(hier_jax.refine_peaks_ula(jnp.asarray(V),
                                               jnp.asarray(coarse), 0.5))
    np.testing.assert_allclose(r, r_j, atol=1e-3)
    np.testing.assert_allclose(np.sort(r, -1),
                               np.tile([61.43, 108.91], (V.shape[0], 1)),
                               atol=0.05)
    _, Vu, _, _ = _ura_scene()
    az_c = np.tile(np.float32([-28.0, 40.0]), (Vu.shape[0], 1))
    el_c = np.tile(np.float32([20.0, 55.0]), (Vu.shape[0], 1))
    az, el = (t.numpy() for t in hierarchical.refine_peaks_ura(
        _Vt(Vu), _t(az_c), _t(el_c), (8, 8), 0.5))
    az_j, el_j = (np.asarray(t) for t in hier_jax.refine_peaks_ura(
        jnp.asarray(Vu), jnp.asarray(az_c), jnp.asarray(el_c), (8, 8), 0.5))
    np.testing.assert_allclose(az, az_j, atol=1e-3)
    np.testing.assert_allclose(el, el_j, atol=1e-3)


@pytest.mark.parametrize("compute_dtype", ["float32", "int8"])
def test_music_hierarchical_matches_reference(compute_dtype):
    """music_hierarchical_ula (dense coarse scan at compute_dtype, the
    reference's) and music_hierarchical_ura: equal coarse peak values
    within 1e-4, refined angles within 1e-3°."""
    _, V, A = _ula_scene()
    jdt = jnp.dtype(compute_dtype)
    v, a = hierarchical.music_hierarchical_ula(
        _Vt(V), _emb(A), 2, 0.5, compute_dtype=compute_dtype)
    v_j, a_j = hier_jax.music_hierarchical_ula(
        jnp.asarray(V), Cpx.from_complex(A), 2, 0.5, compute_dtype=jdt)
    np.testing.assert_allclose(v.numpy(), np.asarray(v_j), atol=1e-4)
    np.testing.assert_allclose(a.numpy(), np.asarray(a_j), atol=1e-3)
    _, Vu, Au, g2 = _ura_scene()
    v, az, el = hierarchical.music_hierarchical_ura(
        _Vt(Vu), _emb(Au), 2, (8, 8), 0.5, g2, compute_dtype=compute_dtype)
    v_j, az_j, el_j = hier_jax.music_hierarchical_ura(
        jnp.asarray(Vu), Cpx.from_complex(Au), 2, (8, 8), 0.5, g2,
        compute_dtype=jdt)
    np.testing.assert_allclose(v.numpy(), np.asarray(v_j), atol=1e-4)
    np.testing.assert_allclose(az.numpy(), np.asarray(az_j), atol=1e-3)
    np.testing.assert_allclose(el.numpy(), np.asarray(el_j), atol=1e-3)


def test_capon_pieces_and_hierarchical_match_reference():
    """capon_cholesky (the loaded factor) within 1e-5 of the largest entry
    of _capon_chol's, capon_den_at within 1e-4 relative of _capon_den_at,
    and capon_hierarchical_ula / _ura within 1e-3° of the reference's."""
    R, _, A = _ula_scene()
    Rr, Ri = _t(R.real), _t(R.imag)
    Rc = Cpx.from_complex(R)
    L = hierarchical.capon_cholesky(Rr, Ri, 1e-4)
    L_j = np.asarray(hier_jax._capon_chol(Rc, 1e-4))
    np.testing.assert_allclose(L.numpy(), L_j, rtol=0,
                               atol=1e-5 * np.abs(L_j).max())
    theta = np.tile(np.linspace(55, 65, 33, dtype=np.float32),
                    (R.shape[0], 2, 1))
    at = hierarchical.ula_steering_rows(_t(theta), 16, 0.5)
    at_j = hier_jax._ula_steering_rows(jnp.asarray(theta), 16, 0.5)
    np.testing.assert_allclose(at.numpy(), np.asarray(at_j), atol=1e-5)
    d = hierarchical.capon_den_at(L, at).numpy()
    d_j = np.asarray(hier_jax._capon_den_at(jnp.asarray(L_j), at_j))
    np.testing.assert_allclose(d, d_j, rtol=1e-4)
    v, a = hierarchical.capon_hierarchical_ula(Rr, Ri, _emb(A), 2, 0.5)
    v_j, a_j = hier_jax.capon_hierarchical_ula(Rc, Cpx.from_complex(A), 2,
                                               0.5)
    np.testing.assert_allclose(v.numpy(), np.asarray(v_j), atol=1e-4)
    np.testing.assert_allclose(a.numpy(), np.asarray(a_j), atol=1e-3)
    Ru, _, Au, g2 = _ura_scene()
    v, az, el = hierarchical.capon_hierarchical_ura(
        _t(Ru.real), _t(Ru.imag), _emb(Au), 2, (8, 8), 0.5, g2)
    v_j, az_j, el_j = hier_jax.capon_hierarchical_ura(
        Cpx.from_complex(Ru), Cpx.from_complex(Au), 2, (8, 8), 0.5, g2)
    np.testing.assert_allclose(v.numpy(), np.asarray(v_j), atol=1e-4)
    np.testing.assert_allclose(az.numpy(), np.asarray(az_j), atol=1e-3)
    np.testing.assert_allclose(el.numpy(), np.asarray(el_j), atol=1e-3)


def test_fusion_dmin_is_the_references_den_min():
    """Kernel 5's plain version under return_dmin: the same P as without
    it, and dmin f32[F, B] within 1e-6 of the reference's refine
    normaliser max(min_g max(den_f, 0), tiny) (wideband.py:582-585)."""
    rng = np.random.default_rng(4)
    F, B, n2, k2, G = 4, 6, 16, 4, 181
    V = np.linalg.qr(rng.standard_normal((F, B, n2, k2)))[0].astype(
        np.float32)
    A = (rng.standard_normal((F, G, n2 // 2))
         + 1j * rng.standard_normal((F, G, n2 // 2))).astype(np.complex64)
    A /= np.abs(A)
    Vt, At = _t(V).transpose(-1, -2).contiguous(), _emb(A)
    P, dmin = wideband_fused_spectrum(Vt, At, return_dmin=True)
    torch.testing.assert_close(P, wideband_fused_spectrum_plain(Vt, At),
                               rtol=0, atol=0)
    dm_j = np.stack([np.min(np.maximum(np.asarray(
        cj.music_denominator_subspace(jnp.asarray(V[f]),
                                      Cpx.from_complex(A[f]))), 0.0), -1)
        for f in range(F)])
    dm_j = np.maximum(dm_j, np.finfo(np.float32).tiny)
    assert dmin.shape == (F, B)
    np.testing.assert_allclose(dmin.numpy(), dm_j, rtol=0, atol=1e-6 * n2)


# --- the pipelines --------------------------------------------------------

def _assert_angles(out, ref, keys, tol=1e-3):
    """Each estimator's angles within tol (each window's sorted,
    pair-sorted on az/el grids); no spectrum for a hierarchical one."""
    for key in keys:
        a = out.peak_angles[key].numpy()
        a_ref = np.asarray(ref.peak_angles[key])
        assert a.shape == a_ref.shape
        if a.ndim == 3:
            a, a_ref = _pair_sorted(a), _pair_sorted(a_ref)
        else:
            a, a_ref = np.sort(a, -1), np.sort(a_ref, -1)
        np.testing.assert_allclose(a, a_ref, atol=tol)


def _c2_capture(B=8, seed=1):
    """tests/test_hierarchical.py's c2 scene (61.43°, 108.91°, 15 dB)."""
    return synth_ula_iq([SourceSpec(theta_deg=61.43, freq_norm=0.1),
                         SourceSpec(theta_deg=108.91, freq_norm=0.31)],
                        8, 0.5, B * 2048, snr_db=15,
                        seed=seed).astype(np.complex64)


@pytest.mark.parametrize("return_spectra", [True, False])
def test_fused_ula16_matches_reference(return_spectra):
    """ULA-16 on the fused route (K1, warm MGS at 40 windows, K2's coarse
    scan with refine=False even with return_spectra=True, then the
    refine): angles within 1e-3° and coarse peak values within 1e-4 of
    the reference's; no MUSIC spectrum either way."""
    cfg = DoaConfig(
        geometry=ArrayGeometry(kind="ula", num_elements=16,
                               norm_spacing=0.5),
        snapshot_size=256, num_sources=2, estimators=(Estimator.MUSIC,),
        grid=GridSpec1D(num_points=256), num_max_vals=2,
        scan_mode="hierarchical")
    x = synth_ula_iq([SourceSpec(theta_deg=70.3, freq_norm=0.1),
                      SourceSpec(theta_deg=110.7, freq_norm=0.3)],
                     16, 0.5, 40 * 256, snr_db=10,
                     seed=2).astype(np.complex64)
    ref = build_pipeline_tpu(dataclasses.replace(cfg, cov_impl="pallas"),
                             return_spectra=return_spectra)(x)
    pipe = build_pipeline_torch(cfg, device="cpu",
                                return_spectra=return_spectra)
    assert pipe.fast_path
    assert pipe.plan.kernels["scan"] == "music_scan_peaks"
    out = pipe(x)
    assert out.spectra == {} and ref.spectra == {}
    _assert_angles(out, ref, ["music"])
    np.testing.assert_allclose(out.peak_values["music"].numpy(),
                               np.asarray(ref.peak_values["music"]),
                               atol=1e-4)
    assert int(out.escalation_flagged) == int(ref.escalation_flagged)


def test_c2_music_capon_matches_reference():
    """c2 (fused route; Capon on R = unembed(E)) hierarchical, MUSIC +
    Capon: within 1e-3° of the reference's and 0.15° of the scene
    (tests/test_hierarchical.py:106-110)."""
    cfg = dataclasses.replace(PRESETS["c2_ula8_2src"],
                              scan_mode="hierarchical",
                              estimators=(Estimator.MUSIC, Estimator.CAPON))
    x = _c2_capture()
    ref = build_pipeline_tpu(dataclasses.replace(cfg, cov_impl="pallas"))(x)
    out = build_pipeline_torch(cfg, device="cpu")(x)
    assert out.spectra == {}
    _assert_angles(out, ref, ["music", "capon"])
    r = np.sort(out.peak_angles["music"].numpy(), -1)
    assert np.abs(r - [61.43, 108.91]).max() < 0.15, r


def test_c3_planes_route_matches_reference():
    """c3 (the planes route: kernel 8, FB, smoothing to L = 12, cold MGS,
    K2's coarse scan for k = 3) hierarchical."""
    cfg = dataclasses.replace(PRESETS["c3_ula16_calib_smooth"],
                              scan_mode="hierarchical")
    x = synth_ula_iq([SourceSpec(theta_deg=40.0, freq_norm=0.12),
                      SourceSpec(theta_deg=70.0, freq_norm=0.12),
                      SourceSpec(theta_deg=100.0, freq_norm=0.3)],
                     16, 0.5, 9 * 1024, snr_db=10,
                     seed=3).astype(np.complex64)
    ref = build_pipeline_tpu(dataclasses.replace(cfg, cov_impl="pallas"))(x)
    pipe = build_pipeline_torch(cfg, device="cpu")
    assert not pipe.fast_path
    assert pipe.plan.kernels["scan"] == "music_scan_peaks"
    out = pipe(x)
    assert out.spectra == {}
    _assert_angles(out, ref, ["music"])


def test_ura_narrowband_matches_reference():
    """The 8×8 URA of tests/test_hierarchical.py:121-150 at 5 windows,
    MUSIC (K3 + the 2-D peaks with refine=False, then the 9 × 9 refine)
    and Capon (argmin on the micro-grid): within 1e-3° of the reference's
    and 0.5° of the scene."""
    cfg = DoaConfig(
        geometry=ArrayGeometry(kind="ura", num_elements=64,
                               norm_spacing=0.5, shape=(8, 8)),
        snapshot_size=1024, num_sources=2,
        estimators=(Estimator.MUSIC, Estimator.CAPON),
        grid2d=GridSpec2D(**URA_G2), num_max_vals=2,
        scan_mode="hierarchical")
    x = synth_ura_iq([SourceSpec(az_deg=a, el_deg=e, freq_norm=f)
                      for (a, e), f in zip(URA_TRUTH, (0.1, 0.3))],
                     (8, 8), 0.5, 5 * 1024, snr_db=15,
                     seed=0).astype(np.complex64)
    ref = build_pipeline_tpu(dataclasses.replace(cfg, cov_impl="pallas"))(x)
    pipe = build_pipeline_torch(cfg, device="cpu")
    assert pipe.plan.kernels["scan"] == "music_scan"
    out = pipe(x)
    assert out.spectra == {}
    _assert_angles(out, ref, ["music", "capon"])
    ang = _pair_sorted(out.peak_angles["music"].numpy())
    assert np.abs(ang - np.array(URA_TRUTH)).max() < 0.5


def test_eigh_keeps_music_dense_and_capon_hierarchical():
    """subspace_method="eigh" under scan_mode="hierarchical": MUSIC stays a
    dense scan of the noise projector (its spectrum returned), Capon takes
    the coarse → refine branch (no spectrum), as the reference."""
    cfg = dataclasses.replace(PRESETS["c2_ula8_2src"],
                              scan_mode="hierarchical",
                              subspace_method="eigh",
                              estimators=(Estimator.MUSIC, Estimator.CAPON))
    x = _c2_capture(B=6)
    ref = build_pipeline_tpu(dataclasses.replace(cfg, cov_impl="pallas"))(x)
    pipe = build_pipeline_torch(cfg, device="cpu")
    assert "scan" not in pipe.plan and "subspace" not in pipe.plan
    out = pipe(x)
    assert sorted(out.spectra) == sorted(ref.spectra) == ["music"]
    _assert_angles(out, ref, ["music", "capon"])
    np.testing.assert_allclose(out.spectra["music"].numpy(),
                               np.asarray(ref.spectra["music"]),
                               rtol=5e-2, atol=1e-3)


def _wb_ula_cfg(scan_mode="hierarchical"):
    """tests/test_hierarchical.py:174-200's wideband ULA config."""
    return DoaConfig(
        geometry=ArrayGeometry("ula", 16, 0.5), snapshot_size=1024,
        num_sources=2, estimators=(Estimator.MUSIC,),
        grid=GridSpec1D(num_points=256),
        wideband=WidebandSpec(num_subbands=8, fractional_bw=0.1),
        num_max_vals=2, scan_mode=scan_mode)


def test_wideband_ula_matches_reference():
    """The wideband ULA case (F = 8, 33 windows: warm subband subspaces)
    on the incoherent route: kernel 5's coarse spectrum and dmin, the
    17-point fused-metric refine with its parabola; within 5e-3° of the
    reference's, within 0.5° of the scene, no worse than the dense scan
    + 0.05° (tests/test_hierarchical.py:196-200), no spectrum."""
    cfg = _wb_ula_cfg()
    x = synth_wideband_ula_iq(
        [SourceSpec(theta_deg=58.7, freq_norm=0.0, bandwidth_norm=0.6),
         SourceSpec(theta_deg=121.4, freq_norm=0.0, bandwidth_norm=0.6)],
        16, 0.5, 33 * 1024, snr_db=15, seed=3,
        fractional_bw=0.1).astype(np.complex64)
    ref = build_pipeline_tpu(dataclasses.replace(cfg, cov_impl="pallas"))(x)
    out = build_pipeline_torch(cfg, device="cpu")(x)
    dense = build_pipeline_torch(_wb_ula_cfg("dense"), device="cpu")(x)
    assert out.spectra == {} and "music" in dense.spectra
    assert out.escalation_flagged is None
    _assert_angles(out, ref, ["music"], tol=5e-3)
    truth = np.array([58.7, 121.4])
    a_h = np.sort(out.peak_angles["music"].numpy(), -1).mean(0)
    a_d = np.sort(dense.peak_angles["music"].numpy(), -1).mean(0)
    np.testing.assert_allclose(a_h, truth, atol=0.5)
    assert np.abs(a_h - truth).max() <= np.abs(a_d - truth).max() + 0.05


def _wb_ura_cfg(fusion="incoherent"):
    """tests/test_wideband_fast.py's 4×4 URA at F = 16, hierarchical."""
    return DoaConfig(
        geometry=ArrayGeometry(kind="ura", num_elements=16, shape=(4, 4),
                               norm_spacing=0.5),
        snapshot_size=16 * 128, num_sources=2, num_max_vals=2,
        estimators=(Estimator.MUSIC,), grid2d=GridSpec2D(num_az=61,
                                                         num_el=31),
        wideband=WidebandSpec(num_subbands=16, fractional_bw=0.1,
                              fusion=fusion),
        scan_mode="hierarchical")


def _wb_ura_capture(B=5):
    return synth_wideband_ura_iq(
        [SourceSpec(az_deg=-20.0, el_deg=30.0, freq_norm=0.0,
                    bandwidth_norm=0.5),
         SourceSpec(az_deg=35.0, el_deg=60.0, freq_norm=0.0,
                    bandwidth_norm=0.5)],
        (4, 4), 0.5, 16 * 128 * B, fractional_bw=0.1, snr_db=15,
        seed=3).astype(np.complex64)


@pytest.mark.parametrize("fusion", ["incoherent", "cssm", "cssm_auto"])
def test_wideband_ura_matches_reference(fusion):
    """A small wideband URA (4×4, F = 16, 5 windows): the incoherent route
    (kernel 5, the 2-D peaks with refine=False, the 17 × 17 fused-metric
    argmax) and the coherent routes on R_coh (cold K4, K3, the 2-D peaks,
    the 9 × 9 refine); pair-sorted az/el within 5e-3°, no spectrum."""
    cfg = _wb_ura_cfg(fusion)
    x = _wb_ura_capture()
    ref = build_pipeline_tpu(dataclasses.replace(cfg, cov_impl="pallas"))(x)
    out = build_pipeline_torch(cfg, device="cpu")(x)
    assert out.peak_angles["music"].shape == (5, 2, 2)
    assert out.spectra == {} and ref.spectra == {}
    _assert_angles(out, ref, ["music"], tol=5e-3)


def test_fused_metric_matches_reference_and_chunks_agree():
    """The refine metric of the wideband scan at data-dependent angles
    (ULA: θ f32[B, k, W]) within 1e-5 of the reference's formula on the
    same subspaces and dmin, and the same (within 1e-6) for any window
    chunk."""
    cfg = _wb_ula_cfg()
    rng = np.random.default_rng(7)
    F, B, n2 = 8, 5, 32
    V = np.linalg.qr(rng.standard_normal((F, B, n2, 4)))[0].astype(
        np.float32)
    dmin = rng.uniform(0.01, 0.1, (F, B)).astype(np.float32)
    theta = rng.uniform(20, 160, (B, 2, 17)).astype(np.float32)
    Vt = _t(V).transpose(-1, -2).contiguous()
    m = wideband.fused_metric(Vt, _t(dmin), _t(theta), cfg).numpy()
    spac = wideband_jax.subband_spacings(cfg)
    tiny = np.finfo(np.float32).tiny
    m_j = np.mean([dmin[f][:, None, None] / np.maximum(np.asarray(
        hier_jax.ula_denominator_at(jnp.asarray(V[f]), jnp.asarray(theta),
                                    jnp.float32(spac[f]))), tiny)
        for f in range(F)], axis=0)
    np.testing.assert_allclose(m, m_j, rtol=1e-5)
    m2 = wideband.fused_metric(Vt, _t(dmin), _t(theta), cfg,
                               refine_chunk=2).numpy()
    np.testing.assert_allclose(m2, m, rtol=1e-6)


def test_scan_capture_under_hierarchical():
    """call.scan_capture of a hierarchical fused config (ULA-8, S = 256,
    overlap 64, 3 blocks): per block the refined peaks, within 1e-3° of
    the reference's scan_capture and equal to the per-block call with its
    carry; no spectrum."""
    from doa_tpu.ops.pallas.cov_embedded import interleave_factor
    S, OV = 256, 64
    cfg = DoaConfig(
        geometry=ArrayGeometry(kind="ula", num_elements=8, norm_spacing=0.5),
        snapshot_size=S, overlap=OV, num_sources=2,
        estimators=(Estimator.MUSIC,), grid=GridSpec1D(num_points=181),
        num_max_vals=2, scan_mode="hierarchical")
    M, T_blk = 3, 5 * (S - OV)
    x = synth_ula_iq([SourceSpec(theta_deg=70.0, freq_norm=0.12),
                      SourceSpec(theta_deg=120.0, freq_norm=0.3)],
                     8, 0.5, M * T_blk, snr_db=15, seed=9)
    blocks = np.ascontiguousarray(x.astype(np.complex64)).view(
        np.float32).reshape(M, T_blk, 16)
    tp = interleave_factor(8)
    ref = build_pipeline_tpu(dataclasses.replace(cfg, cov_impl="pallas"))
    out_ref = ref.scan_capture(blocks.reshape(M, T_blk // tp, 16 * tp))
    pipe = build_pipeline_torch(cfg, device="cpu")
    out = pipe.scan_capture(blocks)
    assert set(out) == set(out_ref) == {"peak_values", "peak_angles"}
    a = out["peak_angles"]["music"].numpy()
    np.testing.assert_allclose(np.sort(a, -1), np.sort(np.asarray(
        out_ref["peak_angles"]["music"]), -1), atol=1e-3)
    C = (S - OV) * -(-OV // (S - OV))
    for m in range(1, M):
        r = pipe.interleaved(np.concatenate([blocks[m - 1][-C:], blocks[m]]))
        assert r.spectra == {}
        np.testing.assert_array_equal(a[m], r.peak_angles["music"].numpy())
