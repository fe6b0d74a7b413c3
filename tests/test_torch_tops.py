"""Port parity for TOPS wideband fusion (doa_tpu_torch/ops/tops.py and the
"tops" pipelines) against doa_tpu on the same numpy inputs.

The ops take subband subspaces made in numpy (eigh of the channelized
subband covariances, as tests/test_tops.py) at K = 1, 2 and 3 (K = 3 is
the Jacobi λ_min, which the reference's own tests do not pin), guard on
and off. The pipelines run ULA-8 (F = 8, S = 256, G = 256; the scene of
tests/test_torch_cssm.py) and the 4×4 URA (F = 16, 31×16 az/el grid;
tests/test_tops.py's planar case); the reference takes its Pallas front
end in interpret mode on an odd window count (one chunk a block)."""

import dataclasses

import numpy as np
import pytest
import torch

import golden
from doa_tpu.configs import (ArrayGeometry, DoaConfig, Estimator, GridSpec1D,
                             GridSpec2D, WidebandSpec)
from doa_tpu.cpx import Cpx, embed_hermitian
from doa_tpu.io.synthetic import (SourceSpec, synth_wideband_ula_iq,
                                  synth_wideband_ura_iq)
from doa_tpu.ops import tops as tops_jax
from doa_tpu.ops import wideband as wideband_jax
from doa_tpu.ops.steering import _ula_steering_np, grid_angles_1d
from doa_tpu.pipeline_tpu import build_pipeline_tpu
from doa_tpu_torch.ops import tops
from doa_tpu_torch.pipeline_torch import build_pipeline_torch, kernel_routes

# spectra: within 1e-4 of their maximum (each is max-normalised to 1)
SPEC_TOL = 1e-4
ANGLE_TOL = 5e-3       # degrees, the wideband parity bound (test_torch_cssm)


def _ula_cfg(K=2, fusion="tops", G=256, **wb):
    return DoaConfig(
        geometry=ArrayGeometry(kind="ula", num_elements=8, norm_spacing=0.5),
        snapshot_size=256, num_sources=K, num_max_vals=K,
        estimators=(Estimator.MUSIC,), grid=GridSpec1D(num_points=G),
        wideband=WidebandSpec(num_subbands=8, fractional_bw=0.4,
                              fusion=fusion, **wb))


def _ura_cfg(**wb):
    return DoaConfig(
        geometry=ArrayGeometry(kind="ura", num_elements=16, shape=(4, 4),
                               norm_spacing=0.5),
        snapshot_size=256, num_sources=1, num_max_vals=1,
        estimators=(Estimator.MUSIC,), grid2d=GridSpec2D(num_az=31, num_el=16),
        wideband=WidebandSpec(num_subbands=16, fractional_bw=0.3,
                              fusion="tops", **wb))


_THETAS = {1: (70.0,), 2: (60.0, 120.0), 3: (50.0, 95.0, 130.0)}


def _ula_capture(T, thetas, seed=3, snr_db=10):
    return synth_wideband_ula_iq(
        [SourceSpec(theta_deg=t, freq_norm=0.0, bandwidth_norm=0.5)
         for t in thetas], 8, 0.5, T, fractional_bw=0.4, snr_db=snr_db,
        seed=seed).astype(np.complex64)


def _ura_capture(T):
    return synth_wideband_ura_iq(
        [SourceSpec(theta_deg=0.0, az_deg=40.0, el_deg=30.0, freq_norm=0.0,
                    bandwidth_norm=0.5)],
        (4, 4), 0.5, T, fractional_bw=0.3, snr_db=10,
        seed=5).astype(np.complex64)


def _subbands(cfg, x):
    """numpy channelizer + per-band covariances R_sub (F, B, N, N), the
    steering stack (F, G, N) and the numpy-eigh signal subspaces
    (F, B, N, K), as tests/test_tops.py's _subband_setup."""
    F, N = cfg.wideband.num_subbands, cfg.geometry.num_elements
    W = wideband_jax.dft_matrix(F)
    xs = np.einsum("ft,mtn->fmn", W, x[:x.shape[0] // F * F].reshape(-1, F, N))
    R = np.stack([golden.sample_covariance(
        golden.frame_samples(xs[f], cfg.snapshot_size // F, 0))
        for f in range(F)])
    theta = grid_angles_1d(cfg.grid)
    A = wideband_jax.wideband_steering_stack(
        cfg, lambda d: _ula_steering_np(theta, N, d)).astype(np.complex64)
    _, v = np.linalg.eigh(R)
    S = v[..., N - cfg.num_sources:].astype(np.complex64)
    return R, A, S


def _close(got, want, tol, scale=None):
    want = np.asarray(want)
    scale = np.abs(want).max() if scale is None else scale
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=tol * scale)


# --- the ops ---------------------------------------------------------------

@pytest.mark.parametrize("K", [1, 2, 3])
def test_tops_ops_match_reference(K):
    """Each function against doa_tpu.ops.tops on the same subspaces: the
    leakage row within 1e-5 of its maximum; the CC planes and the guard
    sum (the port's (.., B, G) against the reference's (.., G, B)) within
    1e-4 of their maxima (the guard's per-band normaliser is 1/min den,
    whose rounding scales a whole window); the finalized spectrum guard
    off and on and tops_spectrum_cpx within 1e-4 of the maximum, with the
    same argmax a window."""
    cfg = _ula_cfg(K)
    _, A, S = _subbands(cfg, _ula_capture(4 * 256, _THETAS[K]))
    F = A.shape[0]
    Sj, Aj = Cpx.from_complex(S), Cpx.from_complex(A)
    St, At = torch.from_numpy(S), torch.from_numpy(A)
    v_ref = tops_jax.tops_leakage_row(Aj[0], Sj[0])
    v = tops.tops_leakage_row(At[0], St[0])
    _close(v.numpy(), np.swapaxes(v_ref.to_numpy(), 1, 2), 1e-5)
    w = [0.0] + [1.0] * (F - 1)
    ccr_j, cci_j, mus_j = tops_jax.tops_accumulate_cc(
        Sj, Aj, Aj[0], Sj[0], v_ref, np.asarray(w, np.float32))
    ccr, cci, mus = tops.tops_accumulate_cc(St, At, At[0], St[0], v, w)
    scale = max(np.abs(np.asarray(ccr_j)).max(),
                np.abs(np.asarray(cci_j)).max())
    _close(ccr.numpy(), np.swapaxes(np.asarray(ccr_j), -1, -2), 1e-4, scale)
    _close(cci.numpy(), np.swapaxes(np.asarray(cci_j), -1, -2), 1e-4, scale)
    _close(mus.numpy(), np.asarray(mus_j).T, 1e-4)
    for guard in (False, True):
        P_ref = np.asarray(tops_jax.tops_finalize(
            ccr_j, cci_j, v_ref, F, guard=mus_j if guard else None))
        P = tops.tops_finalize(ccr, cci, v, F,
                               guard=mus if guard else None).numpy()
        _close(P, P_ref, SPEC_TOL, 1.0)
        np.testing.assert_array_equal(P.argmax(-1), P_ref.argmax(-1))
        P_ref = np.asarray(tops_jax.tops_spectrum_cpx(Sj, Aj, guard=guard))
        P = tops.tops_spectrum_cpx(St, At, guard=guard).numpy()
        assert P.shape == P_ref.shape == (4, 256)
        _close(P, P_ref, SPEC_TOL, 1.0)
        np.testing.assert_array_equal(P.argmax(-1), P_ref.argmax(-1))


@pytest.mark.parametrize("K", [1, 2])
@pytest.mark.parametrize("ref_band", [0, 1])
def test_tops_spectrum_within_1e4_of_float64(K, ref_band):
    """tops_spectrum_cpx in complex64 within 1e-4 of the maximum of the
    same algebra in complex128, guard off and on, at two reference bands.
    λ_min cancels at the true DoA, where the peak is, so this is the
    FP32 spectrum's accuracy: at K = 2 on reference band 1 the
    reference's own spectrum is 1.12e-4 of max from the complex128 one
    (guard on; the port's 4.2e-5), so there the port is held to float64
    rather than to the reference."""
    cfg = _ula_cfg(K)
    _, A, S = _subbands(cfg, _ula_capture(4 * 256, _THETAS[K]))
    for guard in (False, True):
        P = tops.tops_spectrum_cpx(torch.from_numpy(S), torch.from_numpy(A),
                                   ref_band=ref_band, guard=guard).numpy()
        P64 = tops.tops_spectrum_cpx(
            torch.from_numpy(S.astype(np.complex128)),
            torch.from_numpy(A.astype(np.complex128)), ref_band=ref_band,
            guard=guard).numpy()
        _close(P, P64, SPEC_TOL, 1.0)
        np.testing.assert_array_equal(P.argmax(-1), P64.argmax(-1))


# reference bands other than 0 against the reference: the two spectra are
# 1.12e-4 (the reference's) and 4.2e-5 (the port's) of max from the
# complex128 spectrum at K = 2 on band 1, so their gap is at most 1.54e-4
REF_BAND_TOL = 2e-4


@pytest.mark.parametrize("K", [1, 2, 3])
@pytest.mark.parametrize("ref_band", [1, 3])
def test_tops_spectrum_ref_band_matches_reference(K, ref_band):
    """tops_spectrum_cpx at a reference band other than 0 (A_ref, S_ref
    and the zero weight taken from that band) against doa_tpu.ops.tops,
    guard off and on: within 2e-4 of the maximum (REF_BAND_TOL), the same
    argmax a window."""
    cfg = _ula_cfg(K)
    _, A, S = _subbands(cfg, _ula_capture(4 * 256, _THETAS[K]))
    Sj, Aj = Cpx.from_complex(S), Cpx.from_complex(A)
    for guard in (False, True):
        P_ref = np.asarray(tops_jax.tops_spectrum_cpx(
            Sj, Aj, ref_band=ref_band, guard=guard))
        P = tops.tops_spectrum_cpx(torch.from_numpy(S), torch.from_numpy(A),
                                   ref_band=ref_band, guard=guard).numpy()
        _close(P, P_ref, REF_BAND_TOL, 1.0)
        np.testing.assert_array_equal(P.argmax(-1), P_ref.argmax(-1))


def test_tops_spectrum_matches_golden():
    """The textbook spectrum (guard off) against golden.tops_spectrum, the
    paper's matrices in float64, with tests/test_tops.py's bound: the
    same argmax a window, rtol 5e-2 and atol 5e-3 (the deep nulls cancel
    by construction)."""
    cfg = _ula_cfg()
    R, A, S = _subbands(cfg, _ula_capture(4 * 256, _THETAS[2]))
    want = golden.tops_spectrum(R, A, 2, ref_band=0)
    got = tops.tops_spectrum_cpx(torch.from_numpy(S), torch.from_numpy(A),
                                 ref_band=0).numpy()
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    np.testing.assert_allclose(got, want, rtol=5e-2, atol=5e-3)


def test_wideband_tops_entries_match_reference():
    """wideband_tops_cpx's stream entry (the capture and the DFT matrix)
    and its E_sub entry against the reference's on one capture, within
    1e-4 of the maximum, and each other."""
    cfg = _ula_cfg()
    x = _ula_capture(5 * 256, _THETAS[2], seed=4)
    _, A, _ = _subbands(cfg, x)
    W = wideband_jax.dft_matrix(8)
    Aj, Wj, xj = (Cpx.from_complex(a) for a in (A, W, x))
    P_ref = np.asarray(tops_jax.wideband_tops_cpx(xj, Aj, Wj, cfg))
    At, Wt, xt = (torch.from_numpy(a) for a in (A, W, x))
    P = tops.wideband_tops_cpx(xt, At, Wt, cfg).numpy()
    _close(P, P_ref, SPEC_TOL, 1.0)
    R = wideband_jax.subband_covariances(xj, Wj, cfg)
    E = torch.from_numpy(np.array(embed_hermitian(R)))
    P_e = tops.wideband_tops_cpx(None, At, None, cfg, E_sub=E).numpy()
    _close(P_e, P_ref, SPEC_TOL, 1.0)


# --- the pipelines -----------------------------------------------------------

def _pair_sorted(a):
    a = np.asarray(a)
    return np.take_along_axis(a, np.argsort(a[..., 0], -1)[..., None], 1)


def _assert_angles(a, a_ref):
    a, a_ref = np.asarray(a), np.asarray(a_ref)
    assert a.shape == a_ref.shape
    if a.ndim == 3:
        a, a_ref = _pair_sorted(a), _pair_sorted(a_ref)
    else:
        a, a_ref = np.sort(a, -1), np.sort(a_ref, -1)
    np.testing.assert_allclose(a, a_ref, rtol=0, atol=ANGLE_TOL)


@pytest.mark.parametrize("kind", ["ula", "ura"])
def test_tops_pipeline_matches_reference(kind):
    """fusion="tops" through build_pipeline_torch on the CPU against
    build_pipeline_tpu (on the ULA with MUSIC, Capon and root-MUSIC
    asked for): the same keys ("tops" alone, no grid-free angles, no
    escalation counts), angles within 5e-3° (pair-sorted on az/el), the
    spectrum within 2e-3 of its maximum (tests/test_torch_cssm.py's
    pipeline bound: the front ends and subspaces differ by rounding
    before λ_min's cancellation at the peaks); scan_capture's blocks
    likewise, and the scene's median within 2° (tests/test_tops.py's
    bound)."""
    if kind == "ula":
        # estimators beyond MUSIC: accepted, and only "tops" comes back
        cfg, B = dataclasses.replace(_ula_cfg(), estimators=(
            Estimator.MUSIC, Estimator.CAPON, Estimator.ROOT_MUSIC)), 15
        x = _ula_capture(B * 256, _THETAS[2], seed=1)
        truth = np.array(_THETAS[2])
    else:
        cfg, B = _ura_cfg(), 15
        x = _ura_capture(B * 256)
        truth = np.array([[40.0, 30.0]])
    ref = build_pipeline_tpu(dataclasses.replace(cfg, cov_impl="pallas"))
    pipe = build_pipeline_torch(cfg, device="cpu")
    r, out = ref(x), pipe(x)
    for field in ("spectra", "peak_values", "peak_angles"):
        assert (list(getattr(out, field)) == list(getattr(r, field))
                == ["tops"])
    assert out.escalation_flagged is None and r.escalation_flagged is None
    assert out.root_music_angles is None and r.root_music_angles is None
    _assert_angles(out.peak_angles["tops"], r.peak_angles["tops"])
    _close(out.spectra["tops"].numpy(), r.spectra["tops"], 2e-3, 1.0)
    a = out.peak_angles["tops"].numpy()
    med = np.median(_pair_sorted(a) if a.ndim == 3 else np.sort(a, -1), 0)
    assert np.abs(med - truth).max() < 2.0, med
    # scan_capture: 3 blocks of 5 windows, overlap 0 (the reference takes
    # its (M, T_blk/TPACK, 2N·TPACK) layout of the same bytes)
    from doa_tpu.ops.pallas.cov_embedded import interleave_factor
    n2 = 2 * cfg.geometry.num_elements
    tp = interleave_factor(n2 // 2)
    blocks = x.view(np.float32).reshape(3, 5 * 256, n2)
    got = pipe.scan_capture(blocks)
    want = ref.scan_capture(blocks.reshape(3, 5 * 256 // tp, n2 * tp))
    assert list(got["peak_angles"]) == list(want["peak_angles"]) == ["tops"]
    for m in range(3):
        _assert_angles(got["peak_angles"]["tops"][m],
                       np.asarray(want["peak_angles"]["tops"])[m])


def test_tops_pipeline_ref_band_matches_reference():
    """wideband.tops_ref_band = 3 through build_pipeline_torch on the CPU
    against build_pipeline_tpu on a ULA: the key "tops" alone, angles
    within 5e-3°, the spectrum within 2e-3 of its maximum (the pipeline
    bound above)."""
    cfg = _ula_cfg(tops_ref_band=3)
    x = _ula_capture(15 * 256, _THETAS[2], seed=2)
    r = build_pipeline_tpu(dataclasses.replace(cfg, cov_impl="pallas"))(x)
    out = build_pipeline_torch(cfg, device="cpu")(x)
    assert list(out.peak_angles) == list(r.peak_angles) == ["tops"]
    _assert_angles(out.peak_angles["tops"], r.peak_angles["tops"])
    _close(out.spectra["tops"].numpy(), r.spectra["tops"], 2e-3, 1.0)


def test_tops_return_spectra_false_drops_the_spectrum():
    """return_spectra=False keeps the peaks and drops TOPS's spectrum."""
    cfg = _ula_cfg()
    x = _ula_capture(5 * 256, _THETAS[2])
    with_p = build_pipeline_torch(cfg, device="cpu")(x)
    out = build_pipeline_torch(cfg, device="cpu", return_spectra=False)(x)
    assert out.spectra == {} and list(out.peak_angles) == ["tops"]
    torch.testing.assert_close(out.peak_angles["tops"],
                               with_p.peak_angles["tops"], rtol=0, atol=0)


def test_tops_plan_names_the_front_end_and_peaks_only():
    """TOPS plans the front end and, on a 2-D grid, kernel 6; no K4
    ("subspace") and no kernel 5 ("fusion"), as the reference launches
    neither there."""
    assert set(kernel_routes(_ula_cfg())) == {"covariance"}
    assert set(kernel_routes(_ura_cfg())) == {"covariance", "peaks"}
    cfg = dataclasses.replace(_ura_cfg(), estimators=(
        Estimator.MUSIC, Estimator.CAPON, Estimator.ESPRIT))
    assert set(kernel_routes(cfg)) == {"covariance", "peaks"}
