"""Port parity for coherent wideband fusion ("cssm", "cssm_auto") and the
non-power-of-two front end: doa_tpu_torch's focusing matrices, runtime
steering, Newton–Schulz polar factor, focused covariance and runtime
focusing, and the whole wideband pipeline on the CPU (the kernels' plain
versions), against doa_tpu on the same numpy inputs.

The reference pipelines run their Pallas front end in interpret mode on
an odd chunk count, which the reference reduces to one chunk per block,
so each trace stays short."""

import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import golden
from doa_tpu.configs import (ArrayGeometry, AvgMethod, DoaConfig, Estimator,
                             GridSpec1D, GridSpec2D, SmoothingSpec,
                             WidebandSpec)
from doa_tpu.cpx import Cpx
from doa_tpu.io.synthetic import (SourceSpec, synth_wideband_ula_iq,
                                  synth_wideband_ura_iq)
from doa_tpu.ops import wideband as wideband_jax
from doa_tpu.pipeline_tpu import build_pipeline_tpu
from doa_tpu_torch.ops import wideband
from doa_tpu_torch.ops.cuda import wideband_cov
from doa_tpu_torch.pipeline_torch import build_pipeline_torch, load_state


def _ula_cfg(N=8, F=8, S=256, fusion="cssm", fbw=0.1, **over):
    return DoaConfig(
        geometry=ArrayGeometry(kind="ula", num_elements=N, norm_spacing=0.5),
        snapshot_size=S, num_sources=2, num_max_vals=2,
        estimators=(Estimator.MUSIC,), grid=GridSpec1D(num_points=256),
        wideband=WidebandSpec(num_subbands=F, fractional_bw=fbw,
                              fusion=fusion), **over)


def _ura_cfg(F=16, fusion="cssm_auto"):
    """tests/test_wideband_fast.py's 4×4 URA scene config."""
    return DoaConfig(
        geometry=ArrayGeometry(kind="ura", num_elements=16, shape=(4, 4),
                               norm_spacing=0.5),
        snapshot_size=16 * 128, num_sources=2, num_max_vals=2,
        estimators=(Estimator.MUSIC,), grid2d=GridSpec2D(num_az=61, num_el=31),
        wideband=WidebandSpec(num_subbands=F, fractional_bw=0.1,
                              fusion=fusion))


def _ula_capture(T, N=8, thetas=(62.0, 111.0), fbw=0.1, snr_db=15, seed=3):
    return synth_wideband_ula_iq(
        [SourceSpec(theta_deg=t, freq_norm=0.0, bandwidth_norm=0.5)
         for t in thetas], N, 0.5, T, fractional_bw=fbw, snr_db=snr_db,
        seed=seed).astype(np.complex64)


def _pair_sorted(a):
    a = np.asarray(a)
    return np.take_along_axis(a, np.argsort(a[..., 0], -1)[..., None], 1)


def _assert_angles(out, ref, keys=("music",)):
    """Peak angles within 5e-3° (the reference's own fast-vs-XLA bound,
    tests/test_wideband_fast.py), each window's sorted (pair-sorted on
    az/el grids); the escalation counts as the reference reports them."""
    for key in keys:
        a = out.peak_angles[key].numpy()
        a_ref = np.asarray(ref.peak_angles[key])
        assert a.shape == a_ref.shape
        if a.ndim == 3:
            a, a_ref = _pair_sorted(a), _pair_sorted(a_ref)
        else:
            a, a_ref = np.sort(a, -1), np.sort(a_ref, -1)
        np.testing.assert_allclose(a, a_ref, atol=5e-3)
    if ref.escalation_flagged is None:
        assert out.escalation_flagged is None
    else:
        assert int(out.escalation_flagged) == int(ref.escalation_flagged)
        assert int(out.escalation_overflow) == int(ref.escalation_overflow)


# --- the pieces -----------------------------------------------------------

@pytest.mark.parametrize("kind", ["ula", "ura"])
def test_focusing_matrices_match_reference(kind):
    cfg = (_ula_cfg(N=16, F=16, S=1024, fbw=0.4) if kind == "ula"
           else _ura_cfg(fusion="cssm"))
    T = wideband.focusing_matrices(cfg)
    T_ref = wideband_jax.focusing_matrices(cfg)
    assert T.dtype == np.complex64 and T.shape == T_ref.shape
    np.testing.assert_allclose(T, T_ref, rtol=0, atol=1e-6)
    dirs = wideband.focusing_directions(cfg)
    for d, d_ref in zip(np.atleast_2d(dirs),
                        np.atleast_2d(wideband_jax.focusing_directions(cfg))):
        np.testing.assert_array_equal(d, d_ref)


def test_polar_unitary_matches_reference_and_svd():
    """The Newton–Schulz polar factor against the reference's on the same
    batch (1e-5) and the numpy SVD polar U Vᴴ (tests/test_cssm.py's
    5e-4), on a well-conditioned batch."""
    rng = np.random.default_rng(3)
    N, F = 16, 6
    M = ((rng.standard_normal((F, N, N)) + 1j * rng.standard_normal((F, N, N)))
         + 3.0 * np.eye(N)).astype(np.complex64)
    T = wideband.polar_unitary(torch.from_numpy(M)).numpy()
    T_ref = wideband_jax.polar_unitary_cpx(Cpx.from_complex(M)).to_numpy()
    np.testing.assert_allclose(T, T_ref, rtol=0, atol=1e-5)
    for f in range(F):
        U, _, Vh = np.linalg.svd(M[f])
        np.testing.assert_allclose(T[f].conj().T @ T[f], np.eye(N), atol=5e-4)
        np.testing.assert_allclose(T[f], U @ Vh, atol=5e-4)


def test_device_steering_matches_reference():
    th = np.array([40.0, 91.5, 133.0], np.float32)
    az = np.array([-20.0, 35.0, 10.0], np.float32)
    el = np.array([30.0, 60.0, 5.0], np.float32)
    sp = np.array([0.5, 0.61], np.float32)
    a = wideband.device_ula_steering(torch.from_numpy(th), 8,
                                     torch.from_numpy(sp)).numpy()
    a_ref = wideband_jax.device_ula_steering_cpx(jnp.asarray(th), 8,
                                                 sp).to_numpy()
    np.testing.assert_allclose(a, a_ref, rtol=0, atol=2e-5)
    for s, d in enumerate(sp):
        np.testing.assert_allclose(a[s], golden.ula_steering(th, 8, d),
                                   atol=2e-5)
    b = wideband.device_ura_steering(torch.from_numpy(az),
                                     torch.from_numpy(el), (4, 4),
                                     torch.from_numpy(sp)).numpy()
    b_ref = wideband_jax.device_ura_steering_cpx(
        jnp.asarray(az), jnp.asarray(el), (4, 4), sp).to_numpy()
    assert b.shape == (2, 3, 16)
    np.testing.assert_allclose(b, b_ref, rtol=0, atol=2e-5)


def test_cssm_covariance_matches_reference():
    """The focused covariance on the same subband covariances (the port's
    front end on a random capture) against the reference's
    cssm_covariance_cpx and a from-scratch numpy CSSM (tests/test_cssm.py
    golden parity), at that test's rtol 2e-4 / atol 2e-5."""
    cfg = _ula_cfg(N=16, F=8, S=256, fbw=0.2)
    rng = np.random.default_rng(0)
    N, F, S = 16, 8, 256
    x = (rng.standard_normal((4 * S, N))
         + 1j * rng.standard_normal((4 * S, N))).astype(np.complex64)
    E = wideband_cov.wideband_cov_embedded(
        torch.from_numpy(x.view(np.float32)), torch.ones(N), torch.zeros(N),
        N=N, F=F, snapshot_size=S)
    R_sub = torch.complex(E[..., :N, :N], E[..., N:, :N])
    T = wideband.focusing_matrices(cfg)
    got = wideband.cssm_covariance(R_sub, torch.from_numpy(T)).numpy()
    ref = wideband_jax.cssm_covariance_cpx(
        None, None, Cpx.from_complex(T), cfg,
        R_sub=Cpx.from_complex(R_sub.numpy())).to_numpy()
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-5)
    W = wideband_jax.dft_matrix(F)
    xs = np.einsum("ft,mtn->fmn", W, x.reshape(-1, F, N))
    want = sum(np.einsum("nm,bmk,pk->bnp", T[f],
                         golden.sample_covariance(
                             golden.frame_samples(xs[f], S // F, 0)),
                         T[f].conj()) for f in range(F)) / F
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("kind", ["ula", "ura"])
def test_runtime_focusing_matches_reference(kind):
    """Runtime focusing on a given coarse spectrum (two smooth peaks): the
    same peaks, directions and weights, then the polar factor. Its
    Newton–Schulz iteration runs on the ε-regularised, ill-conditioned
    Gram of the direction set, which amplifies the f32 rounding of M
    (~3e-7 relative) to ~4e-4 in T (entries ≤ 1), so T is held to 1e-3."""
    if kind == "ula":
        cfg = _ula_cfg(N=16, F=16, S=1024, fbw=0.4)
        th = np.linspace(0.0, 180.0, 180)
        P = sum(1.0 / (1e-2 + ((th - t) / 10.0) ** 2) for t in (70.0, 115.0))
    else:
        cfg = _ura_cfg()
        az = np.linspace(-90.0, 90.0, 61)[:, None]
        el = np.linspace(0.0, 90.0, 31)[None, :]
        P = sum(1.0 / (1e-2 + ((az - a) / 10.0) ** 2 + ((el - e) / 8.0) ** 2)
                for a, e in ((-20.0, 30.0), (35.0, 60.0)))
    P = (P / P.max()).astype(np.float32).reshape(1, -1)
    spac = np.concatenate([[0.5], wideband_jax.subband_spacings(cfg)]).astype(
        np.float32)
    T = wideband.runtime_focusing(torch.from_numpy(P), cfg, spac).numpy()
    T_ref = wideband_jax.runtime_focusing_cpx(jnp.asarray(P), cfg,
                                              spac).to_numpy()
    assert T.shape == T_ref.shape == (16, 16, 16)
    np.testing.assert_allclose(T, T_ref, rtol=0, atol=1e-3)


# --- the pipelines --------------------------------------------------------

@pytest.mark.parametrize("fusion", ["cssm", "cssm_auto"])
def test_cssm_pipeline_ula_matches_reference(fusion):
    """ULA-8, F = 8 (tests/test_wideband_fast.py's scene, 47 windows) with
    a correction: the FFT front end (kernel 4), R_coh, cold K4 + K3 and
    find_local_max, spectra returned."""
    cfg = _ula_cfg(fusion=fusion)
    x = _ula_capture(47 * 256)
    c = np.exp(1j * np.linspace(0, 0.5, 8)).astype(np.complex64)
    ref = build_pipeline_tpu(dataclasses.replace(cfg, cov_impl="pallas"))(x, c)
    out = build_pipeline_torch(cfg, device="cpu")(x, c)
    _assert_angles(out, ref)
    P, P_ref = out.spectra["music"].numpy(), np.asarray(ref.spectra["music"])
    np.testing.assert_allclose(P, P_ref, rtol=2e-3, atol=2e-3)
    med = np.median(np.sort(out.peak_angles["music"].numpy(), -1), axis=0)
    assert abs(med[0] - 62.0) < 2.5 and abs(med[1] - 111.0) < 2.5, med


def test_cssm_auto_pipeline_ura_matches_reference():
    """The 4×4 URA, F = 16, cssm_auto (tests/test_wideband_fast.py:126-152):
    the 2-D coarse pass and runtime URA steering, then the 2-D peaks."""
    cfg = _ura_cfg()
    x = synth_wideband_ura_iq(
        [SourceSpec(az_deg=-20.0, el_deg=30.0, freq_norm=0.0,
                    bandwidth_norm=0.5),
         SourceSpec(az_deg=35.0, el_deg=60.0, freq_norm=0.0,
                    bandwidth_norm=0.5)],
        (4, 4), 0.5, 16 * 128 * 5, fractional_bw=0.1, snr_db=15,
        seed=3).astype(np.complex64)
    ref = build_pipeline_tpu(dataclasses.replace(cfg, cov_impl="pallas"))(x)
    out = build_pipeline_torch(cfg, device="cpu")(x)
    assert out.peak_angles["music"].shape == (5, 2, 2)
    _assert_angles(out, ref)


def test_non_power_of_two_subbands_match_reference():
    """ULA-8 with F = 6, S = 384 (incoherent): the dense channelizer and
    kernel 7's route against the reference (whose own route there is its
    XLA channelizer, TPACK 8 ∤ 6), with a correction."""
    cfg = _ula_cfg(F=6, S=384, fusion="incoherent")
    assert wideband_cov.resolve_variant(6, "auto") == "embedded"
    x = _ula_capture(384 * 11)
    c = np.exp(1j * np.linspace(0, 0.5, 8)).astype(np.complex64)
    ref = build_pipeline_tpu(dataclasses.replace(cfg, cov_impl="pallas"))(x, c)
    out = build_pipeline_torch(cfg, device="cpu")(x, c)
    assert out.peak_angles["music"].shape == (11, 2)
    _assert_angles(out, ref)
    np.testing.assert_allclose(out.spectra["music"].numpy(),
                               np.asarray(ref.spectra["music"]),
                               rtol=2e-4, atol=2e-4)


def test_cssm_fb_smoothing_capon_matches_reference():
    """tests/test_cssm.py's ULA-16 config (F = 16, fractional bandwidth
    0.4) with forward-backward averaging, smoothing to L = 12 and MUSIC +
    Capon, on its 65°/115° 10 dB scene (15 windows), return_covariance:
    angles within 5e-3°, R_coh within 1e-5·max|R|."""
    cfg = _ula_cfg(N=16, F=16, S=1024, fbw=0.4,
                   avg_method=AvgMethod.FORWARD_BACKWARD,
                   smoothing=SmoothingSpec(subarray_size=12))
    cfg = dataclasses.replace(cfg, estimators=(Estimator.MUSIC,
                                               Estimator.CAPON),
                              grid=GridSpec1D())
    x = _ula_capture(15 * 1024, N=16, thetas=(65.0, 115.0), fbw=0.4,
                     snr_db=10, seed=1)
    ref = build_pipeline_tpu(dataclasses.replace(cfg, cov_impl="pallas"),
                             return_covariance=True)(x)
    out = build_pipeline_torch(cfg, device="cpu", return_covariance=True)(x)
    _assert_angles(out, ref, keys=("music", "capon"))
    R_re, R_im = (np.asarray(p) for p in ref.covariance)
    assert out.covariance.shape == (15, 12, 12)
    tol = 1e-5 * np.abs(R_re).max()
    np.testing.assert_allclose(out.covariance.real.numpy(), R_re, rtol=0,
                               atol=tol)
    np.testing.assert_allclose(out.covariance.imag.numpy(), R_im, rtol=0,
                               atol=tol)
    for key in ("music", "capon"):
        med = np.median(np.sort(out.peak_angles[key].numpy(), -1), axis=0)
        assert abs(med[0] - 65.0) < 2.0 and abs(med[1] - 115.0) < 2.0, med


@pytest.mark.parametrize("fusion", ["incoherent", "cssm"])
def test_wideband_planes_input_equals_c64_input(fusion):
    """A (re, im) pair — arrays, or the stride-2 views of the capture —
    takes the same front end as the complex64 capture: equal results."""
    cfg = _ula_cfg(fusion=fusion)
    x = _ula_capture(9 * 256)
    pipe = build_pipeline_torch(cfg, device="cpu")
    want = pipe(x).peak_angles["music"]
    v = torch.from_numpy(x.view(np.float32)).view(x.shape[0], -1, 2)
    for planes in ((np.ascontiguousarray(x.real),
                    np.ascontiguousarray(x.imag)), (v[..., 0], v[..., 1])):
        torch.testing.assert_close(pipe(planes).peak_angles["music"], want,
                                   rtol=0, atol=0)


def test_load_state_takes_reference_focusing():
    """load_state(focusing=) takes doa_tpu's focusing matrices; the
    pipeline on it equals the pipeline on its own."""
    cfg = _ula_cfg()
    T = wideband_jax.focusing_matrices(cfg)
    own = build_pipeline_torch(cfg, device="cpu")
    assert own.subband_planes is None
    A_re, A_im = (p.numpy() for p in own.steering_planes)
    state = load_state(A_re, A_im, device="cpu",
                       focusing=(T.real, T.imag))
    x = _ula_capture(9 * 256, seed=6)
    torch.testing.assert_close(
        build_pipeline_torch(cfg, device="cpu", state=state)(x)
        .peak_angles["music"], own(x).peak_angles["music"], rtol=0, atol=0)
    with pytest.raises(ValueError, match="focusing"):
        load_state(A_re, A_im, device="cpu", focusing=(T.real[:, :4],
                                                       T.imag[:, :4]))
    with pytest.raises(ValueError, match="focusing"):
        build_pipeline_torch(_ula_cfg(F=4), device="cpu", state=state)
