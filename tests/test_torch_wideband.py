"""Port parity for the wideband slice (c5's path): doa_tpu_torch's front
end, per-subband subspaces, fused subband scan, 2-D peaks and the whole
wideband pipeline on the CPU (the kernels' plain versions) against
doa_tpu with its Pallas kernels in interpret mode, on the same numpy
inputs.

Pallas interpret mode traces one kernel body per grid step's block
shape: the front end runs with one chunk per block (chunks_per_block=1,
or an odd chunk count in the pipeline, which the reference reduces to
one chunk per block), which keeps each test to a few seconds."""

import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from doa_tpu.configs import (ArrayGeometry, DoaConfig, Estimator, GridSpec2D,
                             PRESETS, WidebandSpec)
from doa_tpu.cpx import Cpx
from doa_tpu.io.synthetic import SourceSpec, synth_wideband_ura_iq
from doa_tpu.ops import peaks as peaks_jax
from doa_tpu.ops import wideband as wideband_jax
from doa_tpu.ops.pallas.cov_embedded import interleave_factor
from doa_tpu.ops.pallas.peaks2d import find_local_max_2d_pallas
from doa_tpu.ops.pallas import wideband_cov as wideband_cov_jax
from doa_tpu.ops.pallas.wideband_cov import wideband_cov_embedded_pallas
from doa_tpu.ops.pallas.wideband_scan import wideband_fused_spectrum_pallas
from doa_tpu.pipeline_tpu import build_pipeline_tpu
from doa_tpu_torch.ops import peaks, wideband
from doa_tpu_torch.ops.cuda import (cov_embedded, peaks2d, wideband_cov,
                                    wideband_scan)
from doa_tpu_torch.pipeline_torch import build_pipeline_torch, load_state

AZ_RNG, EL_RNG = (-90.0, 90.0), (0.0, 90.0)


def _correction(N, seed=0):
    rng = np.random.default_rng(seed)
    return ((1.0 + 0.1 * rng.standard_normal(N))
            * np.exp(1j * rng.uniform(-0.3, 0.3, N))).astype(np.complex64)


def _ura_cfg(F=8, overlap=0):
    """A 4×4 URA (N = 16), S = 32 subband samples, a 31×16 az/el grid."""
    return DoaConfig(
        geometry=ArrayGeometry(kind="ura", num_elements=16, shape=(4, 4),
                               norm_spacing=0.5),
        snapshot_size=F * 32, overlap=overlap, num_sources=2,
        num_max_vals=2, estimators=(Estimator.MUSIC,),
        grid2d=GridSpec2D(num_az=31, num_el=16),
        wideband=WidebandSpec(num_subbands=F, fractional_bw=0.1))


def _ura_capture(T, seed=3):
    return synth_wideband_ura_iq(
        [SourceSpec(az_deg=-20.0, el_deg=30.0, freq_norm=0.0,
                    bandwidth_norm=0.5),
         SourceSpec(az_deg=35.0, el_deg=60.0, freq_norm=0.0,
                    bandwidth_norm=0.5)],
        (4, 4), 0.5, T, fractional_bw=0.1, snr_db=15,
        seed=seed).astype(np.complex64)


def _pair_sorted(a):
    """(B, k, 2) az/el → each window's peaks ordered by az."""
    a = np.asarray(a)
    return np.take_along_axis(a, np.argsort(a[..., 0], -1)[..., None], 1)


@pytest.mark.parametrize("F", [8, 16])
@pytest.mark.parametrize("overlap", [0, 64])
def test_front_end_matches_reference(F, overlap):
    """E_sub of the plain front end against the reference's "fft" kernel,
    correction folded, to 2e-5·max|E| (tests/test_wideband_fast.py)."""
    N, S, T = 8, 256, 4096
    rng = np.random.default_rng(F + overlap)
    x = (rng.standard_normal((T, N))
         + 1j * rng.standard_normal((T, N))).astype(np.complex64)
    c = _correction(N, seed=F)
    tp = interleave_factor(N)
    xil = np.ascontiguousarray(x).view(np.float32)
    E_ref = np.asarray(wideband_cov_embedded_pallas(
        jnp.asarray(xil.reshape(T // tp, 2 * N * tp)), None,
        jnp.asarray(c.real), jnp.asarray(c.imag), N=N, F=F,
        snapshot_size=S, overlap=overlap, variant="fft",
        chunks_per_block=1, interpret=True))
    E = wideband_cov.wideband_cov_embedded(
        torch.from_numpy(xil), torch.from_numpy(c.real.copy()),
        torch.from_numpy(c.imag.copy()), N=N, F=F, snapshot_size=S,
        overlap=overlap).numpy()
    assert E.shape == E_ref.shape
    np.testing.assert_allclose(E, E_ref, atol=2e-5 * np.abs(E_ref).max())


def test_front_end_exact_on_integer_frames():
    """F = 4 (twiddles ±1, ±j exactly), integer samples and an integer
    correction: every sum is an exact integer, so the float32 plain
    version equals its float64 form bit for bit."""
    F, N, g = 4, 8, 16
    rng = np.random.default_rng(5)
    xf = torch.from_numpy(rng.integers(-4, 5, (3 * g, F * 2 * N))
                          .astype(np.float32))
    cr = torch.from_numpy(rng.integers(-1, 3, N).astype(np.float32))
    ci = torch.from_numpy(rng.integers(-1, 2, N).astype(np.float32))
    kw = dict(F=F, N=N, g=g, scale=1.0 / 16)
    E32 = wideband_cov.subband_chunk_grams(xf, cr, ci, **kw)
    E64 = wideband_cov.subband_chunk_grams_plain(xf.double(), cr, ci, **kw)
    assert E32.shape == (F, 3, 2 * N, 2 * N)
    torch.testing.assert_close(E32, E64, rtol=0, atol=0)
    np.testing.assert_array_equal(wideband_cov.dft_twiddles(4),
                                  [[1, 0], [0, -1], [-1, 0], [0, 1]])


def test_front_end_rules():
    x = torch.zeros((4096, 16))
    one, zero = torch.ones(8), torch.zeros(8)
    # a non-power-of-two F takes the "embedded" variant ("auto"); the fft
    # variant refuses it, as the reference's
    assert wideband_cov.resolve_variant(12, "auto") == "embedded"
    assert wideband_cov.resolve_variant(16, "auto") == "fft"
    with pytest.raises(ValueError, match="power-of-two"):
        wideband_cov.wideband_cov_embedded(x, one, zero, N=8, F=12,
                                           snapshot_size=240, variant="fft")
    with pytest.raises(ValueError, match="variant"):
        wideband_cov.wideband_cov_embedded(x, one, zero, N=8, F=8,
                                           snapshot_size=256, variant="dft")
    with pytest.raises(ValueError, match="divisible"):
        wideband_cov.wideband_cov_embedded(x, one, zero, N=8, F=8,
                                           snapshot_size=100)
    with pytest.raises(ValueError, match="shorter"):
        wideband_cov.wideband_cov_embedded(x[:200], one, zero, N=8, F=8,
                                           snapshot_size=256)


def _stream(F, N, g, n, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n * g, F * 2 * N)).astype(np.float32),
            _correction(N, seed).real.copy(), _correction(N, seed).imag.copy())


@pytest.mark.parametrize("F", [6, 8])
def test_subband_embedded_matches_reference(F):
    """Kernel 7's plain version against subband_embedded_pallas (interpret
    mode, one chunk a block) on a channelized stream, correction and scale
    folded: within 2e-5·max|E| (the reference's bf16 hi/lo Gram keeps ~16
    mantissa bits of each input)."""
    N, g, n = 8, 16, 5
    y, cr, ci = _stream(F, N, g, n, seed=F)
    E_ref = np.asarray(wideband_cov_jax.subband_embedded_pallas(
        jnp.asarray(y), jnp.asarray(cr), jnp.asarray(ci), F=F, N=N, g=g,
        scale=1.0 / g, chunks_per_block=1, interpret=True))
    E = wideband_cov.subband_embedded(
        torch.from_numpy(y), torch.from_numpy(cr), torch.from_numpy(ci), F=F,
        N=N, g=g, scale=1.0 / g).numpy()
    assert E.shape == E_ref.shape == (F, n, 2 * N, 2 * N)
    np.testing.assert_allclose(E, E_ref, rtol=0,
                               atol=2e-5 * np.abs(E_ref).max())


@pytest.mark.parametrize("sb_group", [1, 2])
def test_subband_grams_matches_reference(sb_group):
    """Kernel 10's plain version against subband_grams_pallas (interpret
    mode) at both sb_group settings, within 2e-5·max|U|; the port accepts
    sb_group and its output does not depend on it."""
    F, N, g, n = 6, 8, 16, 5
    y, _, _ = _stream(F, N, g, n, seed=7)
    U_ref = np.asarray(wideband_cov_jax.subband_grams_pallas(
        jnp.asarray(y), F=F, N=N, g=g, sb_group=sb_group,
        chunks_per_block=1, interpret=True))
    U = wideband_cov.subband_grams(torch.from_numpy(y), F=F, N=N, g=g,
                                   sb_group=sb_group)
    np.testing.assert_allclose(U.numpy(), U_ref, rtol=0,
                               atol=2e-5 * np.abs(U_ref).max())
    torch.testing.assert_close(U, wideband_cov.subband_grams(
        torch.from_numpy(y), F=F, N=N, g=g), rtol=0, atol=0)
    with pytest.raises(ValueError, match="sb_group"):
        wideband_cov.subband_grams(torch.from_numpy(y), F=F, N=N, g=g,
                                   sb_group=0)


@pytest.mark.parametrize("F,N", [(6, 4), (12, 8), (16, 64)])
def test_channelizer_matrix_bit_equal(F, N):
    np.testing.assert_array_equal(wideband_cov.channelizer_matrix(F, N),
                                  wideband_cov_jax.channelizer_matrix(F, N))


@pytest.mark.parametrize("variant", ["embedded", "uhat"])
@pytest.mark.parametrize("F,S,overlap", [(6, 384, 0), (12, 384, 48)])
def test_front_end_variants_match_xla_reference(variant, F, S, overlap):
    """The dense-channelizer variants at non-power-of-two F against the
    reference's split-complex XLA route (subband_covariances on the
    corrected stream), as tests/test_wideband_fast.py: R within
    2e-5·max|R|."""
    N, T = 8, 4096
    rng = np.random.default_rng(F + overlap)
    x = (rng.standard_normal((T, N))
         + 1j * rng.standard_normal((T, N))).astype(np.complex64)
    c = _correction(N, seed=F)
    cfg = DoaConfig(geometry=ArrayGeometry(kind="ula", num_elements=N),
                    snapshot_size=S, overlap=overlap,
                    wideband=WidebandSpec(num_subbands=F, fractional_bw=0.1))
    xc = x * c[None, :]
    W = wideband_jax.dft_matrix(F)
    R_ref = wideband_jax.subband_covariances(
        Cpx(jnp.asarray(xc.real), jnp.asarray(xc.imag)),
        Cpx(jnp.asarray(W.real), jnp.asarray(W.imag)), cfg)
    E = wideband_cov.wideband_cov_embedded(
        torch.from_numpy(np.ascontiguousarray(x).view(np.float32)),
        torch.from_numpy(c.real.copy()), torch.from_numpy(c.imag.copy()),
        N=N, F=F, snapshot_size=S, overlap=overlap, variant=variant).numpy()
    Rr, Ri = np.asarray(R_ref.re), np.asarray(R_ref.im)
    assert E.shape == Rr.shape[:2] + (2 * N, 2 * N)
    tol = 2e-5 * np.abs(Rr).max()
    np.testing.assert_allclose(E[..., :N, :N], Rr, rtol=0, atol=tol)
    np.testing.assert_allclose(E[..., N:, :N], Ri, rtol=0, atol=tol)


@pytest.mark.parametrize("F,N,S,overlap", [(6, 32, 192, 0),
                                           (12, 16, 384, 96)])
def test_embedded_front_end_matches_reference(F, N, S, overlap):
    """The "embedded" variant ("auto" at F not a power of two) on the CPU
    against the reference's own (dense channelizer + its kernel 7 in
    interpret mode, one chunk a block), correction folded: within
    2e-5·max|E|. On the CPU the stage is the reference's composition,
    channelize_frames then subband_embedded_plain, bit for bit, with the
    channelizer matrix given or taken from channelizer_on. (The
    reference's channelizer needs its row packing, TPACK, to divide F.)"""
    T = 4096
    rng = np.random.default_rng(F + overlap)
    x = (rng.standard_normal((T, N))
         + 1j * rng.standard_normal((T, N))).astype(np.complex64)
    c = _correction(N, seed=F)
    tp = interleave_factor(N)
    xil = np.ascontiguousarray(x).view(np.float32)
    E_ref = np.asarray(wideband_cov_embedded_pallas(
        jnp.asarray(xil.reshape(T // tp, 2 * N * tp)),
        jnp.asarray(wideband_cov_jax.channelizer_matrix(F, N)),
        jnp.asarray(c.real), jnp.asarray(c.imag), N=N, F=F,
        snapshot_size=S, overlap=overlap, variant="embedded",
        chunks_per_block=1, interpret=True))
    cr, ci = torch.from_numpy(c.real.copy()), torch.from_numpy(c.imag.copy())
    kw = dict(N=N, F=F, snapshot_size=S, overlap=overlap)
    E = wideband_cov.wideband_cov_embedded(torch.from_numpy(xil), cr, ci,
                                           **kw)
    assert E.shape == E_ref.shape
    np.testing.assert_allclose(E.numpy(), E_ref,
                               atol=2e-5 * np.abs(E_ref).max())
    # the composition, spelled out
    S_sub, hop_sub, g = wideband_cov.subband_framing(F, S, overlap)
    M = T // F
    n = M // g
    xf = torch.from_numpy(xil)[:n * g * F].reshape(n * g, F * 2 * N)
    K = torch.from_numpy(wideband_cov.channelizer_matrix(F, N))
    Y = wideband_cov.channelize_frames(xf, K)
    Ec = wideband_cov.subband_embedded_plain(Y, cr, ci, F=F, N=N, g=g,
                                             scale=1.0 / S_sub)
    Ec = cov_embedded.window_sums(Ec, (M - S_sub) // hop_sub + 1,
                                  S_sub // g, hop_sub // g)
    torch.testing.assert_close(E, Ec, rtol=0, atol=0)
    for kwk in (dict(K=K), dict(variant="embedded")):
        torch.testing.assert_close(wideband_cov.wideband_cov_embedded(
            torch.from_numpy(xil), cr, ci, **kw, **kwk), E, rtol=0, atol=0)


def test_subband_kernels_exact_on_integer_stream():
    """Integer stream and correction, a power-of-two scale: every sum is
    an exact integer, so the float32 plain versions of kernels 7 and 10
    equal their float64 forms bit for bit (the card's exact check)."""
    F, N, g = 10, 16, 24
    rng = np.random.default_rng(9)
    y = torch.from_numpy(rng.integers(-4, 5, (7 * g, F * 2 * N))
                         .astype(np.float32))
    cr = torch.from_numpy(rng.integers(-1, 3, N).astype(np.float32))
    ci = torch.from_numpy(rng.integers(-1, 2, N).astype(np.float32))
    kw = dict(F=F, N=N, g=g)
    E32 = wideband_cov.subband_embedded(y, cr, ci, scale=1.0 / 16, **kw)
    E64 = wideband_cov.subband_embedded_plain(y.double(), cr, ci,
                                              scale=1.0 / 16, **kw)
    torch.testing.assert_close(E32, E64, rtol=0, atol=0)
    U32 = wideband_cov.subband_grams(y, **kw)
    U64 = wideband_cov.subband_grams_plain(y.double(), **kw)
    torch.testing.assert_close(U32, U64, rtol=0, atol=0)
    assert U32.shape == E32.shape == (F, 7, 2 * N, 2 * N)


@pytest.mark.parametrize("F,B,n2,k2,G", [(4, 10, 16, 4, 157),
                                         (8, 33, 32, 2, 496)])
def test_fusion_matches_reference(F, B, n2, k2, G):
    """The plain fused spectrum against the reference's two-pass kernel
    on orthonormal subspaces (tests/test_wideband_scan_pallas.py)."""
    rng = np.random.default_rng(F)
    V = np.linalg.qr(rng.standard_normal((F, B, n2, k2)))[0].astype(
        np.float32)
    At = rng.standard_normal((F, G, n2)).astype(np.float32)
    ref = np.asarray(wideband_fused_spectrum_pallas(
        jnp.asarray(V), jnp.asarray(At), block_b=8, interpret=True))
    Vt = torch.from_numpy(np.ascontiguousarray(np.swapaxes(V, -1, -2)))
    P = wideband_scan.wideband_fused_spectrum(Vt, torch.from_numpy(At))
    np.testing.assert_allclose(P.numpy(), ref, rtol=2e-4, atol=2e-4)
    # the per-subband max normalisation makes each subband's best bin 1
    assert float(P.max()) <= 1.0 + 1e-6


def _edge_spectra():
    """Six windows: a monotone ramp (no interior peak), one sharp peak,
    two exact ties, a peak on the border row, a plateau, corner peaks
    (tests/test_peaks2d_pallas.py) — plus a row of equal values."""
    B, Ga, Ge = 7, 21, 17
    P = np.full((B, Ga, Ge), 0.5, np.float32)
    P[0] = np.linspace(0, 1, Ga * Ge).reshape(Ga, Ge)
    P[1, 10, 8] = 5.0
    P[2, 5, 5] = 3.0
    P[2, 15, 11] = 3.0
    P[3, 0, 7] = 9.0
    P[3, 12, 4] = 2.0
    P[4, 8, 6] = 2.0
    P[4, 8, 7] = 2.0
    P[5, 1, 1] = 4.0
    P[5, Ga - 2, Ge - 2] = 3.5
    return P


def _music_spectra():
    """MUSIC-shaped spectra (reciprocal of a smooth denominator)."""
    rng = np.random.default_rng(3)
    B, Ga, Ge = 6, 37, 19
    az = np.linspace(-90, 90, Ga)[None, :, None]
    el = np.linspace(0, 90, Ge)[None, None, :]
    c_az = rng.uniform(-60, 60, (B, 1, 1))
    c_el = rng.uniform(20, 70, (B, 1, 1))
    den = ((az - c_az) / 30) ** 2 + ((el - c_el) / 20) ** 2 + 1e-3
    P = (1.0 / den + 0.01 * rng.random((B, Ga, Ge))).astype(np.float32)
    return P / P.max(axis=(1, 2), keepdims=True)


@pytest.mark.parametrize("refine", [False, True])
@pytest.mark.parametrize("k", [1, 2, 4])
def test_peaks2d_bit_equal(k, refine):
    """find_local_max_2d (and the kernel wrapper on the CPU) equals the
    reference's XLA rule bit for bit — ties, plateaus, border peaks,
    no-peak rows and padding included — and the reference's Pallas
    kernel wherever that kernel equals the XLA rule. (The Pallas kernel
    itself rounds the last step, lo + frac·step, of a few refined angles
    1 ulp away from the XLA rule; its own tests hold it to 1e-5°.)"""
    for P in (_edge_spectra(), _music_spectra()):
        ref_k = find_local_max_2d_pallas(jnp.asarray(P), k, AZ_RNG, EL_RNG,
                                         refine=refine, interpret=True)
        ref_x = peaks_jax.find_local_max_2d(jnp.asarray(P), k, AZ_RNG,
                                            EL_RNG, refine=refine)
        got = peaks.find_local_max_2d(torch.from_numpy(P), k, AZ_RNG,
                                      EL_RNG, refine=refine)
        wrap = peaks2d.peaks2d(torch.from_numpy(P), k, AZ_RNG, EL_RNG,
                               refine=refine)
        for r_k, r_x, a, w in zip(ref_k, ref_x, got, wrap):
            r_k, r_x, a = np.asarray(r_k), np.asarray(r_x), a.numpy()
            np.testing.assert_array_equal(a, r_x)
            np.testing.assert_array_equal(a == r_k, r_x == r_k)
            np.testing.assert_allclose(a, r_k, rtol=0, atol=1e-5)
            np.testing.assert_array_equal(w.numpy(), a)


def test_peaks2d_rules():
    with pytest.raises(ValueError, match="k ≤ 4"):
        peaks2d.peaks2d(torch.ones((1, 5, 5)), 5, AZ_RNG, EL_RNG)
    with pytest.raises(ValueError, match="2 x 2"):
        peaks2d.peaks2d(torch.ones((1, 1, 5)), 1, AZ_RNG, EL_RNG)


@pytest.mark.parametrize("B", [8, 33])
def test_subband_subspaces_match_reference(B):
    """Cold (B < 32) and warm (B ≥ 32: per-subband capture-mean init,
    escalation armed) subspaces against the reference's on the same
    E_sub: projectors within 1e-5."""
    cfg = _ura_cfg(F=8)
    x = _ura_capture(B * cfg.snapshot_size)
    xil = torch.from_numpy(np.ascontiguousarray(x).view(np.float32))
    E_sub = wideband_cov.wideband_cov_embedded(
        xil, torch.ones(16), torch.zeros(16), N=16, F=8,
        snapshot_size=cfg.snapshot_size)
    assert E_sub.shape == (8, B, 32, 32)
    V_ref = np.asarray(wideband_jax.subband_subspaces_from_E(
        jnp.asarray(E_sub.numpy()), cfg))                  # (F, B, 2N, 2K)
    Vt = wideband.subband_subspaces_from_E(E_sub, cfg).numpy()
    assert Vt.shape == (8, B, 4, 32)
    proj = np.einsum("fbki,fbkj->fbij", Vt, Vt)
    proj_ref = np.einsum("fbik,fbjk->fbij", V_ref, V_ref)
    np.testing.assert_allclose(proj, proj_ref, atol=1e-5)


def test_steering_stack_and_spacings():
    cfg = _ura_cfg(F=16)
    from doa_tpu_torch.pipeline import _steering_fn
    from doa_tpu.pipeline import _steering_fn as _steering_fn_jax
    np.testing.assert_array_equal(
        wideband.wideband_steering_stack(cfg, _steering_fn(cfg)),
        wideband_jax.wideband_steering_stack(cfg, _steering_fn_jax(cfg)))
    np.testing.assert_array_equal(wideband.subband_spacings(cfg),
                                  wideband_jax.subband_spacings(cfg))
    np.testing.assert_array_equal(wideband.subband_center_freqs(16),
                                  wideband_jax.subband_center_freqs(16))


@pytest.mark.parametrize("F,overlap,T", [(8, 0, 7 * 256), (16, 0, 33 * 512),
                                         (8, 64, 37 * 64)])
def test_wideband_slice_matches_reference(F, overlap, T):
    """The whole wideband path on the CPU against build_pipeline_tpu with
    the Pallas front end, fusion and 2-D peaks kernels (interpret mode):
    pair-sorted az/el within 5e-3°, fused spectra within 2e-4. Cold
    (7, 12 windows) and warm (33 windows) subspaces; a correction."""
    cfg = _ura_cfg(F=F, overlap=overlap)
    x = _ura_capture(T)
    c = _correction(16, seed=F)
    ref = build_pipeline_tpu(dataclasses.replace(
        cfg, cov_impl="pallas", wb_fusion_impl="pallas"))(x, c)
    pipe = build_pipeline_torch(cfg, device="cpu")
    out = pipe(x, c)
    a = out.peak_angles["music"].numpy()
    a_ref = np.asarray(ref.peak_angles["music"])
    assert a.shape == a_ref.shape and a.shape[1:] == (2, 2)
    np.testing.assert_allclose(_pair_sorted(a), _pair_sorted(a_ref),
                               atol=5e-3)
    np.testing.assert_allclose(out.spectra["music"].numpy(),
                               np.asarray(ref.spectra["music"]),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(out.peak_values["music"].numpy(),
                               np.asarray(ref.peak_values["music"]),
                               rtol=2e-4, atol=2e-4)
    assert out.escalation_flagged is None and out.escalation_overflow is None
    # the interleaved entry takes the same bytes
    a2 = pipe.interleaved(x.view(np.float32), c).peak_angles["music"]
    np.testing.assert_array_equal(a2.numpy(), a)


def test_wideband_spectra_returned_regardless():
    cfg = _ura_cfg(F=8)
    x = _ura_capture(7 * cfg.snapshot_size)
    out = build_pipeline_torch(cfg, device="cpu", return_spectra=False)(x)
    assert out.spectra["music"].shape == (7, 31 * 16)


def test_load_state_takes_reference_subband_planes():
    """The port's per-subband steering equals doa_tpu's wb_ilv_args bit
    for bit, and a pipeline on load_state(..., subband_planes=those)
    gives the same angles as on its own state."""
    cfg = _ura_cfg(F=8)
    pipe_j = build_pipeline_tpu(dataclasses.replace(cfg, cov_impl="pallas"))
    assert pipe_j.wb_fast
    Xr, Xi = (np.asarray(p) for p in pipe_j.wb_ilv_args[1:])
    A_re, A_im = (np.asarray(p) for p in pipe_j.steering_planes)
    own = build_pipeline_torch(cfg, device="cpu")
    np.testing.assert_array_equal(own.subband_planes[0].numpy(), Xr)
    np.testing.assert_array_equal(own.subband_planes[1].numpy(), Xi)
    c = _correction(16, seed=4)
    state = load_state(A_re, A_im, c, device="cpu", subband_planes=(Xr, Xi))
    pipe = build_pipeline_torch(cfg, device="cpu", state=state)
    x = _ura_capture(7 * cfg.snapshot_size, seed=6)
    np.testing.assert_array_equal(pipe(x).peak_angles["music"].numpy(),
                                  own(x, c).peak_angles["music"].numpy())
    with pytest.raises(ValueError, match="subband"):
        load_state(A_re, A_im, device="cpu", subband_planes=(Xr[:, :5],
                                                             Xi[:, :5]))
    with pytest.raises(ValueError, match="subband"):
        build_pipeline_torch(dataclasses.replace(
            cfg, wideband=WidebandSpec(num_subbands=4, fractional_bw=0.1)),
            device="cpu", state=state)


def test_c5_preset_builds():
    cfg = PRESETS["c5_ura64_wideband"]
    pipe = build_pipeline_torch(cfg, device="cpu")
    assert pipe.subband_planes[0].shape == (16, 181 * 91, 64)
    assert pipe.steering_planes[0].shape == (181 * 91, 64)
