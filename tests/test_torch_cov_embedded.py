"""Port parity: doa_tpu_torch's interleaved-ingest covariance (the plain
path of the K1 chunk-Gram kernel) against doa_tpu's Pallas kernel in
interpret mode, on the same numpy capture."""

import math

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import golden
from doa_tpu.io.native import quantize_interleaved_int8 as quantize_jax
from doa_tpu.ops.pallas import cov_embedded as ce_jax
from doa_tpu_torch import _build
from doa_tpu_torch.io.native import quantize_interleaved_int8
from doa_tpu_torch.ops.cuda import cov_embedded as ce

S = 256


def _capture(N, T=16 * S, seed=3):
    return golden.synthetic_ula_iq([60.0, 110.0], N, 0.5, T, snr_db=10,
                                   seed=seed).astype(np.complex64)


def _correction(N, seed=0):
    rng = np.random.default_rng(seed)
    c = ((1.0 + 0.1 * rng.standard_normal(N))
         * np.exp(1j * rng.uniform(-0.3, 0.3, N))).astype(np.complex64)
    return c.real.astype(np.float32), c.imag.astype(np.float32)


def _jax_E(xil, cr, ci, N, overlap, fb, dtype=jnp.float32):
    tp = ce_jax.interleave_factor(N)
    x = jnp.asarray(np.asarray(xil).reshape(-1, 2 * N * tp))
    return np.asarray(ce_jax.cov_embedded_pallas(
        x, jnp.asarray(cr), jnp.asarray(ci), N=N, snapshot_size=S,
        overlap=overlap, fb=fb, compute_dtype=dtype, interpret=True))


def _torch_E(xil, cr, ci, N, overlap, fb, dtype="float32"):
    return ce.cov_embedded(
        torch.as_tensor(xil), torch.from_numpy(cr), torch.from_numpy(ci),
        N=N, snapshot_size=S, overlap=overlap, fb=fb,
        compute_dtype=dtype).numpy()


@pytest.mark.parametrize("N,overlap,fb", [
    (16, 0, False), (16, 0, True), (16, 128, False), (16, 100, False),
    (16, 192, True), (8, 0, True), (8, 128, False), (8, 192, True)])
def test_cov_embedded_matches_pallas(N, overlap, fb):
    """f32 E(R) windows with a random correction, every overlap framing
    (gcd chunks + strided prefix sums): rtol 1e-4, atol 1e-5·max|E| (the
    tolerance of tests/test_fused_path.py's kernel-vs-golden check; the
    JAX kernel's f32 Gram is a bf16 hi/lo split, ~16 mantissa bits)."""
    xil = _capture(N).view(np.float32)                  # (T, 2N)
    cr, ci = _correction(N)
    E_ref = _jax_E(xil, cr, ci, N, overlap, fb)
    E = _torch_E(xil, cr, ci, N, overlap, fb)
    assert E.shape == E_ref.shape
    np.testing.assert_allclose(E, E_ref, rtol=1e-4,
                               atol=1e-5 * np.abs(E_ref).max())


def test_cov_embedded_bf16_matches_pallas():
    """bf16 ingest: both round the samples to bf16 and accumulate in f32;
    only the summation order differs (rtol 1e-3, atol 1e-4·max|E|)."""
    N = 16
    xil = _capture(N).view(np.float32)
    cr, ci = _correction(N, seed=1)
    E_ref = _jax_E(xil, cr, ci, N, 128, True, dtype=jnp.bfloat16)
    E = _torch_E(xil, cr, ci, N, 128, True, dtype="bfloat16")
    np.testing.assert_allclose(E, E_ref, rtol=1e-3,
                               atol=1e-4 * np.abs(E_ref).max())


def test_quantize_interleaved_int8_bit_equal():
    xil = _capture(16).view(np.float32)
    q_ref, s_ref = quantize_jax(jnp.asarray(xil))
    q, s = quantize_interleaved_int8(torch.from_numpy(xil))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(q_ref))
    assert float(s) == float(s_ref)


@pytest.mark.parametrize("overlap", [0, 128])
def test_cov_embedded_int8(overlap):
    """int8 ingest: the Gram is exact, so E equals scale² times the f32 E
    of the dequantized samples (rtol 1e-5), and matches the JAX int8
    kernel (rtol 1e-6: exact Grams, one f32 windowing/embedding pass)."""
    N = 16
    xil = _capture(N).view(np.float32)
    cr, ci = _correction(N, seed=2)
    q, s = quantize_interleaved_int8(torch.from_numpy(xil))
    E_q = _torch_E(q.numpy(), cr, ci, N, overlap, False, dtype="int8")
    xdq = (q.to(torch.float32) / s).numpy()
    E_f = _torch_E(xdq, cr, ci, N, overlap, False)
    s2 = float(s) ** 2
    np.testing.assert_allclose(E_q, s2 * E_f, rtol=1e-5,
                               atol=1e-5 * np.abs(E_q).max())
    E_ref = _jax_E(q.numpy(), cr, ci, N, overlap, False, dtype=jnp.int8)
    np.testing.assert_allclose(E_q, E_ref, rtol=1e-6,
                               atol=1e-6 * np.abs(E_ref).max())
    with pytest.raises(ValueError, match="int8"):
        _torch_E(xil, cr, ci, N, overlap, False, dtype="int8")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
def test_chunk_grams_plain_matches_numpy(dtype):
    """K1's plain version: Û_c = Σ_t u_t u_tᵀ per chunk of g rows, against
    a float64 numpy Gram of the same (dtype-rounded) samples."""
    rng = np.random.default_rng(5)
    g, n, n2 = 64, 6, 16
    x = torch.from_numpy(
        (rng.standard_normal((n * g + 7, n2)) * 20).astype(np.float32))
    xd = x.to(dtype)
    U = ce.chunk_grams_uhat(xd, g)
    assert U.shape == (n, n2, n2) and U.dtype == torch.float32
    xs = xd.to(torch.float64).numpy()[:n * g].reshape(n, g, n2)
    U_ref = np.einsum("ntc,ntd->ncd", xs, xs)
    if dtype == torch.int8:
        np.testing.assert_array_equal(U.numpy(), U_ref.astype(np.float32))
    else:
        np.testing.assert_allclose(U.numpy(), U_ref, rtol=1e-5,
                                   atol=1e-5 * np.abs(U_ref).max())


def test_chunk_grams_rejects_other_devices_and_dtypes():
    with pytest.raises(ValueError, match="device"):
        ce.chunk_grams_uhat(torch.empty((256, 32), device="meta"), 64)
    with pytest.raises(ValueError, match="float32"):
        ce.chunk_grams_uhat(torch.zeros((256, 32), dtype=torch.float64), 64)


def test_embedding_transform_matches_permutation_form():
    """uhat_windows_to_embedded's index form equals the reference's
    permutation-matmul form E = (P U Pᵀ + M U Mᵀ)/S, M = Jp P, followed
    by the correction and FB — and the permutation is doa_tpu's."""
    N = 8
    n2 = 2 * N
    P = ce._perm_interleaved_to_planar(N)
    np.testing.assert_array_equal(P, ce_jax._perm_interleaved_to_planar(N))
    rng = np.random.default_rng(9)
    Z = rng.standard_normal((5, 40, n2)).astype(np.float32)
    U = np.einsum("btc,btd->bcd", Z, Z)
    cr, ci = _correction(N, seed=4)
    W = ce.correction_pattern(torch.from_numpy(cr), torch.from_numpy(ci))
    Jp = np.zeros((n2, n2), np.float32)
    Jp[:N, N:] = -np.eye(N)
    Jp[N:, :N] = np.eye(N)
    M = Jp @ P
    E0 = (P @ U @ P.T + M @ U @ M.T) / 40.0
    rr, ri = E0[:, :N, :N], E0[:, N:, :N]
    Wre, Wim = W[0].numpy(), W[1].numpy()
    rr, ri = rr * Wre - ri * Wim, rr * Wim + ri * Wre
    rr = 0.5 * (rr + rr[:, ::-1, ::-1])
    ri = 0.5 * (ri - ri[:, ::-1, ::-1])
    E_ref = np.concatenate([np.concatenate([rr, -ri], -1),
                            np.concatenate([ri, rr], -1)], -2)
    E = ce.uhat_windows_to_embedded(torch.from_numpy(U), N, 1.0 / 40.0, W,
                                    fb=True).numpy()
    np.testing.assert_allclose(E, E_ref, rtol=1e-5,
                               atol=1e-6 * np.abs(E_ref).max())


def _jax_E_chunk(xil, cr, ci, N, overlap, fb, dtype=jnp.float32):
    tp = ce_jax.interleave_factor(N)
    x = jnp.asarray(np.asarray(xil).reshape(-1, 2 * N * tp))
    return np.asarray(ce_jax.cov_embedded_pallas(
        x, jnp.asarray(cr), jnp.asarray(ci), N=N, snapshot_size=S,
        overlap=overlap, fb=fb, compute_dtype=dtype, variant="chunk",
        interpret=True))


@pytest.mark.parametrize("overlap,fb", [(0, False), (128, True)])
def test_chunk_variant_matches_pallas(overlap, fb):
    """Kernel 9's route (its plain version here): variant="chunk" against
    cov_embedded_pallas(variant="chunk") in interpret mode on
    tests/test_fused_path.py's case (N = 16, T = 8·S + 100, a random
    correction): rtol 1e-4, atol 1e-5·max|E| (the Grams' summation order
    differs); and against the port's stacked variant within rtol 1e-5,
    atol 1e-5 (test_fused_path.py's stacked-vs-chunk tolerance)."""
    N = 16
    xil = _capture(N, T=8 * S + 100).view(np.float32)
    rng = np.random.default_rng(7)
    cr = rng.standard_normal(N).astype(np.float32)
    ci = rng.standard_normal(N).astype(np.float32)
    E_ref = _jax_E_chunk(xil, cr, ci, N, overlap, fb)
    E = ce.cov_embedded(torch.from_numpy(xil), torch.from_numpy(cr),
                        torch.from_numpy(ci), N=N, snapshot_size=S,
                        overlap=overlap, fb=fb, variant="chunk").numpy()
    assert E.shape == E_ref.shape
    np.testing.assert_allclose(E, E_ref, rtol=1e-4,
                               atol=1e-5 * np.abs(E_ref).max())
    E_st = _torch_E(xil, cr, ci, N, overlap, fb)
    np.testing.assert_allclose(E, E_st, rtol=1e-5, atol=1e-5)


def test_chunk_variant_bf16_matches_pallas():
    """bf16 ingest through the chunk route: both round the samples to
    bf16 and accumulate in f32 (rtol 1e-3, atol 1e-4·max|E|, as the
    stacked bf16 case)."""
    N = 16
    xil = _capture(N, T=4 * S).view(np.float32)
    cr, ci = _correction(N, seed=1)
    E_ref = _jax_E_chunk(xil, cr, ci, N, 128, True, dtype=jnp.bfloat16)
    E = ce.cov_embedded(torch.from_numpy(xil), torch.from_numpy(cr),
                        torch.from_numpy(ci), N=N, snapshot_size=S,
                        overlap=128, fb=True, compute_dtype="bfloat16",
                        variant="chunk").numpy()
    np.testing.assert_allclose(E, E_ref, rtol=1e-3,
                               atol=1e-4 * np.abs(E_ref).max())


def test_chunk_embedded_plain_is_k1_then_the_embedding():
    """chunk_embedded_plain = K1's plain Gram, then uhat_windows_to_embedded
    on every chunk, bit for bit; the wrapper takes it for a CPU tensor and
    counts no launch."""
    N, g = 8, 64
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.standard_normal((5 * g + 3, 2 * N)).astype(
        np.float32))
    cr, ci = (torch.from_numpy(p) for p in _correction(N, seed=5))
    W = ce.correction_pattern(cr, ci)
    ref = ce.uhat_windows_to_embedded(ce.chunk_grams_uhat_plain(x, g), N,
                                      1.0 / g, W, True)
    with _build.counting() as n:
        E = ce.chunk_embedded(x, g, N, 1.0 / g, W, True)
    assert not n
    assert E.shape == (5, 2 * N, 2 * N)
    torch.testing.assert_close(E, ref, rtol=0, atol=0)
    torch.testing.assert_close(ce.chunk_embedded_plain(x, g, N, 1.0 / g, W,
                                                       True), ref, rtol=0,
                               atol=0)


def test_chunk_variant_rejects_int8_and_unknown_variants():
    N = 16
    xil = _capture(N).view(np.float32)
    cr, ci = _correction(N)
    q, _ = quantize_interleaved_int8(torch.from_numpy(xil))
    kw = dict(N=N, snapshot_size=S)
    with pytest.raises(ValueError, match="stacked"):
        ce.cov_embedded(q, torch.from_numpy(cr), torch.from_numpy(ci),
                        compute_dtype="int8", variant="chunk", **kw)
    with pytest.raises(ValueError, match="variant"):
        ce.cov_embedded(torch.from_numpy(xil), torch.from_numpy(cr),
                        torch.from_numpy(ci), variant="planar", **kw)
    with pytest.raises(ValueError, match="device"):
        ce.chunk_embedded(torch.empty((256, 32), device="meta"), 64, 16,
                          1.0, (torch.ones(16, 16), torch.zeros(16, 16)),
                          False)


def _views(x, g, n):
    """n chunks of g rows of x[rows, n2] at row 0, at row 1 and at
    element 1 of the flat buffer (the offsets that break a 16-byte bulk
    copy's alignment on the card)."""
    n2 = x.shape[1]
    return [x[:n * g], x[1:1 + n * g],
            x.reshape(-1)[1:1 + n * g * n2].view(n * g, n2)]


def _np_gram(x, g):
    xs = x.to(torch.float64).numpy()
    xs = xs[:xs.shape[0] // g * g].reshape(-1, g, xs.shape[1])
    return np.einsum("ntc,ntd->ncd", xs, xs)


def _np_embedded(U, N, scale, Wre, Wim, fb):
    """uhat_windows_to_embedded in float64 numpy: the planar fold of the
    interleaved Gram, the correction, FB, the block embedding."""
    rr = (U[:, 0::2, 0::2] + U[:, 1::2, 1::2]) * scale
    ri = (U[:, 1::2, 0::2] - U[:, 0::2, 1::2]) * scale
    rr, ri = rr * Wre - ri * Wim, rr * Wim + ri * Wre
    if fb:
        rr = 0.5 * (rr + rr[:, ::-1, ::-1])
        ri = 0.5 * (ri - ri[:, ::-1, ::-1])
    return np.concatenate([np.concatenate([rr, -ri], -1),
                           np.concatenate([ri, rr], -1)], -2)


@pytest.mark.parametrize("n2", [6, 16, 30, 32, 64])
@pytest.mark.parametrize("g", [1, 3, 4, 7])
def test_chunk_grams_plain_against_float64(g, n2):
    """K1's plain version at every register-tile width of the kernel and
    short, odd chunks, on views at a row and an element offset, against a
    float64 numpy Gram of the same (dtype-rounded) samples: int8 equal to
    the float64 sum rounded once to f32, f32 and bf16 within rtol 1e-5,
    atol 1e-5·max|U| (f32 rounding of sums of at most 7 products)."""
    rng = np.random.default_rng(100 * g + n2)
    n = 5
    x = torch.from_numpy(
        (rng.standard_normal((n * g + 1, n2)) * 20).astype(np.float32))
    for dtype in (torch.float32, torch.bfloat16, torch.int8):
        for xv in _views(x.to(dtype), g, n):
            U = ce.chunk_grams_uhat_plain(xv, g)
            assert U.shape == (n, n2, n2) and U.dtype == torch.float32
            U_ref = _np_gram(xv, g)
            if dtype == torch.int8:
                np.testing.assert_array_equal(U.numpy(),
                                              U_ref.astype(np.float32))
            else:
                np.testing.assert_allclose(U.numpy(), U_ref, rtol=1e-5,
                                           atol=1e-5 * np.abs(U_ref).max())


@pytest.mark.parametrize("n2", [6, 16, 30, 32, 64])
@pytest.mark.parametrize("g", [1, 3, 4, 7])
def test_chunk_embedded_plain_against_float64(g, n2):
    """Kernel 9's plain version (f32 and bf16, FB on and off, a random
    correction) on the same chunks and views as K1's case, against the
    float64 Gram folded, corrected and averaged in numpy: rtol 1e-5,
    atol 1e-5·max|E|."""
    N = n2 // 2
    rng = np.random.default_rng(200 * g + n2)
    n = 5
    x = torch.from_numpy(rng.standard_normal((n * g + 1, n2)).astype(
        np.float32))
    cr, ci = (torch.from_numpy(p) for p in _correction(N, seed=g))
    W = ce.correction_pattern(cr, ci)
    Wre, Wim = (w.to(torch.float64).numpy() for w in W)
    for dtype in (torch.float32, torch.bfloat16):
        for xv in _views(x.to(dtype), g, n):
            for fb in (False, True):
                E = ce.chunk_embedded_plain(xv, g, N, 1.0 / g, W, fb)
                assert E.shape == (n, n2, n2) and E.dtype == torch.float32
                E_ref = _np_embedded(_np_gram(xv, g), N, 1.0 / g, Wre, Wim,
                                     fb)
                np.testing.assert_allclose(E.numpy(), E_ref, rtol=1e-5,
                                           atol=1e-5 * np.abs(E_ref).max())


@pytest.mark.parametrize("variant", ["4 x 16 KiB", "no FMAs",
                                     "no chunk-end reduction",
                                     "no whole-chunk stores",
                                     "barrier at every chunk end",
                                     "no fold", "no E stores"])
def test_timing_experiment_patches_the_kernel_source(variant):
    """exp_cov_gram.py times patched copies of csrc/cov_gram.cu with the
    ring mainloop it includes (csrc/gram_ring.cuh) expanded in place: each
    patch finds its anchor lines in that source exactly once and changes
    the copy, never the package's own files."""
    import os
    import exp_cov_gram
    from doa_tpu_torch import _build

    paths = [os.path.join(_build.CSRC, f) for f in ("cov_gram.cu",
                                                    "gram_ring.cuh")]
    files = []
    for path in paths:
        with open(path) as f:
            files.append(f.read())
    src = _build.expanded_source(paths[0])
    patch, whole = exp_cov_gram.VARIANTS[variant]
    out = patch(src)
    assert out != src and whole == (variant in (
        "4 x 16 KiB", "barrier at every chunk end"))
    for path, text in zip(paths, files):
        with open(path) as f:
            assert f.read() == text


class _Spy:
    """A stage kernel that records each call's embed= and windows= and
    runs the plain version."""

    def __init__(self):
        self.calls = []

    def __call__(self, x, g, embed=None, windows=None):
        self.calls.append((embed, windows))
        return ce.chunk_grams_uhat_plain(x, g, embed, windows)


@pytest.mark.parametrize("overlap,dtype,embedded", [
    (0, "float32", True), (0, "bfloat16", True), (128, "float32", False),
    (100, "bfloat16", False), (0, "int8", False), (128, "int8", False)])
def test_stacked_variant_asks_the_stage_for_E_of_its_windows(
        overlap, dtype, embedded):
    """The stacked variant calls its stage once with embed = (N, 1/S, W,
    fb) at every overlap, with windows = (B, n_win, stride) where a window
    spans chunks (overlap > 0), and returns its E as it is. On the card
    the stage takes the epilogue gram_epilogue names: kernel 9's entry
    ("embedded", the third parameter) where a window is one chunk and the
    rows are float32 or bfloat16; kernel 9's window entry ("windows")
    where windows overlap and it takes the shapes (float32 at overlap 128,
    g = 128; bfloat16 at overlap 100, g = 4); else K1, the prefix-sum
    windows and the torch fold ("gram": int8, the route int8 had). E is
    that route's plain version, bit for bit."""
    N = 16
    xil = torch.from_numpy(_capture(N).view(np.float32))
    cr, ci = (torch.from_numpy(p) for p in _correction(N, seed=6))
    x = quantize_interleaved_int8(xil)[0] if dtype == "int8" else xil
    spy = _Spy()
    E = ce.cov_embedded(x, cr, ci, N=N, snapshot_size=S, overlap=overlap,
                        fb=True, compute_dtype=dtype, kernel=spy)
    assert len(spy.calls) == 1
    embed, windows = spy.calls[0]
    W = ce.correction_pattern(cr, ci)
    assert embed[0] == N and embed[1] == 1.0 / S and embed[3] is True
    for w, want in zip(embed[2], W):
        assert torch.equal(w, want)
    hop = S - overlap
    g = math.gcd(S, hop)
    B = (x.shape[0] - S) // hop + 1
    assert windows == (None if overlap == 0 else (B, S // g, hop // g))
    epilogue = ce.gram_epilogue(dtype, 2 * N, S // g, hop // g)
    assert (epilogue == "embedded") == embedded
    assert (epilogue == "windows") == (overlap > 0 and dtype != "int8")
    xd = (x if dtype == "int8" else x.to(ce._DTYPES[dtype])).reshape(-1,
                                                                     2 * N)
    if epilogue == "windows":
        ref = ce.chunk_windows_plain(xd, g, N, 1.0 / S, W, True, windows)
    else:
        U = ce.chunk_grams_uhat_plain(xd, g)
        ref = ce.uhat_windows_to_embedded(
            ce.window_sums(U, B, S // g, hop // g), N, 1.0 / S, W, True)
    assert torch.equal(E.view(torch.int32), ref.view(torch.int32))


def _ordered_sums(E, B, n_win, stride):
    """Each window's E summed chunk by chunk in order, entry by entry:
    window w = ((E[w·stride] + E[w·stride + 1]) + …); the −Ri block the
    negated sum of the Ri block."""
    N = E.shape[-1] // 2
    out = []
    for w in range(B):
        acc = E[w * stride].clone()
        for k in range(1, n_win):
            acc = acc + E[w * stride + k]
        acc[:N, N:] = -acc[N:, :N]
        out.append(acc)
    return torch.stack(out)


@pytest.mark.parametrize("fb", [False, True])
@pytest.mark.parametrize("overlap", [128, 192, 100])
def test_plain_window_route_is_kernel_9s_chunks_summed_in_order(overlap, fb):
    """Kernel 9's window entry's plain version (chunk_windows_plain) is
    chunk_embedded_plain followed by the ordered window sum, bit for bit,
    at n_win 2, 4 and 64 (stride 39, overlap 100), FB off and on, with a
    correction; and the plain stage asked for E with windows takes it, as
    gram_epilogue names the window entry at each of these overlaps (at
    100, g = 4, K1's whole-chunk shape, too)."""
    N = 16
    hop = S - overlap
    g = math.gcd(S, hop)
    n_win, stride = S // g, hop // g
    xil = torch.from_numpy(_capture(N, T=12 * S + 37).view(np.float32))
    B = (xil.shape[0] - S) // hop + 1
    cr, ci = (torch.from_numpy(p) for p in _correction(N, seed=11))
    W = ce.correction_pattern(cr, ci)
    got = ce.chunk_windows_plain(xil, g, N, 1.0 / S, W, fb,
                                 (B, n_win, stride))
    n = (B - 1) * stride + n_win
    want = _ordered_sums(ce.chunk_embedded_plain(xil[:n * g], g, N, 1.0 / S,
                                                 W, fb), B, n_win, stride)
    assert got.shape == (B, 2 * N, 2 * N)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert ce.gram_epilogue(torch.float32, 2 * N, n_win, stride) == "windows"
    stage = ce.chunk_grams_uhat(xil, g, (N, 1.0 / S, W, fb),
                                (B, n_win, stride))
    assert torch.equal(stage.view(torch.int32), got.view(torch.int32))


def test_ordered_window_sums_drift_less_than_prefix_sums():
    """Over 4,095 chunks (S = 128, hop 64: n_win 2) of a capture with a
    strong common tone, each window's E as the ordered sum of its chunks'
    E (the window route) lies closer to a float64 sum than the prefix-sum
    route's (K1's Grams, window_sums, the fold), whose FP32 prefix sums
    grow with the chunk index."""
    N, S2, hop = 8, 128, 64
    g = math.gcd(S2, hop)
    rng = np.random.default_rng(31)
    T = 4096 * g
    t = np.arange(T)
    tone = 30.0 * np.exp(2j * np.pi * (0.01 * t[:, None]
                                       + 0.2 * np.arange(N)[None, :]))
    noise = rng.standard_normal((T, N)) + 1j * rng.standard_normal((T, N))
    x = torch.from_numpy((tone + noise).astype(np.complex64)
                         .view(np.float32).reshape(T, 2 * N))
    cr, ci = (torch.from_numpy(p) for p in _correction(N, seed=12))
    W = ce.correction_pattern(cr, ci)
    B = (T - S2) // hop + 1
    windows = (B, S2 // g, hop // g)
    ordered = ce.chunk_windows_plain(x, g, N, 1.0 / S2, W, False, windows)
    U = ce.chunk_grams_uhat_plain(x, g)
    prefix = ce.uhat_windows_to_embedded(ce.window_sums(U, *windows), N,
                                         1.0 / S2, W, False)
    xd = x.to(torch.float64).reshape(-1, g, 2 * N)
    U64 = torch.bmm(xd.transpose(1, 2), xd)
    E64 = ce.uhat_windows_to_embedded(
        ce.window_sums(U64, *windows), N, 1.0 / S2,
        [w.to(torch.float64) for w in W], False)
    err_ordered = (ordered.double() - E64).abs().max().item()
    err_prefix = (prefix.double() - E64).abs().max().item()
    assert err_ordered < err_prefix, (err_ordered, err_prefix)
    assert err_ordered < 1e-5 * E64.abs().max().item()


def test_plain_stage_with_embed_is_kernel_9s_plain_version():
    """chunk_grams_uhat_plain(x, g, embed=(N, scale, W, fb)) equals
    chunk_embedded_plain bit for bit, and the wrapper on a CPU tensor
    takes it with no launch counted."""
    N, g = 8, 64
    rng = np.random.default_rng(21)
    x = torch.from_numpy(rng.standard_normal((6 * g + 5, 2 * N)).astype(
        np.float32))
    cr, ci = (torch.from_numpy(p) for p in _correction(N, seed=7))
    W = ce.correction_pattern(cr, ci)
    with _build.counting() as n:
        for xd in (x, x.to(torch.bfloat16)):
            for fb in (False, True):
                want = ce.chunk_embedded_plain(xd, g, N, 1.0 / g, W, fb)
                got = ce.chunk_grams_uhat_plain(xd, g,
                                                embed=(N, 1.0 / g, W, fb))
                assert got.shape == (6, 2 * N, 2 * N)
                assert torch.equal(got.view(torch.int32),
                                   want.view(torch.int32))
                assert torch.equal(ce.chunk_grams_uhat(xd, g, (N, 1.0 / g, W,
                                                              fb)), want)
    assert not n
    assert {ce.gram_epilogue(torch.int8), ce.gram_epilogue(torch.float32),
            ce.gram_epilogue(torch.float32, 2 * N, 2, 1)} == {
                "gram", "embedded", "windows"}


def test_halved_samples_on_the_plain_stage_change_E_at_the_ulas_shape():
    """The benchmark's planted fault on the "chunk_gram" stage (each
    chunk's second half zeroed, the result doubled) still changes E where
    the stage returns E (the ULA cell's framing: overlap 0): E is linear
    in the rows, so half the rows doubled is not E."""
    N = 16
    xil = torch.from_numpy(_capture(N, T=8 * S).view(np.float32))
    cr, ci = (torch.from_numpy(p) for p in _correction(N, seed=8))

    def half_samples(x, g, embed=None):
        rows = x[: (x.shape[0] // g) * g].reshape(-1, g, x.shape[1]).clone()
        rows[:, g // 2:] = 0.0
        return ce.chunk_grams_uhat_plain(rows.reshape(-1, x.shape[1]), g,
                                         embed) * 2.0

    kw = dict(N=N, snapshot_size=S, overlap=0, fb=False)
    E = ce.cov_embedded(xil, cr, ci, **kw)
    Eb = ce.cov_embedded(xil, cr, ci, kernel=half_samples, **kw)
    assert E.shape == Eb.shape == (8, 2 * N, 2 * N)
    assert (Eb - E).abs().max() > 1e-2 * E.abs().max()


def test_chunk_grams_rejects_an_embed_of_another_width():
    with pytest.raises(ValueError, match="embed"):
        ce.chunk_grams_uhat(torch.empty((256, 32), device="meta"), 64,
                            (8, 1.0, None, False))
