"""Kernel 9's fold (csrc/cov_gram.cu, EmbeddedEpi::fold) walked lane by
lane in numpy float32: its items (one entry i <= j of R a lane, in lane
pairs (e, Q(e)) with Q(i, j) = (N-1-j, N-1-i)), their reads of the row
classes' partial tiles in the reduction buffer, the sums in K1's order,
the fold, the correction, the FB exchange by shuffle and the stores. On
any reduction buffer the model's E is bit for bit K1's reduction (each
upper-triangle entry summed over the classes in order, mirrored) followed
by uhat_windows_to_embedded, signed zeros included; and the items cover
the upper triangle once. Change the kernel and this model together."""

import os
import re

import numpy as np
import pytest
import torch

from doa_tpu_torch import _build
from doa_tpu_torch.ops.cuda import cov_embedded as ce

f32 = np.float32
WIDTHS = (6, 10, 16, 24, 30, 32, 48, 64)       # both register-tile forms


def _header_constant(name):
    with open(os.path.join(_build.CSRC, "gram_ring.cuh")) as f:
        return int(re.search(rf"constexpr int {name} = (\d+);",
                             f.read()).group(1))


THREADS = _header_constant("THREADS")


def shape(n2):
    """gram_ring's register-tile form of n2: (RT, nt, ntri, groups)."""
    rt = 4 if n2 % 4 == 0 and n2 <= 64 else 2
    nt = n2 // rt
    ntri = nt * (nt + 1) // 2
    return rt, nt, ntri, THREADS // ntri


def slots(N):
    """Slot s → (i, j, self, mine) as fold() decodes it."""
    h = (N + 1) // 2
    out = []
    for slot in range(2 * h * (N - h + 1)):
        k, i = slot >> 1, 0
        while k >= N - 2 * i:
            k -= N - 2 * i
            i += 1
        j = i + k
        self_ = i + j == N - 1
        mine = True
        if slot & 1:
            i, j = N - 1 - j, N - 1 - i
            mine = not self_
        out.append((i, j, self_, mine))
    return out


def k1_reduce(red, n2):
    """K1's chunk-end reduction: U[a][b] (a <= b in the upper-triangle
    tiles) the sum over the classes in order, U[b][a] the same value."""
    rt, nt, ntri, groups = shape(n2)
    U = np.zeros((n2, n2), f32)
    t = 0
    for ib in range(nt):
        for jb in range(ib, nt):
            for e in range(rt * rt):
                ii, jj = divmod(e, rt)
                if ib == jb and ii > jj:
                    continue
                s = red[e, 0, t]
                for q in range(1, groups):
                    s = f32(s + red[e, q, t])
                a, b = ib * rt + ii, jb * rt + jj
                U[a, b] = U[b, a] = s
            t += 1
    return U


def fold_model(red, n2, scale, Wre, Wim, fb):
    """EmbeddedEpi::fold, a warp's 32 lanes at a time."""
    rt, nt, ntri, groups = shape(n2)
    N = n2 // 2
    scale = f32(scale)
    half = f32(0.5)
    E = np.full((n2, n2), np.nan, f32)
    items = slots(N)
    flat = red.reshape(-1)
    width = groups * ntri

    def correct(r, i_, p):
        wr, wi = Wre.reshape(-1)[p], Wim.reshape(-1)[p]
        return (f32(f32(r * wr) - f32(i_ * wi)),
                f32(f32(r * wi) + f32(i_ * wr)))

    for base in range(0, len(items) + 31, 32):
        vals, lanes = [], []
        for lane in range(32):
            s = base + lane
            if s >= len(items):
                vals.append((f32(0),) * 4)
                lanes.append((0, 0, False, False))
                continue
            i, j, self_, mine = items[s]
            lanes.append((i, j, self_, mine))
            if not mine:
                vals.append((f32(0),) * 4)
                continue
            ib, jb = 2 * i // rt, 2 * j // rt
            b = (((2 * i % rt) * rt + 2 * j % rt) * width
                 + ib * nt - ib * (ib - 1) // 2 + (jb - ib))
            w10 = (1 if i == j else rt) * width
            w11 = (rt + 1) * width
            u00, u01, u10, u11 = (flat[b], flat[b + width], flat[b + w10],
                                  flat[b + w11])
            for q in range(1, groups):
                o = b + q * ntri
                u00 = f32(u00 + flat[o])
                u01 = f32(u01 + flat[o + width])
                u10 = f32(u10 + flat[o + w10])
                u11 = f32(u11 + flat[o + w11])
            r0 = f32(f32(u00 + u11) * scale)
            rr, ri = correct(r0, f32(f32(u10 - u01) * scale), i * N + j)
            mr, mi = correct(r0, f32(f32(u01 - u10) * scale), j * N + i)
            vals.append((rr, ri, mr, mi))
        out = list(vals)
        if fb:
            for lane, (i, j, self_, mine) in enumerate(lanes):
                src = lane if self_ else lane ^ 1
                rr, ri, mr, mi = vals[lane]
                qr, qi, qmr, qmi = vals[src]
                out[lane] = (f32(half * f32(rr + qmr)),
                             f32(half * f32(ri - qmi)),
                             f32(half * f32(mr + qr)),
                             f32(half * f32(mi - qi)))
        for (i, j, _, mine), (rr, ri, mr, mi) in zip(lanes, out):
            if not mine:
                continue
            E[i, j], E[i, N + j], E[N + i, j], E[N + i, N + j] = (
                rr, -ri, ri, rr)
            if i != j:
                E[j, i], E[j, N + i], E[N + j, i], E[N + j, N + i] = (
                    mr, -mi, mi, mr)
    return E


def _red(n2, rng, kind):
    rt, nt, ntri, groups = shape(n2)
    if kind == "random":
        return rng.standard_normal((rt * rt, groups, ntri)).astype(f32)
    # small integers: exact sums, many zeros and exact cancellations, so
    # the signs of zeros are put to the test
    return rng.integers(-2, 3, (rt * rt, groups, ntri)).astype(f32)


@pytest.mark.parametrize("kind", ["random", "integer"])
@pytest.mark.parametrize("fb", [False, True])
@pytest.mark.parametrize("n2", WIDTHS)
def test_fold_is_k1_then_the_torch_fold(n2, fb, kind):
    """The model's E equals K1's reduction followed by
    uhat_windows_to_embedded bit for bit (as int32 words: -0 is not +0),
    with a random correction, or a correction of ones and zeros where
    exact zeros meet."""
    N = n2 // 2
    rng = np.random.default_rng(n2 * 10 + fb)
    red = _red(n2, rng, kind)
    if kind == "random":
        c = rng.standard_normal(N) + 1j * rng.standard_normal(N)
    else:
        c = rng.integers(0, 2, N) + 1j * rng.integers(-1, 1, N)
    cr = torch.from_numpy(c.real.astype(f32))
    ci = torch.from_numpy(c.imag.astype(f32))
    W = ce.correction_pattern(cr, ci)
    scale = 1.0 / 1024 if kind == "random" else 0.5
    E = fold_model(red, n2, scale, W[0].numpy(), W[1].numpy(), fb)
    U = torch.from_numpy(k1_reduce(red, n2))[None]
    ref = ce.uhat_windows_to_embedded(U, N, scale, W, fb)[0].numpy()
    assert not np.isnan(E).any()
    np.testing.assert_array_equal(E.view(np.int32), ref.view(np.int32))


@pytest.mark.parametrize("n2", [n for n in range(2, 66, 2)
                                if ce.gram_takes(n)])
def test_fold_items_cover_the_upper_triangle_once(n2):
    """Every entry i <= j of R is one lane's item; a pair's lanes are
    2k and 2k + 1 of one warp and hold e and Q(e); a lane is its own
    partner exactly where Q(e) = e, and then the odd lane idles; every
    block of an item lies in one register tile."""
    N = n2 // 2
    rt = shape(n2)[0]
    items = slots(N)
    seen = [(i, j) for i, j, _, mine in items if mine]
    assert sorted(seen) == [(i, j) for i in range(N) for j in range(i, N)]
    for s in range(0, len(items), 2):
        (i, j, self_, mine), (qi, qj, qself, qmine) = items[s:s + 2]
        assert mine and i <= j and i + j <= N - 1
        assert (qi, qj) == (N - 1 - j, N - 1 - i) and qself == self_
        assert qmine == (not self_) and self_ == (i + j == N - 1)
        assert (s % 32) // 2 == ((s + 1) % 32) // 2
        for a, b in ((i, j), (qi, qj)):
            assert (2 * a) // rt == (2 * a + 1) // rt
            assert (2 * b) // rt == (2 * b + 1) // rt


def test_the_model_reads_the_kernel_source():
    """The constants and lines the model mirrors are in csrc/cov_gram.cu
    and csrc/gram_ring.cuh, and kernel 9's entry takes K1's whole-chunk
    form and the in-place fold exactly where K1 takes whole chunks (the
    header's whole_chunks), so its sums are K1's at every g."""
    with open(os.path.join(_build.CSRC, "cov_gram.cu")) as f:
        src = f.read()
    for line in ("return 2 * h * (N - h + 1);",
                 "const int src = it.self ? lane : lane ^ 1;",
                 "it.w10 = (i == j ? 1 : RT) * width;",
                 "u10 += p[it.w10];",
                 "rr = __fmul_rn(0.5f, __fadd_rn(rr, qmr));",
                 "mi = __fmul_rn(0.5f, __fsub_rn(mi, qi));",
                 "fold_kernel<<<grid, THREADS, 0, s>>>((float*)out, "
                 "(const float*)Wre,"):
        assert src.count(line) == 1, line
    whole = "if (whole_chunks(g, n2, F::RT, n2 * (int)sizeof(T)))"
    assert src.count(whole) == 2                  # K1's entry and kernel 9's
    k9 = src[src.index("int launch_embedded("):]
    assert k9.index(whole) < k9.index("chunk_gram_kernel<T, F::RT, F::VEC, "
                                      "true>") < k9.index("fold_kernel<<<")


def _fold_plain(U, N, scale, W, fb):
    """fold_kernel's arithmetic on U f32[2N, 2N] in numpy float32, an
    entry (i, j) of R and its FB partner at a time."""
    Wre, Wim = (np.asarray(w, f32) for w in W)
    E = np.zeros((2 * N, 2 * N), f32)

    def entry(i, j):
        r0 = (U[2 * i, 2 * j] + U[2 * i + 1, 2 * j + 1]) * f32(scale)
        i0 = (U[2 * i + 1, 2 * j] - U[2 * i, 2 * j + 1]) * f32(scale)
        return (r0 * Wre[i, j] - i0 * Wim[i, j],
                r0 * Wim[i, j] + i0 * Wre[i, j])

    for i in range(N):
        for j in range(N):
            rr, ri = entry(i, j)
            if fb:
                pr, pi = entry(N - 1 - i, N - 1 - j)
                rr, ri = f32(0.5) * (rr + pr), f32(0.5) * (ri - pi)
            E[i, j], E[i, N + j], E[N + i, j], E[N + i, N + j] = (
                rr, -ri, ri, rr)
    return E


@pytest.mark.parametrize("fb", [False, True])
@pytest.mark.parametrize("n2", [6, 30, 64])
def test_the_in_place_fold_is_the_torch_fold(n2, fb):
    """fold_kernel (kernel 9 where K1 takes whole chunks) computes each
    entry as uhat_windows_to_embedded does, bit for bit, signed zeros
    included."""
    N = n2 // 2
    rng = np.random.default_rng(n2 + fb)
    Z = rng.standard_normal((n2, 3 * n2)).astype(f32)
    U = (Z @ Z.T).astype(f32)
    U[rng.random((n2, n2)) < 0.2] = 0.0
    U = np.triu(U) + np.triu(U, 1).T                 # K1's exact mirror
    W = [rng.standard_normal((N, N)).astype(f32) for _ in range(2)]
    want = ce.uhat_windows_to_embedded(
        torch.from_numpy(U)[None], N, 1.0 / 1024,
        [torch.from_numpy(w) for w in W], fb)[0].numpy()
    got = _fold_plain(U, N, 1.0 / 1024, W, fb)
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("n2,g,dtype,want", [
    (32, 1024, torch.float32, "embedded"),
    (32, 1024, torch.bfloat16, "embedded"),
    (32, 1024, torch.int8, "gram"),
    (32, 36, torch.float32, "embedded"),     # K1's whole chunks: 7 x 36 <= 256
    (32, 37, torch.float32, "embedded"),
    (32, 73, torch.bfloat16, "embedded"),    # 7 x 73 <= 512 rows
    (32, 74, torch.bfloat16, "embedded"),
    (64, 128, torch.float32, "embedded"),    # one class, 128 rows a stage
    (64, 1024, torch.float32, "embedded"),
    (6, 64, torch.float32, "embedded"),      # 42 classes x 64 > 1360 rows
    (6, 32, torch.float32, "embedded"),
    (30, 1024, "bfloat16", "embedded")])
def test_gram_epilogue_names_kernel_9_for_float_rows_at_every_g(n2, g, dtype,
                                                                want):
    """gram_epilogue names kernel 9's entry for float32 and bfloat16 rows
    whether K1 takes whole chunks at (n2, g) or shares them (kernel 9's
    entry follows K1 there: test_the_model_reads_the_kernel_source); int8
    keeps K1."""
    assert ce.gram_epilogue(dtype) == want
