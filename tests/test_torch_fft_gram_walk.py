"""The work partition of the wideband front-end ring kernel
(doa_tpu_torch/csrc/wideband_cov.cu: kernel 4 on the frames, kernel 7 on
the channelized stream, kernel 10's real Grams of the stream) on the CPU.

The kernel runs only on the card. Here its launch plan (`make_plan`,
`Layout`), its persistent walk over (chunk, subband group) units, its
y-buffer (the group's split or direct DFT of the frames, or the group's
column blocks of the stream), its Gram items (`decode`: row class,
upper-triangle tile, subband), its stages and its chunk-end epilogue are
transcribed from the source and run in torch: every unit is walked once
for any grid, every i <= j is one tile entry, every entry of E is written
once; on integer frames (F <= 4: twiddles +-1, +-j) the model gives
`subband_chunk_grams_plain`'s E bit for bit, on integer streams (any F)
`subband_embedded_plain`'s, and at F not a power of two (the split DFT at
G = F / 4 = 3) it is within float32 twiddle rounding of the float64 plain
version. Kernel 10 (kernel 7's y-buffer, items of four sums a complex
entry, J_U a thread, up to MAXT_U threads) writes every entry of U once,
each (i0 <= j0) tile's rows and its mirror's, and gives
`subband_grams_plain`'s U bit for bit on integer streams."""

import math
import os
import re

import numpy as np
import pytest
import torch

from doa_tpu_torch.ops.cuda import wideband_cov as wc

# the constants of csrc/wideband_cov.cu
MAXT, J, STAGES, STAGE_BYTES, Y_BYTES, MAX_P = 192, 3, 2, 32768, 8192, 16
MAXT_U, J_U, BLOCKS_U = 288, 1, 2
BAND = 2
HEAD, MAX_SMEM = 128, 232448
SM_BYTES, BLOCK_RESERVED = 233472, 1024     # an H100 SM's shared memory


def round16(b):
    return (b + 15) & ~15


def tile_form(N):
    """RT of the register tiles (the C entry's dispatch)."""
    if N % 4 == 0 and N <= 64:
        return 4
    if N % 2 == 0 and N <= 32:
        return 2
    assert N <= 16
    return 1


def make_plan(F, N, g, rt, j=J, maxt=MAXT):
    """→ (P, C, threads, items, TS), as make_plan in the source (j items
    a thread and maxt threads at most: J, MAXT for kernels 4 and 7, J_U,
    MAXT_U for kernel 10)."""
    nt = N // rt
    ntri = nt * (nt + 1) // 2
    best = dict(P=0, C=0, threads=0, items=0)
    P = 1
    while P <= F and P <= MAX_P and P * N * 8 <= Y_BYTES:
        if F % P == 0:
            C = 1
            while C <= 32 and C <= g:
                items = P * ntri * C
                if items > j * maxt:
                    break
                threads = (items + 32 * j - 1) // (32 * j) * 32
                lhs, rhs = items * best["threads"], best["items"] * threads
                if (best["P"] == 0 or lhs > rhs or
                        (lhs == rhs and (P > best["P"] or (
                            P == best["P"] and items > best["items"])))):
                    best = dict(P=P, C=C, threads=threads, items=items)
                C *= 2
        P += 1
    rb = F * N * 8
    ts = min(STAGE_BYTES // rb, Y_BYTES // (best["P"] * N * 8))
    return best["P"], best["C"], best["threads"], best["items"], max(ts, 1)


def layout(F, N, P, TS):
    """→ the bytes of shared memory of a launch, as Layout."""
    rb = F * N * 8
    ybuf = HEAD + round16((((P + 3) // 4) * 4 * F + F + 16) * 8)
    ring = ybuf + 2 * round16(P * TS * N * 8)
    return ring + STAGES * (round16(TS * rb) + 16)


def walk(n, G, fit):
    """The grid of the launch (runs of chunks x groups) and each block's
    (group, first chunk, end chunk), as launch() and the kernel's head."""
    runs = max(1, min(fit // G, n))
    grid = runs * G
    out = []
    for b in range(grid):
        q, s = b % G, b // G
        out.append((q, n * s // runs, n * (s + 1) // runs))
    return grid, out


def decode(it, C, nt, ntri):
    """Gram item `it` → (row class, subband, tile row ib, tile column
    jb), as decode in the source."""
    rest = it // C
    rem, s = rest % ntri, rest // ntri
    r0, h = 0, min(BAND, nt)
    while rem >= h * (h + 1) // 2 + h * (nt - r0 - h):
        rem -= h * (h + 1) // 2 + h * (nt - r0 - h)
        r0 += h
        h = min(BAND, nt - r0)
    if rem < h * (h + 1) // 2:
        k = 0
        while rem > k:
            rem -= k + 1
            k += 1
        return it % C, s, r0 + rem, r0 + k
    rem -= h * (h + 1) // 2
    return it % C, s, r0 + rem % h, r0 + h + rem // h


def stage_segments(R0, R1, g, TS):
    """Each stage's (first row, rows) and its chunk segments (stage row,
    rows, chunk offset before, chunk ends), as the kernel's stage loop."""
    nst = -(-(R1 - R0) // TS)
    coff, out = 0, []
    for k in range(nst):
        rows = min(TS, R1 - R0 - k * TS)
        segs, pos = [], 0
        while pos < rows:
            seg = min(rows - pos, g - coff)
            segs.append((pos, seg, coff, coff + seg == g))
            pos += seg
            coff = 0 if coff + seg == g else coff + seg
        out.append((R0 + k * TS, rows, segs))
    return out


def y_buffer(xc, q, G, P, F, tw, stream):
    """The group's y-buffer (P, rows, N) of rows xc (rows, F, N) complex:
    the stream's column blocks q + G s (kernel 7), or the frames' DFT
    (kernel 4) from the float32 twiddles by the kernel's indices, split
    with four subbands a group (z_t1 = sum_t2 W_G^(q t2) x_(t1 + 4 t2),
    y_k = sum_t1 W[q + G k, t1] z_t1), else direct."""
    fs = [q + G * s for s in range(P)]
    if stream:
        return xc[:, fs].permute(1, 0, 2)
    t = torch.arange(F)
    if P == 4 and G > 1:
        twz = tw[q * torch.arange(G) * P % F]                  # (G,)
        z = torch.einsum("u,mtuc->tmc", twz,
                         xc.reshape(-1, G, 4, xc.shape[-1]).transpose(1, 2))
        twy = torch.stack([tw[f * torch.arange(4) % F] for f in fs])
        return torch.einsum("kt,tmc->kmc", twy, z)
    W = torch.stack([tw[f * t % F] for f in fs])               # (P, F)
    return torch.einsum("st,mtc->smc", W, xc)


def kernel_model(xf, cr, ci, F, N, g, scale, fit, stream=False):
    """E f32[F, n, 2N, 2N] by the kernel's plan, walk, stages, y-buffer,
    items and epilogue (sums in float64: exact on exact inputs), and the
    count of writes of every entry of E; xf holds frames, or with
    stream=True the channelized stream."""
    rt = tile_form(N)
    P, C, threads, items, TS = make_plan(F, N, g, rt)
    n = xf.shape[0] // g
    nt = N // rt
    ntri = nt * (nt + 1) // 2
    tw64 = wc.dft_twiddles(F).astype(np.float64)
    tw = torch.complex(torch.from_numpy(tw64[:, 0]),
                       torch.from_numpy(tw64[:, 1]))
    x = xf[:n * g].double().reshape(n * g, F, N, 2)
    xc = torch.complex(x[..., 0], x[..., 1])
    out = np.zeros((F, n, 2 * N, 2 * N), np.float32)
    writes = np.zeros((F, n, 2 * N, 2 * N), np.int64)
    cr32, ci32 = cr.numpy().astype(np.float32), ci.numpy().astype(np.float32)
    _, blocks = walk(n, F // P, fit)
    its = [decode(it, C, nt, ntri) for it in range(items)]
    for q, c0, c1 in blocks:
        if c0 >= c1:
            continue
        G = F // P
        fs = [q + G * s for s in range(P)]      # the group: a residue class
        acc = torch.zeros((C, P, N, N), dtype=torch.complex128)
        cc = c0
        for r, rows, segs in stage_segments(c0 * g, c1 * g, g, TS):
            yb = y_buffer(xc[r:r + rows], q, G, P, F, tw, stream)
            for pos, seg, coff, ends in segs:
                for cls in range(C):
                    first = pos + ((cls - coff) & (C - 1))
                    y = yb[:, first:pos + seg:C]               # (P, rows, N)
                    acc[cls] += torch.einsum("smi,smj->sij", y, y.conj())
                if ends:
                    R = acc.sum(0).numpy()
                    for cls, s, ib, jb in its:
                        if cls == 0:
                            store_tile(out[fs[s], cc], writes[fs[s], cc],
                                       N, ib * rt, jb * rt, rt, R[s], cr32,
                                       ci32, scale)
                    acc.zero_()
                    cc += 1
    return torch.from_numpy(out), writes


def store_tile(oc, wc_, N, i0, j0, rt, R, cr, ci, scale):
    """One tile's entries and (off the diagonal) their mirror, as
    store_tile: numpy float32 scalars, each operation rounded once (R's
    entries are exact, so this is the plain version's rounding of the
    correction and scale); a diagonal tile's lower half from its upper."""
    f32 = np.float32
    scale = f32(scale)
    for u in range(rt):
        for v in range(rt):
            i, j = i0 + u, j0 + v
            if i0 == j0 and u > v:
                continue
            rr = f32(R[i, j].real)
            ri = f32(0.0) if i == j else f32(R[i, j].imag)
            wre = cr[i] * cr[j] + ci[i] * ci[j]
            wim = ci[i] * cr[j] - cr[i] * ci[j]
            er = (rr * wre - ri * wim) * scale
            ei = (rr * wim + ri * wre) * scale
            for a, b, val in ((i, j, er), (i, N + j, -ei), (N + i, j, ei),
                              (N + i, N + j, er)):
                oc[a, b] = val
                wc_[a, b] += 1
            if i != j:
                for a, b, val in ((j, i, er), (j, N + i, ei), (N + j, i, -ei),
                                  (N + j, N + i, er)):
                    oc[a, b] = val
                    wc_[a, b] += 1


@pytest.mark.parametrize("F", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("fit", [1, 7, 132, 264, 1000])
def test_walk_covers_every_unit_once(F, fit):
    for N in (5, 16, 64):
        P = make_plan(F, N, 64, tile_form(N))[0]
        G = F // P
        for n in (1, 3, 67, 2048 + 5):
            grid, blocks = walk(n, G, fit)
            assert grid % G == 0 and grid >= G
            seen = np.zeros((n, G), np.int64)
            for q, c0, c1 in blocks:
                seen[c0:c1, q] += 1
            assert (seen == 1).all(), (N, n, fit)


@pytest.mark.parametrize("N", [1, 3, 5, 6, 8, 12, 16, 18, 30, 32, 36, 64])
def test_tile_map_covers_each_pair_once(N):
    rt = tile_form(N)
    nt = N // rt
    ntri = nt * (nt + 1) // 2
    for F, g in ((1, 1), (4, 64), (16, 64), (16, 3)):
        P, C, threads, items, TS = make_plan(F, N, g, rt)
        cover = np.zeros((C, P, N, N), np.int64)
        for it in range(items):
            cls, s, ib, jb = decode(it, C, nt, ntri)
            assert ib <= jb and s < P
            # a tile's classes in adjacent lanes of one warp
            assert cls == it % C and it // 32 == (it - cls) // 32
            for u in range(rt):
                for v in range(rt):
                    i, j = ib * rt + u, jb * rt + v
                    if i <= j:
                        cover[cls, s, i, j] += 1
        iu = np.triu_indices(N)
        assert (cover[:, :, iu[0], iu[1]] == 1).all()
        assert cover.sum() == C * P * N * (N + 1) // 2
    # tile rows in bands: the tiles of a band's column are neighbours, in
    # order of their rows
    tiles = [decode(ti, 1, nt, ntri)[2:] for ti in range(ntri)]
    for ti, (ib, jb) in enumerate(tiles):
        if ib % BAND and ti:
            assert tiles[ti - 1] == (ib - 1, jb)
        if ib % BAND == 0:
            last = min(ib + BAND - 1, jb, nt - 1)
            assert tiles[ti:ti + last - ib + 1] == [
                (r, jb) for r in range(ib, last + 1)]


@pytest.mark.parametrize("F,N,g", [(16, 64, 64), (16, 16, 64), (4, 64, 1),
                                   (4, 64, 3), (4, 16, 64), (2, 6, 7),
                                   (1, 5, 5), (1, 64, 100), (32, 64, 64)])
def test_plan_fits_the_card(F, N, g):
    rt = tile_form(N)
    P, C, threads, items, TS = make_plan(F, N, g, rt)
    assert F % P == 0 and C & (C - 1) == 0 and 1 <= C <= min(32, g)
    assert threads % 32 == 0 and items <= J * threads <= J * MAXT
    assert threads >= 32 and 32 % C == 0
    assert layout(F, N, P, TS) <= MAX_SMEM
    assert P * TS * N * 8 <= Y_BYTES and (TS * F * N * 8 <= STAGE_BYTES
                                          or TS == 1)


def test_c5_plan():
    """c5: four subbands a group (each chunk leaves L2 4 times, not 16),
    one row class, 192 threads for 544 items, 4 frames a stage, and two
    blocks a SM."""
    assert make_plan(16, 64, 64, 4) == (4, 1, 192, 544, 4)
    assert 2 * (layout(16, 64, 4, 4) + BLOCK_RESERVED) <= SM_BYTES
    # the ULA-16 cssm front end: one group of all 16 subbands, two row
    # classes
    assert make_plan(16, 16, 64, 4)[:3] == (16, 2, 128)


def test_c5_f12_plan():
    """c5_f12 (F = 12, both sources): four subbands a group (G = 3, the
    split DFT on the frames), one row class, 192 threads for 544 items,
    4 rows a stage, two blocks a SM."""
    assert make_plan(12, 64, 64, 4) == (4, 1, 192, 544, 4)
    assert 2 * (layout(12, 64, 4, 4) + BLOCK_RESERVED) <= SM_BYTES


@pytest.mark.parametrize("g,TS", [(1, 4), (3, 4), (4, 4), (7, 4), (64, 4),
                                  (5, 1), (100, 8)])
def test_stage_segments_cover_each_row_once(g, TS):
    for c0, c1 in ((0, 1), (3, 11), (5, 40)):
        rows_seen, chunk_ends = [], 0
        coff_next = 0
        for r, rows, segs in stage_segments(c0 * g, c1 * g, g, TS):
            assert 1 <= rows <= TS
            covered = 0
            for pos, seg, coff, ends in segs:
                assert pos == covered and seg >= 1 and coff == coff_next
                assert coff + seg <= g
                rows_seen += [r + pos + i for i in range(seg)]
                covered += seg
                coff_next = 0 if ends else coff + seg
                chunk_ends += ends
            assert covered == rows
        assert rows_seen == list(range(c0 * g, c1 * g))
        assert chunk_ends == c1 - c0


@pytest.mark.parametrize("F,N,g,n,fit", [
    (4, 8, 16, 3, 264), (4, 8, 1, 10, 4), (4, 8, 3, 7, 3), (2, 6, 7, 4, 2),
    (1, 5, 5, 6, 5), (4, 16, 5, 5, 2), (2, 12, 9, 3, 264), (1, 4, 2, 9, 4)])
def test_model_gives_plain_bit_for_bit(F, N, g, n, fit):
    """Integer frames and correction, F <= 4: every sum is exact, so the
    model's E (the kernel's addressing and epilogue) equals the float64
    plain version's, and every entry is written once."""
    rng = np.random.default_rng(F * 1000 + N * 10 + g)
    xf = torch.from_numpy(rng.integers(-4, 5, (n * g, F * 2 * N))
                          .astype(np.float32))
    cr = torch.from_numpy(rng.integers(-1, 3, N).astype(np.float32))
    ci = torch.from_numpy(rng.integers(-1, 2, N).astype(np.float32))
    kw = dict(F=F, N=N, g=g, scale=1.0 / 16)
    E, writes = kernel_model(xf, cr, ci, fit=fit, **kw)
    assert (writes == 1).all()
    Ep = wc.subband_chunk_grams_plain(xf.double(), cr, ci, **kw)
    torch.testing.assert_close(E, Ep, rtol=0, atol=0)


@pytest.mark.parametrize("F", [8, 12, 16, 20, 32])
def test_split_dft_matches_the_direct_sum(F):
    """Four subbands a group (F = 4G, the residue class q mod G): the
    kernel's split DFT, z_t1 = sum_t2 W_G^(q t2) x_(t1 + 4 t2) and
    y_k = sum_t1 W[q + G k, t1] z_t1, from the snapped twiddles by the
    kernel's indices, is the DFT of subbands q + G k, for G a power of
    two or not."""
    G = F // 4
    w = wc.dft_twiddles(F).astype(np.float64)
    tw = w[:, 0] + 1j * w[:, 1]
    rng = np.random.default_rng(F)
    x = rng.standard_normal(F) + 1j * rng.standard_normal(F)
    direct = np.fft.fft(x)
    for q in range(G):
        z = [sum(tw[q * t2 * 4 % F] * x[t1 + 4 * t2] for t2 in range(G))
             for t1 in range(4)]
        y = [sum(tw[(q + G * k) * t1 % F] * z[t1] for t1 in range(4))
             for k in range(4)]
        # the twiddles are float32 (2^-24 relative)
        np.testing.assert_allclose(y, direct[[q + G * k for k in range(4)]],
                                   rtol=0, atol=1e-6)


def test_model_matches_plain_on_a_scene():
    """F = 16 (non-trivial twiddles), normal samples: the model within
    float32 rounding of the plain version."""
    F, N, g, n = 16, 8, 8, 3
    rng = np.random.default_rng(2)
    xf = torch.from_numpy(rng.standard_normal((n * g, F * 2 * N))
                          .astype(np.float32))
    one, zero = torch.ones(N), torch.zeros(N)
    kw = dict(F=F, N=N, g=g, scale=1.0 / 8)
    E, writes = kernel_model(xf, one, zero, fit=5, **kw)
    assert (writes == 1).all()
    Ep = wc.subband_chunk_grams_plain(xf, one, zero, **kw)
    assert (E - Ep).abs().max().item() <= 1e-5 * Ep.abs().max().item()
    assert math.isfinite(E.abs().max().item())


@pytest.mark.parametrize("F,N,g,n,fit", [
    (12, 8, 16, 3, 264), (12, 6, 7, 4, 5), (12, 5, 9, 3, 3),
    (10, 12, 5, 4, 264), (10, 6, 3, 7, 4), (10, 3, 8, 3, 2),
    (6, 16, 4, 5, 264), (6, 2, 5, 6, 3), (6, 5, 16, 2, 7),
    (5, 4, 9, 3, 2), (5, 10, 3, 5, 264), (5, 1, 7, 4, 1)])
def test_stream_model_gives_plain_bit_for_bit(F, N, g, n, fit):
    """Kernel 7 (the stream source): integer stream and correction at
    F = 12, 10, 6, 5 and every register-tile form (RT = 4, 2, 1): every sum
    is exact, so the model's E equals the float64 plain version's, and
    every entry is written once."""
    rng = np.random.default_rng(F * 1000 + N * 10 + g)
    y = torch.from_numpy(rng.integers(-4, 5, (n * g, F * 2 * N))
                         .astype(np.float32))
    cr = torch.from_numpy(rng.integers(-1, 3, N).astype(np.float32))
    ci = torch.from_numpy(rng.integers(-1, 2, N).astype(np.float32))
    kw = dict(F=F, N=N, g=g, scale=1.0 / 16)
    E, writes = kernel_model(y, cr, ci, fit=fit, stream=True, **kw)
    assert (writes == 1).all()
    Ep = wc.subband_embedded_plain(y.double(), cr, ci, **kw)
    torch.testing.assert_close(E, Ep, rtol=0, atol=0)


@pytest.mark.parametrize("F,N,g,n,split", [
    (12, 5, 16, 3, True), (12, 8, 8, 2, False), (6, 12, 8, 3, False),
    (10, 6, 5, 4, False)])
def test_frames_model_at_f_not_a_power_of_two(F, N, g, n, split):
    """Kernel 4 on the frames at F = 12 (four subbands a group, G = 3: the
    split DFT; and twelve a group: direct), 6 and 10, normal samples and a
    correction: the model within 1e-6·max|E| of the float64 plain version
    (the float32 twiddles are within 2^-24 of the DFT's)."""
    P = make_plan(F, N, g, tile_form(N))[0]
    assert (P == 4 and F // P > 1) == split
    rng = np.random.default_rng(F + N)
    xf = torch.from_numpy(rng.standard_normal((n * g, F * 2 * N))
                          .astype(np.float32))
    cr = torch.from_numpy(rng.standard_normal(N).astype(np.float32))
    ci = torch.from_numpy(rng.standard_normal(N).astype(np.float32))
    kw = dict(F=F, N=N, g=g, scale=1.0 / g)
    E, writes = kernel_model(xf, cr, ci, fit=7, **kw)
    assert (writes == 1).all()
    Ep = wc.subband_chunk_grams_plain(xf.double(), cr, ci, **kw)
    assert (E - Ep).abs().max().item() <= 1e-6 * Ep.abs().max().item()


def test_constants_are_the_sources():
    """The constants transcribed above are csrc/wideband_cov.cu's."""
    with open(os.path.join(os.path.dirname(wc.__file__), "..", "..", "csrc",
                           "wideband_cov.cu")) as f:
        src = f.read()
    for name, val in dict(MAXT=MAXT, J=J, MAXT_U=MAXT_U, J_U=J_U,
                          BLOCKS_U=BLOCKS_U,
                          STAGES=STAGES, STAGE_BYTES=STAGE_BYTES,
                          Y_BYTES=Y_BYTES, MAX_P=MAX_P, BAND=BAND, HEAD=HEAD,
                          MAX_SMEM=MAX_SMEM).items():
        assert re.findall(rf"constexpr int {name} = (\d+);", src) == [
            str(val)], name


def uhat_model(y, F, N, g, fit):
    """U f32[F, n, 2N, 2N] by kernel 10's plan (J_U items a thread, up to
    MAXT_U threads), walk, stages, y-buffer (the stream's column blocks, as
    kernel 7's), items and epilogue (store_utile; sums in float64: exact
    on exact inputs), and the count of writes of every entry of U."""
    rt = tile_form(N)
    P, C, threads, items, TS = make_plan(F, N, g, rt, J_U, MAXT_U)
    n = y.shape[0] // g
    nt = N // rt
    ntri = nt * (nt + 1) // 2
    yr = y[:n * g].double().reshape(n * g, F, N, 2)
    out = np.zeros((F, n, 2 * N, 2 * N), np.float32)
    writes = np.zeros((F, n, 2 * N, 2 * N), np.int64)
    _, blocks = walk(n, F // P, fit)
    its = [decode(it, C, nt, ntri) for it in range(items)]
    for q, c0, c1 in blocks:
        if c0 >= c1:
            continue
        G = F // P
        fs = [q + G * s for s in range(P)]
        # (class, subband, i, a, j, b): sum of y_i.a y_j.b
        acc = torch.zeros((C, P, N, 2, N, 2), dtype=torch.float64)
        cc = c0
        for r, rows, segs in stage_segments(c0 * g, c1 * g, g, TS):
            yb = yr[r:r + rows][:, fs].permute(1, 0, 2, 3)  # the y-buffer
            for pos, seg, coff, ends in segs:
                for cls in range(C):
                    first = pos + ((cls - coff) & (C - 1))
                    v = yb[:, first:pos + seg:C]
                    acc[cls] += torch.einsum("smia,smjb->siajb", v, v)
                if ends:
                    R = acc.sum(0).numpy()
                    for cls, s, ib, jb in its:
                        if cls == 0:
                            store_utile(out[fs[s], cc], writes[fs[s], cc],
                                        ib * rt, jb * rt, rt, R[s])
                    acc.zero_()
                    cc += 1
    return torch.from_numpy(out), writes


def store_utile(oc, wc_, i0, j0, rt, R):
    """store_utile: the tile's rows 2i + a, columns 2j + b, and off the
    diagonal their mirror rows 2j + b, columns 2i + a, from the same sums
    R[i, a, j, b]; a diagonal tile whole."""
    for u in range(rt):
        for v in range(rt):
            i, j = i0 + u, j0 + v
            for a in range(2):
                for b in range(2):
                    val = np.float32(R[i, a, j, b])
                    oc[2 * i + a, 2 * j + b] = val
                    wc_[2 * i + a, 2 * j + b] += 1
                    if i0 != j0:
                        oc[2 * j + b, 2 * i + a] = val
                        wc_[2 * j + b, 2 * i + a] += 1


def test_uhat_c5_plan():
    """Kernel 10 at c5 (F = 16, N = 64, g = 64): two subbands a group, one
    row class, 288 threads for 272 items (one a thread: 64 sums), 4 frames
    a stage, BLOCKS_U = 2 blocks a SM."""
    assert make_plan(16, 64, 64, 4, J_U, MAXT_U) == (2, 1, 288, 272, 4)
    assert BLOCKS_U * (layout(16, 64, 2, 4) + BLOCK_RESERVED) <= SM_BYTES


@pytest.mark.parametrize("N", [1, 3, 5, 6, 8, 12, 16, 18, 30, 32, 36, 64])
def test_uhat_items_cover_each_tile_and_mirror_once(N):
    """Kernel 10's plans: every (i0 <= j0) tile of every subband is one
    item of row class 0, and its rows and (off the diagonal) its mirror's
    write every entry of U once."""
    rt = tile_form(N)
    nt = N // rt
    ntri = nt * (nt + 1) // 2
    for F, g in ((1, 1), (4, 64), (16, 64), (12, 64), (16, 3)):
        P, C, threads, items, TS = make_plan(F, N, g, rt, J_U, MAXT_U)
        assert threads % 32 == 0 and items <= J_U * threads <= J_U * MAXT_U
        assert layout(F, N, P, TS) <= MAX_SMEM
        tiles = [decode(it, C, nt, ntri)[1:] for it in range(items)
                 if decode(it, C, nt, ntri)[0] == 0]
        assert sorted(tiles) == sorted(
            (s, ib, jb) for s in range(P) for ib in range(nt)
            for jb in range(ib, nt))
        writes = np.zeros((P, 2 * N, 2 * N), np.int64)
        for s, ib, jb in tiles:
            store_utile(np.zeros((2 * N, 2 * N), np.float32), writes[s],
                        ib * rt, jb * rt, rt, np.zeros((N, 2, N, 2)))
        assert (writes == 1).all()


@pytest.mark.parametrize("F,N,g,n,fit", [
    (16, 8, 16, 3, 264), (12, 6, 7, 4, 5), (12, 5, 9, 3, 3),
    (10, 12, 5, 4, 264), (6, 2, 5, 6, 3), (4, 16, 4, 5, 2),
    (2, 32, 3, 3, 264), (5, 1, 7, 4, 1)])
def test_uhat_model_gives_plain_bit_for_bit(F, N, g, n, fit):
    """Kernel 10: integer streams at every register-tile form (RT = 4, 2,
    1): every sum is exact, so the model's U equals the float64 plain
    version's, and every entry is written once."""
    rng = np.random.default_rng(F * 1000 + N * 10 + g + 7)
    y = torch.from_numpy(rng.integers(-4, 5, (n * g, F * 2 * N))
                         .astype(np.float32))
    U, writes = uhat_model(y, F, N, g, fit)
    assert (writes == 1).all()
    Up = wc.subband_grams_plain(y.double(), F=F, N=N, g=g)
    torch.testing.assert_close(U, Up, rtol=0, atol=0)
