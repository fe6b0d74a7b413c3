"""The arithmetic order of the planes Gram kernels 8 and 12
(doa_tpu_torch/csrc/covariance.cu on csrc/gram_ring.cuh) on the CPU.

The kernels run only on the card. Here their walks are transcribed from
the source and run in torch:

* kernel 8's ring form: a stage's staged rows (the interleaved buffer's
  rows, or the Xr rows then the Xi rows of two planes), each thread's
  column offsets (`col`), its upper-triangle tile and row class, the
  chunk-end reduction buffer (entry-major, class 0's slot holding the
  sum) and the planar-fold epilogue through `u_at`: bit-equal to
  `chunk_grams_plain` on integer inputs (every sum exact in FP32), and
  within 1e-5·max|R| of doa_tpu's `chunk_grams_pallas` in interpret mode;
* kernel 12's chunk-sum form: each block's run of windows, its slabs of
  chunks, each chunk's Gram tiles, the window slots opened, added to and
  closed in chunk order, the stash of each closed window's entries / S
  and the fold: bit-equal to `cov_windows_plain` on integer inputs, within
  the reference's tolerances of `cov_windows_pallas(interpret=True)`, and
  bit for bit the same for any grid and slab size;
* each form's predicate (`planes_layout`, `chunk_form`, `windows_form`).
"""

import math

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import golden
from doa_tpu.cpx import Cpx
from doa_tpu.ops.pallas.covariance import chunk_grams_pallas, cov_windows_pallas
from doa_tpu_torch.ops.cuda import covariance as cov

# the constants of csrc/gram_ring.cuh and csrc/covariance.cu
THREADS, STAGE_BYTES = 256, 32768
SLOT = STAGE_BYTES + 16
WS_ZBYTES, WS_CHUNKS = 32768, 32


def tile_form(n2):
    """RT of the ring's register tiles (launch_ring's dispatch)."""
    return 4 if n2 % 4 == 0 and n2 <= 64 else 2


def tiles(nt):
    """The upper-triangle tiles (ib, jb) in thread order (ti)."""
    out = []
    for ti in range(nt * (nt + 1) // 2):
        ib, rem = 0, ti
        while rem >= nt - ib:
            rem -= nt - ib
            ib += 1
        out.append((ib, ib + rem))
    return out


def stage_rows(rb):
    return (STAGE_BYTES // rb) & ~15


def bf16(x):
    return x.to(torch.bfloat16).to(torch.float32)


def ring_chunk_grams(xr, xi, g, layout, dtype="float32"):
    """Kernel 8's ring form, transcribed: → (Rr, Ri) f32[T // g, N, N]."""
    T, N = xr.shape
    n2 = 2 * N
    RT = tile_form(n2)
    nt = n2 // RT
    ntri = nt * (nt + 1) // 2
    groups = THREADS // ntri
    width = groups * ntri
    planes = layout == "planar"
    rb = N if planes else n2                    # floats a staged row
    if planes:                                  # a stage's Xi rows at half
        TS = ((STAGE_BYTES - 4 * rb) // (8 * rb)) & ~15
        half = (TS + 1) * rb
        assert (TS * rb * 4) % 128 == 0 and 2 * half * 4 + 15 <= SLOT
    else:
        TS, half = stage_rows(rb * 4), 0

    def col(i):                                 # gram_mainloop's col()
        if planes:
            return i if i < N else half + i - N
        return i

    def re(i):                                  # PlanesEpi's basis
        return i if planes else 2 * i

    def im(i):
        return N + i if planes else 2 * i + 1

    n = T // g
    rr = torch.empty((n, N, N))
    ri = torch.empty((n, N, N))
    pairs = tiles(nt)
    ii, jj = np.meshgrid(np.arange(N), np.arange(N), indexing="ij")
    for c in range(n):
        rows = slice(c * g, (c + 1) * g)
        # the chunk's staged rows as the slot holds them (one stage of g
        # rows here: the walk over stages keeps each class's row order)
        if planes:
            slot = torch.zeros(2 * half)
            slot[:g * N] = xr[rows].reshape(-1)
            slot[half:half + g * N] = xi[rows].reshape(-1)
        else:
            slot = torch.stack([xr[rows], xi[rows]], -1).reshape(-1)
        if dtype == "bfloat16":
            slot = bf16(slot)
        red = torch.zeros(RT * RT * width)
        for ti, (ib, jb) in enumerate(pairs):
            i0, j0 = ib * RT, jb * RT
            ci = [col(i0 + u) for u in range(RT)]
            cj = [col(j0 + v) for v in range(RT)]
            for rg in range(groups):
                acc = torch.zeros(RT, RT)
                for t in range(rg, g, groups):
                    a = slot[[t * rb + o for o in ci]]
                    b = slot[[t * rb + o for o in cj]]
                    acc += a[:, None] * b[None, :]
                for u in range(RT):
                    for v in range(RT):
                        red[(u * RT + v) * width + rg * ntri + ti] = acc[u, v]
            for e in range(RT * RT):                # the chunk-end sums
                if ib == jb and e // RT > e % RT:
                    continue
                s = red[e * width + ti].clone()
                for q in range(1, groups):
                    s += red[e * width + q * ntri + ti]
                red[e * width + ti] = s

        def u_at(i, j):                         # (i, j) or its mirror
            i, j = np.minimum(i, j), np.maximum(i, j)
            ib, jb, iu, ju = i // RT, j // RT, i % RT, j % RT
            t = ib * nt - ib * (ib - 1) // 2 + (jb - ib)
            return red[torch.from_numpy((iu * RT + ju) * width + t)]

        rr[c] = u_at(re(ii), re(jj)) + u_at(im(ii), im(jj))
        ri[c] = u_at(im(ii), re(jj)) - u_at(re(ii), im(jj))
    return rr, ri


def _planes(x, layout):
    if layout == "planar":                      # torch's 64-byte aligned
        return (torch.from_numpy(np.ascontiguousarray(x.real)).clone(),
                torch.from_numpy(np.ascontiguousarray(x.imag)).clone())
    v = torch.from_numpy(x.view(np.float32)).view(x.shape[0], x.shape[1], 2)
    return v[..., 0], v[..., 1]


def _int_capture(N, T, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(-20, 21, (T, N))
            + 1j * rng.integers(-20, 21, (T, N))).astype(np.complex64)


def _capture(N, T, seed=3):
    return golden.synthetic_ula_iq([60.0, 110.0], N, 0.5, T, snr_db=10,
                                   seed=seed).astype(np.complex64)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout,N", [
    ("interleaved", 8), ("interleaved", 15), ("interleaved", 16),
    ("planar", 8), ("planar", 16)])
def test_ring_form_exact_on_integers(layout, N, dtype):
    """3 chunks of 24 rows + a tail: bit-equal to the plain version."""
    x = _int_capture(N, 3 * 24 + 5, seed=N)
    xr, xi = _planes(x, layout)
    assert cov.planes_layout(xr, xi).layout == layout
    want = cov.chunk_grams_plain(xr, xi, 24, dtype)
    got = ring_chunk_grams(xr, xi, 24, layout, dtype)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert torch.equal(got[0], got[0].transpose(1, 2))
    assert torch.equal(got[1], -got[1].transpose(1, 2))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout", ["interleaved", "planar"])
def test_ring_form_matches_pallas(layout, dtype):
    """c3's N = 16 on a scene, 3 chunks of 64: within 1e-5·max|R| of the
    reference kernel (the same inputs, another sum order)."""
    N, g = 16, 64
    x = _capture(N, 3 * g + 9)
    ref = chunk_grams_pallas(Cpx.from_complex(x), g,
                             compute_dtype=jnp.dtype(dtype),
                             chunks_per_block=1, interpret=True)
    rr, ri = ring_chunk_grams(*_planes(x, layout), g, layout, dtype)
    scale = np.abs(np.asarray(ref.re)).max()
    np.testing.assert_allclose(rr.numpy(), np.asarray(ref.re), rtol=0,
                               atol=1e-5 * scale)
    np.testing.assert_allclose(ri.numpy(), np.asarray(ref.im), rtol=0,
                               atol=1e-5 * scale)


def ws_shape(n2, ntri, g, h):
    """(cs, ko): chunks a slab, windows closing in one (ws_shape)."""
    cs = min(WS_ZBYTES // (g * n2 * 4), WS_CHUNKS)
    return cs, (cs + h - 1) // h


def window_sums(xr, xi, S, overlap, grid=3, cs=None):
    """Kernel 12's chunk-sum form, transcribed: → (Rr, Ri) f32[B, N, N].
    grid: blocks; cs: chunks a slab (the kernel's own by default)."""
    T, N = xr.shape
    n2, hop = 2 * N, S - overlap
    g = math.gcd(S, hop)
    m, h = S // g, hop // g
    B = (T - S) // hop + 1
    nt = n2 // 4
    ntri = nt * (nt + 1) // 2
    NS, W, threads = cov._window_slots(N, S, overlap)
    assert NS == -(-m // h)
    cs_k, _ = ws_shape(n2, ntri, g, h)
    cs = cs or cs_k
    pairs = tiles(nt)
    # the slab's rows as they are staged: an interleaved buffer's rows as
    # they lie (the basis u: re, im of each element side by side), other
    # layouts as Z = [Xr | Xi]
    ilv = xr.stride(1) == 2 and xi.data_ptr() == xr.data_ptr() + 4
    if ilv:
        Z = torch.stack([xr, xi], -1).reshape(T, n2)
        re, im = (lambda a: 2 * a), (lambda a: 2 * a + 1)
    else:
        Z = torch.cat([xr, xi], -1)
        re, im = (lambda a: a), (lambda a: N + a)
    rr = torch.full((B, N, N), float("nan"))
    ri = torch.full((B, N, N), float("nan"))
    ii, jj = np.meshgrid(np.arange(N), np.arange(N), indexing="ij")
    for blk in range(min(grid, B)):
        b0, b1 = B * blk // grid, B * (blk + 1) // grid
        if b0 >= b1:
            continue
        C0, C1 = b0 * h, (b1 - 1) * h + m
        slots = torch.zeros(NS, 16 * ntri)          # every quad's W slots
        bo = bc = b0
        for cA in range(C0, C1, cs):
            ncs = min(cs, C1 - cA)
            zs = Z[cA * g:(cA + ncs) * g]           # the slab's rows
            gs = torch.empty(ncs, 16 * ntri)        # its chunk Grams
            for k in range(ncs):
                zc = zs[k * g:(k + 1) * g]
                for t, (ib, jb) in enumerate(pairs):
                    a = zc[:, 4 * ib:4 * ib + 4]
                    b = zc[:, 4 * jb:4 * jb + 4]
                    gs[k, 16 * t:16 * t + 16] = (a.T @ b).reshape(-1)
            out = {}
            for k in range(ncs):
                c = cA + k
                if bo < b1 and c == bo * h:         # a window opens
                    slots[(bo - b0) % NS] = 0.0
                    bo += 1
                slots += gs[k]                      # every slot, in order
                if bc < b1 and c == bc * h + m - 1:  # a window closes
                    out[bc] = slots[(bc - b0) % NS] / S
                    bc += 1
            for b, ow in out.items():               # the fold
                def at(r, s):
                    r, s = np.minimum(r, s), np.maximum(r, s)
                    rb, sb = r // 4, s // 4
                    t = rb * nt - rb * (rb - 1) // 2 + (sb - rb)
                    return ow[torch.from_numpy(t * 16 + (r % 4) * 4 + s % 4)]
                rr[b] = at(re(ii), re(jj)) + at(im(ii), im(jj))
                ri[b] = at(im(ii), re(jj)) - at(re(ii), im(jj))
    assert not torch.isnan(rr).any()
    return rr, ri


_WINDOWS = [(256, 200), (128, 100), (96, 95), (256, 56)]


@pytest.mark.parametrize("layout", ["interleaved", "planar"])
@pytest.mark.parametrize("S,overlap", _WINDOWS)
def test_window_sums_exact_on_integers(S, overlap, layout):
    """Every window an ordered sum of its chunk Grams, staged in the
    interleaved basis or as Z: bit-equal to the plain version (one Gram of
    the window's S rows) on integer inputs."""
    N = 4
    x = _int_capture(N, 2048 + 37, seed=S)
    xr, xi = _planes(x, layout)
    assert cov.windows_form(N, S, overlap) == "chunk_sums"
    want = cov.cov_windows_plain(xr, xi, S, overlap)
    got = window_sums(xr, xi, S, overlap)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("S,overlap", _WINDOWS)
def test_window_sums_match_pallas(S, overlap):
    """Within the present tolerances (rtol 1e-5, atol 1e-6·max|R|) of
    cov_windows_pallas in interpret mode (hop 56, 28, 1 and 200: gcd 8, 4,
    1 and 8; the last hop past S/2)."""
    N = 4
    x = _capture(N, 2048 + 37, seed=4)
    ref = cov_windows_pallas(Cpx.from_complex(x), S, overlap, interpret=True)
    rr, ri = window_sums(*_planes(x, "interleaved"), S, overlap)
    scale = np.abs(np.asarray(ref.re)).max()
    np.testing.assert_allclose(rr.numpy(), np.asarray(ref.re), rtol=1e-5,
                               atol=1e-6 * scale)
    np.testing.assert_allclose(ri.numpy(), np.asarray(ref.im), rtol=1e-5,
                               atol=1e-6 * scale)


def test_window_sums_do_not_depend_on_the_grid():
    """A window's sum order is its chunks' order: any grid and slab size
    give the same bits (N = 16, c3's width, S = 256, hop 24)."""
    x = _capture(16, 1024 + 24 * 7, seed=6)
    xr, xi = _planes(x, "interleaved")
    a = window_sums(xr, xi, 256, 232, grid=1)
    for grid, cs in ((2, None), (5, 7), (40, 3)):
        b = window_sums(xr, xi, 256, 232, grid=grid, cs=cs)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_planes_layouts():
    """The one layout decision: the staged forms' load form and the ring
    form's layout, read off the same strides and addresses."""
    def lay(a, b):
        return cov.planes_layout(a, b)[-2:]

    x = torch.zeros(40, 16, 2)
    buf = torch.zeros(40 * 16 * 3)
    x3 = buf.view(40, 16, 3)
    assert lay(x[..., 0], x[..., 1]) == (0, "interleaved")
    assert lay(x[..., 1], x[..., 0]) == (3, "strided")
    assert lay(x[1:, :, 0], x[1:, :, 1]) == (0, "interleaved")
    assert lay(x[:, :8, 0], x[:, :8, 1]) == (0, "strided")
    assert lay(x3[..., 0], x3[..., 2]) == (3, "strided")
    x15 = torch.zeros(40, 15, 2)
    assert lay(x15[..., 0], x15[..., 1]) == (1, "interleaved")
    # strides that differ: both planes made contiguous
    assert lay(x[..., 0], x[..., 1].contiguous()) == (2, "planar")
    p = torch.zeros(2, 40 * 16 + 4)
    assert lay(p[0, :640].view(40, 16),
               p[1, :640].view(40, 16)) == (2, "planar")
    assert lay(p[0, :640].view(40, 16),
               p[1, 1:641].view(40, 16)) == (3, "strided")


@pytest.mark.parametrize("N,layout,form", [
    (16, "interleaved", "ring_interleaved"), (15, "interleaved",
                                              "ring_interleaved"),
    (32, "interleaved", "ring_interleaved"), (16, "planar", "ring_planar"),
    (32, "planar", "ring_planar"), (4, "planar", "ring_planar"),
    (6, "planar", "staged"), (15, "planar", "staged"),
    (16, "strided", "staged"), (17, "interleaved", None),
    (48, "planar", None)])
def test_chunk_form(N, layout, form):
    assert cov.chunk_form(N, layout) == form


@pytest.mark.parametrize("N,S,overlap,form", [
    (16, 1024, 1000, "chunk_sums"),   # the cov_windows entry: 43 slots
    (16, 1024, 1002, "chunk_sums"),   # hop 22: 47 slots, 3 x 144 threads
    (16, 1024, 1003, "per_window"),   # hop 21: 49 slots, 4 x 144 > 448
    (16, 1024, 1023, "per_window"),   # hop 1: 1024 slots
    (8, 256, 250, "chunk_sums"), (4, 96, 95, "chunk_sums"),
    (15, 1024, 1000, "per_window"),   # N odd
    (18, 1024, 1000, "per_window"),   # 2N > 32
    (16, 100, 0, "per_window"),       # no overlap: one slot
    (16, 256, 200, "chunk_sums")])
def test_windows_form(N, S, overlap, form):
    assert cov.windows_form(N, S, overlap) == form


@pytest.mark.parametrize("variant", ["package", "k8 no FMAs",
                                     "k8 no epilogue stores",
                                     "k8 copies only", "k12 no window adds",
                                     "k12 no chunk Grams",
                                     "k12 no fold stores", "k12 loads only"])
def test_timing_experiment_patches_the_kernel_source(variant):
    """exp_planes_gram.py times patched copies of csrc/covariance.cu with
    csrc/gram_ring.cuh expanded in place: each patch finds its anchor
    lines there exactly once (the whole package copy changes nothing), and
    the package's own files stay as they are."""
    import os
    import exp_planes_gram
    from doa_tpu_torch import _build

    paths = [os.path.join(_build.CSRC, f) for f in ("covariance.cu",
                                                    "gram_ring.cuh")]
    files = []
    for path in paths:
        with open(path) as f:
            files.append(f.read())
    src = _build.expanded_source(paths[0])
    patch, whole = exp_planes_gram.VARIANTS[variant]
    assert (patch(src) == src) == (variant == "package")
    assert whole == (variant == "package")
    for path, text in zip(paths, files):
        with open(path) as f:
            assert f.read() == text
