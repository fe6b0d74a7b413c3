"""Port parity: doa_tpu_torch's MUSIC scan (plain paths of kernels K3 and
K2) and find_local_max against doa_tpu's Pallas kernels in interpret mode
and doa_tpu.ops.peaks, on the same numpy inputs; and K3's tensor-core
form on the CPU: its operand layouts with 2N padding, its grid of
(stretch, window group) blocks and its two-accumulator 3×TF32 arithmetic,
modelled by the shared mainloop's model (test_torch_fusion_split)."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import golden
from doa_tpu.cpx import Cpx, embed_vector
from doa_tpu.ops import cpx_ops as ops_jax
from doa_tpu.ops.pallas.music_scan import (music_scan_pallas,
                                           music_scan_peaks_pallas)
from doa_tpu.ops.peaks import find_local_max as find_local_max_jax
from doa_tpu_torch.ops.cuda import music_scan as ms
from doa_tpu_torch.ops.cuda.scan_tc import (fusion_bins, fusion_kp,
                                            subspace_fragments, tf32_split)
from doa_tpu_torch.ops.peaks import find_local_max
from test_torch_fusion_split import _kernel_den


def _setup(B=37, N=8, G=250, K=2, S=256, seed=3):
    """Scene subspaces V (JAX layout f32[B, 2N, 2K]) and the embedded
    grid Ã f32[G, 2N]. B = 37 is not a multiple of the reference's window
    block (128/2K); G = 250 is not a multiple of 128."""
    x = golden.synthetic_ula_iq([60.0, 110.0, 85.0][:max(K, 2)], N, 0.5,
                                B * S, snr_db=10, seed=seed)
    R = golden.sample_covariance(golden.frame_samples(x, S, 0))
    A = golden.ula_steering(np.linspace(0, 180, G), N, 0.5).astype(
        np.complex64)
    V = np.array(ops_jax.signal_subspace_embedded(Cpx.from_complex(R), K,
                                                  iters=16))
    At = np.array(embed_vector(Cpx.from_complex(A)))
    return V, At


def _vt(V):
    return torch.from_numpy(np.ascontiguousarray(np.swapaxes(V, 1, 2)))


# (2K, 2N) of K3's tested shapes: the headline's, c3's, c5's (2N = 128)
# and a 10x10 URA's, whose 2N pads to the mainloop's multiple of 16
K3_SHAPES = [(4, 32), (6, 24), (4, 128), (2, 200)]


@pytest.mark.parametrize("k2,n2", K3_SHAPES)
def test_music_scan_matches_pallas(k2, n2):
    """P = 1/den: compared on den (the reciprocal amplifies f32 noise at
    the nulls without bound), rtol 1e-5 plus atol 1e-5·max‖a‖² for the
    cancellation in ‖a‖² − ‖Vᵀã‖²."""
    V, At = _setup(N=n2 // 2, K=k2 // 2)
    P_ref = np.asarray(music_scan_pallas(jnp.asarray(V), jnp.asarray(At),
                                         interpret=True))
    P = ms.music_scan(_vt(V), torch.from_numpy(At)).numpy()
    assert P.shape == P_ref.shape == (37, 250)
    nrm = (At * At).sum(-1).max()
    np.testing.assert_allclose(1.0 / P, 1.0 / P_ref, rtol=1e-5,
                               atol=1e-5 * nrm)


@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_music_scan_peaks_matches_pallas(k):
    """Fused scan + peaks: identical bin indices (refine off: locs are
    exactly x_min + idx·dx) and refined angles within 1e-4°."""
    V, At = _setup(K=2 if k < 3 else 3)
    Vj, Aj = jnp.asarray(V), jnp.asarray(At)
    Vt, At_t = _vt(V), torch.from_numpy(At)
    v0_ref, l0_ref = music_scan_peaks_pallas(Vj, Aj, k, 0.0, 180.0,
                                             refine=False, interpret=True)
    v0, l0 = ms.music_scan_peaks(Vt, At_t, k, 0.0, 180.0, refine=False)
    assert l0.shape == (37, k)
    np.testing.assert_array_equal(l0.numpy(), np.asarray(l0_ref))
    # values are dmin/den: dmin sits at a MUSIC null, where
    # ‖a‖² − ‖Vᵀã‖² cancels, so its f32 relative error is
    # ~1e-6·‖a‖²/dmin (measured up to 4e-4 here; the reference's own
    # fused-vs-unfused check uses 5e-2)
    np.testing.assert_allclose(v0.numpy(), np.asarray(v0_ref), rtol=1e-2)
    v1_ref, l1_ref = music_scan_peaks_pallas(Vj, Aj, k, 0.0, 180.0,
                                             refine=True, interpret=True)
    v1, l1 = ms.music_scan_peaks(Vt, At_t, k, 0.0, 180.0, refine=True)
    np.testing.assert_allclose(l1.numpy(), np.asarray(l1_ref), atol=1e-4)


def test_fused_peaks_equal_unfused_rule():
    """K2's plain version equals K3 → normalise → find_local_max on the
    same den (the fused kernel's contract), including the fallback row
    of a flat spectrum."""
    V, At = _setup(B=9)
    Vt, At_t = _vt(V), torch.from_numpy(At)
    Vt[0] = 0.0                          # den = ‖a‖² is flat: no peak
    for refine in (False, True):
        v, l = ms.music_scan_peaks(Vt, At_t, 2, 0.0, 180.0, refine=refine)
        P = ms.music_scan(Vt, At_t)
        P = P / P.max(dim=-1, keepdim=True).values
        v_ref, l_ref = find_local_max(P, 2, 0.0, 180.0, refine=refine)
        np.testing.assert_allclose(l.numpy(), l_ref.numpy(), atol=1e-4)
        np.testing.assert_allclose(v.numpy(), v_ref.numpy(), rtol=1e-5)
    assert float(v[0, 0]) == 1.0


def _spectra_with_ties(B=24, G=64, seed=7):
    """Positive integer-valued spectra: plateaus, equal peaks, monotone
    rows (no interior maximum) and a constant row."""
    rng = np.random.default_rng(seed)
    P = rng.integers(1, 6, size=(B, G)).astype(np.float32)
    P[1, 10:14] = 9.0                     # plateau
    P[2, :] = np.arange(1, G + 1)         # monotone: fallback to argmax
    P[3, :] = 4.0                         # constant
    P[4, [5, 20, 40]] = 9.0               # three equal peaks
    return P


@pytest.mark.parametrize("k", [1, 2, 4, 6])
@pytest.mark.parametrize("refine", [False, True])
def test_find_local_max_matches_reference(k, refine):
    P = _spectra_with_ties()
    v_ref, l_ref = find_local_max_jax(jnp.asarray(P), k, 0.0, 180.0,
                                      refine=refine)
    v, l = find_local_max(torch.from_numpy(P), k, 0.0, 180.0, refine=refine)
    np.testing.assert_array_equal(v.numpy(), np.asarray(v_ref))
    np.testing.assert_allclose(l.numpy(), np.asarray(l_ref), atol=1e-5)


def test_fused_peaks_size_rule_and_devices():
    V, At = _setup(B=4)
    with pytest.raises(ValueError, match="k"):
        ms.music_scan_peaks(_vt(V), torch.from_numpy(At), 5, 0.0, 180.0)
    with pytest.raises(ValueError, match="device"):
        ms.music_scan(torch.empty((2, 4, 16), device="meta"),
                      torch.empty((250, 16), device="meta"),
                      torch.empty((250,), device="meta"))


def _unpad_tiles(tiles, G, n2, k2):
    """scan_tiles' A' → (hi, lo) f32[G, 2N], and what lies past G, 2N."""
    GB, KP = 2 * fusion_bins(k2), fusion_kp(n2)
    nJ = tiles.shape[0]
    # [j][plane][KP/4 c][GB/8 r][8 row][4 e] → g = GB·j + 8r + row,
    # n = 4c + e
    planes = tiles.permute(0, 3, 4, 1, 2, 5).reshape(nJ * GB, 2, KP)
    return planes[:G, :, :n2], planes[G:], planes[:G, :, n2:]


@pytest.mark.parametrize("k2,n2", K3_SHAPES)
def test_k3_layouts_reassemble_with_padding(k2, n2):
    """A' (scan_tiles) and V' (subspace_fragments) hold every operand once,
    at the mainloop's address, with zeros past G, B and 2N."""
    rng = np.random.default_rng(n2)
    B, G = 45, 301                      # ragged: 2 window tiles, odd G
    Vt = torch.from_numpy(rng.standard_normal((B, k2, n2)).astype(np.float32))
    At = torch.from_numpy(rng.standard_normal((G, n2)).astype(np.float32))
    tiles = ms.scan_tiles(At, k2)
    GB, KP = 2 * fusion_bins(k2), fusion_kp(n2)
    assert tiles.shape == (-(-G // GB), 2, KP // 4, GB // 8, 8, 4)
    planes, past_g, past_n = _unpad_tiles(tiles, G, n2, k2)
    hi, lo = tf32_split(At)
    assert torch.equal(planes[:, 0], hi) and torch.equal(planes[:, 1], lo)
    assert not past_g.any() and not past_n.any()
    Vf = subspace_fragments(Vt[None])[0]
    nT, MT = -(-B // 32), k2 // 2
    assert Vf.shape == (nT, KP // 8, MT, 4, 32, 4)
    # [T][s][i][w][lane (g, t)][e = 2c + h] → window 32T + 8w + g,
    # k = 2i + h, n = 8s + 4c + t
    V = Vf.reshape(nT, KP // 8, MT, 4, 8, 4, 2, 2).permute(
        0, 3, 4, 2, 7, 1, 6, 5).reshape(nT * 32, k2, KP)
    assert torch.equal(V[:B, :, :n2], Vt)
    assert not V[B:].any() and not V[:, :, n2:].any()


def _k3_model(Vt, At, nrm, sms=132):
    """P f32[B, G] as K3 forms it: the grid of window_groups (every block
    one stretch of bins and `per` window tiles; each (tile, stretch) must
    be reached once), the shared mainloop's den from the wrapper's
    layouts, then the epilogue's IEEE 1/den."""
    B, k2, n2 = Vt.shape
    G = At.shape[0]
    tiles, Vf = ms.scan_tiles(At, k2)[None], subspace_fragments(Vt[None])
    nT, nJ = Vf.shape[1], tiles.shape[1]
    groups, per = ms.window_groups(nJ, nT, sms)
    assert (groups - 1) * per < nT <= groups * per
    P = torch.full((nT * 32, G), float("nan"))
    for grp in range(groups):
        T0, T1 = grp * per, min((grp + 1) * per, nT)
        rows = slice(32 * T0, 32 * T1)
        assert bool(P[rows].isnan().all())
        den = _kernel_den(Vf[:, T0:T1], tiles, nrm[None], k2, n2)[0]
        P[rows] = 1.0 / den
    assert not bool(P.isnan().any())
    return P[:B]


@pytest.mark.parametrize("k2,n2", K3_SHAPES)
def test_k3_model_exact_inputs_equal_plain(k2, n2):
    """Quarter-step V, integer A, nrm above every Σy²: every sum exact, so
    K3's grid, layouts and epilogue give music_scan_plain bit for bit
    (chip_smoke's exact-input case), over several window groups."""
    rng = np.random.default_rng(k2 * n2)
    B, G = 300, 157
    Vt = torch.from_numpy(rng.integers(-2, 3, (B, k2, n2))
                          .astype(np.float32) / 4)
    At = torch.from_numpy(rng.integers(-3, 4, (G, n2)).astype(np.float32))
    nrm = torch.from_numpy(300000.0 + rng.integers(0, 64, G)
                           .astype(np.float32))
    P = _k3_model(Vt, At, nrm, sms=8)
    assert torch.equal(P, ms.music_scan_plain(Vt, At, nrm))


def test_k3_model_within_tolerance_of_float64_on_c5_scene():
    """On a c5-like scene (8x8 URA, 2N = 128, the exact signal subspace of
    two sources, so den cancels to ~0 at their bins) the 3×TF32 model's
    den is within chip_smoke's 1e-5·max‖a‖² of den in float64."""
    from doa_tpu_torch.ops.steering import ura_grid
    from doa_tpu_torch.configs import ArrayGeometry, GridSpec2D
    geo = ArrayGeometry(kind="ura", num_elements=64, shape=(8, 8),
                        norm_spacing=0.5)
    A = ura_grid(geo, GridSpec2D(num_az=37, num_el=19))       # (G, 64) c64
    At = torch.from_numpy(np.concatenate([A.real, A.imag], -1)
                          .astype(np.float32))
    rng = np.random.default_rng(5)
    B = 40
    Vt = np.empty((B, 4, 128), np.float32)
    for b in range(B):
        src = A[rng.integers(0, A.shape[0], 2)]               # (2, 64)
        emb = np.concatenate([np.concatenate([src.real, src.imag], -1),
                              np.concatenate([-src.imag, src.real], -1)])
        Vt[b] = np.linalg.qr(emb.T.astype(np.float64))[0].T
    Vt = torch.from_numpy(Vt)
    nrm = (At * At).sum(-1)
    den = 1.0 / _k3_model(Vt, At, nrm)
    y = torch.einsum("bkn,gn->bkg", Vt.double(), At.double())
    den64 = nrm.double() - (y * y).sum(1)
    err = float((den.double() - den64.clamp_min(0)).abs().max())
    assert err <= 1e-5 * float(nrm.max()), err
    assert float(den64.min()) < 1e-3           # the scene reaches its nulls


# K2's tensor-core form on the CPU: a model of its walk, den tile, dmin
# merge and warp peak rule, bit-equal to the plain version on exact inputs

_NEG = -1e30
_IMAX = 0x7FFFFFFF


def _better(v, i, bv, bi):
    return v > bv or (v == bv and i < bi)


def _warp_peaks(row, G, dmin, gfirst, k, x_min, dx, refine):
    """csrc's warp_peaks on one den row f32[Gp]: lane l takes bins
    4(l + 32m) to 4(l + 32m) + 3 in order (the kernel marks them in a
    first pass and tests the marked ones in a second, in the same order);
    a bin with den[g] >= den[g-1], or with den[g] >
    den[g+1]·(1 + 2^-20) while den[g] <= dmin·2^100, is ruled out without
    dividing; the others take Pn = dmin / den of the bin and its two
    neighbours in FP32 (IEEE division, as torch's) and the exact test;
    each lane keeps its 4 best interior peaks by (value, index); a round
    is the xor butterfly of the lanes' heads, whose lane moves its list
    up."""
    f32 = lambda x: torch.tensor(x, dtype=torch.float32)  # noqa: E731
    dnormal = dmin * f32(2.0 ** 100)
    lists = []
    for lane in range(32):
        lst = [(_NEG, _IMAX)] * 4
        for g in (g0 + e for g0 in range(4 * lane, G, 128)
                  for e in range(4)):
            if not 1 <= g <= G - 2:
                continue
            d, dl, dr = row[g], row[g - 1], row[g + 1]
            if not d < dl or (d > dr * f32(1.0 + 2.0 ** -20)
                              and d <= dnormal):
                continue
            pc = dmin / d
            if not (pc > dmin / dl and pc >= dmin / dr):
                continue
            c = (float(pc), g)
            for s in range(4):
                if _better(*c, *lst[s]):
                    lst[s], c = c, lst[s]
        lists.append(lst)
    pv, pi = [], []
    for _ in range(k):
        heads = [lst[0] for lst in lists]
        for off in (16, 8, 4, 2, 1):
            heads = [h if not _better(*heads[l ^ off], *h) else
                     heads[l ^ off] for l, h in enumerate(heads)]
        v, i = heads[0]
        assert all(h == (v, i) for h in heads)
        for lst in lists:
            if lst[0][1] == i:
                lst[:] = lst[1:] + [(_NEG, _IMAX)]
        pv.append(v)
        pi.append(i)
    have_any = pv[0] > 0.5 * _NEG
    best = (pv[0], pi[0]) if have_any else (1.0, gfirst)
    vals, locs = [], []
    for v, i in zip(pv, pi):
        v, i = (v, i) if v > 0.5 * _NEG else best
        delta = f32(0.0)
        if refine and 0 < i < G - 1:
            q0, qm, qp = row[i], row[i - 1], row[i + 1]
            dd = (qm - f32(2.0) * q0) + qp
            d = (f32(0.5) * (qm - qp)) / dd if dd.abs() > 0 else f32(0.0)
            delta = d.clamp(-0.5, 0.5)
        frac = f32(float(i)) + delta
        vals.append(f32(v))
        locs.append(f32(x_min) + frac * f32(dx))
    return torch.stack(vals), torch.stack(locs)


def _thread_dmin(den_tile, G, NT, nJ):
    """(dmin, first bin of it) of each of the tile's 32 windows as the
    kernel forms it: each thread (warpgroup wg, lane quad tq) scans its
    bins j·GB + wg·NT + 8jj + 2tq + c in order keeping the first least
    den; the 4 lanes of a window merge by xor shuffles, then the two
    warpgroups through shared memory."""
    out = []
    for r in range(32):
        best = {}
        for wg in range(2):
            for tq in range(4):
                v, i = float("inf"), _IMAX
                for j in range(nJ):
                    for jj in range(NT // 8):
                        for c in range(2):
                            g = j * 2 * NT + wg * NT + 8 * jj + 2 * tq + c
                            if g < G and float(den_tile[r, g]) < v:
                                v, i = float(den_tile[r, g]), g
                best[wg, tq] = (v, i)
        lt = lambda a, b: a[0] < b[0] or (a[0] == b[0] and a[1] < b[1])  # noqa
        for wg in range(2):
            for off in (1, 2):
                for tq in range(4):
                    o = best[wg, tq ^ off]
                    if tq < tq ^ off:
                        a = best[wg, tq]
                        m = o if lt(o, a) else a
                        best[wg, tq] = best[wg, tq ^ off] = m
        a, b = best[0, 0], best[1, 0]
        out.append(b if lt(b, a) else a)
    return out


def _stage_tile(Vt, T, KP):
    """The tile's V' as K2's kernel stages it in shared memory from Vt read
    in place: element (window wl, k, n) of the tile at float
    ((n/8·MT + k/2)·128 + 32·(wl/8) + 4·(wl%8) + n%4)·4 + k%2 + 2·(n/4%2),
    zero past B and 2N → f32[KP/8, 2K/2, 4, 32, 4]."""
    B, k2, n2 = Vt.shape
    MT = k2 // 2
    wl, kk, n = np.meshgrid(np.arange(32), np.arange(k2), np.arange(KP),
                            indexing="ij")
    b = 32 * T + wl
    off = ((((n >> 3) * MT + (kk >> 1)) * 128 + 32 * (wl >> 3)
            + 4 * (wl & 7) + (n & 3)) * 4 + (kk & 1) + 2 * ((n >> 2) & 1))
    ok = (b < B) & (n < n2)
    vs = torch.full((32 * k2 * KP,), float("nan"))
    vs[torch.from_numpy(off.ravel())] = 0.0
    vs[torch.from_numpy(off[ok])] = Vt[b[ok], kk[ok], n[ok]]
    assert not bool(vs.isnan().any())
    return vs.view(KP // 8, MT, 4, 32, 4)


def _k2_model(Vt, At, nrm, k, x_min, x_max, refine, sms=132):
    """(vals, locs) as K2's tensor-core form forms them: a persistent grid
    of min(tiles, sms) blocks, block x walking tiles x, x + grid, … and for
    each every stretch j in order (each (tile, stretch) reached once), the
    tile's V' staged from Vt (_stage_tile, which must equal the wrapper
    layout subspace_fragments), the stretch's den by the shared mainloop's
    model (_kernel_den) from it and the wrapper's A' written into the
    tile's den rows of
    nJ·GB + DEN_PAD floats, then after the last stretch the dmin merge and
    the warp peak rule on each window's row."""
    B, k2, n2 = Vt.shape
    G = At.shape[0]
    assert ms.peaks_tc_takes(k2, n2, G)
    tiles = ms.peaks_tiles(At, k2)
    Vf = subspace_fragments(Vt[None])
    NT = fusion_bins(k2)
    GB, nT, nJ = 2 * NT, Vf.shape[1], tiles.shape[0]
    nrm_p = torch.zeros(nJ * GB)
    nrm_p[:G] = nrm
    dx = (x_max - x_min) / (G - 1)
    grid = min(nT, sms)
    vals = torch.full((B, k), float("nan"))
    locs = torch.full((B, k), float("nan"))
    seen = []
    for x in range(grid):
        units = (-(-(nT - x) // grid)) * nJ
        for u in range(units):
            T, j = x + (u // nJ) * grid, u % nJ
            seen.append((T, j))
            if j == 0:
                den_tile = torch.full((32, nJ * GB + ms.DEN_PAD),
                                      float("nan"))
                vs = _stage_tile(Vt, T, fusion_kp(n2))
                assert torch.equal(vs, Vf[0, T])
            den_tile[:, j * GB:(j + 1) * GB] = _kernel_den(
                vs[None, None], tiles[None, j:j + 1],
                nrm_p[None, j * GB:(j + 1) * GB], k2, n2)[0]
            if j < nJ - 1:
                continue
            assert not bool(den_tile[:, :nJ * GB].isnan().any())
            mins = _thread_dmin(den_tile, G, NT, nJ)
            for r in range(32):
                b = 32 * T + r
                if b < B:
                    vals[b], locs[b] = _warp_peaks(
                        den_tile[r], G, torch.tensor(mins[r][0]),
                        mins[r][1], k, x_min, dx, refine)
    assert sorted(seen) == [(T, j) for T in range(nT) for j in range(nJ)]
    return vals, locs


def _exact_k2_inputs(k2, n2, G, B, seed):
    """Quarter-step V, integer A, a constant nrm above every Σy²: every sum
    exact (den a multiple of 1/16 below 2^24), many equal den values
    (plateaus, equal peaks); window 0 is zero, so its den is flat (no peak:
    the fallback, value 1 at bin 0)."""
    rng = np.random.default_rng(seed)
    Vt = torch.from_numpy(rng.integers(-2, 3, (B, k2, n2))
                          .astype(np.float32) / 4)
    Vt[0] = 0.0
    At = torch.from_numpy(rng.integers(-3, 4, (G, n2)).astype(np.float32))
    return Vt, At, torch.full((G,), 300000.0)


# (2K, 2N, G, k): the headline's, c3's, c2's and a ULA-4 at K = 1
K2_TC_SHAPES = [(4, 32, 1024, 2), (6, 24, 1024, 3), (4, 16, 181, 2),
                (2, 8, 250, 1)]


@pytest.mark.parametrize("refine", [False, True])
@pytest.mark.parametrize("k2,n2,G,k", K2_TC_SHAPES)
def test_k2_model_exact_inputs_equal_plain(k2, n2, G, k, refine):
    """K2's tensor-core form, modelled (walk, den tile, dmin merge, warp
    peak rule), gives music_scan_peaks_plain bit for bit on exact inputs
    (chip_smoke's exact-input case): a ragged B over several tiles a
    block, the flat window's fallback."""
    B = 70
    Vt, At, nrm = _exact_k2_inputs(k2, n2, G, B, k2 * n2 + G)
    v, l = _k2_model(Vt, At, nrm, k, 0.0, 180.0, refine, sms=2)
    vp, lp = ms.music_scan_peaks_plain(Vt, At, k, 0.0, 180.0, refine, nrm)
    assert torch.equal(v, vp) and torch.equal(l, lp)
    assert float(v[0, 0]) == 1.0 and float(l[0, 0]) == 0.0
    # the data has ties: some window's best two peaks are equal
    if k > 1:
        assert bool((vp[:, 0] == vp[:, 1]).any())


def _tie_rows(G=181, seed=11):
    """Integer den rows: plateaus at the minimum, equal isolated minima,
    a monotone row (no interior peak), a flat row, a row whose every
    second bin is a peak and ragged rows; then rows whose den differ from
    their neighbours' by 1 to 3 units in the last place or by 1e-5 of
    themselves, once at a normal dmin and once at FLT_MIN (an exact null,
    clamped), where the quotients are subnormal and 1e-5 apart round
    equal, so a bin above its right neighbour in den is still a peak."""
    rng = np.random.default_rng(seed)
    den = rng.integers(2, 7, size=(14, G)).astype(np.float32)
    den[1, 40:44] = 1.0                       # a plateau at the minimum
    den[2, [5, 60, 120, 170]] = 1.0           # four equal peaks
    den[3] = np.arange(G, 0, -1)              # monotone: fallback
    den[4] = 3.0                              # flat: fallback, value 1
    den[5, ::2] = 1.0                         # a peak every other bin
    den[6, [0, G - 1]] = 0.5                  # the minimum at both edges
    ulps = rng.integers(0, 4, size=(2, G)).astype(np.int32)
    den[12:] = (np.float32(1000.0).view(np.int32) + ulps).view(np.float32)
    den[12:, 1::3] = 1000.01                  # ≥ 2^-20 above the right
    den[12:, 0::3] = 1001.0                   # neighbour, 1e-5 relative
    den[12, 90] = 1.0
    den[13, 90] = np.finfo(np.float32).tiny
    return torch.from_numpy(den)


@pytest.mark.parametrize("k", [1, 2, 3, 4])
@pytest.mark.parametrize("refine", [False, True])
def test_k2_warp_peak_rule_equals_plain_on_ties(k, refine):
    """The warp peak rule (lane-strided bins, shuffled neighbours, the
    lanes' top-4 lists and their (value, index) merge) against the plain
    rule on den rows full of ties."""
    den = _tie_rows()
    G = den.shape[1]
    vp, lp = ms.peaks_from_den_plain(den, k, -90.0, 90.0, refine)
    for r in range(den.shape[0]):
        row = den[r]
        dmin = row.min()
        gfirst = int((row == dmin).nonzero()[0])
        v, l = _warp_peaks(row, G, dmin, gfirst, k, -90.0, 180.0 / (G - 1),
                           refine)
        assert torch.equal(v, vp[r]) and torch.equal(l, lp[r]), r


@pytest.mark.parametrize("k2,n2,G,k", [(6, 24, 1024, 3), (4, 16, 181, 2)])
def test_k2_at_c3_c2_shapes_matches_pallas(k2, n2, G, k):
    """At c3's and c2's (2K, 2N, G, k): the port's K2 (its plain version
    here) and the model of its tensor-core form against doa_tpu's
    _scan_peaks_kernel in interpret mode: the same bins with refine off,
    locs within 1e-4° with refine on."""
    V, At = _setup(B=40, N=n2 // 2, G=G, K=k2 // 2)
    Vj, Aj = jnp.asarray(V), jnp.asarray(At)
    Vt, At_t = _vt(V), torch.from_numpy(At)
    nrm = (At_t * At_t).sum(-1)
    for refine in (False, True):
        _, l_ref = music_scan_peaks_pallas(Vj, Aj, k, 0.0, 180.0,
                                           refine=refine, interpret=True)
        l_ref = np.asarray(l_ref)
        _, l = ms.music_scan_peaks(Vt, At_t, k, 0.0, 180.0, refine=refine)
        _, lm = _k2_model(Vt, At_t, nrm, k, 0.0, 180.0, refine)
        for got in (l, lm):
            if refine:
                np.testing.assert_allclose(got.numpy(), l_ref, atol=1e-4)
            else:
                np.testing.assert_array_equal(got.numpy(), l_ref)
