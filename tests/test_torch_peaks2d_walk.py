"""The ring form of kernel 6 (doa_tpu_torch/csrc/peaks2d.cu, the 2-D az/el
peaks) on the CPU.

The kernel runs only on the card. Here its form predicate and its ring
constants are read from the source, and the ring form's decomposition is
run in numpy lane by lane: the rows each stencil warp owns (warps 1..W-1;
warp 0 merges, refines and refills), each lane's walk down its interior
el columns with the up and centre values carried from row to row, each
lane's sorted top-k, the xor shuffle butterfly that merges a warp's lanes
(skipped where no lane holds a peak), the warps' lists on warp 0's lanes
and the same butterfly over them, warp 0's strided walk for the global
argmax of a window with no finite peak, then the pad and the refine on
lanes 0..k-1 with the kernel's float32 rounding at each step. The model
equals find_local_max_2d bit for bit on ties, plateaus, border peaks,
no-peak windows and MUSIC-shaped spectra at several warp counts, as
chip_smoke.py holds the kernel on the card (d == 0.0)."""

import dataclasses
import os
import re

import numpy as np
import pytest
import torch

from doa_tpu_torch import PRESETS, _build
from doa_tpu_torch.ops.cuda import peaks2d as pk
from doa_tpu_torch.ops.peaks import find_local_max_2d
from doa_tpu_torch.plan import Plan, kernel_forms, kernel_routes

SRC = os.path.join(os.path.dirname(pk.__file__), "..", "..", "csrc",
                   "peaks2d.cu")
with open(SRC) as _f:
    SOURCE = _f.read()
AZ_RNG, EL_RNG = (-90.0, 90.0), (0.0, 90.0)
BIG = 0x7fffffff
F32 = np.float32
EMPTY = (F32(-np.inf), BIG)


def const(name):
    m = re.findall(rf"constexpr int {name} = (\d+)", SOURCE)
    assert len(m) == 1, name
    return int(m[0])


RING_THREADS, RING_SLOTS = const("RING_THREADS"), const("RING_SLOTS")
HEAD_BYTES, SMEM_LIMIT = const("HEAD_BYTES"), const("SMEM_LIMIT")
MAX_K, RING_WARPS = const("MAX_K"), const("RING_THREADS") // 32


def better(a, b):
    """The kernel's order: the larger value, then the lower index."""
    return a[0] > b[0] or (a[0] == b[0] and a[1] < b[1])


def insert(lst, e, k):
    """`insert`: e into the sorted list of k entries (a new list)."""
    lst = list(lst)
    for q in range(k):
        if better(e, lst[q]):
            lst[q], e = e, lst[q]
    return lst


def warp_merge(lists, k):
    """`warp_merge` on 32 lanes' lists: nothing where no lane holds an
    entry; else at each xor step a lane inserts its partner's entries in
    order."""
    if all(lst[0][1] == BIG for lst in lists):
        return lists
    for off in (16, 8, 4, 2, 1):
        nxt = []
        for ln in range(32):
            lst = lists[ln]
            for q in range(k):
                lst = insert(lst, lists[ln ^ off][q], k)
            nxt.append(lst)
        lists = nxt
    return lists


def warp_argmax(Wn):
    """`warp_argmax`: lane l walks bins l, l + 32, ..., then the xor
    butterfly → every lane's (value, index)."""
    lanes = []
    for ln in range(32):
        g = EMPTY
        for i in range(ln, Wn.size, 32):
            if better((Wn[i], i), g):
                g = (Wn[i], i)
        lanes.append(g)
    for off in (16, 8, 4, 2, 1):
        lanes = [lanes[ln ^ off] if better(lanes[ln ^ off], lanes[ln])
                 else lanes[ln] for ln in range(32)]
    return lanes


def rows_of(w, Ga, W):
    """The rows [r0, r1) stencil warp w (1..W-1) owns."""
    return (w - 1) * Ga // (W - 1), w * Ga // (W - 1)


def lane_walk(Wn, Ga, Ge, r0, r1, lane, k):
    """One lane's walk: its interior columns e = 1 + lane + 32c down the
    interior rows of r0..r1-1, the up and centre values carried → its
    sorted top-k."""
    lst = [EMPTY] * k
    a0, a1 = max(r0, 1), min(r1, Ga - 1)
    if r0 >= r1:
        return lst
    for e in range(1 + lane, Ge - 1, 32):
        if a0 >= a1:
            break
        up, cur = Wn[(a0 - 1) * Ge + e], Wn[a0 * Ge + e]
        for a in range(a0, a1):
            gi = a * Ge + e
            down, left, right = Wn[gi + Ge], Wn[gi - 1], Wn[gi + 1]
            if cur > up and cur >= down and cur > left and cur >= right:
                lst = insert(lst, (cur, gi), k)
            up, cur = cur, down
    return lst


def recip(v):
    return F32(1) / max(v, F32(np.finfo(np.float32).tiny))


def refine_frac(Wn, at, pos, length, step):
    """`refine_frac`, each float32 operation rounded on its own."""
    pm = pos - 1 if pos > 0 else 0
    pp = pos + 1 if pos < length - 1 else length - 1
    qm = recip(Wn[at + (pm - pos) * step])
    q0 = recip(Wn[at])
    qp = recip(Wn[at + (pp - pos) * step])
    dd = (qm - F32(2) * q0) + qp
    d = (F32(0.5) * (qm - qp)) / dd if abs(dd) > 0 else F32(0)
    d = min(max(d, F32(-0.5)), F32(0.5))
    return F32(pos) + (d if 0 < pos < length - 1 else F32(0))


def ring_model(P, k, refine, W=RING_WARPS):
    """The ring form on P f32[B, Ga, Ge] with W warps → (values, az, el)
    f32[B, k], and whether every lane of warp 0 ended with the same list
    and argmax."""
    B, Ga, Ge = P.shape
    daz = F32((AZ_RNG[1] - AZ_RNG[0]) / (Ga - 1))
    del_ = F32((EL_RNG[1] - EL_RNG[0]) / (Ge - 1))
    out = np.zeros((3, B, k), np.float32)
    agree = True
    for b in range(B):
        Wn = P[b].reshape(-1)
        lists = [[EMPTY] * k]                      # warp 0 owns no rows
        for w in range(1, W):
            r0, r1 = rows_of(w, Ga, W)
            lanes = [lane_walk(Wn, Ga, Ge, r0, r1, ln, k)
                     for ln in range(32)]
            lists.append(warp_merge(lanes, k)[0])  # lane 0 stores it
        lanes = warp_merge([lists[ln] if 1 <= ln < W else [EMPTY] * k
                            for ln in range(32)], k)
        agree &= all(lst == lanes[0] for lst in lanes)
        best = [lst[0] for lst in lanes]
        if not np.isfinite(lanes[0][0][0]):        # uniform on warp 0
            best = warp_argmax(Wn)
            agree &= all(g == best[0] for g in best)
        for r in range(k):                         # lane r
            lst = lanes[r]
            v, i = lst[r]
            if not np.isfinite(v):
                v, i = best[r]
            ia, ie = i // Ge, i % Ge
            fa, fe = F32(ia), F32(ie)
            if refine:
                fa = refine_frac(Wn, i, ia, Ga, Ge)
                fe = refine_frac(Wn, i, ie, Ge, 1)
            out[:, b, r] = (v, F32(AZ_RNG[0]) + fa * daz,
                            F32(EL_RNG[0]) + fe * del_)
    return out, agree


def edge_spectra(Ga=21, Ge=17):
    """Ties, plateaus, border peaks, corner peaks, a rising window (no
    interior peak), a flat one, a window of integer values full of ties
    and one MUSIC-shaped window."""
    rng = np.random.default_rng(17)
    P = np.full((9, Ga, Ge), 0.5, np.float32)
    P[0] = np.linspace(0, 1, Ga * Ge).reshape(Ga, Ge)
    P[1, Ga // 2, Ge // 2] = 5.0
    P[2, min(5, Ga - 2), 5] = 3.0              # an exact tie
    P[2, max(Ga - 6, 1), Ge - 6] = 3.0
    P[3, 0, 7] = 9.0                           # the best on the border
    P[3, Ga // 2, 4] = 2.0
    P[4, Ga // 2, 6] = 2.0                     # a plateau
    P[4, Ga // 2, 7] = 2.0
    P[5, 1, 1] = 4.0
    P[5, Ga - 2, Ge - 2] = 3.5
    P[7] = rng.integers(1, 4, (Ga, Ge))
    az = np.linspace(-90, 90, Ga)[:, None]
    el = np.linspace(0, 90, Ge)[None, :]
    den = ((az - 20) / 30) ** 2 + ((el - 50) / 20) ** 2 + 1e-3
    P[8] = 1.0 / den + 0.01 * rng.random((Ga, Ge))
    return P


@pytest.mark.parametrize("W", [2, 5, RING_WARPS, 32])
@pytest.mark.parametrize("shape", [(21, 17), (9, 40), (4, 70)])
def test_ring_model_is_find_local_max_2d(W, shape):
    """The ring form's walk and merges equal the plain rule bit for bit,
    for every warp count (a grid with fewer rows than warps included) and
    el columns walked in one, two and three lane passes."""
    P = edge_spectra(*shape)
    for k in (1, 2, 3, 4):
        for refine in (False, True):
            got, agree = ring_model(P, k, refine, W)
            want = find_local_max_2d(torch.from_numpy(P), k, AZ_RNG,
                                     EL_RNG, refine)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w.numpy())
            assert agree


def test_rows_cover_the_grid_once():
    """Warps 1..W-1 own disjoint runs of rows covering every row of the
    grid, and the runs differ in length by at most one."""
    for Ga in (2, 15, 16, 181, 361):
        spans = [rows_of(w, Ga, RING_WARPS) for w in range(1, RING_WARPS)]
        rows = [a for r0, r1 in spans for a in range(r0, r1)]
        assert rows == list(range(Ga))
        lens = [r1 - r0 for r0, r1 in spans]
        assert max(lens) - min(lens) <= 1


def c_ring_form(G):
    """csrc/peaks2d.cu's `ring_form`, transcribed."""
    slot = (4 * G + 12 + 15) & ~15
    return (G <= (SMEM_LIMIT - HEAD_BYTES) // RING_SLOTS // 4
            and HEAD_BYTES + RING_SLOTS * slot <= SMEM_LIMIT)


def test_form_predicate_is_the_sources():
    """peaks_form's constants and slot size are the source's, and it
    names "ring" exactly where the source's ring_form holds: c5's 181×91
    window (65,884 bytes) fits three slots, a 361×181 window does not."""
    assert "return (4 * G + 12 + 15) & ~15;" in SOURCE
    assert (pk.RING_SLOTS, pk.HEAD_BYTES, pk.SMEM_LIMIT) == (
        RING_SLOTS, HEAD_BYTES, SMEM_LIMIT)
    assert pk.MAX_PEAKS2D_K == MAX_K
    for G in (4, 16471, 19195, 19196, 19197, 19200, 19201, 65341):
        assert pk.slot_bytes(G) == (4 * G + 27) & ~15
        want = "ring" if c_ring_form(G) else "block"
        assert pk.peaks_form(G, 1) == want, G
    assert pk.peaks_form(181, 91) == "ring"
    assert pk.peaks_form(361, 181) == "block"
    # a slot holds the window at any address mod 16 (a float's 0-12 bytes)
    for G in (4, 5, 16471):
        assert pk.slot_bytes(G) >= 4 * G + 12 and pk.slot_bytes(G) % 16 == 0


@pytest.mark.parametrize("grid,want", [((181, 91), "ring"),
                                       ((361, 181), "block")])
def test_plan_names_kernel_6s_form(grid, want):
    """c5's plan names the ring form for its peaks stage, a grid too large
    for the ring the block form; on the CPU no form is named."""
    cfg = PRESETS["c5_ura64_wideband"]
    cfg = dataclasses.replace(cfg, grid2d=dataclasses.replace(
        cfg.grid2d, num_az=grid[0], num_el=grid[1]))
    for spectra in (True, False):
        routes = kernel_routes(cfg, return_spectra=spectra)
        plan = Plan(routes, forms=kernel_forms(cfg, routes))
        assert plan["peaks"] == "peaks2d"
        assert plan.forms["peaks"] == want
        assert Plan(routes, on_card=False,
                    forms=kernel_forms(cfg, routes)).forms == {}


def test_wrapper_forms_on_the_cpu():
    """A CPU tensor takes the plain version and counts no launch; a form
    that does not take the grid raises before any launch."""
    P = torch.from_numpy(edge_spectra())
    big = torch.ones((1, 361, 181))
    with _build.counting() as n:
        for a, b in zip(pk.peaks2d(P, 2, AZ_RNG, EL_RNG, True),
                        find_local_max_2d(P, 2, AZ_RNG, EL_RNG, True)):
            assert torch.equal(a, b)
        for form in ("ring", "warp"):
            with pytest.raises(ValueError, match="form"):
                pk._launch(big, 2, AZ_RNG, EL_RNG, True, form)
    assert not n
    assert {pk.peaks_form(181, 91), pk.peaks_form(361, 181)} == set(
        pk.PEAKS_FORMS) == {"ring", "block"}
