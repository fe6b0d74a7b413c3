"""The work split of K4's block form (doa_tpu_torch/csrc/subspace.cu, the
MGS subspace iteration at 64 < 2N <= 128) on the CPU.

The kernel runs only on the card. Here its thread map (a column of W and
a half of E's rows a thread), the order in which the two halves' partial
Ws are summed, its MGS on one warp (4 columns a lane, the xor shuffle
tree), its persistent walk over windows, its init-row indexing and the
form predicate are transcribed from the source and run in torch: every
(row, column) of E is one thread's, every window is walked once for any
grid, and on exact inputs (E a signed permutation a window, inits rows of
it) the model gives `mgs_iterate_plain`'s Vt, W and Vt_prev bit for
bit. The constants are read from the source, so the model and the kernel
cannot drift apart unseen."""

import dataclasses
import os
import re

import pytest
import torch

from doa_tpu.configs import (ArrayGeometry, DoaConfig, Estimator,
                             GridSpec1D, PRESETS)
from doa_tpu_torch.ops import cpx_ops
from doa_tpu_torch.plan import kernel_routes

SRC = os.path.join(os.path.dirname(cpx_ops.__file__), "..", "csrc",
                   "subspace.cu")
with open(SRC) as _f:
    SOURCE = _f.read()


def const(name):
    m = re.findall(rf"constexpr (?:int|size_t) {name} = (\d+);", SOURCE)
    assert len(m) == 1, name
    return int(m[0])


WARP_MAX_N2 = const("WARP_MAX_N2")
BLOCK_THREADS = const("BLOCK_THREADS")
BLOCKS_PER_SM = const("BLOCKS_PER_SM")
MAX_N2, MAX_K2 = const("MAX_N2"), const("MAX_K2")
SM_BYTES, BLOCK_RESERVED = 233472, 1024      # an H100 SM's shared memory


def threads(n2):
    """Each thread's (column j, half, first pair, end pair, active), as
    the block kernel's head: j = 32 (warp % 4) + lane, rows of half h the
    pairs [0, P/2) or [P/2, P) of P = n2 / 2."""
    P = n2 // 2
    out = []
    for tid in range(BLOCK_THREADS):
        warp, lane = tid >> 5, tid & 31
        j, half = (warp & 3) * 32 + lane, warp >> 2
        p0, p1 = (P // 2, P) if half else (0, P // 2)
        out.append((j, half, p0, p1, j < n2))
    return out


def walk(B, fit):
    """The persistent grid (every block that fits, at most B) and each
    block's windows k, k + grid, ... with the mbarrier parity of each."""
    grid = min(B, fit)
    return grid, [[(b, t & 1) for t, b in enumerate(range(k, B, grid))]
                  for k in range(grid)]


def init_rows(init, B):
    """The wrapper's init and group (init_group = B // m) and the row each
    window starts from (b / init_group in the kernel)."""
    m, init = cpx_ops._init_rows(init, B)
    group = B // m
    init = init.contiguous()
    return torch.stack([init[b // group] for b in range(B)])


def warp_sum(x):
    """__shfl_xor_sync's tree over the 32 lanes (last axis), in order."""
    idx = torch.arange(32)
    for off in (16, 8, 4, 2, 1):
        x = x + x[..., idx ^ off]
    return x


def mgs_rows(W, n2, passes):
    """block_mgs: W f32[B, K2, n2] → orthonormal rows; lane l holds
    columns l + 32c, c < 4, each dot product the lane's 4 products in c
    order, then the tree (mgs_rows and, at K2 = 8, mgs<4> alike)."""
    B, K2, _ = W.shape
    v = torch.zeros(B, K2, 32, 4)
    for c in range(4):
        for lane in range(32):
            if lane + 32 * c < n2:
                v[:, :, lane, c] = W[:, :, lane + 32 * c]
    mask = torch.tensor([[float(l + 32 * c < n2) for c in range(4)]
                         for l in range(32)]) > 0
    v = list(v.unbind(1))
    for i in range(K2):
        for _ in range(passes):
            for u in range(i):
                d = torch.zeros(B, 32)
                for c in range(4):
                    d = torch.where(mask[:, c], d + v[u][..., c] * v[i][..., c],
                                    d)
                d = warp_sum(d)[..., None]
                v[i] = torch.where(mask, v[i] - d * v[u], v[i])
        s = torch.zeros(B, 32)
        for c in range(4):
            s = s + v[i][..., c] * v[i][..., c]
        r = torch.rsqrt(warp_sum(s).clamp_min(1e-30))[..., None]
        v[i] = v[i] * r
    out = torch.stack(v, 1)                        # (B, K2, 32, 4)
    return out.permute(0, 1, 3, 2).reshape(B, K2, 128)[..., :n2].contiguous()


def apply_rows(E, V, p0, p1):
    """A half's partial W: rows 2p0 .. 2p1 - 1 summed in row order."""
    acc = torch.zeros(V.shape)
    for p in range(p0, p1):
        acc = acc + V[:, :, 2 * p, None] * E[:, None, 2 * p, :]
        acc = acc + V[:, :, 2 * p + 1, None] * E[:, None, 2 * p + 1, :]
    return acc


def block_model(E, K2, rounds, init=None):
    """The block kernel's schedule on every window at once → (Vt, W,
    Vt_prev): cold MGS of E's first K2 rows or the window's init row;
    rounds - 1 applies each followed by MGS (two passes the last), or one
    apply for the detector; W = part0 + part1."""
    n2 = E.shape[-1]
    P = n2 // 2
    VW = (mgs_rows(E[:, :K2, :], n2, 1) if init is None
          else init_rows(init, E.shape[0]).clone())
    applies, orth = (rounds - 1, True) if rounds > 1 else (1, False)
    for r in range(applies):
        last = r == applies - 1
        part0 = apply_rows(E, VW, 0, P // 2)
        part1 = apply_rows(E, VW, P // 2, P)
        if last:
            Vprev, Vt = VW, VW
        W = part0 + part1
        if orth:
            VW = mgs_rows(W, n2, 2 if last else 1)
            if last:
                Vt = VW
    return Vt, W, Vprev


def signed_permutations(B, n2, seed):
    g = torch.Generator().manual_seed(seed)
    perm = torch.argsort(torch.rand((B, n2), generator=g), dim=-1)
    sign = torch.randint(0, 2, (B, n2), generator=g).float() * 2 - 1
    E = torch.zeros((B, n2, n2))
    E.scatter_(2, perm[..., None], sign[..., None])
    return E


def old_mgs_takes(n2, k2):
    """mgs_takes before the block form."""
    return n2 <= 128 and n2 % 2 == 0 and k2 <= min(n2, 8)


def test_form_predicate_is_the_sources():
    """cpx_ops.mgs_form names the form the C entry dispatches to
    (block_form: n2 > WARP_MAX_N2), and mgs_takes still takes every shape
    it took before."""
    assert "return n2 > WARP_MAX_N2;" in SOURCE
    assert cpx_ops.MGS_WARP_MAX_N2 == WARP_MAX_N2
    assert (cpx_ops.MGS_MAX_N2, cpx_ops.MGS_MAX_K2) == (MAX_N2, MAX_K2)
    for n2 in range(0, 260):
        for k2 in range(0, 20):
            form = cpx_ops.mgs_form(n2, k2)
            assert cpx_ops.mgs_takes(n2, k2) == old_mgs_takes(n2, k2)
            assert (form is not None) == old_mgs_takes(n2, k2)
            if form is not None:
                assert form == ("block" if n2 > WARP_MAX_N2 else "warp")


@pytest.mark.parametrize("n2", [66, 96, 98, 126, 128, 24, 32])
def test_every_row_and_column_is_one_threads(n2):
    """Each (row n, column j) of E, n, j < n2, is summed by one active
    thread: 4 column groups of 32 cover MAX_N2, two halves of the row
    pairs cover the rows."""
    assert BLOCK_THREADS == 256 and 4 * 32 >= MAX_N2
    seen = torch.zeros((n2, n2), dtype=torch.int32)
    for j, half, p0, p1, active in threads(n2):
        if active:
            seen[2 * p0:2 * p1, j] += 1
    assert bool((seen == 1).all())


@pytest.mark.parametrize("K2", [2, 4, 6, 8])
def test_three_blocks_fit_an_sm(K2):
    """The header's arithmetic: E, Vt/W and X a block (+ the mbarrier
    and the reserved KiB) leave BLOCKS_PER_SM blocks resident at
    n2 = 128, and the launch bounds' 80 registers a thread fit them in
    the SM's 65536."""
    assert "__launch_bounds__(BLOCK_THREADS, BLOCKS_PER_SM)" in SOURCE
    smem = 4 * (MAX_N2 * MAX_N2 + 2 * K2 * MAX_N2) + 8 + BLOCK_RESERVED
    assert BLOCKS_PER_SM * smem <= SM_BYTES
    assert 65536 // (BLOCK_THREADS * BLOCKS_PER_SM) // 8 * 8 == 80


@pytest.mark.parametrize("B,fit", [(1, 396), (16, 396), (2048, 396),
                                   (32768, 396), (1001, 264), (7, 3)])
def test_walk_takes_every_window_once(B, fit):
    grid, runs = walk(B, fit)
    got = sorted(b for run in runs for b, _ in run)
    assert got == list(range(B))
    assert grid == min(B, fit)
    for run in runs:                     # parity flips a window
        assert [p for _, p in run] == [t & 1 for t in range(len(run))]


@pytest.mark.parametrize("grouping", ["one", "group", "window", "expand"])
def test_init_rows_index_as_plain(grouping):
    """Window b starts from init row b / (B // m): one init, one per
    group of consecutive windows, one per window, and an init expanded
    over the windows (stride 0), as mgs_iterate_plain's expand."""
    B, K2, n2 = 12, 4, 128
    init = torch.randn(B, K2, n2)
    ini = {"one": init[:1], "group": init[:3], "window": init,
           "expand": init[:1].expand(B, -1, -1)}[grouping]
    m, ref = cpx_ops._init_rows(ini, B)
    want = ref[:, None].expand(m, B // m, K2, n2).reshape(B, K2, n2)
    assert torch.equal(init_rows(ini, B), want)


def exact_case(n2, K2, B, grouping, seed):
    E = signed_permutations(B, n2, seed)
    if grouping is None:
        return E, None
    m = {"one": 1, "group": 3, "window": B, "expand": 1}[grouping]
    # distinct signed unit rows of a window of each group: orthonormal
    init = E[torch.arange(m) * (B // m), :K2, :].clone()
    if grouping == "expand":
        init = init.expand(B, -1, -1)
    return E, init


@pytest.mark.parametrize("K2,n2", [(2, 66), (4, 128), (8, 128), (6, 96)])
@pytest.mark.parametrize("grouping", [None, "one", "group", "window",
                                      "expand"])
@pytest.mark.parametrize("rounds", [1, 3])
def test_model_is_plain_on_exact_inputs(K2, n2, grouping, rounds):
    """E a signed permutation a window (every dot product 0, every norm 1,
    every sum exact in any order): the model's Vt, W and Vt_prev equal
    mgs_iterate_plain's bit for bit, cold and from each init grouping, at
    a ragged B."""
    B = 9
    E, init = exact_case(n2, K2, B, grouping, seed=K2 * n2 + rounds)
    got = block_model(E, K2, rounds, init)
    want = cpx_ops.mgs_iterate_plain(E, K2 // 2, rounds, init)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_model_is_plain_on_exact_inputs_at_eight_rounds():
    E = signed_permutations(6, 128, seed=5)
    for ini in (None, E[::3, :4, :].clone()):
        got = block_model(E, 4, 8, ini)
        want = cpx_ops.mgs_iterate_plain(E, 2, 8, ini)
        for a, b in zip(got, want):
            assert torch.equal(a, b)


def test_model_near_plain_on_a_scene():
    """A planted spectrum (2 strong directions over a noise floor): the
    model's projectors within 1e-5 of the plain version's, and W within
    1e-5 of max|W| (the tolerances chip_smoke.py holds the kernel to)."""
    g = torch.Generator().manual_seed(7)
    n2, B = 128, 4
    Q, _ = torch.linalg.qr(torch.randn(n2, n2, generator=g,
                                       dtype=torch.float64))
    lam = torch.full((n2,), 0.1, dtype=torch.float64)
    lam[:4] = torch.tensor([100.0, 100.0, 40.0, 40.0])
    E0 = (Q * lam) @ Q.T
    E = (E0 + 0.01 * torch.randn(B, n2, n2, generator=g,
                                 dtype=torch.float64))
    E = (0.5 * (E + E.transpose(1, 2))).float()
    for rounds in (3, 8):
        got = block_model(E, 4, rounds)
        want = cpx_ops.mgs_iterate_plain(E, 2, rounds)
        pg, pw = (v.transpose(1, 2) @ v for v in (got[0], want[0]))
        assert (pg - pw).abs().max().item() <= 1e-5
        assert ((got[1] - want[1]).abs().max()
                / want[1].abs().max()).item() <= 1e-5


def _ula48():
    return DoaConfig(
        geometry=ArrayGeometry(kind="ula", num_elements=48,
                               norm_spacing=0.5),
        snapshot_size=1024, num_sources=2, estimators=(Estimator.MUSIC,),
        grid=GridSpec1D(num_points=256), num_max_vals=2)


def _c5(**over):
    c5 = PRESETS["c5_ura64_wideband"]
    S = over.pop("snapshot_size", c5.snapshot_size)
    return dataclasses.replace(
        c5, snapshot_size=S,
        wideband=dataclasses.replace(c5.wideband, **over))


@pytest.mark.parametrize("name,make,stage", [
    ("c5", lambda: PRESETS["c5_ura64_wideband"], "subspace"),
    ("c5_f12", lambda: _c5(num_subbands=12, snapshot_size=768),
     "subspace"),
    ("c5 cssm", lambda: _c5(fusion="cssm"), "subspace"),
    ("c5 cssm_auto", lambda: _c5(fusion="cssm_auto"), "coarse_subspace"),
    ("c5 cssm_auto", lambda: _c5(fusion="cssm_auto"), "subspace"),
    ("ULA-48", _ula48, "subspace"),
])
def test_block_form_shapes_stay_planned_on_k4(name, make, stage):
    """The shapes that launched K4 at 2N > 64 before the block form still
    plan it: the c5 paths at 2N = 128 and ULA-48 at 2N = 96."""
    routes = kernel_routes(make())
    kernel, takes = routes[stage]
    assert (kernel, takes) == ("mgs_iterate", True), (name, routes)
    cfg = make()                         # no smoothing: 2N elements
    assert cpx_ops.mgs_form(2 * cfg.geometry.num_elements,
                            2 * cfg.num_sources) == "block"
