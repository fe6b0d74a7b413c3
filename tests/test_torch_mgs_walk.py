"""The work split of K4 (doa_tpu_torch/csrc/subspace.cu, the MGS subspace
iteration) on the CPU, in both of its forms.

The kernel runs only on the card. Here its work split is transcribed from
the source and run in torch:

* the block form (64 < 2N <= 128): its thread map (a column of W and a
  half of E's rows a thread), the order in which the two halves' partial
  Ws are summed, its MGS on one warp (4 columns a lane, the xor shuffle
  tree), its persistent walk over windows;
* the group form (2N <= 64): a window per group of L = 4, 8 or 16 lanes
  (by 2N), lane gl holding columns gl + L c of every row, each dot
  product the lane's products then a log2(L)-level xor tree inside the
  group, each apply summed in row order, E's slots L banks apart, the
  persistent walk of groups over windows;

and the init-row indexing and the form predicate. Every (row, column) of
E is one thread's, every (window, column) one lane's of one group, every
window is walked once for any grid, and on exact inputs (E a signed
permutation a window, inits rows of it) each model gives
`mgs_iterate_plain`'s Vt, W and Vt_prev bit for bit. The constants are
read from the source, so the models and the kernel cannot drift apart
unseen."""

import dataclasses
import os
import re

import pytest
import torch

from doa_tpu.configs import (ArrayGeometry, DoaConfig, Estimator,
                             GridSpec1D, PRESETS)
from doa_tpu_torch.ops import cpx_ops
from doa_tpu_torch.plan import kernel_forms, kernel_routes

SRC = os.path.join(os.path.dirname(cpx_ops.__file__), "..", "csrc",
                   "subspace.cu")
with open(SRC) as _f:
    SOURCE = _f.read()


def const(name):
    m = re.findall(rf"constexpr (?:int|size_t) {name} = (\d+);", SOURCE)
    assert len(m) == 1, name
    return int(m[0])


GROUP_MAX_N2 = const("GROUP_MAX_N2")
GROUP_THREADS = const("GROUP_THREADS")
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


def group_sum(x, L=32):
    """group_sum<L>: __shfl_xor_sync's tree over the L lanes of a group
    (last axis), offsets L/2 ... 1 in order (L = 32: warp_sum's)."""
    idx = torch.arange(L)
    off = L // 2
    while off:
        x = x + x[..., idx ^ off]
        off //= 2
    return x


def mgs_rows(W, n2, passes, L=32, C=4):
    """mgs_rows<K2, L, C>: W f32[B, K2, n2] → orthonormal rows; lane l of
    the group holds columns l + Lc, c < C, each dot product the lane's C
    products in c order, then the group's tree. L = 32, C = 4 is the block
    form's block_mgs (mgs_rows<K2, 32, 4> and, at K2 = 8, mgs<4> alike)."""
    B, K2, _ = W.shape
    v = torch.zeros(B, K2, L, C)
    for c in range(C):
        for lane in range(L):
            if lane + L * c < n2:
                v[:, :, lane, c] = W[:, :, lane + L * c]
    mask = torch.tensor([[float(l + L * c < n2) for c in range(C)]
                         for l in range(L)]) > 0
    v = list(v.unbind(1))
    for i in range(K2):
        for _ in range(passes):
            for u in range(i):
                d = torch.zeros(B, L)
                for c in range(C):
                    d = torch.where(mask[:, c], d + v[u][..., c] * v[i][..., c],
                                    d)
                d = group_sum(d, L)[..., None]
                v[i] = torch.where(mask, v[i] - d * v[u], v[i])
        s = torch.zeros(B, L)
        for c in range(C):
            s = s + v[i][..., c] * v[i][..., c]
        r = torch.rsqrt(group_sum(s, L).clamp_min(1e-30))[..., None]
        v[i] = v[i] * r
    out = torch.stack(v, 1)                        # (B, K2, L, C)
    return out.permute(0, 1, 3, 2).reshape(B, K2, L * C)[..., :n2].contiguous()


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


def group_width(n2):
    """group_width: the lanes of a window's group."""
    return 4 if n2 <= 16 else 8 if n2 <= 32 else 16


def group_columns(n2):
    """launch_group_k's (L, C) of n2: C = ceil(n2 / L) by its switch."""
    L = group_width(n2)
    if L == 4:
        return L, (n2 + 3) // 4
    return L, (3 if n2 <= (24 if L == 8 else 48) else 4)


def group_lanes(n2):
    """Each thread's (group of the block, lane gl, [(c, column, ok)]), as
    the group kernel's head: column gl + L c, ok = c < C - 1 or the column
    lies in the window."""
    L, C = group_columns(n2)
    out = []
    for tid in range(GROUP_THREADS):
        grp, gl = tid // L, tid % L
        cols = [(c, gl + L * c, c < C - 1 or gl + L * c < n2)
                for c in range(C)]
        out.append((grp, gl, cols))
    return out


def group_walk(B, G, fit):
    """The group form's persistent grid (every block that fits, no more
    than ceil(B / G)) and each group's windows q, q + grid G, ... with the
    mbarrier parity of each; group q = block · G + group of the block."""
    grid = min(-(-B // G), fit)
    stride = grid * G
    return grid, [[(b, t & 1) for t, b in enumerate(range(q, B, stride))]
                  for q in range(stride)]


def group_model(E, K2, rounds, init=None):
    """The group kernel's schedule on every window at once → (Vt, W,
    Vt_prev): cold MGS of E's first K2 rows or the window's init row;
    applies W = Vt E summed in row order; rounds - 1 applies each followed
    by MGS (two passes the last), or one apply for the detector; MGS over
    the group's L lanes of C columns each."""
    n2 = E.shape[-1]
    L, C = group_columns(n2)
    V = (mgs_rows(E[:, :K2, :], n2, 1, L, C) if init is None
         else init_rows(init, E.shape[0]).clone())
    applies, orth = (rounds - 1, True) if rounds > 1 else (1, False)
    for r in range(applies):
        last = r == applies - 1
        W = apply_rows(E, V, 0, n2 // 2)
        if last:
            Vprev, Vt = V, V
        if orth:
            V = mgs_rows(W, n2, 2 if last else 1, L, C)
            if last:
                Vt = V
    return Vt, W, Vprev


def model(n2):
    """The model of the form that takes n2."""
    return block_model if n2 > GROUP_MAX_N2 else group_model


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
    (block_form: n2 > GROUP_MAX_N2, else the group form), and mgs_takes
    still takes every shape it took before."""
    assert "return n2 > GROUP_MAX_N2;" in SOURCE
    assert cpx_ops.MGS_GROUP_MAX_N2 == GROUP_MAX_N2 == 64
    assert cpx_ops.MGS_FORMS == ("group", "block")
    assert (cpx_ops.MGS_MAX_N2, cpx_ops.MGS_MAX_K2) == (MAX_N2, MAX_K2)
    for n2 in range(0, 260):
        for k2 in range(0, 20):
            form = cpx_ops.mgs_form(n2, k2)
            assert cpx_ops.mgs_takes(n2, k2) == old_mgs_takes(n2, k2)
            assert (form is not None) == old_mgs_takes(n2, k2)
            if form is not None:
                assert form == ("block" if n2 > GROUP_MAX_N2 else "group")


def test_group_shape_rules_are_the_sources():
    """group_width, group_slot and launch_group_k's choice of C, as the
    models read them: L = 4, 8, 16 by n2 and C = ceil(n2 / L) <= 4 for
    every even n2 <= GROUP_MAX_N2."""
    assert "return n2 <= 16 ? 4 : n2 <= 32 ? 8 : 16;" in SOURCE
    assert "return (n2 * n2 + 31) / 32 * 32 + L;" in SOURCE
    assert "case 8: return n2 <= 24 ? DOA_GROUP(8, 3) : DOA_GROUP(8, 4);" \
        in SOURCE
    assert "default: return n2 <= 48 ? DOA_GROUP(16, 3) : DOA_GROUP(16, 4);" \
        in SOURCE
    assert "switch ((n2 + 3) / 4) {" in SOURCE
    for n2 in range(2, GROUP_MAX_N2 + 1, 2):
        L, C = group_columns(n2)
        assert C == -(-n2 // L) <= 4 and GROUP_THREADS % L == 0


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


@pytest.mark.parametrize("n2", [2, 8, 14, 16, 18, 24, 26, 32, 34, 48,
                                50, 64])
def test_every_window_column_is_one_lanes(n2):
    """Each column j < n2 of a group's window is held by one lane of the
    group with ok set, and no lane holds a column outside the window with
    ok set; ok's shortcut (c < C - 1) is the plain test j < n2. The
    warp's groups read a row of their slots L banks apart: each (row,
    column slot) load of a warp touches 32 distinct banks; their Vt
    areas start in distinct float4 bank quads, for every K2."""
    L, C = group_columns(n2)
    G = GROUP_THREADS // L
    seen = torch.zeros((G, n2), dtype=torch.int32)
    for grp, gl, cols in group_lanes(n2):
        for c, j, ok in cols:
            assert ok == (j < n2)
            if ok:
                seen[grp, j] += 1
    assert bool((seen == 1).all())
    slot = (n2 * n2 + 31) // 32 * 32 + L
    for warp in range(GROUP_THREADS // 32):
        for n in range(n2):
            for c in range(C):
                banks = {(grp * slot + n * n2 + gl + L * c) % 32
                         for grp, gl, _ in group_lanes(n2)[32 * warp:
                                                            32 * warp + 32]}
                assert len(banks) == 32
    assert "return L * C * vt_pad(K2) + 4;" in SOURCE
    assert "return (K2 + 3) / 4 * 4;" in SOURCE
    for K2 in (2, 4, 6, 8):
        vt = L * C * ((K2 + 3) // 4 * 4) + 4
        for warp in range(GROUP_THREADS // 32):
            quads = {(grp * vt) % 32 // 4 for grp in
                     range(warp * 32 // L, (warp + 1) * 32 // L)}
            assert len(quads) == 32 // L


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


@pytest.mark.parametrize("B,n2,fit", [(1, 32, 792), (1001, 32, 792),
                                      (16384, 32, 792), (8192, 16, 1716),
                                      (16384, 24, 792), (7, 64, 3),
                                      (1001, 8, 5)])
def test_group_walk_takes_every_window_once(B, n2, fit):
    """Every window once, for a ragged B and a grid cut to what fits; the
    parity flips a window of a group."""
    G = GROUP_THREADS // group_width(n2)
    grid, runs = group_walk(B, G, fit)
    got = sorted(b for run in runs for b, _ in run)
    assert got == list(range(B))
    assert grid == min(-(-B // G), fit)
    for run in runs:
        assert [p for _, p in run] == [t & 1 for t in range(len(run))]
    assert "int b = blockIdx.x * G + grp;" in SOURCE
    assert "const int stride = gridDim.x * G;" in SOURCE


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


@pytest.mark.parametrize("K2,n2", [(2, 66), (4, 128), (8, 128), (6, 96),
                                   (2, 8), (4, 16), (4, 32), (6, 24),
                                   (8, 32), (2, 34), (6, 48), (8, 64)])
@pytest.mark.parametrize("grouping", [None, "one", "group", "window",
                                      "expand"])
@pytest.mark.parametrize("rounds", [1, 3])
def test_model_is_plain_on_exact_inputs(K2, n2, grouping, rounds):
    """E a signed permutation a window (every dot product 0, every norm 1,
    every sum exact in any order): the model of the form that takes n2
    (block above 64, group at or below) gives mgs_iterate_plain's Vt, W
    and Vt_prev bit for bit, cold and from each init grouping, at a
    ragged B."""
    B = 9
    E, init = exact_case(n2, K2, B, grouping, seed=K2 * n2 + rounds)
    got = model(n2)(E, K2, rounds, init)
    want = cpx_ops.mgs_iterate_plain(E, K2 // 2, rounds, init)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_model_is_plain_on_exact_inputs_at_eight_rounds():
    """Both forms' models at 8 rounds (the block form at 2N = 128, the
    group form at the headline's 32 and c3's 24)."""
    for n2 in (128, 32, 24):
        E = signed_permutations(6, n2, seed=5)
        for ini in (None, E[::3, :4, :].clone()):
            got = model(n2)(E, 4, 8, ini)
            want = cpx_ops.mgs_iterate_plain(E, 2, 8, ini)
            for a, b in zip(got, want):
                assert torch.equal(a, b)


def test_model_near_plain_on_a_scene():
    """A planted spectrum (2 strong directions over a noise floor): each
    form's model (the block form at 2N = 128, the group form at 32, 24
    and 16) gives projectors within 1e-5 of the plain version's, and W
    within 1e-5 of max|W| (the tolerances chip_smoke.py holds the kernel
    to)."""
    for n2 in (128, 32, 24, 16):
        scene_case(n2)


def scene_case(n2):
    g = torch.Generator().manual_seed(7)
    B = 4
    Q, _ = torch.linalg.qr(torch.randn(n2, n2, generator=g,
                                       dtype=torch.float64))
    lam = torch.full((n2,), 0.1, dtype=torch.float64)
    lam[:4] = torch.tensor([100.0, 100.0, 40.0, 40.0])
    E0 = (Q * lam) @ Q.T
    E = (E0 + 0.01 * torch.randn(B, n2, n2, generator=g,
                                 dtype=torch.float64))
    E = (0.5 * (E + E.transpose(1, 2))).float()
    for rounds in (3, 8):
        got = model(n2)(E, 4, rounds)
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


def _beams(n):
    base = PRESETS["c4_ula16_streaming"]
    return dataclasses.replace(base, beamspace=dataclasses.replace(
        base.beamspace, num_beams=n))


@pytest.mark.parametrize("name,make,stage,form", [
    ("c1", lambda: PRESETS["c1_ula4_tone"], "subspace", "group"),
    ("c2", lambda: PRESETS["c2_ula8_2src"], "subspace", "group"),
    ("c3", lambda: PRESETS["c3_ula16_calib_smooth"], "subspace", "group"),
    ("c4", lambda: PRESETS["c4_ula16_streaming"], "subspace", "group"),
    ("fast_bf16", lambda: PRESETS["fast_bf16"], "subspace", "group"),
    ("8 beams", lambda: _beams(8), "subspace", "group"),
    ("ULA-48", _ula48, "subspace", "block"),
    ("c5", lambda: PRESETS["c5_ura64_wideband"], "subspace", "block"),
    ("c5 cssm_auto", lambda: _c5(fusion="cssm_auto"), "coarse_subspace",
     "block"),
])
def test_plan_names_k4_form(name, make, stage, form):
    """kernel_forms names the form K4 launches at each stage's (2N, 2K):
    the group form on every narrowband preset (2N = 8 to 32) and under
    beamspace (2Nb = 16), the block form at 2N > 64."""
    cfg = make()
    routes = kernel_routes(cfg)
    assert routes[stage][0] == "mgs_iterate", (name, routes)
    assert kernel_forms(cfg, routes)[stage] == form
