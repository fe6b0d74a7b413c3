"""The warp form of kernel 11 (doa_tpu_torch/csrc/subspace_ns.cu, the cold
Newton–Schulz subspace at 2N <= 64, 2K <= 8) on the CPU.

The kernel runs only on the card. Here its form predicate, its lane maps
(a lane's columns of Vt; the chain's entries on half-warps, Y on lanes
0-15 and Z on 16-31, RPS rows a slot) and the shuffle sources of its
chain are transcribed from the source, and the warp form is run in torch
lane by lane: the trace and Gram as the xor shuffle tree, each product
summed in the kernel's order, the chain's operands fetched from the
lanes the kernel reads, Z's columns read back from its transposed copy
in shared memory. The transcription agrees with `subspace_ns_plain`
within chip_smoke.py's tolerances for kernel 11 on the card. The
constants are read from the source, so the model and the kernel cannot
drift apart unseen."""

import dataclasses
import os
import re

import numpy as np
import pytest
import torch

from doa_tpu.configs import ArrayGeometry, DoaConfig, Estimator, GridSpec1D
from doa_tpu_torch import _build
from doa_tpu_torch.cpx import embed_planes
from doa_tpu_torch.ops.cpx_ops import mgs_form
from doa_tpu_torch.ops.cuda import subspace_ns as sns
from doa_tpu_torch.pipeline_torch import build_pipeline_torch
from doa_tpu_torch.plan import Plan, kernel_forms, kernel_routes, subspace_n2

SRC = os.path.join(os.path.dirname(sns.__file__), "..", "..", "csrc",
                   "subspace_ns.cu")
with open(SRC) as _f:
    SOURCE = _f.read()
NS_PROJ_TOL, NS_ORTH_TOL = 2e-5, 2e-4     # chip_smoke.py's, kernel 11


def const(name):
    m = re.findall(rf"constexpr (?:int|size_t) {name} = (\d+);", SOURCE)
    assert len(m) == 1, name
    return int(m[0])


WARP_MAX_N2, WARP_MAX_K2 = const("WARP_MAX_N2"), const("WARP_MAX_K2")
MAX_N2, MAX_K2 = const("MAX_N2"), const("MAX_K2")


def rps(K2):
    """Chain rows a slot (`constexpr int RPS = 16 / K2;`)."""
    return 16 // K2


def slots(K2):
    """Chain entries a lane (`SLOTS = (K2 + RPS - 1) / RPS`)."""
    return -(-K2 // rps(K2))


def cpl(n2):
    """Columns of a row a lane: the entry instantiated for n2."""
    return 1 if n2 <= 32 else 2


def chain_entry(lane, s, K2):
    """(half, k, l, active) of lane's slot s: half lane / 16 holds Y (0)
    or Z (1); lane i = lane % 16 holds (s RPS + i / K2, i % K2)."""
    h, i = lane >> 4, lane & 15
    k, l = s * rps(K2) + i // K2, i % K2
    return h, k, l, i < rps(K2) * K2 and k < K2


def holder(h, k, l, K2):
    """(lane, slot) that holds entry (k, l) of half h."""
    return 16 * h + (k % rps(K2)) * K2 + l, k // rps(K2)


def old_ns_takes(n2, k2):
    """ns_takes before the warp form."""
    return n2 <= 128 and n2 % 2 == 0 and k2 <= 16


def test_form_predicate_is_the_sources():
    """ns_form names the form the C entry dispatches to (warp_form: n2 <=
    WARP_MAX_N2 and K2 <= WARP_MAX_K2), ns_takes takes what it took
    before the warp form, and every shape it takes has a form."""
    assert "return n2 <= WARP_MAX_N2 && K2 <= WARP_MAX_K2;" in SOURCE
    assert "warp_form(n2, K2) ? 1 : 0" in SOURCE
    assert "constexpr int RPS = 16 / K2;" in SOURCE
    assert "constexpr int SLOTS = (K2 + RPS - 1) / RPS;" in SOURCE
    assert (sns.NS_WARP_MAX_N2, sns.NS_WARP_MAX_K2) == (WARP_MAX_N2,
                                                        WARP_MAX_K2)
    assert (sns.NS_MAX_N2, sns.NS_MAX_K2) == (MAX_N2, MAX_K2)
    for n2 in range(0, 260):
        for k2 in range(0, 20, 2):
            takes = sns.ns_takes(n2, k2)
            assert takes == old_ns_takes(n2, k2), (n2, k2)
            want = (None if not takes else "warp"
                    if n2 <= WARP_MAX_N2 and k2 <= WARP_MAX_K2 else "block")
            assert sns.ns_form(n2, k2) == want, (n2, k2)


@pytest.mark.parametrize("K2", [2, 4, 6, 8])
def test_chain_lane_map_holds_each_entry_once(K2):
    """Every entry of Y (lanes 0-15) and of Z (lanes 16-31) is one active
    (lane, slot)'s, and the shuffles of a step read the lane that holds
    the operand: a row k of Z and of (Y | T) at 16 h + rl + m in the
    lane's own slot, a column l at (m % RPS) K2 + l in slot m / RPS, Z's
    entry (k, lo) of the output at 16 + (k % RPS) K2 + lo."""
    seen = {}
    for lane in range(32):
        for s in range(slots(K2)):
            h, k, l, active = chain_entry(lane, s, K2)
            if active:
                assert (h, k, l) not in seen
                seen[h, k, l] = (lane, s)
    assert set(seen) == {(h, k, l) for h in (0, 1) for k in range(K2)
                         for l in range(K2)}
    for (h, k, l), (lane, s) in seen.items():
        assert holder(h, k, l, K2) == (lane, s)
        i = lane & 15
        rl = i - l
        for m in range(K2):
            for hh in (0, 1):
                assert seen[hh, k, m] == (16 * hh + rl + m, s)
                assert seen[hh, m, l] == ((m % rps(K2)) * K2 + l
                                          + 16 * hh, m // rps(K2))
    assert slots(K2) <= 4 and rps(K2) * K2 <= 16


@pytest.mark.parametrize("n2", [2, 16, 24, 30, 32, 34, 48, 62, 64])
def test_every_column_is_one_lanes(n2):
    """Lane l holds columns l + 32c, c < CPL: each column of Vt once."""
    cols = [lane + 32 * c for lane in range(32) for c in range(cpl(n2))
            if lane + 32 * c < n2]
    assert sorted(cols) == list(range(n2))


def warp_sum(x):
    """__shfl_xor_sync's tree over the 32 lanes (last axis), in order."""
    idx = torch.arange(32)
    for off in (16, 8, 4, 2, 1):
        x = x + x[..., idx ^ off]
    return x


def shfl(x, src):
    """__shfl_sync: lane t reads x[..., src[t] % 32]."""
    return x[..., torch.as_tensor(src) % 32]


def orthonormalise(v, n_ns, K2):
    """The kernel's `orthonormalise` on v[b][k][lane][c] (Vt's column
    lane + 32c of row k) → the new v."""
    B = v.shape[0]
    R, S = rps(K2), slots(K2)
    lanes = torch.arange(32)
    h, i = lanes >> 4, lanes & 15
    l, rl = i % K2, i - i % K2
    g = {}
    for a in range(K2):
        for bb in range(a, K2):
            p = torch.zeros(B, 32)
            for c in range(v.shape[-1]):
                p = p + v[:, a, :, c] * v[:, bb, :, c]
            g[a, bb] = g[bb, a] = warp_sum(p)[:, 0]
    d = [1.0 / torch.sqrt(g[k, k].clamp_min(1e-30)) for k in range(K2)]
    fro2 = torch.zeros(B)
    for a in range(K2):
        for bb in range(K2):
            gt = g[a, bb] * d[bb] * d[a]
            fro2 = fro2 + gt * gt
    fro = torch.sqrt(fro2)
    inv = 1.0 / fro.clamp_min(1e-30)
    M = torch.zeros(B, 32, S)
    for s in range(S):
        for lane in range(32):
            hh, k, ll, active = chain_entry(lane, s, K2)
            if active:
                M[:, lane, s] = (float(k == ll) if hh
                                 else g[k, ll] * d[ll] * d[k] * inv)
    diag = torch.zeros(32, S)
    for s in range(S):
        diag[:, s] = ((s * R + i // K2) == l).float()
    for _ in range(n_ns):
        col = [shfl(M[:, :, m // R], (m % R) * K2 + l) for m in range(K2)]
        T = torch.zeros_like(M)
        for s in range(S):
            acc = torch.zeros(B, 32)
            for m in range(K2):
                acc = acc + shfl(M[:, :, s], 16 + rl + m) * col[m]
            T[:, :, s] = 1.5 * diag[:, s] - 0.5 * acc
        col = [shfl(torch.where(h > 0, M[:, :, m // R], T[:, :, m // R]),
                    16 * h + (m % R) * K2 + l) for m in range(K2)]
        new = torch.zeros_like(M)
        for s in range(S):
            acc = torch.zeros(B, 32)
            for m in range(K2):
                acc = acc + shfl(torch.where(h > 0, T[:, :, s], M[:, :, s]),
                                 16 * h + rl + m) * col[m]
            new[:, :, s] = acc
        M = new
    sc = 1.0 / torch.sqrt(fro.clamp_min(1e-30))
    Zs = torch.zeros(B, K2 * K2)             # Z transposed, from the upper
    for s in range(S):                      # half's lanes
        for lane in range(16, 32):
            _, k, lo, active = chain_entry(lane, s, K2)
            if active:
                Zs[:, lo * K2 + k] = M[:, lane, s]
    w = torch.zeros_like(v)
    for lo in range(K2):
        z = [Zs[:, lo * K2 + k] for k in range(K2)]
        s_ = torch.zeros(v[:, 0].shape)
        for k in range(K2):
            s_ = s_ + z[k][:, None, None] * (v[:, k] * d[k][:, None, None])
        w[:, lo] = s_ * sc[:, None, None]
    return w


def warp_model(E, K, iters, squarings, ns_iters=12, ns_iters_mid=8):
    """The warp kernel on every window at once: E f32[B, 2N, 2N] → Vt."""
    B, n2 = E.shape[0], E.shape[-1]
    K2, C = 2 * K, cpl(n2)
    dg = torch.diagonal(E, dim1=-2, dim2=-1)
    t0 = torch.zeros(B, 32)
    t1 = torch.zeros(B, 32)
    t0[:, :min(n2, 32)] = dg[:, :32]
    t1[:, :max(n2 - 32, 0)] = dg[:, 32:]
    tr = warp_sum(t0)[:, 0] + warp_sum(t1)[:, 0]
    A = E * (1.0 / (tr / n2).clamp_min(1e-30))[:, None, None]
    for _ in range(squarings):
        Sq = torch.zeros_like(A)
        for m in range(n2):
            Sq = Sq + A[:, :, m, None] * A[:, None, m, :]
        A = 0.5 * (Sq + Sq.transpose(1, 2))
    Ap = torch.zeros(B, n2, 32 * C)
    Ap[:, :, :n2] = A
    Ap = Ap.view(B, n2, C, 32).transpose(2, 3)      # [b, n, lane, c]
    v = Ap[:, :K2].clone()
    rounds = sns.ns_rounds(iters, squarings)
    for r in range(rounds):
        if r > 0:
            Vs = v.transpose(2, 3).reshape(B, K2, 32 * C)[..., :n2]
            acc = torch.zeros_like(v)
            for n in range(n2):
                acc = acc + Vs[:, :, n, None, None] * Ap[:, None, n]
            v = acc
        v = orthonormalise(v, ns_iters if r in (0, rounds - 1)
                           else ns_iters_mid, K2)
    return v.transpose(2, 3).reshape(B, K2, 32 * C)[..., :n2].contiguous()


def scene_E(N, angles, B=16, S=256, snr_db=10.0, seed=0):
    """B windows of K sources at `angles` on an N-element half-wavelength
    ULA, complex Gaussian signals and noise made with numpy → E f32[B,
    2N, 2N] (the embedded sample covariance)."""
    rng = np.random.default_rng(seed)
    a = np.exp(1j * np.pi * np.outer(np.arange(N),
                                     np.cos(np.deg2rad(angles))))
    s = (rng.standard_normal((B, len(angles), S))
         + 1j * rng.standard_normal((B, len(angles), S)))
    w = (rng.standard_normal((B, N, S))
         + 1j * rng.standard_normal((B, N, S))) * 10 ** (-snr_db / 20)
    X = a @ s + w
    R = X @ X.conj().transpose(0, 2, 1) / S
    return embed_planes(torch.tensor(R.real, dtype=torch.float32),
                        torch.tensor(R.imag, dtype=torch.float32))


@pytest.mark.parametrize("N,angles", [(16, (60.0, 110.0)),
                                      (12, (40.0, 70.0, 100.0)),
                                      (8, (60.0, 110.0))])
@pytest.mark.parametrize("squarings", [0, 2])
def test_warp_model_near_plain(N, angles, squarings):
    """The warp form's transcription against subspace_ns_plain at the
    phase-12 shapes (2N, 2K) = (32, 4), (24, 6), (16, 4): projectors
    within NS_PROJ_TOL, its rows orthonormal within NS_ORTH_TOL (8 rounds
    at squarings 0; iters 16 at squarings 2, except 8 at the headline's
    shape, as phase 12)."""
    K = len(angles)
    iters = 8 if squarings == 0 or N == 16 else 16
    E = scene_E(N, angles, seed=N + squarings)
    Vm = warp_model(E, K, iters, squarings)
    Vp = sns.subspace_ns_plain(E, K, iters=iters, squarings=squarings)
    dp = (Vm.transpose(1, 2) @ Vm - Vp.transpose(1, 2) @ Vp).abs().max()
    do = (Vm @ Vm.transpose(1, 2) - torch.eye(2 * K)).abs().max()
    assert dp <= NS_PROJ_TOL and do <= NS_ORTH_TOL, (dp, do)


def _ula(N, K, **over):
    return DoaConfig(
        geometry=ArrayGeometry(kind="ula", num_elements=N, norm_spacing=0.5),
        snapshot_size=1024, overlap=0, num_sources=K,
        estimators=(Estimator.MUSIC,), grid=GridSpec1D(num_points=1024),
        num_max_vals=K, power_schedule="e1", power_iters=8, **over)


@pytest.mark.parametrize("N,K,want", [(16, 2, "warp"), (12, 3, None),
                                      (8, 2, "warp"), (64, 2, "block"),
                                      (16, 5, "block")])
@pytest.mark.parametrize("spectra", [True, False])
def test_plan_names_kernel_11s_form(N, K, want, spectra):
    """Under subspace_impl="pallas" on the fused route the plan names
    kernel 11's form for its subspace stage: the warp form at the
    headline (ULA-16, K = 2) and ULA-8, the block form at 2N = 128 and
    2K = 10. ULA-12 at K = 3 is off the fused route (no kernel 11: K4,
    whose form the plan names). The default subspace_impl runs K4 and
    names K4's form (none where K4 does not take the shape and its plain
    version runs); on the CPU no form is named."""
    cfg = _ula(N, K, subspace_impl="pallas")
    routes = kernel_routes(cfg, return_spectra=spectra)
    plan = Plan(routes, forms=kernel_forms(cfg, routes))
    k4_form = mgs_form(subspace_n2(cfg), 2 * K)
    assert plan.forms.get("subspace") == (want if want is not None
                                          else k4_form)
    assert (plan.get("subspace") == "subspace_ns") == (want is not None)
    dflt = dataclasses.replace(cfg, subspace_impl="auto")
    r = kernel_routes(dflt, return_spectra=spectra)
    assert Plan(r, forms=kernel_forms(dflt, r)).forms.get("subspace") == \
        k4_form
    if want is not None:
        assert build_pipeline_torch(cfg, device="cpu").plan.forms == {}


def test_wrapper_forms_on_the_cpu():
    """A CPU tensor takes the plain version and counts no launch; a form
    that does not take the shape raises before any launch; ns_form names
    both forms."""
    E = scene_E(8, (60.0, 110.0), B=4)
    E128 = torch.eye(128).expand(2, 128, 128)
    with _build.counting() as n:
        assert torch.equal(sns.subspace_ns(E, 2),
                           sns.subspace_ns_plain(E, 2))
        for form in ("warp", "tile"):
            with pytest.raises(ValueError, match="form"):
                sns._launch(E128, 2, form)
    assert not n
    assert {sns.ns_form(16, 4), sns.ns_form(128, 4)} == set(
        sns.NS_FORMS) == {"warp", "block"}
