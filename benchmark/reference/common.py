"""What the plain references share: the precision they compute in, the
covariance Gram, the subspace iteration the configurations state, the
MUSIC denominator and the two peak rules.

Everything here is plain PyTorch on whatever device the inputs are on. It
imports nothing of the program under test. A `Prec` says how products are
computed:

* ``Prec("float64")``: the reference. Every product and sum in float64.
* ``Prec("tf32")``: the control. Float32 tensors, every matrix product on
  operands rounded to TF32 (10 explicit mantissa bits, to nearest even)
  and summed in float32, which is what the tensor cores do when a float32
  product is allowed to run in TF32. Elementwise work stays float32.
"""

from __future__ import annotations

import math

import torch


class Prec:
    """The precision a reference runs in: "float64" or "tf32"."""

    def __init__(self, name: str):
        if name not in ("float64", "tf32"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name
        self.dtype = torch.float64 if name == "float64" else torch.float32

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """a @ b in this precision (batched like torch.matmul)."""
        a, b = a.to(self.dtype), b.to(self.dtype)
        if self.name == "tf32":
            a, b = tf32_round(a), tf32_round(b)
        prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            return torch.matmul(a, b)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev

    @property
    def tiny(self) -> float:
        return torch.finfo(self.dtype).tiny


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 → the nearest TF32 value (10 mantissa bits, ties to even),
    still stored as float32. Finite inputs only."""
    b = x.contiguous().view(torch.int32)
    lsb = torch.bitwise_and(torch.bitwise_right_shift(b, 13), 1)
    b = torch.bitwise_and(b + 0x0FFF + lsb, ~0x1FFF)
    return b.view(torch.float32)


def cgram(prec: Prec, yr: torch.Tensor, yi: torch.Tensor, scale: float):
    """Planes yr, yi [..., S, N] of S samples → the planes (Rr, Ri)
    [..., N, N] of R = scale · Σ_t y_t y_tᴴ (R[a, b] = Σ y_a conj(y_b))."""
    yrT, yiT = yr.transpose(-1, -2), yi.transpose(-1, -2)
    rr = prec.mm(yrT, yr) + prec.mm(yiT, yi)
    ri = prec.mm(yiT, yr) - prec.mm(yrT, yi)
    return rr * scale, ri * scale


def embed(rr: torch.Tensor, ri: torch.Tensor) -> torch.Tensor:
    """(Rr, Ri) [..., N, N] → the real embedding [[Rr, −Ri], [Ri, Rr]]
    [..., 2N, 2N]: R acting on [re; im] as a real map."""
    return torch.cat([torch.cat([rr, -ri], dim=-1),
                      torch.cat([ri, rr], dim=-1)], dim=-2)


# ---------------------------------------------------------------------
# The power subspace: subspace iteration with modified Gram–Schmidt
# ---------------------------------------------------------------------

def mgs(V: torch.Tensor, passes: int = 1) -> torch.Tensor:
    """Modified Gram–Schmidt over the rows of V [..., k2, n2]."""
    rows = []
    for i in range(V.shape[-2]):
        v = V[..., i, :]
        for _ in range(passes):
            for u in rows:
                v = v - (u * v).sum(-1, keepdim=True) * u
        v = v * torch.rsqrt((v * v).sum(-1, keepdim=True).clamp_min(1e-30))
        rows.append(v)
    return torch.stack(rows, dim=-2)


def escalation_floor(subspace: dict, snapshots: int, n2: int) -> float:
    """The signal floor of the escalation detector at `snapshots` samples a
    window in an n2-dimensional embedding: the configured floor, raised
    to 1.5 × the noise bulk's edge (1 + √(n2/snapshots))²."""
    edge = (1.0 + math.sqrt(n2 / max(snapshots, 1))) ** 2
    return max(subspace["subspace_escalate_signal_floor"], 1.5 * edge)


def power_subspace(prec: Prec, E: torch.Tensor, k2: int, rounds: int,
                   init: torch.Tensor | None, esc: dict | None):
    """The signal subspace Vt [B, k2, n2] (rows orthonormal) of the
    embedded covariances E [B, n2, n2] by subspace iteration:

    * start from `init` [B, k2, n2] (warm), or cold from MGS of E's first
      k2 rows;
    * rounds − 1 times Vt ← MGS(Vt·E), two passes in the last round;
    * where `esc` is given ({gap, tol, floor, extra}), the detector on the
      last apply: a window whose captured directions are not invariant
      (residual > tol) or whose weakest one sits in the noise bulk
      (γ < gap), in a capture with a dominant component (γ_max ≥ floor),
      runs `extra` more rounds.

    → (Vt, number of windows that ran the extra rounds)."""
    n2 = E.shape[-1]
    Vt = mgs(E[..., :k2, :]) if init is None else init
    W = Vt_prev = None
    for r in range(rounds - 1):
        W = prec.mm(Vt, E)
        Vt_prev = Vt
        Vt = mgs(W, passes=2 if r == rounds - 2 else 1)
    if esc is None or esc["extra"] <= 0:
        return Vt, 0
    if W is None:
        Vt_prev = Vt
        W = prec.mm(Vt, E)
    scale = (torch.diagonal(E, dim1=-2, dim2=-1).sum(-1) / n2).clamp_min(
        1e-30)
    lam = (W * Vt_prev).sum(-1) / scale[:, None]
    noise = ((n2 - lam.sum(-1)) / (n2 - k2)).clamp_min(1e-30)
    gamma = lam.min(-1).values / noise
    gamma_max = lam.max(-1).values / noise
    C = prec.mm(W, Vt_prev.transpose(-1, -2))
    w2 = (W * W).sum((-2, -1))
    c2 = (C * C).sum((-2, -1))
    res = torch.sqrt((w2 - c2).clamp_min(0.0) / w2.clamp_min(1e-30))
    bad = (((res > esc["tol"]) | (gamma < esc["gap"]))
           & (gamma_max >= esc["floor"]))
    n_bad = int(bad.sum())
    if n_bad:
        idx = bad.nonzero()[:, 0]
        v, Ec = Vt[idx], E[idx]
        for _ in range(esc["extra"]):
            v = mgs(prec.mm(v, Ec), passes=2)
        Vt = Vt.clone()
        Vt[idx] = v
    return Vt, n_bad


def configured_subspace(prec: Prec, E: torch.Tensor, E_mean: torch.Tensor,
                        k2: int, subspace: dict, snapshots: int):
    """The subspace the configuration states for windows E [B, n2, n2]
    whose capture mean is E_mean [n2, n2]: with warm start, the capture
    mean's subspace (max(power_iters, 8) cold iterations), then
    power_iters_warm applies a window from it; cold, power_iters
    iterations. The escalation detector is armed on both where the
    configuration arms it. → (Vt [B, k2, n2], windows escalated)."""
    n2 = E.shape[-1]
    esc = None
    if subspace["subspace_escalate"]:
        esc = {"gap": subspace["subspace_escalate_gap"],
               "tol": subspace["subspace_tol"],
               "floor": escalation_floor(subspace, snapshots, n2),
               "extra": subspace["subspace_escalate_extra"]}
    if subspace["subspace_warm_start"]:
        mean_rounds = max(1, max(subspace["power_iters"], 8))
        Vbar, _ = power_subspace(prec, E_mean[None], k2, mean_rounds, None,
                                 esc)
        init = Vbar.expand(E.shape[0], k2, n2)
        return power_subspace(prec, E, k2, subspace["power_iters_warm"] + 1,
                              init, esc)
    return power_subspace(prec, E, k2, max(1, subspace["power_iters"]), None,
                          esc)


# ---------------------------------------------------------------------
# MUSIC on the signal subspace, and the peak rules
# ---------------------------------------------------------------------

def music_den(prec: Prec, Vt: torch.Tensor, At: torch.Tensor):
    """den [B, G] = ‖a‖² − ‖Vt·ã‖² of the signal subspace Vt [B, k2, n2]
    and the embedded steering At [G, n2] = [Re a, Im a], at least the
    dtype's tiny."""
    At = At.to(prec.dtype)
    nrm = (At * At).sum(-1)
    y = prec.mm(Vt, At.transpose(0, 1))                  # [B, k2, G]
    den = nrm - (y * y).sum(-2)
    return den.clamp_min(prec.tiny)


def _parabola(qm, q0, qp):
    """The vertex offset, clipped to ±0.5, of the parabola through q at
    three neighbouring bins (0 where they are collinear)."""
    d = qm - 2.0 * q0 + qp
    off = torch.where(d.abs() > 0, 0.5 * (qm - qp) / d,
                      torch.zeros_like(d))
    return off.clamp(-0.5, 0.5)


def peaks_1d(den: torch.Tensor, k: int, lo: float, hi: float,
             tie: float = 0.0):
    """The peaks of the normalised MUSIC spectrum P = min(den)/den over a
    1-D grid of G bins on [lo, hi]: a bin is a peak if it is interior, above
    its left neighbour and not below its right one; the k highest, the
    lower index first on ties; a row with fewer pads with its best, a row
    with none takes the global maximum (value 1). Each peak is refined by
    the parabola through den at its bin and its two neighbours.

    → (values [B, k], angles [B, k] in degrees, candidates [B, k, 3]): the
    angle refined from the peak's bin and from each neighbour whose P lies
    within a share `tie` of the peak's (else the peak's own angle again): a
    bin a computation of lower precision may take for the peak."""
    B, G = den.shape
    dmin = den.min(dim=-1, keepdim=True).values
    P = dmin / den
    iota = torch.arange(G, device=den.device).expand(B, G)
    is_max = torch.zeros_like(P, dtype=torch.bool)
    is_max[:, 1:-1] = (P[:, 1:-1] > P[:, :-2]) & (P[:, 1:-1] >= P[:, 2:])
    vals, idx = _top_k(torch.where(is_max, P, torch.full_like(P, -math.inf)),
                       iota, k)
    gidx = torch.where(den == dmin, iota, G).min(-1, keepdim=True).values
    vals, idx = _pad(vals, idx, torch.ones_like(dmin), gidx)
    dx = (hi - lo) / (G - 1)

    def refined(j):
        def pick(off):
            return torch.gather(den, 1, (j + off).clamp(0, G - 1))
        inner = (j > 0) & (j < G - 1)
        return lo + dx * (j.to(den.dtype) + torch.where(
            inner, _parabola(pick(-1), pick(0), pick(1)),
            torch.zeros_like(vals)))

    angles = refined(idx)
    cands = [angles]
    for off in (-1, 1):
        j = idx + off
        near = ((j > 0) & (j < G - 1)
                & (torch.gather(P, 1, j.clamp(0, G - 1))
                   >= vals * (1.0 - tie)))
        cands.append(torch.where(near, refined(j.clamp(0, G - 1)), angles))
    return vals, angles, torch.stack(cands, -1)


def peaks_2d(P: torch.Tensor, k: int, az_rng, el_rng, tie: float = 0.0):
    """The peaks of a spectrum P [B, Ga, Ge] over an az/el grid: a bin is a
    peak if it is interior on both axes, above its up and left neighbours
    and not below its down and right ones; the k highest, the first
    row-major index on ties; padding and the global fallback as in 1-D.
    Each peak is refined separably by the parabola through 1/P along az
    and along el.

    → (values [B, k], angles [B, k, 2] (az, el in degrees), candidates
    [B, k, 9, 2]): the angles refined from the peak's bin and from each of
    its eight neighbours whose P lies within a share `tie` of the peak's
    (else the peak's own angles again)."""
    B, Ga, Ge = P.shape
    G = Ga * Ge
    c = P[:, 1:-1, 1:-1]
    is_max = torch.zeros_like(P, dtype=torch.bool)
    is_max[:, 1:-1, 1:-1] = ((c > P[:, :-2, 1:-1]) & (c >= P[:, 2:, 1:-1])
                             & (c > P[:, 1:-1, :-2]) & (c >= P[:, 1:-1, 2:]))
    Pf = P.reshape(B, G)
    iota = torch.arange(G, device=P.device).expand(B, G)
    vals, idx = _top_k(torch.where(is_max.reshape(B, G), Pf,
                                   torch.full_like(Pf, -math.inf)), iota, k)
    gval = Pf.max(-1, keepdim=True).values
    gidx = torch.where(Pf == gval, iota, G).min(-1, keepdim=True).values
    vals, idx = _pad(vals, idx, gval, gidx)
    da = (az_rng[1] - az_rng[0]) / (Ga - 1)
    de = (el_rng[1] - el_rng[0]) / (Ge - 1)

    def q(a, e):
        return 1.0 / torch.gather(Pf, 1, a * Ge + e).clamp_min(
            torch.finfo(P.dtype).tiny)

    def refine(i, n, qm, q0, qp):
        inner = (i > 0) & (i < n - 1)
        return i.to(P.dtype) + torch.where(inner, _parabola(qm, q0, qp),
                                           torch.zeros_like(vals))

    def refined(ia, ie):
        q0 = q(ia, ie)
        fa = refine(ia, Ga, q((ia - 1).clamp(0, Ga - 1), ie), q0,
                    q((ia + 1).clamp(0, Ga - 1), ie))
        fe = refine(ie, Ge, q(ia, (ie - 1).clamp(0, Ge - 1)), q0,
                    q(ia, (ie + 1).clamp(0, Ge - 1)))
        return torch.stack([az_rng[0] + fa * da, el_rng[0] + fe * de], -1)

    ia, ie = idx // Ge, idx % Ge
    angles = refined(ia, ie)
    cands = []
    for oa in (0, -1, 1):
        for oe in (0, -1, 1):
            ja, je = ia + oa, ie + oe
            inside = (ja > 0) & (ja < Ga - 1) & (je > 0) & (je < Ge - 1)
            ja, je = ja.clamp(0, Ga - 1), je.clamp(0, Ge - 1)
            near = inside & (torch.gather(Pf, 1, ja * Ge + je)
                             >= vals * (1.0 - tie))
            cands.append(torch.where(near[..., None], refined(ja, je),
                                     angles))
    return vals, angles, torch.stack(cands, -2)


def _top_k(masked: torch.Tensor, iota: torch.Tensor, k: int):
    """k rounds of (max, its lowest index) over the last axis."""
    G = masked.shape[-1]
    vals, idxs = [], []
    for _ in range(k):
        v = masked.max(-1, keepdim=True).values
        i = torch.where(masked == v, iota, G).min(-1, keepdim=True).values
        masked = torch.where(iota == i, torch.full_like(masked, -math.inf),
                             masked)
        vals.append(v)
        idxs.append(i)
    return torch.cat(vals, -1), torch.cat(idxs, -1)


def _pad(vals, idx, fallback_val, fallback_idx):
    """Peaks a row lacks → its best peak; a row with none → the fallback."""
    have = torch.isfinite(vals[:, :1])
    best_v = torch.where(have, vals[:, :1], fallback_val)
    best_i = torch.where(have, idx[:, :1], fallback_idx)
    ok = torch.isfinite(vals)
    return torch.where(ok, vals, best_v), torch.where(ok, idx, best_i)
