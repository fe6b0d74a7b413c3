"""Pseudospectrum peak extraction (doa_tpu.ops.peaks.find_local_max).

Interior local maxima of each row of P (B, G) — P[g] > P[g-1] and
P[g] >= P[g+1] — top k by value with the lowest index on ties, rows with
fewer peaks padded with the best peak, rows with none falling back to the
global argmax. Optional sub-bin refine: a 3-point parabola in reciprocal
space (q = 1/P is locally quadratic at a MUSIC null). The fused scan +
peaks kernel (ops/cuda/music_scan.py, K2) reproduces this rule;
find_local_max_2d is its az/el form (doa_tpu.ops.peaks.find_local_max_2d),
which the 2-D peaks kernel (ops/cuda/peaks2d.py) reproduces.
"""

from __future__ import annotations

import torch


def _topk_lastaxis(masked: torch.Tensor, k: int):
    """top-k along the last axis → (vals, idx) each (B, k): k rounds of
    argmax + mask, lowest index on equal values (as lax.top_k and the
    reference's rule)."""
    if k > 4:
        # stable descending sort keeps the first index first among ties
        vals, idx = torch.sort(masked, dim=-1, descending=True, stable=True)
        return vals[:, :k], idx[:, :k]
    G = masked.shape[-1]
    iota = torch.arange(G, device=masked.device).expand_as(masked)
    vals, idxs = [], []
    m = masked
    for _ in range(k):
        v = m.max(dim=-1, keepdim=True).values
        i = torch.where(m == v, iota, G).min(dim=-1, keepdim=True).values
        vals.append(v)
        idxs.append(i)
        m = torch.where(iota == i, torch.full_like(m, -torch.inf), m)
    return torch.cat(vals, dim=-1), torch.cat(idxs, dim=-1)


def find_local_max(P: torch.Tensor, num_max_vals: int, x_min: float,
                   x_max: float, refine: bool = False):
    """P: (B, G) → (values, locations) each (B, num_max_vals)."""
    G = P.shape[-1]
    is_max = torch.zeros_like(P, dtype=torch.bool)
    is_max[:, 1:-1] = (P[:, 1:-1] > P[:, :-2]) & (P[:, 1:-1] >= P[:, 2:])
    masked = torch.where(is_max, P, torch.full_like(P, -torch.inf))
    vals, idx = _topk_lastaxis(masked, num_max_vals)

    gval = P.max(dim=-1, keepdim=True).values
    gidx = torch.where(P == gval, torch.arange(G, device=P.device),
                       G).min(dim=-1, keepdim=True).values
    have_any = torch.isfinite(vals[:, 0:1])
    best_val = torch.where(have_any, vals[:, 0:1], gval)
    best_idx = torch.where(have_any, idx[:, 0:1], gidx)
    valid = torch.isfinite(vals)
    vals = torch.where(valid, vals, best_val)
    idx = torch.where(valid, idx, best_idx)

    dx = (x_max - x_min) / (G - 1)
    if refine:
        locs = x_min + _refine_frac(P, idx, G) * dx
    else:
        locs = x_min + idx.to(P.dtype) * dx
    return vals, locs


def _refine_frac(P: torch.Tensor, idx: torch.Tensor, G: int):
    """idx + sub-bin offset from the reciprocal-space parabola through
    the three gathered points (the reciprocal is taken on those only)."""
    im = (idx - 1).clamp(0, G - 1)
    ip = (idx + 1).clamp(0, G - 1)
    return _parabola_frac(torch.gather(P, -1, im), torch.gather(P, -1, idx),
                          torch.gather(P, -1, ip), idx, G)


def _parabola_frac(pm, p0, pp, idx: torch.Tensor, G: int):
    """idx + the vertex offset of the parabola through q = 1/P at the
    bins idx − 1, idx, idx + 1 (P values pm, p0, pp; the neighbours
    clamped to the axis), clipped to ±0.5; 0 at the axis ends."""
    tiny = torch.finfo(p0.dtype).tiny

    def recip(v):
        return 1.0 / v.clamp_min(tiny)

    qm, q0, qp = recip(pm), recip(p0), recip(pp)
    denom = qm - 2.0 * q0 + qp
    delta = torch.where(denom.abs() > 0, 0.5 * (qm - qp) / denom,
                        torch.zeros_like(denom))
    delta = delta.clamp(-0.5, 0.5)
    interior = (idx > 0) & (idx < G - 1)
    return idx.to(p0.dtype) + torch.where(interior, delta,
                                          torch.zeros_like(delta))


def find_local_max_2d(P: torch.Tensor, num_max_vals: int, az_rng, el_rng,
                      refine: bool = False):
    """2-D peak extraction for az/el scans: P (B, Ga, Ge) → (values,
    az, el) each (B, k).

    A bin is a peak iff it is interior on both axes, strictly exceeds its
    up (az − 1) and left (el − 1) neighbours and is ≥ its down and right
    ones; top k by value, the first row-major index on ties; rows with
    fewer peaks pad with the best peak, rows with none fall back to the
    global argmax. Refinement is separable: the reciprocal-space parabola
    along the az column and along the el row through each peak. The 2-D
    peaks kernel (ops/cuda/peaks2d.py) reproduces this rule."""
    B, Ga, Ge = P.shape
    G = Ga * Ge
    is_max = torch.zeros_like(P, dtype=torch.bool)
    c = P[:, 1:-1, 1:-1]
    is_max[:, 1:-1, 1:-1] = ((c > P[:, :-2, 1:-1]) & (c >= P[:, 2:, 1:-1])
                             & (c > P[:, 1:-1, :-2]) & (c >= P[:, 1:-1, 2:]))
    Pf = P.reshape(B, G)
    flat = torch.where(is_max.reshape(B, G), Pf,
                       torch.full_like(Pf, -torch.inf))
    vals, idx = _topk_lastaxis(flat, num_max_vals)

    gval = Pf.max(dim=-1, keepdim=True).values
    gidx = torch.where(Pf == gval, torch.arange(G, device=P.device),
                       G).min(dim=-1, keepdim=True).values
    have_any = torch.isfinite(vals[:, 0:1])
    best_val = torch.where(have_any, vals[:, 0:1], gval)
    best_idx = torch.where(have_any, idx[:, 0:1], gidx)
    valid = torch.isfinite(vals)
    vals = torch.where(valid, vals, best_val)
    idx = torch.where(valid, idx, best_idx)

    ia = idx // Ge
    ie = idx % Ge
    da = (az_rng[1] - az_rng[0]) / (Ga - 1)
    de = (el_rng[1] - el_rng[0]) / (Ge - 1)
    if refine:
        pick = lambda a, e: torch.gather(Pf, -1, a * Ge + e)  # noqa: E731
        am = (ia - 1).clamp(0, Ga - 1)
        ap = (ia + 1).clamp(0, Ga - 1)
        em = (ie - 1).clamp(0, Ge - 1)
        ep = (ie + 1).clamp(0, Ge - 1)
        p0 = pick(ia, ie)
        fa = _parabola_frac(pick(am, ie), p0, pick(ap, ie), ia, Ga)
        fe = _parabola_frac(pick(ia, em), p0, pick(ia, ep), ie, Ge)
    else:
        fa = ia.to(P.dtype)
        fe = ie.to(P.dtype)
    return vals, az_rng[0] + fa * da, el_rng[0] + fe * de
