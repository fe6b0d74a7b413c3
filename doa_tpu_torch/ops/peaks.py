"""Pseudospectrum peak extraction (doa_tpu.ops.peaks.find_local_max).

Interior local maxima of each row of P (B, G) — P[g] > P[g-1] and
P[g] >= P[g+1] — top k by value with the lowest index on ties, rows with
fewer peaks padded with the best peak, rows with none falling back to the
global argmax. Optional sub-bin refine: a 3-point parabola in reciprocal
space (q = 1/P is locally quadratic at a MUSIC null). The fused scan +
peaks kernel (ops/cuda/music_scan.py, K2) reproduces this rule.
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
    tiny = torch.finfo(P.dtype).tiny

    def recip(v):
        return 1.0 / v.clamp_min(tiny)

    qm = recip(torch.gather(P, -1, im))
    q0 = recip(torch.gather(P, -1, idx))
    qp = recip(torch.gather(P, -1, ip))
    denom = qm - 2.0 * q0 + qp
    delta = torch.where(denom.abs() > 0, 0.5 * (qm - qp) / denom,
                        torch.zeros_like(denom))
    delta = delta.clamp(-0.5, 0.5)
    interior = (idx > 0) & (idx < G - 1)
    return idx.to(P.dtype) + torch.where(interior, delta,
                                         torch.zeros_like(delta))
