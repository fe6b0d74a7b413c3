"""Source counting (model order) by AIC / MDL from covariance eigenvalues
— port of doa_tpu/ops/model_order.py.

The information-theoretic criteria (Wax & Kailath) pick the K that
minimises

    crit(k) = S·(N−k)·(log a_k − log g_k) + penalty(k),

a_k and g_k the arithmetic and geometric means of the N−k smallest
eigenvalues, penalty(k) = k(2N−k) · (½·log S for MDL, 1 for AIC). The
eigenvalues come from the real 2N embedding (each one twice: every other
sorted value), so the whole count is batched real linear algebra, and
its result is an int32 count a window.
"""

from __future__ import annotations

import math

import torch

from doa_tpu_torch.cpx import embed_planes


def eigenvalues(Rr: torch.Tensor, Ri: torch.Tensor) -> torch.Tensor:
    """Ascending eigenvalues f32[..., N] of the Hermitian R with planes
    (Rr, Ri), from the doubled spectrum of E(R)."""
    return torch.linalg.eigvalsh(embed_planes(Rr, Ri))[..., ::2]


def estimate_num_sources(Rr: torch.Tensor, Ri: torch.Tensor,
                         num_snapshots: int, criterion: str = "mdl",
                         max_k: int | None = None) -> torch.Tensor:
    """Covariance planes f32[B, N, N] and the snapshots S a window →
    the estimated source count int32[B], k in 0 … max_k (default N − 1).

    criterion: "mdl" (consistent) or "aic" (tends to count more)."""
    if criterion not in ("mdl", "aic"):
        raise ValueError(criterion)
    N = Rr.shape[-1]
    S = num_snapshots
    if max_k is None:
        max_k = N - 1
    w = eigenvalues(Rr, Ri).clamp_min(1e-12)          # ascending (B, N)
    # prefix sums over the m = N − k smallest eigenvalues
    csum = torch.cumsum(w, dim=-1)
    clog = torch.cumsum(torch.log(w), dim=-1)
    ks = torch.arange(0, max_k + 1, device=w.device)  # candidate k
    m = N - ks                                        # noise dimensions
    mf = m.to(w.dtype)
    a = csum[..., m - 1] / mf                         # (B, max_k + 1)
    g_log = clog[..., m - 1] / mf
    llr = S * mf * (torch.log(a) - g_log)             # ≥ 0
    kf = ks.to(w.dtype)
    if criterion == "mdl":
        pen = 0.5 * kf * (2 * N - kf) * math.log(S)
    else:
        pen = kf * (2 * N - kf)
    return torch.argmin(llr + pen, dim=-1).to(torch.int32)
