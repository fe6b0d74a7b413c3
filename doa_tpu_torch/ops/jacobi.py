"""Batched symmetric eigendecomposition by parallel cyclic Jacobi (port of
doa_tpu/ops/jacobi.py).

Each round rotates n/2 disjoint pivot pairs at once (a round-robin
tournament schedule): the n/2 Givens rotations compose into one
orthogonal Q = Σ_k [c_k (E_pp + E_qq) + s_k (E_pq − E_qp)] built from
static one-hot bases, and the updates A ← Qᵀ A Q, V ← V Q are batched
n×n products over every window at once. A fixed number of sweeps
(n − 1 rounds each) and no data-dependent branch: nothing syncs with the
host. Real FP32, used on the 2N embedding of Hermitian covariances
(cpx.embed_planes).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from doa_tpu_torch.cpx import fp32_matmuls


def _round_robin_schedule(n: int) -> np.ndarray:
    """Tournament schedule: (n-1) rounds × (n/2) disjoint pairs covering
    all C(n,2) pairs. Standard circle method; n must be even."""
    assert n % 2 == 0
    players = list(range(n))
    rounds = []
    for _ in range(n - 1):
        pairs = [(players[i], players[n - 1 - i]) for i in range(n // 2)]
        rounds.append([(min(p, q), max(p, q)) for p, q in pairs])
        players = [players[0]] + [players[-1]] + players[1:-1]
    return np.asarray(rounds)  # (n-1, n/2, 2)


@functools.lru_cache(maxsize=None)
def _schedule_bases(n: int):
    """Static per-round rotation bases:
    CE[r]: (n/2, n, n) with E_pp + E_qq per pair,
    SE[r]: (n/2, n, n) with E_pq − E_qp per pair,
    P_idx[r]: (n/2, 2) pivot indices."""
    sched = _round_robin_schedule(n)
    R = sched.shape[0]
    CE = np.zeros((R, n // 2, n, n), np.float32)
    SE = np.zeros((R, n // 2, n, n), np.float32)
    for r in range(R):
        for k, (p, q) in enumerate(sched[r]):
            CE[r, k, p, p] = 1.0
            CE[r, k, q, q] = 1.0
            SE[r, k, p, q] = 1.0
            SE[r, k, q, p] = -1.0
    return sched, CE, SE


def _jacobi_raw(A: torch.Tensor, sweeps: int):
    """Jacobi sweeps without the eigen-sort → (diag f32[..., n],
    V f32[..., n, n]), the columns of V the eigenvectors of diag."""
    n = A.shape[-1]
    sched, CE_np, SE_np = _schedule_bases(n)
    dev = A.device
    p_idx = torch.from_numpy(sched[..., 0]).to(dev)
    q_idx = torch.from_numpy(sched[..., 1]).to(dev)
    # the bases flattened (rounds, n/2, n·n): Q = c·CE + s·SE as products
    CE = torch.from_numpy(CE_np.reshape(len(sched), n // 2, n * n)).to(dev)
    SE = torch.from_numpy(SE_np.reshape(len(sched), n // 2, n * n)).to(dev)
    batch = A.shape[:-2]
    Acur = A.reshape(-1, n, n)
    B = Acur.shape[0]
    Vcur = torch.eye(n, dtype=A.dtype, device=dev).expand(B, n, n)
    with fp32_matmuls():
        for _ in range(sweeps):
            for r in range(len(sched)):
                p, q = p_idx[r], q_idx[r]
                app = Acur[:, p, p]
                aqq = Acur[:, q, q]
                apq = Acur[:, p, q]
                small = apq.abs() <= 1e-30
                tau = (aqq - app) / torch.where(small, 1.0, 2.0 * apq)
                t = torch.sign(tau) / (tau.abs() + torch.sqrt(1.0 + tau * tau))
                t = torch.where(small, 0.0, t)
                c = 1.0 / torch.sqrt(1.0 + t * t)
                s = t * c
                Q = (torch.matmul(c, CE[r])
                     + torch.matmul(s, SE[r])).view(B, n, n)
                Anew = torch.matmul(torch.matmul(Q.transpose(-1, -2), Acur),
                                    Q)
                Acur = 0.5 * (Anew + Anew.transpose(-1, -2))
                Vcur = torch.matmul(Vcur, Q)
    diag = torch.diagonal(Acur, dim1=-2, dim2=-1)
    return diag.reshape(*batch, n), Vcur.reshape(*batch, n, n)


def eigh_jacobi(A: torch.Tensor, sweeps: int = 10):
    """A: f32[..., n, n] symmetric (n even) → (eigvals f32[..., n]
    ascending, eigvecs f32[..., n, n] columns): torch.linalg.eigh's and
    the reference's convention. Equal eigenvalues keep their Jacobi
    order (a stable sort, as jnp.argsort)."""
    diag, V = _jacobi_raw(A, sweeps)
    w, order = torch.sort(diag, dim=-1, stable=True)
    V = torch.gather(V, -1, order[..., None, :].expand(V.shape))
    return w, V


def subspace_projector_jacobi(A: torch.Tensor, subspace_dim: int,
                              smallest: bool = True, sweeps: int = 10):
    """Projector onto the span of the `subspace_dim` smallest- (or
    largest-) eigenvalue eigenvectors of symmetric A f32[..., n, n],
    without sorting the eigenvectors: P = V·diag(w)·Vᵀ with a 0/1 weight
    w = (eigenvalue ranks within the top `subspace_dim`), the threshold
    the subspace_dim-th value of a top-k. Eigenvalue pairs of an embedded
    Hermitian matrix are both in or both out (its spectrum is doubled)."""
    w, V = _jacobi_raw(A, sweeps)
    sel = -w if smallest else w
    kth = torch.topk(sel, subspace_dim, dim=-1).values[..., -1:]
    weight = (sel >= kth).to(A.dtype)
    with fp32_matmuls():
        return torch.matmul(V * weight[..., None, :], V.transpose(-1, -2))
