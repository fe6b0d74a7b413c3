"""Batched Hermitian eigendecomposition and the subspaces (port of
doa_tpu/ops/subspace.py): complex torch.linalg.eigh over every window
at once."""

from __future__ import annotations

import torch


# matrices a torch.linalg.eigh call: cuSOLVER's batched eigensolver
# refuses 32767 windows of 16×16 (CUSOLVER_STATUS_INVALID_VALUE from its
# buffer-size query) and takes 16384
EIGH_BATCH = 16384


def eigh_batched(R: torch.Tensor):
    """R (..., N, N) Hermitian → (eigenvalues ascending (..., N),
    eigenvectors (..., N, N) as columns). R is symmetrized first,
    ½(R + Rᴴ), as jnp.linalg.eigh does by default: torch.linalg.eigh
    reads only the lower triangle, and window sums are Hermitian only to
    rounding. At most EIGH_BATCH matrices go to one eigh call."""
    H = 0.5 * (R + R.mH)
    N = H.shape[-1]
    flat = H.reshape(-1, N, N)
    if flat.shape[0] <= EIGH_BATCH:
        return torch.linalg.eigh(H)
    parts = [torch.linalg.eigh(flat[i:i + EIGH_BATCH])
             for i in range(0, flat.shape[0], EIGH_BATCH)]
    w = torch.cat([p[0] for p in parts]).reshape(H.shape[:-1])
    v = torch.cat([p[1] for p in parts]).reshape(H.shape)
    return w, v


def noise_subspace(R: torch.Tensor, num_sources: int) -> torch.Tensor:
    """E_n (..., N, N − K): the eigenvectors of the N − K smallest
    eigenvalues."""
    _, v = eigh_batched(R)
    return v[..., :, :R.shape[-1] - num_sources]


def signal_subspace(R: torch.Tensor, num_sources: int) -> torch.Tensor:
    """E_s (..., N, K): the eigenvectors of the K largest eigenvalues."""
    _, v = eigh_batched(R)
    return v[..., :, R.shape[-1] - num_sources:]


def principal_eigvec(R: torch.Tensor) -> torch.Tensor:
    """v1 (..., N): the eigenvector of the largest eigenvalue of the
    Hermitian R (..., N, N) complex64 (complex torch.linalg.eigh; columns
    in ascending eigenvalue order). Its global phase is arbitrary, as in
    the reference."""
    _, v = torch.linalg.eigh(R)
    return v[..., :, -1]
