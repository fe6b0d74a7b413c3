"""Hermitian eigendecomposition helpers (port of doa_tpu/ops/subspace.py,
the part the calibration stage uses)."""

from __future__ import annotations

import torch


def principal_eigvec(R: torch.Tensor) -> torch.Tensor:
    """v1 (..., N): the eigenvector of the largest eigenvalue of the
    Hermitian R (..., N, N) complex64 (complex torch.linalg.eigh; columns
    in ascending eigenvalue order). Its global phase is arbitrary, as in
    the reference."""
    _, v = torch.linalg.eigh(R)
    return v[..., :, -1]
