"""Bartlett (delay-and-sum) spectrum on complex64 tensors (port of
doa_tpu/ops/bartlett.py): P(θ) = Re(aᴴ R a), no inverse and no
subspace. The planes path's Bartlett, one product on the real
embedding, is cpx_ops.bartlett_spectrum."""

from __future__ import annotations

import torch

from doa_tpu_torch.cpx import fp32_matmuls


def bartlett_spectrum(R: torch.Tensor, steering_mat: torch.Tensor,
                      normalize: bool = True) -> torch.Tensor:
    """R (B, N, N) complex, A (G, N) → f32[B, G], each window divided by
    its maximum unless normalize is False."""
    with fp32_matmuls():
        T = torch.matmul(R, steering_mat.T)                # (B, N, G)
    P = (steering_mat.T.conj()[None] * T).sum(-2).real
    if normalize:
        P = P / P.max(dim=-1, keepdim=True).values
    return P
