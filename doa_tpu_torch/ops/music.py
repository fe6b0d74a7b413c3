"""MUSIC pseudospectrum on complex64 tensors (port of
doa_tpu/ops/music.py, the complex-typed path of ``pipeline.py``).

P(θ) = 1 / Re(aᴴ M a) with the noise projector M = E_n E_nᴴ of each
window, scanned over the steering matrix A (G, N): T = conj(A)·M
(G×N · N×N a window), then each row dotted with a. Every product is
true FP32 (cpx.fp32_matmuls). The fused path's kernels scan the real
embedding instead (ops/cuda/music_scan.py).
"""

from __future__ import annotations

import torch

from doa_tpu_torch.cpx import fp32_matmuls
from doa_tpu_torch.ops.cpx_ops import spectrum_from_den
from doa_tpu_torch.ops.subspace import noise_subspace


def noise_projector(R: torch.Tensor, num_sources: int) -> torch.Tensor:
    """M = E_n E_nᴴ (..., N, N), the projector onto the noise subspace
    of R (..., N, N)."""
    En = noise_subspace(R, num_sources)
    with fp32_matmuls():
        return torch.matmul(En, En.mH)


def music_spectrum_from_projector(M: torch.Tensor, steering_mat: torch.Tensor,
                                  normalize: bool = True) -> torch.Tensor:
    """M (B, N, N) noise projector, A (G, N) → P f32[B, G]:
    den = Re(aᴴ M a) held at FP32's least normal value from below,
    P = 1/den, each window divided by its maximum unless normalize is
    False."""
    with fp32_matmuls():
        T = torch.matmul(steering_mat.conj(), M)           # (B, G, N)
    den = (T * steering_mat[None]).sum(-1).real
    return spectrum_from_den(den, normalize)


def music_spectrum(R: torch.Tensor, steering_mat: torch.Tensor,
                   num_sources: int, normalize: bool = True) -> torch.Tensor:
    """R (B, N, N), A (G, N) → the MUSIC pseudospectrum f32[B, G]."""
    return music_spectrum_from_projector(
        noise_projector(R, num_sources), steering_mat, normalize)
