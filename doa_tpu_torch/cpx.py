"""Hermitian real embedding and the FP32 matmul scope.

doa_tpu carries complex values as split (re, im) planes (``Cpx``) because
its TPU backend has no complex64; torch has complex64 on CUDA, so that type
is not ported: the planes path carries (re, im) tensor pairs where the
reference carries a ``Cpx``. The real 2N embedding is: the covariance
kernels emit it and the subspace iteration and the scan kernels work on it.

    E(C) = [[Cr, -Ci], [Ci, Cr]]   (2N x 2N real symmetric for Hermitian C)
    embed_vector(v) = [re(v); im(v)]
"""

from __future__ import annotations

import contextlib

import torch


def embed_planes(re: torch.Tensor, im: torch.Tensor) -> torch.Tensor:
    """Planes (re, im) (..., N, N) of a Hermitian C → E(C)
    (..., 2N, 2N) real symmetric."""
    top = torch.cat([re, -im], dim=-1)
    bot = torch.cat([im, re], dim=-1)
    return torch.cat([top, bot], dim=-2)


def unembed_planes(m: torch.Tensor):
    """(..., 2N, 2N) real embedding → planes (re, im) (..., N, N).
    Averages the two redundant copies for numerical symmetry."""
    N = m.shape[-1] // 2
    re = 0.5 * (m[..., :N, :N] + m[..., N:, N:])
    im = 0.5 * (m[..., N:, :N] - m[..., :N, N:])
    return re, im


def embed_vector(v: torch.Tensor) -> torch.Tensor:
    """(..., N) complex → (..., 2N) real [re; im], matching
    embed_planes' convention (E(C)·ṽ = embed of C·v)."""
    return torch.cat([v.real, v.imag], dim=-1)


@contextlib.contextmanager
def fp32_matmuls():
    """Scope in which every float32 product is true FP32.

    Turns TF32 off for cuBLAS matmuls and cuDNN and requires
    ``torch.get_float32_matmul_precision() == "highest"``. TF32 keeps a
    10-bit mantissa; the subspace iteration and the scan's
    den = ‖a‖² − ‖Vᵀã‖² cancel, and at that precision the power
    iteration converges to wrong subspaces (doa_tpu's r2 bug class,
    docs/PERF.md). The previous flags are restored on exit."""
    prec = torch.get_float32_matmul_precision()
    if prec != "highest":
        raise RuntimeError(
            f"float32 matmul precision is {prec!r}; the DoA pipeline needs "
            "'highest' (true FP32): torch.set_float32_matmul_precision"
            "('highest')")
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev
