"""Capon-MVDR pseudospectrum on complex64 tensors (port of
doa_tpu/ops/capon.py): P(θ) = 1 / Re(aᴴ R⁻¹ a), R⁻¹ through a batched
complex Cholesky factor, R = L Lᴴ ⇒ aᴴR⁻¹a = ‖L⁻¹a‖². The planes path's
Capon, on the real embedding, is cpx_ops.capon_spectrum."""

from __future__ import annotations

import torch

from doa_tpu_torch.cpx import fp32_matmuls
from doa_tpu_torch.ops.cpx_ops import spectrum_from_den


def capon_spectrum(R: torch.Tensor, steering_mat: torch.Tensor,
                   diag_load: float = 1e-4,
                   normalize: bool = True) -> torch.Tensor:
    """R (B, N, N), A (G, N) → the Capon spectrum f32[B, G].

    diag_load is relative: R + diag_load·(tr(R)/N)·I. R is symmetrized,
    ½(R + Rᴴ), before the factor, as jax.lax.linalg.cholesky does by
    default; cholesky_ex does not sync with the host."""
    N = R.shape[-1]
    if diag_load > 0:
        tr = torch.diagonal(R, dim1=-2, dim2=-1).sum(-1).real / N
        eye = torch.eye(N, dtype=R.dtype, device=R.device)
        R = R + (diag_load * tr)[..., None, None] * eye
    L, _ = torch.linalg.cholesky_ex(0.5 * (R + R.mH))
    At = steering_mat.T                                # (N, G), column a_g
    with fp32_matmuls():
        X = torch.linalg.solve_triangular(
            L, At.expand(R.shape[:-2] + At.shape), upper=False)
    den = X.abs().square().sum(-2)
    return spectrum_from_den(den, normalize)
