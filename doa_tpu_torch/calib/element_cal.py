"""Stage-2 calibration: antenna-element gain/phase corrections from a
pilot at a known angle (port of doa_tpu/calib/element_cal.py).

Per covariance window, the principal eigenvector v1 of R spans the pilot's
signal subspace; the correction is c_k = a_k(pilot)/v1_k, normalised so
that the reference element's is exactly 1 (which removes v1's arbitrary
global phase and scale).
"""

from __future__ import annotations

import torch

from doa_tpu_torch.ops.steering import _ula_steering_np
from doa_tpu_torch.ops.subspace import principal_eigvec


def element_calibration(R: torch.Tensor, pilot_theta_deg: float,
                        norm_spacing: float) -> torch.Tensor:
    """R: complex64 [B, N, N] windows of a pilot-only capture →
    corrections complex64 [B, N]."""
    v1 = principal_eigvec(R)                       # (B, N)
    a = torch.from_numpy(_ula_steering_np(
        pilot_theta_deg, R.shape[-1], norm_spacing)).to(R.device)
    c = a[None, :] / v1
    return c / c[..., :1]


def average_corrections(c: torch.Tensor) -> torch.Tensor:
    """c complex64 [B, N] per-window corrections → complex64 [N]: gains
    averaged arithmetically, phases on the unit circle."""
    mag = torch.abs(c)
    ph = torch.angle(torch.mean(c / mag.clamp_min(1e-30), dim=0))
    return torch.polar(mag.mean(dim=0), ph).to(torch.complex64)
