"""Stage-1 calibration: receiver-chain relative phase offsets (port of
doa_tpu/calib/phase_offset.py).

All channels receive a common reference tone through a cable splitter; the
relative phase of chain k against chain 0 is arg(E[x_k conj(x_0)]).
"""

from __future__ import annotations

import torch


def phase_offset_est(x: torch.Tensor, ref_channel: int = 0) -> torch.Tensor:
    """x: complex64 [T, N] common-tone capture (any device; e.g. the
    zero-copy torch.view_as_complex of an interleaved f32 buffer) → phi
    f32[N] radians, phi[ref_channel] == 0. The complex product is averaged
    before taking its argument (SNR weighting, no phase-wrap bias)."""
    ref = x[:, ref_channel:ref_channel + 1]
    z = torch.mean(x * torch.conj(ref), dim=0)
    return torch.angle(z).to(torch.float32)


def phase_correction(phi: torch.Tensor) -> torch.Tensor:
    """phi f32[N] → the correction c complex64[N], c_k = exp(−j·phi_k)."""
    phi = torch.as_tensor(phi, dtype=torch.float32)
    return torch.polar(torch.ones_like(phi), -phi)
