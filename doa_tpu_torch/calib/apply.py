"""Applying calibration (port of doa_tpu/calib/apply.py).

The pipeline folds its correction into the covariance; these apply a
correction to samples and compose the two stages into one vector."""

from __future__ import annotations

import torch


def apply_correction(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """x complex [T, N] × c complex [N] → corrected samples."""
    return x * torch.as_tensor(c, device=x.device)[None, :]


def compose_corrections(*cs):
    """The elementwise product of stage-1 and stage-2 corrections: the one
    vector the pipeline takes."""
    out = None
    for c in cs:
        c = torch.as_tensor(c)
        out = c if out is None else out * c.to(out.device)
    return out
