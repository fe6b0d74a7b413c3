"""Pipeline result type and the config-static steering matrix
(doa_tpu.pipeline: DoaResult, _steering_fn, _steering_matrix)."""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from doa_tpu_torch.configs import DoaConfig
from doa_tpu_torch.ops import steering as steer_ops


@dataclasses.dataclass
class DoaResult:
    """Per-window outputs of one pipeline call (tensors on the pipeline's
    device)."""

    spectra: Dict[str, torch.Tensor]        # estimator → f32[B, G]
    peak_values: Dict[str, torch.Tensor]    # estimator → f32[B, k]
    peak_angles: Dict[str, torch.Tensor]    # estimator → f32[B, k] deg
    root_music_angles: Optional[torch.Tensor] = None
    esprit_angles: Optional[torch.Tensor] = None
    unitary_esprit_angles: Optional[torch.Tensor] = None
    covariance: Optional[torch.Tensor] = None        # c64[B, N, N]
    subspace_residual: Optional[torch.Tensor] = None
    # windows the escalation detector flagged in this call, and flagged
    # windows beyond subspace_escalate_capacity left unescalated
    escalation_flagged: Optional[torch.Tensor] = None   # int32 scalar
    escalation_overflow: Optional[torch.Tensor] = None  # int32 scalar


def _steering_fn(cfg: DoaConfig):
    """→ A_fn(norm_spacing) → (G, N_eff) complex64 host steering matrix."""
    if cfg.geometry.kind == "ula":
        def A_fn(spacing):
            geo = dataclasses.replace(cfg.geometry, norm_spacing=spacing)
            return steer_ops.ula_grid(
                geo, cfg.grid, num_elements=cfg.effective_num_elements)
        return A_fn
    assert cfg.grid2d is not None, "ura geometry requires grid2d"

    def A_fn(spacing):
        geo = dataclasses.replace(cfg.geometry, norm_spacing=spacing)
        return steer_ops.ura_grid(geo, cfg.grid2d)
    return A_fn


def _steering_matrix(cfg: DoaConfig):
    """Scan steering matrix A: (G, N_eff) + (x_min, x_max)."""
    A = _steering_fn(cfg)(cfg.geometry.norm_spacing)
    if cfg.geometry.kind == "ula":
        return A, (cfg.grid.lo_deg, cfg.grid.hi_deg)
    # 2-D grids flatten az-major: bin → az index * num_el + el index
    return A, (0.0, float(A.shape[0] - 1))
