"""The complex-typed pipeline, the pipeline result type and the
config-static steering matrix (port of doa_tpu/pipeline.py).

``build_pipeline(cfg)`` and ``estimate_doa(x, cfg)`` are the public
one-shot entry: complex64 samples x[T, N] → calibration correction →
covariance windows (FB, smoothing; beamspace Bᴴ R B) → the spectra of
MUSIC, Capon, Bartlett and min-norm with their peaks, root-MUSIC,
ESPRIT (2-D on a URA) and Unitary ESPRIT. Each stage is a composition of
PyTorch library calls on complex64 tensors (products, eigh, Cholesky,
triangular solves), true FP32 throughout, as the reference composes its
complex path of XLA library calls; it reaches no hand-written kernel.
``pipeline_torch.build_pipeline_torch`` is the fast path on the card.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from doa_tpu_torch.configs import AvgMethod, DoaConfig, Estimator, as_config
from doa_tpu_torch.cpx import fp32_matmuls
from doa_tpu_torch.ops import covariance as cov_ops
from doa_tpu_torch.ops import esprit
from doa_tpu_torch.ops import steering as steer_ops
from doa_tpu_torch.ops.bartlett import bartlett_spectrum
from doa_tpu_torch.ops.beamspace import (beamspace_covariance_complex,
                                         beamspace_steering, dft_beam_matrix)
from doa_tpu_torch.ops.capon import capon_spectrum
from doa_tpu_torch.ops.min_norm import min_norm_spectrum
from doa_tpu_torch.ops.music import music_spectrum
from doa_tpu_torch.ops.peaks import find_local_max, find_local_max_2d
from doa_tpu_torch.ops.root_music import root_music


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


def compute_covariances(x: torch.Tensor, cfg: DoaConfig) -> torch.Tensor:
    """x c64[T, N] → R c64[B, N_eff, N_eff] by the config's windowing,
    FB averaging and spatial smoothing."""
    fb = cfg.avg_method == AvgMethod.FORWARD_BACKWARD
    R = cov_ops.cov_from_stream(x, cfg.snapshot_size, cfg.overlap,
                                fb_average=fb)
    if cfg.smoothing.enabled:
        R = cov_ops.spatial_smooth(R, cfg.smoothing.subarray_size)
    return R


def _spectra_and_peaks(R, A, cfg: DoaConfig, x_rng, refine: bool):
    """The grid estimators' spectra f32[B, G] and their peaks (values,
    angles); on an az/el grid the angles are [az, el] pairs."""
    spectra, pvals, pangs = {}, {}, {}
    is_2d = cfg.grid2d is not None and cfg.geometry.kind == "ura"
    for est in cfg.estimators:
        if est == Estimator.MUSIC:
            P = music_spectrum(R, A, cfg.num_sources)
        elif est == Estimator.CAPON:
            P = capon_spectrum(R, A, diag_load=cfg.capon_diag_load)
        elif est == Estimator.BARTLETT:
            P = bartlett_spectrum(R, A)
        elif est == Estimator.MIN_NORM:
            P = min_norm_spectrum(R, A, cfg.num_sources)
        elif est in (Estimator.ROOT_MUSIC, Estimator.ESPRIT,
                     Estimator.UNITARY_ESPRIT):
            continue                        # grid-free: build_pipeline
        else:  # pragma: no cover
            raise ValueError(est)
        if is_2d:
            g2 = cfg.grid2d
            v, az, el = find_local_max_2d(
                P.reshape(P.shape[0], g2.num_az, g2.num_el),
                cfg.num_max_vals, (g2.az_lo_deg, g2.az_hi_deg),
                (g2.el_lo_deg, g2.el_hi_deg), refine=refine)
            loc = torch.stack([az, el], dim=-1)
        else:
            v, loc = find_local_max(P, cfg.num_max_vals, x_rng[0], x_rng[1],
                                    refine=refine)
        spectra[est.value] = P
        pvals[est.value] = v
        pangs[est.value] = loc
    return spectra, pvals, pangs


def _complex_on(t, device: torch.device) -> torch.Tensor:
    """numpy or torch input → a complex64 tensor on the device."""
    if not isinstance(t, torch.Tensor):
        t = torch.from_numpy(np.ascontiguousarray(t, dtype=np.complex64))
    return t.to(device=device, dtype=torch.complex64)


def build_pipeline(cfg: DoaConfig, refine_peaks: bool = True,
                   return_covariance: bool = False, *, device="cuda"):
    """→ call(x, correction=None) → DoaResult for x c64[T, N] (numpy or
    tensor) and the per-channel complex calibration vector correction
    c64[N] (None: ones), applied to the samples before the covariance.

    Runs on the card unless device="cpu" (no card: RuntimeError; it
    never falls back to the CPU). The steering matrix is built once and
    kept on the device (``call.steering_matrix``). As the reference's
    complex path, it ignores cov_dtype, compute_dtype, subspace_method,
    scan_mode and wideband."""
    from doa_tpu_torch.pipeline_torch import _device

    cfg = as_config(cfg)
    dev = _device(device)
    A_host, x_rng = _steering_matrix(cfg)
    Bm = None
    if cfg.beamspace.enabled:
        Bm_host = dft_beam_matrix(
            cfg.geometry.num_elements, cfg.beamspace.num_beams,
            cfg.beamspace.center_deg, cfg.geometry.norm_spacing)
        A_host = beamspace_steering(A_host, Bm_host)
        Bm = torch.from_numpy(Bm_host).to(dev)
    A = torch.from_numpy(A_host).to(dev)
    ests = cfg.estimators
    K, d = cfg.num_sources, cfg.geometry.norm_spacing

    def run(x, correction):
        x = x * correction[None, :]
        R = compute_covariances(x, cfg)
        if Bm is not None:
            R = beamspace_covariance_complex(R, Bm)
        spectra, pvals, pangs = _spectra_and_peaks(R, A, cfg, x_rng,
                                                   refine_peaks)
        out = dict(spectra=spectra, peak_values=pvals, peak_angles=pangs,
                   covariance=R if return_covariance else None)
        if Estimator.ROOT_MUSIC in ests:
            out["root_music_angles"] = root_music(R, K, d)
        if Estimator.ESPRIT in ests or Estimator.UNITARY_ESPRIT in ests:
            # the planes functions are the one implementation, as the
            # reference wraps R's planes in a Cpx
            Rr, Ri = R.real.contiguous(), R.imag.contiguous()
        if Estimator.ESPRIT in ests:
            if cfg.geometry.kind == "ula":
                out["esprit_angles"] = esprit.esprit_cpx(Rr, Ri, K, d)
            else:
                az, el = esprit.esprit_2d_cpx(Rr, Ri, K, d,
                                              cfg.geometry.shape)
                out["esprit_angles"] = torch.stack([az, el], dim=-1)
        if Estimator.UNITARY_ESPRIT in ests:
            out["unitary_esprit_angles"] = esprit.unitary_esprit_cpx(
                Rr, Ri, K, d)
        return DoaResult(**out)

    def call(x, correction=None) -> DoaResult:
        x = _complex_on(x, dev)
        c = (torch.ones((x.shape[1],), dtype=torch.complex64, device=dev)
             if correction is None else _complex_on(correction, dev))
        with fp32_matmuls():
            return run(x, c)

    call.steering_matrix = A
    call.config = cfg
    return call


def estimate_doa(x, cfg: DoaConfig, correction=None,
                 refine_peaks: bool = True, *, device="cuda") -> DoaResult:
    """One-shot: build the complex pipeline and run it on x c64[T, N]."""
    return build_pipeline(cfg, refine_peaks=refine_peaks,
                          device=device)(x, correction)
