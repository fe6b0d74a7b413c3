"""Wideband DoA by per-subband channelization and incoherent fusion —
port of the power path of doa_tpu/ops/wideband.py.

An F-point DFT channelizer splits the capture into F subband streams at
rate 1/F (ops/cuda/wideband_cov.py); each subband gets its own signal
subspace (here) and its own steering grid, at the effective spacing
d·(1 + f·fractional_bw) a subband at baseband offset f sees; the fused
spectrum is the mean of the subbands' max-normalised MUSIC spectra
(ops/cuda/wideband_scan.py).

Ported so far: the steering stack, the subspaces from the front end's
embedded covariances (warm and cold) and the incoherent fusion. The
complex-stream channelizer, CSSM, cssm_auto, TOPS and the hierarchical
scan are not (ROADMAP.md, queue A.4).
"""

from __future__ import annotations

import numpy as np
import torch

from doa_tpu.configs import DoaConfig
from doa_tpu_torch.ops.cpx_ops import signal_subspace_from_E_T
from doa_tpu_torch.ops.cuda.wideband_scan import wideband_fused_spectrum


def subband_center_freqs(num_subbands: int) -> np.ndarray:
    """Normalized center frequency of each DFT bin, in [-0.5, 0.5)."""
    return np.fft.fftfreq(num_subbands).astype(np.float32)


def subband_spacings(cfg: DoaConfig) -> np.ndarray:
    """Effective per-subband element spacings d·(1 + f·fractional_bw)."""
    freqs = subband_center_freqs(cfg.wideband.num_subbands)
    fbw = cfg.wideband.fractional_bw
    return (cfg.geometry.norm_spacing
            * (1.0 + freqs * fbw)).astype(np.float32)


def wideband_steering_stack(cfg: DoaConfig, A_fn) -> np.ndarray:
    """Per-subband steering matrices complex64[F, G, N]; A_fn(spacing) →
    (G, N) is the config's grid at a given spacing
    (pipeline._steering_fn)."""
    fbw = getattr(cfg.wideband, "fractional_bw", 0.0)
    freqs = subband_center_freqs(cfg.wideband.num_subbands)
    return np.stack([A_fn(cfg.geometry.norm_spacing * (1.0 + float(fn) * fbw))
                     for fn in freqs], axis=0)


def subband_subspaces_from_E(E_sub: torch.Tensor,
                             cfg: DoaConfig) -> torch.Tensor:
    """Embedded per-subband covariances f32[F, B, 2N, 2N] → signal
    subspaces Vt f32[F, B, 2K, 2N] (transposed: rows orthonormal; the
    reference returns the swap, f32[F, B, 2N, 2K]). The (F, B) axes merge
    into one batch for the iteration.

    cfg.subspace_warm_start and B ≥ 32: each window starts from its
    subband's capture-mean subspace (max(power_iters, 8) iterations on F
    matrices) and refines with power_iters_warm applies, the escalation
    detector armed at the subband operating point (S/F snapshots); the
    init is one row per subband, shared by that subband's B windows in
    the subspace kernel. Otherwise a cold start with power_iters and the
    config's squarings, detector off — as the reference. No escalation
    counts are returned, as in the reference."""
    F, B, n2, _ = E_sub.shape
    K = cfg.num_sources
    E = E_sub.reshape(F * B, n2, n2)
    if cfg.subspace_warm_start and B >= 32:
        esc = cfg.escalate_kwargs_for(
            cfg.snapshot_size // cfg.wideband.num_subbands, n2=n2)
        Vt_bar = signal_subspace_from_E_T(
            E_sub.mean(dim=1), K, iters=max(cfg.power_iters, 8), **esc)
        Vt = signal_subspace_from_E_T(E, K, iters=cfg.power_iters_warm,
                                      init=Vt_bar, **esc)
    else:
        Vt = signal_subspace_from_E_T(E, K, iters=cfg.power_iters,
                                      squarings=cfg.power_squarings)
    return Vt.reshape(F, B, 2 * K, n2)


def wideband_music(E_sub: torch.Tensor, At_emb: torch.Tensor,
                   nrm: torch.Tensor, cfg: DoaConfig) -> torch.Tensor:
    """The power path of wideband_music_cpx with E_sub given:
    per-subband subspaces, then the fused incoherent spectrum
    P f32[B, G] from the embedded steering stack At_emb f32[F, G, 2N]
    (nrm f32[F, G] its squared norms)."""
    return wideband_fused_spectrum(subband_subspaces_from_E(E_sub, cfg),
                                   At_emb, nrm)
