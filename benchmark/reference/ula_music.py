"""Plain reference of narrowband MUSIC on a uniform linear array, as the
configuration states it: windows of S samples every hop samples, R =
(1/S) Σ x xᴴ, the power subspace of K sources (warm start from the
capture mean, the escalation detector), MUSIC over a 1-D grid of angles,
the k highest local maxima refined by a parabola.

`answers` works from the capture block alone (interleaved float32 samples
[T, 2N], the bytes of a complex64 (T, N) capture): it computes the
steering, the windows, the capture mean and every product again.
"""

from __future__ import annotations

import numpy as np
import torch

from reference.common import (Prec, cgram, configured_subspace, embed,
                              music_den, peaks_1d)

PIECE = 1 << 22          # samples a piece when the capture mean is summed


def _unsupported(cfg: dict) -> None:
    if (cfg["avg_method"] or cfg["smoothing"]["subarray_size"]
            or cfg["beamspace"]["num_beams"]
            or cfg["wideband"]["num_subbands"] > 1
            or cfg["subspace_method"] != "power"
            or cfg["estimators"] != ["music"]
            or cfg["geometry"]["kind"] != "ula"
            or cfg["cov_dtype"] != "float32"
            or cfg["compute_dtype"] != "float32"
            or cfg["power_schedule"] != "e1"):
        raise ValueError("the ULA MUSIC reference takes a ULA, plain "
                         "windows in float32 and the e1 power subspace "
                         "for MUSIC only")


def steering(cfg: dict, dtype, device) -> torch.Tensor:
    """[G, 2N]: [Re a(θ), Im a(θ)] over the grid, a(θ)_n =
    exp(−j·2π·d·n·cos θ)."""
    g, geo = cfg["grid"], cfg["geometry"]
    theta = np.deg2rad(np.linspace(g["lo_deg"], g["hi_deg"],
                                   g["num_points"]))
    n = np.arange(geo["num_elements"])
    ph = -2.0 * np.pi * geo["norm_spacing"] * np.cos(theta)[:, None] * n
    return torch.from_numpy(np.concatenate([np.cos(ph), np.sin(ph)], -1)).to(
        device=device, dtype=dtype)


def windows_of(T: int, S: int, hop: int) -> int:
    return (T - S) // hop + 1


def capture_mean(prec: Prec, x: torch.Tensor, N: int, S: int, hop: int,
                 B: int):
    """(Rr, Ri) of (1/B) Σ_w R_w over the B windows of the capture x
    [T, 2N]: each sample weighted by the number of windows that hold it."""
    last = (B - 1) * hop + S
    t = torch.arange(last, device=x.device)
    # windows w with w·hop ≤ t < w·hop + S
    hi = torch.clamp(t // hop, max=B - 1)
    lo = torch.clamp((t - S) // hop + 1, min=0)
    weight = (hi - lo + 1).to(prec.dtype)
    rr = ri = 0.0
    for a in range(0, last, PIECE):
        b = min(a + PIECE, last)
        xp = x[a:b].to(prec.dtype).reshape(b - a, N, 2)
        w = weight[a:b].sqrt()[:, None]
        r, i = cgram(prec, xp[..., 0] * w, xp[..., 1] * w, 1.0)
        rr, ri = rr + r, ri + i
    scale = 1.0 / (S * B)
    return rr * scale, ri * scale


def answers(x: torch.Tensor, cfg: dict, overlap: int, windows: torch.Tensor,
            prec: Prec, tie: float = 0.0) -> dict:
    """The configuration's MUSIC peaks at the given windows of the capture
    x [T, 2N] → {"values": [n, k], "angles": [n, k] (degrees),
    "candidates": [n, k, 3] (common.peaks_1d, bins within `tie`),
    "escalated": windows that ran the extra rounds}."""
    _unsupported(cfg)
    N = cfg["geometry"]["num_elements"]
    S = cfg["snapshot_size"]
    hop = S - overlap
    K, k = cfg["num_sources"], cfg["num_max_vals"]
    B = windows_of(x.shape[0], S, hop)
    mr, mi = capture_mean(prec, x, N, S, hop, B)
    start = windows.to(x.device)[:, None] * hop
    rows = start + torch.arange(S, device=x.device)[None, :]   # [n, S]
    xw = x[rows].to(prec.dtype).reshape(len(windows), S, N, 2)
    E = embed(*cgram(prec, xw[..., 0], xw[..., 1], 1.0 / S))
    warm = cfg["subspace_warm_start"] and B >= 32
    sub = dict(cfg, subspace_warm_start=warm)
    Vt, escalated = configured_subspace(prec, E, embed(mr, mi), 2 * K, sub, S)
    den = music_den(prec, Vt, steering(cfg, prec.dtype, x.device))
    g = cfg["grid"]
    vals, angles, cands = peaks_1d(den, k, g["lo_deg"], g["hi_deg"], tie)
    return {"values": vals, "angles": angles, "candidates": cands,
            "escalated": escalated}

