"""Plain reference of wideband incoherent MUSIC on a uniform rectangular
array, as the configuration states it: frames of F consecutive samples,
an F-point DFT of each frame (subband f is DFT bin f, at the baseband
offset fftfreq(F)[f]), windows of S/F subband samples, each subband's
R = (F/S) Σ y yᴴ, the power subspace of K sources in every subband (warm
start from the subband's capture mean, the escalation detector at S/F
snapshots), each subband's MUSIC over the az/el grid at its own element
spacing d·(1 + f·fractional_bw), the fused spectrum P = (1/F) Σ_f
min(den_f)/den_f, and its k highest 2-D local maxima refined by a
parabola along each axis.

`answers` works from the capture block alone (interleaved float32 samples
[T, 2N]); the DFT is a product with the DFT matrix, so the control
computes it in TF32 like every other product.
"""

from __future__ import annotations

import numpy as np
import torch

from reference.common import (Prec, cgram, configured_subspace, embed,
                              music_den, peaks_2d)

PIECE = 1 << 14          # frames a piece when the capture means are summed


def _unsupported(cfg: dict) -> None:
    wb = cfg["wideband"]
    if (cfg["avg_method"] or cfg["smoothing"]["subarray_size"]
            or cfg["beamspace"]["num_beams"] or wb["num_subbands"] < 2
            or wb["fusion"] != "incoherent"
            or cfg["subspace_method"] != "power"
            or cfg["geometry"]["kind"] != "ura"
            or cfg["compute_dtype"] != "float32"
            or cfg["power_schedule"] != "e1"
            or cfg["scan_mode"] == "hierarchical"):
        raise ValueError("the URA wideband reference takes incoherent "
                         "fusion of the e1 power subspaces in float32 on "
                         "a dense az/el grid")


def dft_planes(F: int, dtype, device):
    """(Re, Im) of the F-point DFT matrix W[f, t] = exp(−2πj·f·t/F)."""
    ft = np.outer(np.arange(F), np.arange(F)) % F
    w = np.exp(-2j * np.pi * ft / F)
    return (torch.from_numpy(w.real.copy()).to(device=device, dtype=dtype),
            torch.from_numpy(w.imag.copy()).to(device=device, dtype=dtype))


def subband_spacings(cfg: dict) -> np.ndarray:
    wb = cfg["wideband"]
    freqs = np.fft.fftfreq(wb["num_subbands"])
    return cfg["geometry"]["norm_spacing"] * (1.0 + freqs
                                              * wb["fractional_bw"])


def steering(cfg: dict, dtype, device) -> torch.Tensor:
    """[F, G, 2N]: each subband's [Re a, Im a] over the az/el grid (az
    major), elements on an (nx, ny) grid flattened x major, a_n =
    exp(−j·2π·d_f·(ux·ix + uy·iy)), ux = cos el sin az, uy = cos el cos az."""
    g2, (nx, ny) = cfg["grid2d"], cfg["geometry"]["shape"]
    az = np.deg2rad(np.linspace(g2["az_lo_deg"], g2["az_hi_deg"],
                                g2["num_az"]))
    el = np.deg2rad(np.linspace(g2["el_lo_deg"], g2["el_hi_deg"],
                                g2["num_el"]))
    azg, elg = np.meshgrid(az, el, indexing="ij")
    ux = (np.cos(elg) * np.sin(azg)).ravel()
    uy = (np.cos(elg) * np.cos(azg)).ravel()
    ix = np.repeat(np.arange(nx), ny)
    iy = np.tile(np.arange(ny), nx)
    proj = ux[:, None] * ix + uy[:, None] * iy                # [G, N]
    out = [np.concatenate([np.cos(-2 * np.pi * d * proj),
                           np.sin(-2 * np.pi * d * proj)], -1)
           for d in subband_spacings(cfg)]
    return torch.from_numpy(np.stack(out)).to(device=device, dtype=dtype)


def channelize(prec: Prec, frames: torch.Tensor, W) -> tuple:
    """frames [M, F, N, 2] (float) → the subband samples (Yr, Yi)
    [F, M, N]: Y[f, m] = Σ_t W[f, t] x[m, t]."""
    M, F, N, _ = frames.shape
    xr = frames[..., 0].permute(1, 0, 2).reshape(F, M * N)
    xi = frames[..., 1].permute(1, 0, 2).reshape(F, M * N)
    wr, wi = W
    yr = prec.mm(wr, xr) - prec.mm(wi, xi)
    yi = prec.mm(wr, xi) + prec.mm(wi, xr)
    return yr.reshape(F, M, N), yi.reshape(F, M, N)


def answers(x: torch.Tensor, cfg: dict, overlap: int, windows: torch.Tensor,
            prec: Prec, tie: float = 0.0) -> dict:
    """The configuration's fused MUSIC peaks at the given windows of the
    capture x [T, 2N] → {"values": [n, k], "angles": [n, k, 2] (az, el in
    degrees), "candidates": [n, k, 9, 2] (common.peaks_2d, bins within
    `tie`), "escalated": subband windows that ran the extra rounds}."""
    _unsupported(cfg)
    N = cfg["geometry"]["num_elements"]
    F = cfg["wideband"]["num_subbands"]
    S, K, k = cfg["snapshot_size"], cfg["num_sources"], cfg["num_max_vals"]
    S_sub = S // F
    hop = max(S_sub - overlap // F, 1)
    M = x.shape[0] // F
    B = (M - S_sub) // hop + 1
    W = dft_planes(F, prec.dtype, x.device)
    frames = x[:M * F].reshape(M, F, N, 2)
    # each subband's capture mean: a subband sample weighted by the number
    # of windows that hold it
    last = (B - 1) * hop + S_sub
    m = torch.arange(last, device=x.device)
    weight = (torch.clamp(m // hop, max=B - 1)
              - torch.clamp((m - S_sub) // hop + 1, min=0) + 1).to(prec.dtype)
    mr = mi = 0.0
    for a in range(0, last, PIECE):
        b = min(a + PIECE, last)
        yr, yi = channelize(prec, frames[a:b].to(prec.dtype), W)
        w = weight[a:b].sqrt()[None, :, None]
        r, i = cgram(prec, yr * w, yi * w, 1.0)
        mr, mi = mr + r, mi + i
    E_mean = embed(mr, mi) / (S_sub * B)                     # [F, 2N, 2N]
    n = len(windows)
    rows = (windows.to(x.device)[:, None] * hop
            + torch.arange(S_sub, device=x.device)[None, :])  # [n, S_sub]
    yr, yi = channelize(prec, frames[rows.reshape(-1)].to(prec.dtype), W)
    yr, yi = (y.reshape(F, n, S_sub, N) for y in (yr, yi))
    E = embed(*cgram(prec, yr, yi, 1.0 / S_sub))              # [F, n, ...]
    warm = cfg["subspace_warm_start"] and B >= 32
    sub = dict(cfg, subspace_warm_start=warm)
    At = steering(cfg, prec.dtype, x.device)
    P, escalated = 0.0, 0
    for f in range(F):
        Vt, esc = configured_subspace(prec, E[f], E_mean[f], 2 * K, sub,
                                      S // F)
        den = music_den(prec, Vt, At[f])
        P = P + den.min(-1, keepdim=True).values / den
        escalated += esc
    P = P / F
    g2 = cfg["grid2d"]
    P = P.reshape(n, g2["num_az"], g2["num_el"])
    vals, angles, cands = peaks_2d(P, k, (g2["az_lo_deg"], g2["az_hi_deg"]),
                                   (g2["el_lo_deg"], g2["el_hi_deg"]), tie)
    return {"values": vals, "angles": angles, "candidates": cands,
            "escalated": escalated}
