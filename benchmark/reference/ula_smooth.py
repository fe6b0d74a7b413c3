"""Plain reference of calibrated narrowband MUSIC with forward–backward
averaging and spatial smoothing on a uniform linear array, as the
configuration states it: windows of S samples every hop samples, R =
(1/S) Σ x xᴴ, the calibration correction folded as (c cᴴ) ∘ R, ½(R + J R̄ J),
the mean of the N − L + 1 diagonal L×L blocks, the cold power subspace of
K sources on its real embedding (the escalation detector armed at the
smoothed width 2L), MUSIC over a 1-D grid of angles with the L-element
steering, the k highest local maxima refined by a parabola.

`answers` works from the capture block alone (interleaved float32 samples
[T, 2N], the bytes of a complex64 (T, N) capture): it computes the
steering, the windows and every product again.

The subspace is cold whatever `subspace_warm_start` says: the planes path
(the route smoothing takes) starts each window from MGS of its own first
2K rows and runs `power_iters` rounds. Every flagged window runs the extra
rounds here, while the program escalates at most
`subspace_escalate_capacity` windows a call, the worst first: the two
agree while a call flags no more windows than that, which the cells'
readings show (a call that flagged more would need the whole block's
scores to say which windows the program left).
"""

from __future__ import annotations

import torch

from reference.common import (Prec, cgram, configured_subspace, embed,
                              music_den, peaks_1d)
from reference.ula_music import steering, windows_of


def _unsupported(cfg: dict) -> None:
    L = cfg["smoothing"]["subarray_size"]
    if (cfg["beamspace"]["num_beams"]
            or cfg["wideband"]["num_subbands"] > 1
            or cfg["subspace_method"] != "power"
            or cfg["estimators"] != ["music"]
            or cfg["geometry"]["kind"] != "ula"
            or cfg["cov_dtype"] != "float32"
            or cfg["compute_dtype"] != "float32"
            or cfg["power_schedule"] != "e1"
            or not 0 < L <= cfg["geometry"]["num_elements"]):
        raise ValueError("the smoothed ULA reference takes a ULA, plain "
                         "windows in float32, a subarray of 1 to N "
                         "elements and the e1 power subspace for MUSIC "
                         "only")


def correct(rr: torch.Tensor, ri: torch.Tensor, cr: torch.Tensor,
            ci: torch.Tensor):
    """(c cᴴ) ∘ R for c = cr + j·ci [N]: the covariance of diag(c)·x."""
    wr = cr[:, None] * cr[None, :] + ci[:, None] * ci[None, :]
    wi = ci[:, None] * cr[None, :] - cr[:, None] * ci[None, :]
    return rr * wr - ri * wi, rr * wi + ri * wr


def forward_backward(rr: torch.Tensor, ri: torch.Tensor):
    """½(R + J R̄ J): J reverses both axes, R̄ negates the imaginary part."""
    return 0.5 * (rr + rr.flip(-2, -1)), 0.5 * (ri - ri.flip(-2, -1))


def smooth(rr: torch.Tensor, ri: torch.Tensor, L: int):
    """The mean of the N − L + 1 diagonal L×L blocks of R."""
    M = rr.shape[-1] - L + 1
    sr = sum(rr[..., m:m + L, m:m + L] for m in range(M))
    si = sum(ri[..., m:m + L, m:m + L] for m in range(M))
    return sr / M, si / M


def answers(x: torch.Tensor, cfg: dict, overlap: int, windows: torch.Tensor,
            prec: Prec, tie: float = 0.0) -> dict:
    """The configuration's MUSIC peaks at the given windows of the capture
    x [T, 2N] → {"values": [n, k], "angles": [n, k] (degrees),
    "candidates": [n, k, 3] (common.peaks_1d, bins within `tie`),
    "escalated": windows that ran the extra rounds}."""
    _unsupported(cfg)
    N = cfg["geometry"]["num_elements"]
    L = cfg["smoothing"]["subarray_size"]
    S = cfg["snapshot_size"]
    hop = S - overlap
    K, k = cfg["num_sources"], cfg["num_max_vals"]
    B = windows_of(x.shape[0], S, hop)
    if int(windows.max()) >= B:
        raise ValueError(f"window {int(windows.max())} past the capture's "
                         f"{B}")
    start = windows.to(x.device)[:, None] * hop
    rows = start + torch.arange(S, device=x.device)[None, :]   # [n, S]
    xw = x[rows].to(prec.dtype).reshape(len(windows), S, N, 2)
    rr, ri = cgram(prec, xw[..., 0], xw[..., 1], 1.0 / S)
    del xw
    # the configuration states no correction: the identity, applied in
    # full as the program applies it
    one = torch.ones(N, dtype=rr.dtype, device=rr.device)
    rr, ri = correct(rr, ri, one, torch.zeros_like(one))
    if cfg["avg_method"]:
        rr, ri = forward_backward(rr, ri)
    if L < N:
        rr, ri = smooth(rr, ri, L)
    E = embed(rr, ri)
    cold = dict(cfg, subspace_warm_start=False)
    Vt, escalated = configured_subspace(prec, E, None, 2 * K, cold, S)
    sub = dict(cfg, geometry=dict(cfg["geometry"], num_elements=L))
    den = music_den(prec, Vt, steering(sub, prec.dtype, x.device))
    g = cfg["grid"]
    vals, angles, cands = peaks_1d(den, k, g["lo_deg"], g["hi_deg"], tie)
    return {"values": vals, "angles": angles, "candidates": cands,
            "escalated": escalated}
