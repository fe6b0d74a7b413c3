"""int8 ingest quantizer (doa_tpu.io.native.quantize_interleaved_int8).

Only this function is ported; the C++ framer stays with doa_tpu for now
(ROADMAP.md, queue A.5)."""

from __future__ import annotations

import torch


def quantize_interleaved_int8(xil: torch.Tensor, clip_sigma: float = 6.0):
    """Interleaved float sample rows → (int8 rows, scale) for the int8
    ingest mode (cov_dtype="int8").

    q = round(clip(x, ±A)·127/A), A = clip_sigma·RMS — a symmetric
    mid-tread quantizer, as an int8 ADC driven at `clip_sigma` sigmas of
    headroom. The scale (127/A, a 0-d tensor) is informational: the
    quantized covariance is scale²·R and every consumer downstream is
    scale-invariant. Runs on the tensor's device."""
    x = xil.to(torch.float32)
    rms = torch.sqrt(torch.mean(x * x))
    A = clip_sigma * rms.clamp_min(1e-30)
    s = 127.0 / A
    q = torch.round(x * s).clamp(-127, 127).to(torch.int8)
    return q, s
