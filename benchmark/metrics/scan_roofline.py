"""scan_roofline: the scan layer's share of its roofline.

The layer is K2 with its peaks (ops/cuda/music_scan.py::music_scan_peaks,
the plan's "music_scan_peaks" stage). Its work at the boundary: Vt
f32[B, 2K, 2N] and the embedded steering f32[G, 2N] read once, the peaks
(values and angles, f32[B, k] each) written once; the products Vt·ã over
every window and bin (2·B·G·2K·2N operations, FP32-accurate, so counted
as three TF32 products) and, in FP32, the squares, sums, subtraction and
normalisation (B·G·(2·2K + 2)).
"""

from harness.roofline import share_pct

LAYER = "scan"
ENTRIES = ("doa_tpu_torch.plan:KERNELS.music_scan_peaks",)
UNIT = "%"
MOVES = "snapshots_per_s"


def work(s: dict) -> dict:
    B, G, n2, k2 = s["B"], s["G"], s["n2"], s["k2"]
    return {"bytes": (B * k2 * n2 + G * n2 + 2 * B * s["k"]) * 4,
            "ops": {"tf32x3": 2 * B * G * k2 * n2,
                    "fp32": B * G * (2 * k2 + 2)}}


def read(ctx):
    return share_pct(ctx, ENTRIES, work(ctx.shapes))
