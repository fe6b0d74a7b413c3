"""wb_fusion_roofline: the wideband subspace and fusion layer's share of
its roofline.

The layer is ops/wideband.py::wideband_music_cpx: the subband capture
means, K4 twice (the means' subspaces, then every subband window's warm
rounds) and kernel 5's fused scan P = (1/F) Σ_f min(den_f)/den_f. Its work
at the boundary: E_sub f32[F, B, 2N, 2N] read once and P f32[B, G]
written once; the products Vt·ã of every subband window and bin
(2·F·B·G·2K·2N, FP32-accurate, so three TF32 products), in FP32 the
squares, sums, subtraction, minimum, division and mean (F·B·G·(2·2K + 4))
and each window's warm applies (2·2K·(2N)² each).
"""

from harness.roofline import share_pct

LAYER = "wideband subspace and fusion"
ENTRIES = ("doa_tpu_torch.pipeline_torch:wideband_music_cpx",)
UNIT = "%"
MOVES = "snapshots_per_s"


def work(s: dict) -> dict:
    F, B, G, n2, k2 = s["F"], s["B"], s["G"], s["n2"], s["k2"]
    return {"bytes": F * B * n2 * n2 * 4 + B * G * 4,
            "ops": {"tf32x3": 2 * F * B * G * k2 * n2,
                    "fp32": F * B * G * (2 * k2 + 4)
                    + F * B * s["warm_applies"] * 2 * k2 * n2 * n2}}


def read(ctx):
    return share_pct(ctx, ENTRIES, work(ctx.shapes))
