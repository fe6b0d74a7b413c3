"""wb_front_roofline: the wideband front end's share of its roofline.

The layer is ops/cuda/wideband_cov.py::wideband_cov_embedded: kernel 4's
F-point DFT of every frame and each subband's chunk Grams, and the
windows. Its work at the boundary: the frames f32[M, F·2N] read once,
E_sub f32[F, chunks, 2N, 2N] written once; an F-point FFT (5·F·log2 F)
a frame and element, and the Hermitian half of the subband Grams
(4·g·N² a chunk and subband), in FP32.
"""

import math

from harness.roofline import share_pct

LAYER = "wideband front end"
ENTRIES = ("doa_tpu_torch.pipeline_torch:wideband_cov_embedded",)
UNIT = "%"
MOVES = "snapshots_per_s"


def work(s: dict) -> dict:
    M, F, N, g, n = s["M"], s["F"], s["N"], s["g"], s["chunks"]
    return {"bytes": M * F * 2 * N * 4 + F * n * 4 * N * N * 4,
            "ops": {"fp32": 5 * F * math.log2(F) * M * N
                    + 4 * g * N * N * F * n}}


def read(ctx):
    return share_pct(ctx, ENTRIES, work(ctx.shapes))
