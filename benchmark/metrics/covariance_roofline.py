"""covariance_roofline: the covariance layer's share of its roofline.

The layer is ops/cuda/cov_embedded.py::cov_embedded as the fused
narrowband path calls it: K1's chunk Grams, the windows (window_sums,
skipped where the chunks are the windows), the planar fold, correction
and embedding. Its work at the boundary: the capture x f32[T, 2N] read
once, the embedded windows E f32[B, 2N, 2N] written once, and the half of
each sample's real Gram u uᵀ (2N(2N + 1) FP32 operations a sample) that
the Hermitian output determines.
"""

from harness.roofline import share_pct

LAYER = "covariance"
ENTRIES = ("doa_tpu_torch.pipeline_torch:cov_embedded",)
UNIT = "%"
MOVES = "snapshots_per_s"


def work(s: dict) -> dict:
    return {"bytes": s["T"] * s["n2"] * 4 + s["B"] * s["n2"] ** 2 * 4,
            "ops": {"fp32": s["T"] * s["n2"] * (s["n2"] + 1)}}


def read(ctx):
    return share_pct(ctx, ENTRIES, work(ctx.shapes))
