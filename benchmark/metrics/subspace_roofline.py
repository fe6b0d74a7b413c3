"""subspace_roofline: the subspace layer's share of its roofline.

The layer is ops/cpx_ops.py::signal_subspace_from_E_T as the fused path
calls it: the capture mean's subspace, K4's warm rounds over every window,
the escalation detector and, where a window is flagged, its extra rounds.
(The capture mean E.mean itself is launched by the caller, outside the
span.) Its work at the boundary: E f32[B, 2N, 2N] read once, Vt
f32[B, 2K, 2N] written once, and each window's warm applies Vt·E
(2·2K·(2N)² FP32 operations each).
"""

from harness.roofline import share_pct

LAYER = "subspace"
ENTRIES = ("doa_tpu_torch.pipeline_torch:signal_subspace_from_E_T",)
UNIT = "%"
MOVES = "snapshots_per_s"


def work(s: dict) -> dict:
    B, n2, k2 = s["B"], s["n2"], s["k2"]
    return {"bytes": B * n2 * n2 * 4 + B * k2 * n2 * 4,
            "ops": {"fp32": B * s["warm_applies"] * 2 * k2 * n2 * n2}}


def read(ctx):
    return share_pct(ctx, ENTRIES, work(ctx.shapes))
