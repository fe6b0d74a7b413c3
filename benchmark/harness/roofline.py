"""The yardstick of the roofline metrics: the published peaks of one
NVIDIA H100 SXM (NVIDIA's data sheet, dense rates, at the full 700 W
power limit) and the least time a layer's work can take on it.

A layer's work is fixed from the cell's shapes by its metric's file: the
bytes of its inputs read once and its outputs written once, at the
layer's boundary, and the operations its function needs, by type. The
bound is the larger of the bytes over the memory rate and the sum of each
type's operations over its rate. A product that has to be FP32-accurate
is counted as three TF32 products ("tf32x3"), the cheapest way the tensor
cores reach FP32 accuracy, so that no FP32-accurate route reads above its
bound.
"""

from __future__ import annotations

BYTES_PER_S = 3.35e12          # HBM3
RATES = {
    "fp32": 67e12,             # FLOP/s outside the tensor cores
    "tf32x3": 495e12 / 3,      # FLOP/s of an FP32-accurate product as
                               # three TF32 products on the tensor cores
    "int8": 1979e12,           # OP/s
}


def bound_s(work: dict) -> float:
    """{"bytes": n, "ops": {type: n}} → the least seconds the card could
    take."""
    t_bytes = work["bytes"] / BYTES_PER_S
    t_ops = sum(n / RATES[kind] for kind, n in work.get("ops", {}).items())
    return max(t_bytes, t_ops)


def share_pct(ctx, entries, work: dict):
    """100 × the layer's bound over the device time a call of the ops
    launched from the layer's entries; None where an entry has no span
    or the layer ran no op on the device."""
    missing = [e for e in entries if ctx.span_status.get(e)]
    if missing:
        ctx.note(f"no span for {missing}: "
                 f"{[ctx.span_status[e] for e in missing]}")
        return None
    t = ctx.trace.device_s_per_call(entries)
    if t <= 0:
        ctx.note(f"no device op launched from {list(entries)}")
        return None
    return 100.0 * bound_s(work) / t
