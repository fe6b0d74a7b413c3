"""smoothing.roofline: the planes path's calibration correction (c cᴴ) ∘ R,
forward–backward averaging and spatial smoothing as a share of their
roofline, read from the program's own span doa.smoothing, which opens
inside doa.covariance after the Grams.

Their work at the boundary: the covariance planes (Rr, Ri) f32[B, N, N]
read once and the smoothed planes f32[B, L, L] written once (L the
subarray size, from the configuration's fields: the shapes do not carry
it)."""

from harness import stages
from harness.roofline import bound_s

LAYER = "calibration and smoothing"
UNIT = "%"
MOVES = "snapshots_per_s"
SPAN = "doa.smoothing"


def layer_work(s: dict, L: int) -> dict:
    return {"bytes": s["B"] * (s["N"] ** 2 + L ** 2) * 8}


def read(ctx):
    names, why = stages.family(ctx.trace, SPAN)
    if names is None:
        ctx.note(why)
        return None
    t = ctx.trace.device_s_per_call(names)
    if t <= 0:
        ctx.note(f"no device op launched under {SPAN}")
        return None
    L = ctx.fields["smoothing"]["subarray_size"]
    return 100.0 * bound_s(layer_work(ctx.shapes, L)) / t
