"""step_mfu: the whole call's share of the card's roofline.

The least time the call's work could take, the sum of the bounds of the
cell's layers that have a work function (each layer's bytes or
operations, as its own metric counts them), over the call's wall time in
the traced window (host clock, idle time included). It bounds every
layer's share from above in the time it saves: a layer taken off the
path leaves its own metric silent, not this one.
"""

from harness.roofline import bound_s

LAYER = "entry"
UNIT = "%"
MOVES = "snapshots_per_s"


def read(ctx):
    if not ctx.works:
        ctx.note("the cell has no layer with a work function")
        return None
    call_s = ctx.trace.window_s / ctx.trace.n_calls
    return 100.0 * sum(bound_s(w) for w in ctx.works.values()) / call_s
