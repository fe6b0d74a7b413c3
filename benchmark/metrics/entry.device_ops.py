"""entry.device_ops: device operations (kernels, copies, fills) a call
launches, counted in the traced window from the first call's issue to the
last call's answers on the host. Fewer, larger launches leave the host
less to do between them."""

LAYER = "entry"
UNIT = "ops/call"
MOVES = "call_ms_p95"


def read(ctx):
    return len(ctx.trace.ops) / ctx.trace.n_calls
