"""device.idle: the share of the traced window in which no operation ran
on the card (1 − the union of the device ops' intervals over the window's
length): the time the card waited for the host."""

LAYER = "device"
UNIT = "share"
MOVES = "call_ms_p95"


def read(ctx):
    return 1.0 - ctx.trace.busy_s() / ctx.trace.window_s
