"""entry.idle: the share of the traced window in which the card ran no
operation while the host was inside the program's call (``doa.call``):
the complement of the device ops' union, clipped to the calls. What
device.idle reads beyond it falls between calls, in the harness and the
profiler."""

from harness import stages

LAYER = "entry"
UNIT = "share"
MOVES = "call_ms_p95"


def read(ctx):
    if not stages.instances(ctx.trace, stages.CALL):
        ctx.note(f"no {stages.CALL} span: the program opens no spans")
        return None
    return stages.idle_s_inside(ctx.trace, stages.CALL) / ctx.trace.window_s
