"""entry.host_syncs: the host reads a call makes that wait for the card
(each a ``doa.sync.<where>`` span the program opens around the read
alone), counted in the traced window. Each one drains the card's queue
before the host can launch the rest of the call."""

from harness import stages

LAYER = "entry"
UNIT = "syncs/call"
MOVES = "call_ms_p95"


def read(ctx):
    if not stages.instances(ctx.trace, stages.CALL):
        ctx.note(f"no {stages.CALL} span: the program opens no spans")
        return None
    return stages.count_per_call(ctx.trace, stages.SYNCS)
