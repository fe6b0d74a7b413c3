"""wb_front.roofline: the wideband front end (kernel 4), as a share of its
roofline, read from the program's own span doa.wb_front: the layer's
bound as wb_front_roofline counts its work (ctx.works, the twin's), over
the device time a call of the ops launched under doa.wb_front, the
harness's entry spans nested in it included."""

from harness import stages

LAYER = "wideband front end"
UNIT = "%"
MOVES = "snapshots_per_s"


def read(ctx):
    return stages.stage_roofline(ctx, "doa.wb_front", "wb_front_roofline")
