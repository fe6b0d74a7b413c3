"""scan.roofline: the scan stage (K2 with its peaks), as a share of its
roofline, read from the program's own span doa.scan: the layer's bound
as scan_roofline counts its work (ctx.works, the twin's), over the
device time a call of the ops launched under doa.scan, the harness's
entry spans nested in it included."""

from harness import stages

LAYER = "scan"
UNIT = "%"
MOVES = "snapshots_per_s"


def read(ctx):
    return stages.stage_roofline(ctx, "doa.scan", "scan_roofline")
