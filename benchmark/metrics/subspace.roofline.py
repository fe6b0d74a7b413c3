"""subspace.roofline: the subspace stage as a share of its roofline, read
from the program's own span doa.subspace: the layer's bound as
subspace_roofline counts its work (ctx.works, the twin's), over the device
time a call of the ops launched under doa.subspace, the harness's entry
spans nested in it included. Unlike the twin it holds the capture mean
E.mean, which the warm start launches before its first subspace."""

from harness import stages

LAYER = "subspace"
UNIT = "%"
MOVES = "snapshots_per_s"


def read(ctx):
    return stages.stage_roofline(ctx, "doa.subspace", "subspace_roofline")
