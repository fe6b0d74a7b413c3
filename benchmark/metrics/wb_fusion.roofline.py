"""wb_fusion.roofline: the wideband subspace and fusion stage (the subband
means, K4 twice, kernel 5), as a share of its roofline, read from the
program's own span doa.wb_fusion: the layer's bound as
wb_fusion_roofline counts its work (ctx.works, the twin's), over the
device time a call of the ops launched under doa.wb_fusion, the
harness's entry spans nested in it included."""

from harness import stages

LAYER = "wideband subspace and fusion"
UNIT = "%"
MOVES = "snapshots_per_s"


def read(ctx):
    return stages.stage_roofline(ctx, "doa.wb_fusion", "wb_fusion_roofline")
