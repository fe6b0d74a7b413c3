"""covariance.roofline: the covariance stage (K1's chunk Grams, the windows
and the embedding), as a share of its roofline, read from the program's
own span doa.covariance: the layer's bound as covariance_roofline counts
its work (ctx.works, the twin's), over the device time a call of the ops
launched under doa.covariance, the harness's entry spans nested in it
included."""

from harness import stages

LAYER = "covariance"
UNIT = "%"
MOVES = "snapshots_per_s"


def read(ctx):
    return stages.stage_roofline(ctx, "doa.covariance", "covariance_roofline")
