"""planes_gram.roofline: the planes path's Gram stage (kernel 8's chunk
Grams of the capture's two stride-2 planes and the windows) as a share of
its roofline, read from the program's own span doa.gram, which opens
inside doa.covariance around cpx_ops.cov_from_stream.

Its work at the boundary: the capture x f32[T, 2N] read once and the
covariance planes (Rr, Ri) f32[B, N, N] written once; the half of each
sample's real Gram [Xr | Xi]ᵀ[Xr | Xi] (2N(2N + 1) FP32 operations a
sample) that the Hermitian output determines. The bytes bound it."""

from harness import stages

LAYER = "covariance"
UNIT = "%"
MOVES = "snapshots_per_s"


def work(s: dict) -> dict:
    return {"bytes": s["T"] * s["n2"] * 4 + s["B"] * s["N"] ** 2 * 8,
            "ops": {"fp32": s["T"] * s["n2"] * (s["n2"] + 1)}}


def read(ctx):
    return stages.stage_roofline(ctx, "doa.gram", "planes_gram.roofline")
