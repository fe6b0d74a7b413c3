"""calib.step_mfu: the whole call's share of the card's roofline on the
planes path, read as step_mfu reads it: the sum of the bounds of the
call's layers over the call's wall time in the traced window (host clock,
idle time included).

The layers, at the smoothed width n2 = 2L (L from the configuration's
fields):

* the Grams and windows, as planes_gram.roofline counts them;
* correction, FB and smoothing, as smoothing.roofline counts them;
* the cold subspace: E(R) f32[B, 2L, 2L] read once and Vt f32[B, 2K, 2L]
  written once; power_iters rounds, that is power_iters − 1 applies
  Vt·E (2·2K·(2L)² FP32 operations each) and power_iters + 1 MGS passes
  (2·2K(2K − 1)·2L + 3·2K·2L each: the dot products and updates of every
  row pair, each row's norm and scale);
* K2 with its peaks, as scan_roofline counts it, at 2L.
"""

from harness.roofline import bound_s
from harness.spec import load_metric

LAYER = "entry"
UNIT = "%"
MOVES = "snapshots_per_s"


def cold_subspace_work(s: dict, rounds: int) -> dict:
    B, n2, k2 = s["B"], s["n2"], s["k2"]
    mgs = 2 * k2 * (k2 - 1) * n2 + 3 * k2 * n2
    return {"bytes": B * (n2 * n2 + k2 * n2) * 4,
            "ops": {"fp32": B * ((rounds - 1) * 2 * k2 * n2 * n2
                                 + (rounds + 1) * mgs)}}


def layer_works(s: dict, fields: dict) -> dict:
    L = fields["smoothing"]["subarray_size"]
    smoothed = dict(s, n2=2 * L)
    return {"gram": load_metric("planes_gram.roofline").work(s),
            "smoothing": load_metric("smoothing.roofline").layer_work(s, L),
            "subspace": cold_subspace_work(smoothed, fields["power_iters"]),
            "scan": load_metric("scan_roofline").work(smoothed)}


def read(ctx):
    call_s = ctx.trace.window_s / ctx.trace.n_calls
    works = layer_works(ctx.shapes, ctx.fields)
    return 100.0 * sum(bound_s(w) for w in works.values()) / call_s
