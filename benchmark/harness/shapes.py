"""A cell's shapes, from its configuration's fields and its traffic: what
the work functions of the per-layer metrics count with."""

from __future__ import annotations

import math


def cell_shapes(fields: dict, T: int) -> dict:
    """fields: the DoaConfig fields (overlap included); T: samples a call.
    → {T, N, n2, S, hop, B, K, k2, k, G, warm_applies} and, wideband,
    {F, S_sub, M, g, chunks}: windows a call B, subbands F, frames M,
    chunk length g and chunks of the front end."""
    geo = fields["geometry"]
    N, S, K = geo["num_elements"], fields["snapshot_size"], \
        fields["num_sources"]
    s = {"T": T, "N": N, "n2": 2 * N, "S": S, "K": K, "k2": 2 * K,
         "k": fields["num_max_vals"],
         "warm_applies": fields["power_iters_warm"]}
    if geo["kind"] == "ura":
        g2 = fields["grid2d"]
        s["G"] = g2["num_az"] * g2["num_el"]
    else:
        s["G"] = fields["grid"]["num_points"]
    F = fields["wideband"]["num_subbands"]
    if F > 1:
        S_sub = S // F
        hop = max(S_sub - fields["overlap"] // F, 1)
        M = T // F
        g = math.gcd(S_sub, hop)
        s.update(F=F, S_sub=S_sub, hop=hop, M=M, g=g, chunks=M // g,
                 B=(M - S_sub) // hop + 1)
    else:
        hop = S - fields["overlap"]
        s.update(hop=hop, B=(T - S) // hop + 1)
    return s
