"""The readings that a cell's correctness limits are set from, in one
process (the pipeline is built once):

* program: for each seed, the cell's ring of blocks, `--calls` calls of
  the timed entry over it at the cell's own size, and the widest gaps of
  their answers from the plain reference at the cell's checked windows,
  as a run reads them;
* control: for each control seed, the plain reference computed in the
  nearest precision below the configuration's (float32 with TF32
  products, common.Prec("tf32")) put in the program's place, read the
  same way.

    python3 benchmark/readings.py --workload <cell> --seeds 1,2,3 \\
        --control-seeds 1,2,3 [--calls 8] [--device cuda]

One JSON line a reading on standard output. The benchmark's own runs do
not run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

import numpy as np  # noqa: E402
import torch  # noqa: E402

from harness import checks, traffic  # noqa: E402
from harness.runner import build_config, reference_gaps  # noqa: E402
from harness.shapes import cell_shapes  # noqa: E402
from harness.spec import Cell, load_spec  # noqa: E402


def _envelopes(cell, seed, ring, count):
    B = cell_shapes(cell.fields, ring[0][0].shape[0])["B"]
    return [checks.Envelope(traffic.check_windows(
        seed, i, B, count, cell.traffic["check"]["run_windows"]))
        for i in range(len(ring))]


def program_reading(cell, pipe, seed, device, calls, samples=None,
                    blocks=None, count=None) -> dict:
    tr = cell.traffic
    count = tr["check"]["windows_per_block"] if count is None else count
    ring = traffic.make_ring(cell.fields, tr, seed, device, samples, blocks)
    envs = _envelopes(cell, seed, ring, count)
    key = tr["answer_key"]
    for i in range(calls):
        b = i % len(ring)
        res = pipe.interleaved(ring[b][0])
        envs[b].add(res.peak_angles[key].cpu().numpy(),
                    res.peak_values[key].cpu().numpy())
    gaps = reference_gaps(cell, ring, envs)
    return {"seed": seed, "kind": "program", "calls": calls,
            "directions": [d for _, d in ring], **gaps}


def control_reading(cell, seed, device, samples=None, blocks=None,
                    count=None) -> dict:
    from reference.common import Prec
    tr = cell.traffic
    count = tr["check"]["windows_per_block"] if count is None else count
    ring = traffic.make_ring(cell.fields, tr, seed, device, samples, blocks)
    envs = _envelopes(cell, seed, ring, count)
    ref = cell.reference()
    for (x, _), env in zip(ring, envs):
        a = ref.answers(x, cell.config["doa_config"], tr["overlap"],
                        torch.from_numpy(env.windows), Prec("tf32"))
        # the control's answers at the checked windows, placed as a call's
        B = cell_shapes(cell.fields, x.shape[0])["B"]
        ang = a["angles"].double().cpu().numpy()
        val = a["values"].double().cpu().numpy()
        full_a = _scatter(ang, env.windows, B)
        full_v = _scatter(val, env.windows, B)
        env.add(full_a, full_v)
    gaps = reference_gaps(cell, ring, envs)
    return {"seed": seed, "kind": "control", **gaps}


def _scatter(a, windows, B):
    out = np.full((B,) + a.shape[1:], np.nan)
    out[windows] = a
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--calls", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cell = Cell(load_spec(), args.workload)
    dev = torch.device(args.device)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    if seeds:
        from doa_tpu_torch.pipeline_torch import build_pipeline_torch
        pipe = build_pipeline_torch(build_config(cell.fields), device=dev,
                                    return_spectra=False)
        for seed in seeds:
            t0 = time.perf_counter()
            r = program_reading(cell, pipe, seed, dev, args.calls)
            r["seconds"] = time.perf_counter() - t0
            print(json.dumps(r), flush=True)
    for seed in (int(s) for s in args.control_seeds.split(",") if s):
        t0 = time.perf_counter()
        r = control_reading(cell, seed, dev)
        r["seconds"] = time.perf_counter() - t0
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
