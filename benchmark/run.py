"""Run one cell of the benchmark of doa_tpu_torch on the card(s) of this
machine:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

--trace 0 measures the cell's end-to-end metrics over a closed loop of
--seconds seconds; --trace 1 reads its per-layer metrics from a
torch.profiler window of whole calls. Either way the served answers are
compared with the plain reference once the window has closed. The last
line of standard output is the result, one JSON object; the last lines of
standard error are the numbers compared, each beside its limit. With no
card (or fewer than the cell asks for) the run prints no result and exits
with 2; if JAX or the JAX package was loaded, with 3.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

from harness.runner import card_line, process_start, run_cell  # noqa: E402

T_START = process_start()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    from harness import fence
    from harness.spec import Cell, load_spec

    torch.set_num_threads(1)
    cell = Cell(load_spec(), args.workload)
    seen = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if seen < cell.chips:
        print(f"{cell.name} needs {cell.chips} CUDA card(s); torch sees "
              f"{seen}: no result", file=sys.stderr)
        return 2
    result, notes = run_cell(cell, args.seed, args.seconds,
                             bool(args.trace), t_start=T_START)
    banned = fence.loaded_banned()
    if banned:
        print(f"loaded in this process: {banned}; the benchmark measures "
              f"{fence.PROGRAM} alone: no result", file=sys.stderr)
        return 3
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell.chips,
              "memory_peak_bytes": result.pop("memory_peak_bytes")}
    if args.trace:
        device["busy_s"] = result.pop("busy_s")
        device["window_s"] = result.pop("window_s")
    checks = result.pop("checks")
    line = {"correct": result["correct"], "attempted": result["attempted"],
            "failed": result["failed"],
            "metrics": {k: {"value": v, "unit": units[k]}
                        for k, v in result["metrics"].items()},
            "device": device, "card": card_line()}
    if "breakdown" in result:
        line["breakdown"] = result["breakdown"]
    line["checks"] = checks
    for note in notes:
        print(note, file=sys.stderr)
    for name, c in checks.items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
