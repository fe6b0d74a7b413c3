#!/usr/bin/env python3
"""Time whole pipeline calls of two checkouts of the port in turns on one
NVIDIA GPU: the headline with and without spectra, the headline under
subspace_impl="pallas" (kernel 11, without spectra), c5, c5_f12, c5 cssm
and cssm_auto (chip_smoke.py's scenes and configs), and trace one window
of calls of each.

    python3 exp_paths.py --against OTHER_ROOT [--reps 20]

OTHER_ROOT is another checkout's root (e.g. an earlier commit unpacked by
`git archive`). Each root runs in worker processes of its own, in the
order OTHER, this, this, OTHER, so both share the machine's state alike;
a worker imports the root's doa_tpu_torch, builds its kernels, makes the
scenes on the card, checks every path's angles (the headline within 0.5°
of the planted scene in every window, c5 medians within 2.0°), then times
`reps` calls of each path after 3 warm ones (CUDA events around a call,
which ends in a host sync) and the host's wall clock around the same
calls, and traces 3 calls with torch.profiler: the union of the device
ops' intervals against the wall (the idle share), the top device ops, and
the caching allocator's retries and cudaMalloc calls in the timed calls.
Prints one line per worker and path, then the medians of each root (the
mean of its two workers' medians) beside the card's name and power limit.
"""

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
WARM = 3
PROFILE_CALLS = 3


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def trace(torch, fn):
    """→ (wall ms, device busy ms, top device ops) of PROFILE_CALLS calls:
    the union of the device ops' intervals (chip_smoke.profile_window's
    rule)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(PROFILE_CALLS):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3

    def on_device(ev):
        return (ev.device_type == DeviceType.CUDA
                and ev.key != "Activity Buffer Request")

    spans = sorted((ev.time_range.start, ev.time_range.end)
                   for ev in prof.events() if on_device(ev))
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    rows = sorted(((ev.self_device_time_total / 1e3 / PROFILE_CALLS,
                    ev.key[:70]) for ev in prof.key_averages()
                   if on_device(ev)), reverse=True)[:6]
    return wall, busy / 1e3, rows


def worker(root, reps):
    """Time and trace every path with root's package → {path: figures}."""
    sys.path.insert(0, root)
    sys.path.insert(1, HERE)
    import torch
    import doa_tpu_torch
    import chip_smoke as cs
    from doa_tpu_torch import PRESETS
    from doa_tpu_torch.pipeline_torch import build_pipeline_torch

    pkg = os.path.dirname(os.path.abspath(doa_tpu_torch.__file__))
    if os.path.dirname(pkg) != os.path.abspath(root):
        sys.exit(f"imported {pkg}, not {root}'s package")
    dev = torch.device("cuda")
    x = cs.make_scene(torch, cs.T_MAIN, 16, dev)
    x16 = cs.make_c5_scene(torch, cs.T_C5, dev, seed=5)
    x12 = cs.make_c5_scene(torch, cs.T_F12, dev, seed=4)
    torch.cuda.synchronize()
    head = cs.headline_config()
    paths = {
        "headline": (build_pipeline_torch(head, device=dev,
                                          return_spectra=False), x),
        "headline spectra": (build_pipeline_torch(head, device=dev), x),
        "headline pallas": (build_pipeline_torch(
            dataclasses.replace(head, subspace_impl="pallas"), device=dev,
            return_spectra=False), x),
        "c5": (build_pipeline_torch(PRESETS["c5_ura64_wideband"],
                                    device=dev), x16),
        "c5_f12": (build_pipeline_torch(cs.c5_variant(
            snapshot_size=768, num_subbands=12), device=dev), x12),
        "c5 cssm": (build_pipeline_torch(
            cs.c5_variant(fusion="cssm"), device=dev), x16),
        "c5 cssm_auto": (build_pipeline_torch(
            cs.c5_variant(fusion="cssm_auto"), device=dev), x16),
    }
    out = {}
    for name, (pipe, xin) in paths.items():
        def call():
            return pipe.interleaved(xin)
        ang = call().peak_angles["music"]
        if ang.dim() == 3:
            _, _, med = cs.c5_errors(torch, ang, cs.C5_TRUTH)
            err = float((med - torch.tensor(cs.C5_TRUTH, device=dev)
                         ).abs().max())
            ok = err <= cs.CSSM_ANGLE_TOL
        else:
            err = cs.angle_err(torch, ang)
            ok = err <= cs.ANGLE_TOL
        if not ok:
            sys.exit(f"{root} {name}: angles off by {err} deg")
        for _ in range(WARM):
            call()
        torch.cuda.synchronize()
        stats0 = torch.cuda.memory_stats()
        dev_ms, host_ms = [], []
        for _ in range(reps):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            e0.record()
            call()
            e1.record()
            e1.synchronize()
            host_ms.append((time.perf_counter() - t0) * 1e3)
            dev_ms.append(e0.elapsed_time(e1))
        stats1 = torch.cuda.memory_stats()
        wall, busy, rows = trace(torch, call)
        dev_ms.sort()
        host_ms.sort()
        out[name] = dict(
            median_ms=dev_ms[reps // 2], min_ms=dev_ms[0],
            max_ms=dev_ms[-1], host_median_ms=host_ms[reps // 2],
            angle_err_deg=err,
            trace_wall_ms=wall / PROFILE_CALLS,
            trace_busy_ms=busy / PROFILE_CALLS,
            idle_share=1.0 - busy / wall,
            alloc_retries=stats1["num_alloc_retries"]
            - stats0["num_alloc_retries"],
            cuda_mallocs=stats1["segment.all.allocated"]
            - stats0["segment.all.allocated"],
            top_ops=rows)
        del pipe
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--against", required=True,
                    help="another checkout's root")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        print("RESULT " + json.dumps(worker(args.worker, args.reps)),
              flush=True)
        return
    import torch
    if not torch.cuda.is_available():
        sys.exit("exp_paths.py needs an NVIDIA GPU")
    card = card_line()
    other = os.path.abspath(args.against)
    runs = {HERE: [], other: []}
    for root in (other, HERE, HERE, other):
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--against", other,
             "--reps", str(args.reps), "--worker", root],
            capture_output=True, text=True, timeout=1800)
        lines = [ln for ln in proc.stdout.splitlines()
                 if ln.startswith("RESULT ")]
        if proc.returncode != 0 or not lines:
            sys.exit(f"worker {root} failed ({proc.returncode}):\n"
                     f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
        res = json.loads(lines[-1][len("RESULT "):])
        runs[root].append(res)
        tag = "this" if root == HERE else "against"
        for name, r in res.items():
            print(f"{tag} {name}: median {r['median_ms']:.4f} ms (min "
                  f"{r['min_ms']:.4f}, max {r['max_ms']:.4f}; host clock "
                  f"{r['host_median_ms']:.4f}); trace {PROFILE_CALLS} calls: "
                  f"wall {r['trace_wall_ms']:.4f}, device busy "
                  f"{r['trace_busy_ms']:.4f} ms a call, idle "
                  f"{r['idle_share']:.3f}; allocator retries "
                  f"{r['alloc_retries']}, cudaMallocs {r['cuda_mallocs']}; "
                  f"angle error {r['angle_err_deg']:.4f} deg  [{card}]",
                  flush=True)
            for ms, key in r["top_ops"]:
                print(f"    {ms:9.4f} ms/call  {key}", flush=True)
    summary = {}
    for root, tag in ((other, "against"), (HERE, "this")):
        summary[tag] = {
            name: 0.5 * sum(r[name]["median_ms"] for r in runs[root])
            for name in runs[root][0]}
    print(f"medians, mean of two workers each, ms  [{card}]")
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
