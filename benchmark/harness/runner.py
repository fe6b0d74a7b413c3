"""One run of one cell: set-up, the measured window (or the traced one),
the comparison with the plain reference, and the result's line.

run_cell takes the device as an argument so that a test can drive a run
on the CPU at a small size; run.py is what looks for the card.
"""

from __future__ import annotations

import gc
import math
import os
import subprocess
import tempfile
import time

import numpy as np
import torch

from harness import checks, tracing, traffic
from harness.shapes import cell_shapes

WARM_TRACE_CALLS = 2     # calls the profiler runs before its window


def process_start() -> float:
    """perf_counter() at this process's start (from /proc: the kernel's
    start time of the process and the system's uptime)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return time.perf_counter() - (uptime - start_ticks
                                  / os.sysconf("SC_CLK_TCK"))


def build_config(fields: dict):
    """The port's DoaConfig from the configuration file's fields."""
    from doa_tpu_torch import configs as c
    nested = {"geometry": c.ArrayGeometry, "grid": c.GridSpec1D,
              "grid2d": c.GridSpec2D, "smoothing": c.SmoothingSpec,
              "wideband": c.WidebandSpec, "beamspace": c.BeamspaceSpec}
    kw = {}
    for name, value in fields.items():
        if name in nested and value is not None:
            value = dict(value)
            if "shape" in value and value["shape"] is not None:
                value["shape"] = tuple(value["shape"])
            value = nested[name](**value)
        elif name == "estimators":
            value = tuple(c.Estimator(e) for e in value)
        elif name == "avg_method":
            value = c.AvgMethod(value)
        kw[name] = value
    return c.DoaConfig(**kw)


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()
        return out[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


class LayerContext:
    """What a per-layer metric's reader reads: the cell's shapes and
    fields, the traced window, which entries have spans, and the works of
    the cell's layers."""

    def __init__(self, shapes, fields, trace, span_status):
        self.shapes, self.fields = shapes, fields
        self.trace, self.span_status = trace, span_status
        self.works = {}              # metric name → its layer's work
        self.notes = []

    def note(self, msg: str) -> None:
        self.notes.append(msg)


def _answers(pipe, x, key):
    res = pipe.interleaved(x)
    values = res.peak_values[key].cpu().numpy()
    angles = res.peak_angles[key].cpu().numpy()
    return angles, values


def run_cell(cell, seed: int, seconds: float, trace: bool, *,
             device="cuda", t_start: float | None = None,
             samples: int | None = None, blocks: int | None = None,
             windows_per_block: int | None = None,
             trace_path: str | None = None) -> tuple:
    """→ (the result's dict, the notes to print). samples, blocks and
    windows_per_block shrink the cell for a run on the CPU."""
    t_start = process_start() if t_start is None else t_start
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats(dev)
    tr = cell.traffic
    fields = cell.fields
    notes = []
    metric_mods = {m["name"]: cell.metric(m["name"]) for m in cell.per_layer}
    span_status = {}
    if trace:
        entries = [e for mod in metric_mods.values()
                   for e in getattr(mod, "ENTRIES", ())]
        span_status = tracing.install_spans(entries)
    phases = [("start", t_start), ("imports", time.perf_counter())]
    from doa_tpu_torch.pipeline_torch import build_pipeline_torch
    pipe = build_pipeline_torch(build_config(fields), device=dev,
                                return_spectra=False)
    phases.append(("pipeline", time.perf_counter()))
    key = tr["answer_key"]
    ring = traffic.make_ring(fields, tr, seed, dev, samples, blocks)
    if on_card:
        torch.cuda.synchronize(dev)
    phases.append(("ring", time.perf_counter()))
    T = ring[0][0].shape[0]
    shapes = cell_shapes(fields, T)
    count = tr["check"]["windows_per_block"] if windows_per_block is None \
        else windows_per_block
    envs = [checks.Envelope(traffic.check_windows(
        seed, i, shapes["B"], count, tr["check"]["run_windows"]))
        for i in range(len(ring))]
    for i in range(tr["warmup_calls"]):
        _answers(pipe, ring[i % len(ring)][0], key)
    if on_card:
        torch.cuda.synchronize(dev)
    phases.append(("warm-up", time.perf_counter()))
    notes.append("set-up: " + ", ".join(
        f"{name} {t - t0:.3f} s" for (_, t0), (name, t) in
        zip(phases, phases[1:])))
    result = {"metrics": {}}
    if not trace:
        t_first = time.perf_counter()
        setup_s = t_first - t_start
        deadline = t_first + seconds
        calls, lat = 0, []
        while True:
            b = calls % len(ring)
            t0 = time.perf_counter()
            angles, values = _answers(pipe, ring[b][0], key)
            t1 = time.perf_counter()
            lat.append(t1 - t0)
            calls += 1
            envs[b].add(angles, values)
            if t1 >= deadline:
                break
        window_s = t1 - t_first
        result["metrics"] = {
            "snapshots_per_s": calls * shapes["B"] / window_s,
            "call_ms_p95": float(np.percentile(np.array(lat) * 1e3, 95)),
            "setup_s": setup_s}
    else:
        calls = WARM_TRACE_CALLS + tr["trace_calls"]
        path = trace_path or os.path.join(
            tempfile.gettempdir(), "doa_bench",
            f"{cell.name}.{seed}.trace.json")

        def step(i):
            b = i % len(ring)
            with torch.profiler.record_function(tracing.CALL):
                res = pipe.interleaved(ring[b][0])
                with torch.profiler.record_function(tracing.COPY):
                    values = res.peak_values[key].cpu().numpy()
                    angles = res.peak_angles[key].cpu().numpy()
            with torch.profiler.record_function(tracing.RECORD):
                envs[b].add(angles, values)

        tracing.profile_calls(step, WARM_TRACE_CALLS, tr["trace_calls"],
                              path)
        tw = tracing.Trace(path)
        tw.write_spans(path.replace(".trace.json", ".spans.jsonl"))
        ctx = LayerContext(shapes, fields, tw, span_status)
        for name, mod in metric_mods.items():
            if hasattr(mod, "work"):
                ctx.works[name] = mod.work(shapes)
        for m in cell.per_layer:
            ctx.notes = []
            value = (metric_mods[m["name"]].read(ctx) if tw.ops
                     else ctx.note("no device op in the traced window"))
            if value is None:
                notes.append(f"{m['name']}: nothing to read "
                             f"({'; '.join(ctx.notes) or 'no reason given'})")
                continue
            result["metrics"][m["name"]] = value
        result["busy_s"], result["window_s"] = tw.busy_s(), tw.window_s
        result["breakdown"] = tw.breakdown()
        for entry, why in span_status.items():
            if why:
                notes.append(f"no span for {entry}: {why}")
    failed = sum(e.failed_calls() for e in envs)
    result["attempted"], result["failed"] = calls, failed
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    # the program's state goes before the reference runs
    del pipe
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    gaps = reference_gaps(cell, ring, envs)
    limits = tr["check"]["limits"]
    result["correct"] = (failed == 0 and checks.verdict(gaps, limits)
                         and all(e.calls for e in envs))
    result["checks"] = {n: {"value": None if math.isnan(gaps[n]) else gaps[n],
                            "limit": limits[n]} for n in checks.NAMES}
    result["memory_peak_bytes"] = int(peak)
    return result, notes


def reference_gaps(cell, ring, envs, prec_name: str = "float64"):
    """The widest gaps of the served answers from the plain reference's,
    over the blocks that were served; a neighbour of a peak's bin whose
    spectrum lies within the cell's value limit of the peak's is as good
    a bin for the peak as its own (checks.Envelope.gaps)."""
    from reference.common import Prec
    ref = cell.reference()
    prec = Prec(prec_name)
    tie = cell.traffic["check"]["limits"]["value_gap"]
    out = []
    for (x, _), env in zip(ring, envs):
        if not env.calls:
            continue
        a = ref.answers(x, cell.config["doa_config"], cell.traffic["overlap"],
                        torch.from_numpy(env.windows), prec, tie)
        out.append(env.gaps({key: a[key].double().cpu().numpy() for key in
                             ("angles", "values", "candidates")}))
    return checks.merge(out) if out else {n: math.nan for n in checks.NAMES}

