"""The traced run: spans around the program's entries, a torch.profiler
window of whole calls, and the reduction of its trace to what the
per-layer metrics read.

Spans are recorded from the benchmark's side: each entry a per-layer
metric names ("module:attr", or "module:REGISTRY.key" for a registry dict
whose value is a callable or a tuple of callables) is replaced, in the
traced process only, by a wrapper that opens a ``record_function`` span
named after the entry. A device op belongs to the innermost span open on
the host when its launch was issued (the profiler's correlation id joins
the two).
"""

from __future__ import annotations

import functools
import importlib
import json
import os

import torch

CALL = "bench.call"
COPY = "bench.copy_out"
RECORD = "bench.record"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def _spanned(fn, name: str):
    @functools.wraps(fn)
    def inner(*args, **kwargs):
        with torch.profiler.record_function(name):
            return fn(*args, **kwargs)
    return inner


def install_spans(entries) -> dict:
    """Wrap each entry in a span named after it → {entry: None if wrapped,
    else why not}. Call before the pipeline is built: builders take their
    callables from these names."""
    status = {}
    for entry in entries:
        if entry in status:
            continue
        try:
            mod_name, path = entry.split(":")
            obj = importlib.import_module(mod_name)
            *parents, last = path.split(".")
            for p in parents:
                obj = obj[p] if isinstance(obj, dict) else getattr(obj, p)
            cur = obj[last] if isinstance(obj, dict) else getattr(obj, last)
            if isinstance(cur, tuple) and all(callable(c) for c in cur):
                new = tuple(_spanned(c, entry) for c in cur)
            elif callable(cur):
                new = _spanned(cur, entry)
            else:
                raise TypeError(f"{type(cur).__name__} is not callable")
            if isinstance(obj, dict):
                obj[last] = new
            else:
                setattr(obj, last, new)
            status[entry] = None
        except (ImportError, AttributeError, KeyError, TypeError,
                ValueError) as e:
            status[entry] = f"{type(e).__name__}: {e}"
    return status


def profile_calls(step, warm: int, active: int, path: str):
    """Run step(i) for warm + active calls under torch.profiler, the first
    `warm` outside the recorded window; write the Chrome trace to `path`.
    step must open the CALL span around each call."""
    from torch.profiler import ProfilerActivity, profile, schedule
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=warm, active=active,
                                   repeat=1),
                 on_trace_ready=lambda p: p.export_chrome_trace(path)) as prof:
        for i in range(warm + active):
            step(i)
            prof.step()


class Trace:
    """The recorded window of a Chrome trace: the calls, the host spans and
    every device op with the span it was launched from."""

    def __init__(self, path: str):
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        xs = [e for e in events if e.get("ph") == "X"]
        self.spans = sorted(((e["ts"], e["ts"] + e.get("dur", 0), e["name"])
                             for e in xs
                             if e.get("cat") == "user_annotation"
                             and not e["name"].startswith("ProfilerStep")),
                            key=lambda s: s[0])
        self.calls = [s for s in self.spans if s[2] == CALL]
        if not self.calls:
            raise ValueError(f"no {CALL} span in {path}")
        self.t0, self.t1 = self.calls[0][0], self.calls[-1][1]
        launch = {e["args"]["correlation"]: e["ts"] for e in xs
                  if e.get("cat") in LAUNCH_CATS
                  and "correlation" in e.get("args", {})}
        self.ops = []                # (start, end, name, span)
        for e in xs:
            if e.get("cat") not in DEVICE_CATS:
                continue
            start, end = e["ts"], e["ts"] + e.get("dur", 0)
            if end <= self.t0 or start >= self.t1:
                continue
            t = launch.get(e.get("args", {}).get("correlation"))
            self.ops.append((start, end, e["name"],
                             None if t is None else self.span_at(t)))
        self.ops.sort()

    def span_at(self, t: float):
        """The innermost span open at host time t (µs), or None."""
        best = None
        for a, b, name in self.spans:
            if a > t:
                break
            if b >= t and (best is None or b - a < best[1] - best[0]):
                best = (a, b, name)
        return None if best is None else best[2]

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-6

    @property
    def n_calls(self) -> int:
        return len(self.calls)

    def busy_s(self) -> float:
        """Seconds in which some device op ran: the union of their
        intervals, clipped to the window."""
        busy, end = 0.0, self.t0
        for a, b, _, _ in self.ops:
            a, b = max(a, end), min(b, self.t1)
            if b > a:
                busy += b - a
            end = max(end, b)
        return busy * 1e-6

    def gaps(self) -> list:
        """[(seconds, label)] of every interval of the window in which no
        device op ran, labelled by the innermost span open on the host at
        its middle ("harness" between spans)."""
        out, end = [], self.t0
        for a, b, _, _ in self.ops + [(self.t1, self.t1, None, None)]:
            if a > end:
                out.append(((a - end) * 1e-6,
                            self.span_at(0.5 * (a + end)) or "harness"))
            end = max(end, b)
        return out

    def device_s_per_call(self, spans) -> float:
        """Device seconds a call of the ops launched from any of `spans`."""
        spans = set(spans)
        return sum(b - a for a, b, _, s in self.ops
                   if s in spans) * 1e-6 / self.n_calls

    def breakdown(self) -> dict:
        """The ten device ops that took most time in the window, by name,
        and the ten longest idle gaps, by the host's span."""
        by_name = {}
        for a, b, name, _ in self.ops:
            by_name[name] = by_name.get(name, 0.0) + (b - a) * 1e-6
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(self.gaps(), key=lambda g: -g[0])[:10]
        return {"device_ops": [[n, s] for n, s in top],
                "idle_gaps": [[label, s] for s, label in gaps]}

    def write_spans(self, path: str) -> None:
        """The host spans and the device ops of the window as JSON lines."""
        with open(path, "w") as f:
            for a, b, name in self.spans:
                if b >= self.t0 and a <= self.t1:
                    f.write(json.dumps({"span": name, "ts_us": a,
                                        "dur_us": b - a}) + "\n")
            for a, b, name, span in self.ops:
                f.write(json.dumps({"op": name, "ts_us": a, "dur_us": b - a,
                                    "span": span}) + "\n")
