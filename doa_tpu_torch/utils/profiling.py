"""Profiling and timing utilities (port of doa_tpu/utils/profiling.py).

* `trace_to(dir)`: a context manager around `torch.profiler` (CPU
  activity, and CUDA activity where a card is present) that writes a
  Chrome trace of what ran inside it into `dir`.
* `Timer`: wall-clock laps with a completion fence. PyTorch returns
  before the card finishes, so `Timer.fence(x)` reads one element of the
  first tensor in a result to the host (`.cpu()`), which completes once
  the card has computed it.
* `throughput_report`: snapshots/s + samples/s from timed runs (a copy).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Optional

import numpy as np
import torch


@contextlib.contextmanager
def trace_to(log_dir: str):
    """Profile the body; on exit write ``trace_<pid>_<ns>.json`` (Chrome
    trace format) into log_dir, made if missing. The context yields the
    profiler."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def first_tensor(x) -> Optional[torch.Tensor]:
    """The first tensor in x, depth first through dataclass fields, dict
    values, lists and tuples (doa_tpu's first pytree leaf); None if
    there is none."""
    if isinstance(x, torch.Tensor):
        return x
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        items = (getattr(x, f.name) for f in dataclasses.fields(x))
    elif isinstance(x, dict):
        items = x.values()
    elif isinstance(x, (list, tuple)):
        items = x
    else:
        return None
    for item in items:
        t = first_tensor(item)
        if t is not None:
            return t
    return None


class Timer:
    def __init__(self):
        self.laps = []
        self._t0 = None

    @staticmethod
    def fence(x) -> None:
        """Completion fence: one element of the first tensor of x read to
        the host."""
        t = first_tensor(x)
        if t is not None:
            t.reshape(-1)[:1].cpu()

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.laps.append(time.perf_counter() - self._t0)

    @property
    def mean(self) -> float:
        return float(np.mean(self.laps)) if self.laps else float("nan")

    @property
    def best(self) -> float:
        return float(np.min(self.laps)) if self.laps else float("nan")


def throughput_report(seconds_per_call: float, snapshots_per_call: int,
                      snapshot_size: int, num_channels: int,
                      samp_rate: Optional[float] = None,
                      hop: Optional[int] = None) -> dict:
    """samples/s counts each INPUT sample once: with overlapped windows a
    snapshot advances the stream by `hop` samples (hop = S − overlap), not
    by snapshot_size — pass `hop` for overlapped configs or samples/s,
    ingest bytes/s and x_realtime over-count by S/hop."""
    snaps_s = snapshots_per_call / seconds_per_call
    samples_s = snaps_s * (hop if hop is not None else snapshot_size)
    rep = {
        "snapshots_per_s": snaps_s,
        "samples_per_s_per_channel": samples_s,
        "aggregate_samples_per_s": samples_s * num_channels,
        "ingest_bytes_per_s": samples_s * num_channels * 8.0,
    }
    if samp_rate:
        rep["x_realtime"] = samples_s / samp_rate
    return rep
