"""Profiling and timing utilities (port of doa_tpu/utils/profiling.py).

* `trace_to(dir)`: a context manager around `torch.profiler` (CPU
  activity, and CUDA activity where a card is present) that writes a
  Chrome trace of what ran inside it into `dir`.
* `Timer`: wall-clock laps with a completion fence. PyTorch returns
  before the card finishes, so `Timer.fence(x)` reads one element of the
  first tensor in a result to the host (`.cpu()`), which completes once
  the card has computed it.
* `span(name)`: the pipeline's named spans (``doa.call``,
  ``doa.covariance``, ``doa.sync.escalation``, ...). While a profiler
  records, a ``record_function`` whose host event lands in the same Chrome
  trace as the card's operations, on one clock; otherwise one shared
  no-op context, so a call pays a flag read a span when nothing records.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Optional

import numpy as np
import torch


_OFF = contextlib.nullcontext()


def span(name: str):
    """A context that names the work inside it on a profiler's trace: a
    ``torch.profiler.record_function(name)`` while a profiler records
    (``trace_to``, a benchmark's traced run, an operator's own), else a
    shared no-op context, with no object built. The profiler puts a device
    operation down to the innermost span open when it was launched, and
    nests the spans of one call inside its ``doa.call``."""
    if torch.autograd.profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _OFF


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
