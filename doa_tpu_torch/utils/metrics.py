"""Structured pipeline metrics & logging (SURVEY §5 observability: the
reference's observability was a qtgui plot; here results and rates are
structured and log-friendly).

A copy of doa_tpu/utils/metrics.py (no jax in it either)."""

from __future__ import annotations

import dataclasses
import json
import logging
import time
from typing import Optional

logger = logging.getLogger("doa_tpu_torch")


@dataclasses.dataclass
class PipelineMetrics:
    """Rolling counters for a streaming deployment."""

    t_start: float = dataclasses.field(default_factory=time.time)
    samples_in: int = 0
    windows_out: int = 0
    blocks_dropped: int = 0
    last_angles: Optional[list] = None

    def update(self, samples: int, windows: int, angles=None,
               dropped: int = 0):
        self.samples_in += samples
        self.windows_out += windows
        self.blocks_dropped += dropped
        if angles is not None:
            self.last_angles = [float(a) for a in angles]

    def snapshot(self) -> dict:
        dt = max(time.time() - self.t_start, 1e-9)
        return {
            "uptime_s": round(dt, 3),
            "samples_in": self.samples_in,
            "windows_out": self.windows_out,
            "blocks_dropped": self.blocks_dropped,
            "samples_per_s": round(self.samples_in / dt, 1),
            "windows_per_s": round(self.windows_out / dt, 1),
            "last_angles_deg": self.last_angles,
        }

    def log(self):
        logger.info("doa_metrics %s", json.dumps(self.snapshot()))
