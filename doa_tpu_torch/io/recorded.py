"""Recorded-IQ file I/O.

The reference ingests/emits raw interleaved `gr_complex` (complex64) streams
via GNU Radio file_source/file_sink. Two formats here:

  * `.c64` / `.cfile`: raw interleaved complex64, channel-interleaved per
    sample frame `[s0c0, s0c1, ..., s0c{N-1}, s1c0, ...]` — the layout a
    multichannel gr file sink of an N-stream interleaver produces.
  * `.npz`: self-describing (samples + metadata), preferred.

A copy of doa_tpu/io/recorded.py (numpy only): a file written by either
package loads in the other.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np


def save_iq(path: str, x: np.ndarray, samp_rate: float = 1.0,
            metadata: Optional[dict] = None):
    """x: (T, N) complex64. `.npz` keeps metadata; `.c64`/`.cfile` writes
    raw interleaved complex64 plus a sidecar `<path>.json`."""
    x = np.ascontiguousarray(x, dtype=np.complex64)
    meta = {"num_channels": int(x.shape[1]), "samp_rate": float(samp_rate)}
    if metadata:
        meta.update(metadata)
    if path.endswith(".npz"):
        np.savez(path, samples=x, meta=json.dumps(meta))
    else:
        x.tofile(path)
        with open(path + ".json", "w") as f:
            json.dump(meta, f)


def load_iq_channels(paths) -> np.ndarray:
    """Assemble (T, N) from N single-channel raw complex64 files — the
    layout a bank of per-channel GNU Radio file_sinks produces (one
    `file_sink` per coherent stream). Channels are truncated to the
    shortest file."""
    chans = [np.fromfile(p, dtype=np.complex64) for p in paths]
    T = min(len(c) for c in chans)
    return np.stack([c[:T] for c in chans], axis=1)


def load_iq(path: str, num_channels: Optional[int] = None) -> np.ndarray:
    """→ (T, N) complex64. For raw files the channel count comes from the
    sidecar json or the `num_channels` argument."""
    if path.endswith(".npz"):
        with np.load(path) as z:
            return z["samples"]
    if num_channels is None:
        sidecar = path + ".json"
        if not os.path.exists(sidecar):
            raise ValueError(
                f"raw IQ file {path} needs num_channels or a sidecar json"
            )
        with open(sidecar) as f:
            num_channels = json.load(f)["num_channels"]
    flat = np.fromfile(path, dtype=np.complex64)
    T = len(flat) // num_channels
    return flat[: T * num_channels].reshape(T, num_channels)
