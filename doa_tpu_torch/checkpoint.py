"""Streaming-state checkpoint/resume (port of doa_tpu/checkpoint.py).

For the streaming and tracking deployment (BASELINE config 4): a
snapshot of the live state — the covariance ring carry, the overlap
tail, the tracker's state — so a long-running estimator can restart
without re-priming windows or losing tracks.

The ``.npz`` keys and the ``meta`` record are doa_tpu's, so a checkpoint
written by either package loads in the other (as the calibration
artifact does). The track state loads onto the device as tensors
(``tracking.TrackState``); with no card there, loading raises.
"""

from __future__ import annotations

import dataclasses
import json
import time
from typing import Optional

import numpy as np
import torch

from doa_tpu_torch.cpx import checked_device
from doa_tpu_torch.tracking import TrackState, state_from_numpy

CHECKPOINT_VERSION = 1


@dataclasses.dataclass
class StreamState:
    """Everything needed to resume a streaming DoA session."""

    cov_carry_re: Optional[np.ndarray] = None   # (S/hop, N, N)
    cov_carry_im: Optional[np.ndarray] = None
    overlap_tail: Optional[np.ndarray] = None   # (overlap, N) complex64
    track_state: Optional[TrackState] = None
    samples_processed: int = 0
    created_unix: float = 0.0
    version: int = CHECKPOINT_VERSION


def _norm_path(path: str) -> str:
    """np.savez appends '.npz' to extension-less paths; normalize the same
    way on save AND load so round-trips work with any path spelling."""
    return path if str(path).endswith(".npz") else str(path) + ".npz"


def _host(a, dtype) -> np.ndarray:
    """A tensor (any device) or array → a numpy array of `dtype`."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, dtype)


def save_stream_state(path: str, st: StreamState):
    path = _norm_path(path)
    arrays = {"meta": json.dumps({
        "version": st.version,
        "samples_processed": int(st.samples_processed),
        "created_unix": st.created_unix or time.time(),
    })}
    if st.cov_carry_re is not None:
        arrays["cov_carry_re"] = _host(st.cov_carry_re, np.float32)
        arrays["cov_carry_im"] = _host(st.cov_carry_im, np.float32)
    if st.overlap_tail is not None:
        arrays["overlap_tail"] = _host(st.overlap_tail, np.complex64)
    if st.track_state is not None:
        ts = st.track_state
        arrays["track_angle"] = _host(ts.angle, np.float32)
        arrays["track_vel"] = _host(ts.vel, np.float32)
        arrays["track_active"] = _host(ts.active, bool)
        arrays["track_missed"] = _host(ts.missed, np.int32)
        arrays["track_age"] = _host(ts.age, np.int32)
    np.savez(path, **arrays)


def load_stream_state(path: str, device="cuda") -> StreamState:
    """The StreamState saved at `path`; its track state on `device` (the
    card unless device="cpu"; no card: RuntimeError)."""
    dev = checked_device(device)
    with np.load(_norm_path(path)) as z:
        meta = json.loads(str(z["meta"]))
        if meta["version"] > CHECKPOINT_VERSION:
            raise ValueError(
                f"checkpoint version {meta['version']} newer than "
                f"supported {CHECKPOINT_VERSION}")
        ts = None
        if "track_angle" in z:
            ts = state_from_numpy(
                (z["track_angle"], z["track_vel"], z["track_active"],
                 z["track_missed"], z["track_age"]), device=dev)
        return StreamState(
            cov_carry_re=(z["cov_carry_re"] if "cov_carry_re" in z
                          else None),
            cov_carry_im=(z["cov_carry_im"] if "cov_carry_im" in z
                          else None),
            overlap_tail=(z["overlap_tail"] if "overlap_tail" in z
                          else None),
            track_state=ts,
            samples_processed=int(meta["samples_processed"]),
            created_unix=float(meta.get("created_unix", 0.0)),
            version=int(meta["version"]),
        )
