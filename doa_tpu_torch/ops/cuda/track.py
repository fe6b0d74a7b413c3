"""The tracker's scan kernel (csrc/track.cu): all B windows of the
alpha-beta tracker in one launch.

It replaces no Pallas kernel, but the XLA ``lax.scan`` of
doa_tpu/tracking.py::track_batch, which a loop of torch ops would run as
about 70 launches a window (tracking._step). The kernel is bit-equal to
its plain version, tracking.track_batch_plain: the same first-NaN argmin,
stable spawn order and once-rounded products and sums.

`track_takes` is its predicate (1 ≤ max_tracks ≤ 32, 1 ≤ K ≤ 32: a slot
and a detection a lane of one warp); plan.track_plan routes on it.
"""

from __future__ import annotations

import ctypes

import torch

from doa_tpu_torch import _build
from doa_tpu_torch.tracking import (TrackState, TrackerConfig, gains,
                                    track_batch_plain)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIG = {"doa_track_scan": [_P, _P, _I, _I, *[_P] * 11, _I, _F, _F, _F, _I,
                           _I, _P]}
MAX_LANES = 32           # csrc/track.cu: LANES, slots and detections
_STATE_DTYPES = (torch.float32, torch.float32, torch.bool, torch.int32,
                 torch.int32)


def track_takes(max_tracks: int, K: int) -> bool:
    """Whether the kernel takes M = max_tracks slots and K detections a
    window: one warp holds a slot and a detection a lane."""
    return 1 <= max_tracks <= MAX_LANES and 1 <= K <= MAX_LANES


def track_scan(peak_angles: torch.Tensor, peak_values: torch.Tensor,
               tc: TrackerConfig, init: TrackState):
    """peak_angles, peak_values f32[B, K] and the state before window 0
    (five tensors of max_tracks slots on the same device) → (the state
    after window B − 1, tracks f32[B, max_tracks], NaN where a slot is not
    confirmed).

    A CPU tensor takes the plain version (tracking.track_batch_plain); a
    CUDA tensor launches the kernel, counted as "track" (_build.count),
    and raises where the kernel does not take the shapes."""
    if peak_angles.device.type == "cpu":
        return track_batch_plain(peak_angles, peak_values, tc, init)
    if not peak_angles.is_cuda:
        raise ValueError(f"unsupported device {peak_angles.device}")
    B, K = peak_angles.shape
    M = tc.max_tracks
    if not track_takes(M, K):
        raise ValueError(f"the track kernel takes 1 ≤ max_tracks, K ≤ "
                         f"{MAX_LANES}, got max_tracks={M}, K={K}")
    if (peak_values.shape != peak_angles.shape
            or peak_angles.dtype != torch.float32
            or peak_values.dtype != torch.float32):
        raise ValueError("need peak angles and values f32[B, K] of one "
                         "shape")
    for t, dt in zip(init, _STATE_DTYPES):
        if t.shape != (M,) or t.dtype != dt or t.device != peak_angles.device:
            raise ValueError(f"need a state of {M} slots ({_STATE_DTYPES}) "
                             f"on {peak_angles.device}")
    ang = peak_angles.contiguous()
    val = peak_values.contiguous()
    state0 = [t.contiguous() for t in init]
    state1 = [torch.empty_like(t) for t in state0]
    out = torch.empty((B, M), dtype=torch.float32, device=ang.device)
    gate, alpha, beta = gains(tc)
    lib = _build.load("track", _SIG)
    err = lib.doa_track_scan(
        ang.data_ptr(), val.data_ptr(), B, K,
        *(t.data_ptr() for t in state0), *(t.data_ptr() for t in state1),
        out.data_ptr(), M, float(gate), float(alpha), float(beta),
        tc.max_missed, tc.min_age,
        torch.cuda.current_stream(ang.device).cuda_stream)
    _build.check(err, "doa_track_scan")
    _build.count("track")
    return TrackState(*state1), out
