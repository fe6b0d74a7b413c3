"""Sliding-window DoA tracking of moving emitters (port of
doa_tpu/tracking.py; BASELINE config 4).

A batch of per-window peak detections f32[B, K] is associated to
persistent tracks with an alpha-beta filter, window after window. Per
window: predict each track (constant velocity), match tracks in slot
order to the nearest unused detection within `gate_deg`, update the
matched ones, age out tracks missed more than `max_missed` windows, and
spawn tracks from the unmatched detections in descending order of their
peak values (ties in index order, NaN values last) into the first free
slots.

doa_tpu runs the B windows as one device program (``lax.scan``). Here
``track_batch`` takes the plan's route (``plan.track_plan``): on a CUDA
tensor with max_tracks ≤ 32 and K ≤ 32, one launch of the scan kernel
(``ops/cuda/track.py``, ``csrc/track.cu``) runs all B windows from the
input state to the output state; otherwise ``track_batch_plain``, the
reference's ``_step`` as torch ops, one window at a time (some 60 small
ops a window at max_tracks = 4, K = 2; no host read).

Semantics kept from the reference, which the kernel reproduces bit for
bit: argmin takes the first NaN (a NaN detection wins a track's argmin
and fails its gate, leaving the track unmatched); the spawn order is a
stable descending sort of the values (``jnp.argsort`` is stable); the
updates round once a product and once a sum (no fused multiply-add);
``gate_deg``, ``alpha`` and ``beta`` are float32.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from doa_tpu_torch.cpx import checked_device


class TrackState(NamedTuple):
    angle: torch.Tensor    # f32[M] current angle estimate (deg)
    vel: torch.Tensor      # f32[M] deg/window
    active: torch.Tensor   # bool[M]
    missed: torch.Tensor   # i32[M] consecutive missed windows
    age: torch.Tensor      # i32[M] windows since spawn


@dataclasses.dataclass(frozen=True)
class TrackerConfig:
    max_tracks: int = 4
    gate_deg: float = 5.0      # association gate
    alpha: float = 0.5         # position gain
    beta: float = 0.15         # velocity gain
    max_missed: int = 5        # windows before a track dies
    min_age: int = 3           # windows before a track is "confirmed"


def _zeros(M: int, dev: torch.device) -> TrackState:
    return TrackState(
        angle=torch.zeros(M, dtype=torch.float32, device=dev),
        vel=torch.zeros(M, dtype=torch.float32, device=dev),
        active=torch.zeros(M, dtype=torch.bool, device=dev),
        missed=torch.zeros(M, dtype=torch.int32, device=dev),
        age=torch.zeros(M, dtype=torch.int32, device=dev),
    )


def init_tracks(tc: TrackerConfig, device="cuda") -> TrackState:
    """No track active, on the device (no card: RuntimeError)."""
    return _zeros(tc.max_tracks, checked_device(device))


def state_from_numpy(ts, device="cuda") -> TrackState:
    """A TrackState of the port's from the five arrays of any track state
    in field order (doa_tpu's TrackState with its arrays as numpy, the
    arrays of a checkpoint), on the device."""
    dev = checked_device(device)
    angle, vel, active, missed, age = (np.asarray(a) for a in ts)
    return TrackState(
        angle=torch.from_numpy(angle.astype(np.float32)).to(dev),
        vel=torch.from_numpy(vel.astype(np.float32)).to(dev),
        active=torch.from_numpy(active.astype(bool)).to(dev),
        missed=torch.from_numpy(missed.astype(np.int32)).to(dev),
        age=torch.from_numpy(age.astype(np.int32)).to(dev),
    )


def gains(tc: TrackerConfig):
    """(gate, alpha, beta) as float32, the types they take in doa_tpu
    (weak-typed Python floats in float32 arithmetic)."""
    return tuple(np.float32(v) for v in (tc.gate_deg, tc.alpha, tc.beta))


def _step(tc: TrackerConfig, state: TrackState, d_ang, order, consts):
    """One window of doa_tpu/tracking.py::_step as torch ops on the
    state's device: d_ang f32[K] and the spawn order int64[K] (the stable
    descending sort of the window's values). No host read: each
    data-dependent index is a one-element tensor (argmin with keepdim,
    gather, scatter)."""
    gate, alpha, beta, inf = consts
    K = d_ang.shape[0]
    M = tc.max_tracks
    dev = d_ang.device
    angle, vel, active, missed, age = state
    pred = angle + vel
    dist = (pred[:, None] - d_ang[None, :]).abs()       # (M, K)

    # greedy association, tracks in slot order
    used = torch.zeros(K, dtype=torch.bool, device=dev)
    match = torch.full((M,), -1, dtype=torch.int64, device=dev)
    for m in range(M):
        cost = torch.where(used, inf, dist[m])
        j = torch.argmin(cost, dim=0, keepdim=True)      # first NaN wins
        ok = active[m:m + 1] & (cost.gather(0, j) <= gate)
        match[m:m + 1] = torch.where(ok, j, -1)
        used = used.scatter(0, j, used.gather(0, j) | ok)

    matched = match >= 0
    resid = d_ang.gather(0, match.clamp(0, K - 1)) - pred
    new_angle = torch.where(matched, pred + alpha * resid, pred)
    new_vel = torch.where(matched, vel + beta * resid, vel)
    new_missed = torch.where(matched, 0, missed + 1)
    still = active & (new_missed <= tc.max_missed)
    new_age = torch.where(still, age + 1, 0)

    # spawn: the reference walks the detections in `order`, each unused
    # one taking the first free slot; so the r-th unused detection in
    # that order takes the r-th free slot, while free slots last
    free = ~still
    can = ~used.gather(0, order)
    pick = free[:, None] & can[None, :] & (
        (free.cumsum(0) - 1)[:, None] == (can.cumsum(0) - 1)[None, :])
    have = pick.any(1)
    j = order.gather(0, pick.to(torch.uint8).argmax(1))
    ang_s = torch.where(have, d_ang.gather(0, j), new_angle)
    vel_s = torch.where(have, 0.0, new_vel)
    act_s = still | have
    mis_s = torch.where(have, 0, new_missed)
    age_s = torch.where(have, 0, new_age)

    out = torch.where(act_s & (age_s >= tc.min_age), ang_s, torch.nan)
    return TrackState(ang_s, vel_s, act_s, mis_s, age_s), out


def track_batch_plain(peak_angles: torch.Tensor, peak_values: torch.Tensor,
                      tc: TrackerConfig, init: TrackState):
    """The plain version of the tracker scan (and of the kernel):
    peak_angles, peak_values f32[B, K] and the state before window 0 →
    (the state after window B − 1, tracks f32[B, max_tracks] with NaN
    for unconfirmed slots), window by window with _step."""
    dev = peak_angles.device
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=dev)  # noqa
    gate, alpha, beta = gains(tc)
    consts = (f32(gate), f32(alpha), f32(beta), f32(np.inf))
    state = TrackState(*init)
    # each window's spawn order: descending values, ties in index order,
    # NaN last (as jnp.argsort(-d_val), which is stable)
    orders = torch.argsort(-peak_values, dim=1, stable=True)
    outs = []
    for b in range(peak_angles.shape[0]):
        state, out = _step(tc, state, peak_angles[b], orders[b], consts)
        outs.append(out)
    tracks = (torch.stack(outs) if outs else
              torch.empty((0, tc.max_tracks), dtype=torch.float32,
                          device=dev))
    return state, tracks


def _as_tensor(a, dev) -> torch.Tensor:
    if not isinstance(a, torch.Tensor):
        a = torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))
    return a.to(device=dev, dtype=torch.float32)


def track_batch(peak_angles, peak_values, tc: TrackerConfig = TrackerConfig(),
                init: TrackState | None = None, *, device=None):
    """peak_angles / peak_values: f32[B, K] per-window detections
    (tensors, or numpy) → (final TrackState, track_angles f32[B,
    max_tracks] with NaN for unconfirmed slots).

    Runs on `device`: by default the device of peak_angles where it is a
    tensor, else the card. `init` (default: no track active) is the state
    before the first window, so a capture cut in two and resumed from the
    first part's state gives the tracks of the whole. The route is
    plan.track_plan's: the scan kernel on the card where it takes
    (max_tracks, K), else track_batch_plain."""
    from doa_tpu_torch.plan import track_plan

    if device is None:
        device = (peak_angles.device if isinstance(peak_angles, torch.Tensor)
                  else "cuda")
    dev = checked_device(device)
    ang = _as_tensor(peak_angles, dev)
    val = _as_tensor(peak_values, dev)
    if ang.dim() != 2 or ang.shape != val.shape:
        raise ValueError(f"need peak angles and values f32[B, K] of one "
                         f"shape, got {tuple(ang.shape)} and "
                         f"{tuple(val.shape)}")
    if init is None:
        init = _zeros(tc.max_tracks, dev)
    init = TrackState(*(t.to(dev) for t in init))
    plan = track_plan(tc.max_tracks, ang.shape[1],
                      on_card=dev.type == "cuda")
    return plan.op("track")(ang, val, tc, init)


def track_batch_np(peak_angles, peak_values,
                   tc: TrackerConfig = TrackerConfig(), *, device="cuda"):
    """Host-numpy convenience wrapper returning a numpy track matrix;
    the tracker runs on `device` (the card unless device="cpu")."""
    _, out = track_batch(peak_angles, peak_values, tc, device=device)
    return out.cpu().numpy()
