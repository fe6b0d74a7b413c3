"""The comparison that decides `correct`.

Every call of the window hands back the peaks of every window of its
block, and the run keeps its answers at the windows drawn for the block
(traffic.check_windows: runs of consecutive windows, each copied out of
a call's answers in one piece). Once the window has closed, each call's peaks
and the plain reference's, computed from the same block at the same
windows, are put in order of angle (azimuth on a 2-D grid), and the run
reads:

* angle_gap_deg: the widest gap, over every call, window and peak,
  between a served angle (θ, or az and el) and the reference's;
* value_gap: the widest gap between a served peak value (the spectrum at
  the peak, normalised as the configuration's path normalises it) and the
  reference's.

Each is held to the cell's limit; a gap that is not a number fails.
"""

from __future__ import annotations

import math

import numpy as np

NAMES = ("angle_gap_deg", "value_gap")


def canonical(angles: np.ndarray, *others: np.ndarray, two_d: bool):
    """Peaks in order of their first angle component: angles [.., k], or
    [.., k, 2] (az, el) where two_d, and the same reordering of each of
    `others` ([.., k, ...] with the same leading axes)."""
    key = angles[..., 0] if two_d else angles
    order = np.argsort(key, axis=-1, kind="stable")

    def take(a):
        o = order.reshape(order.shape + (1,) * (a.ndim - order.ndim))
        return np.take_along_axis(a, o, axis=order.ndim - 1)
    return (take(angles), *(take(o) for o in others))


class Envelope:
    """The answers every call gave at the checked windows of one block.
    A call only copies its rows out; the ordering and the comparison run
    once the window has closed."""

    def __init__(self, runs: list):
        self.runs = [slice(a, b) for a, b in runs]
        self.windows = np.concatenate([np.arange(a, b) for a, b in runs])
        self.angles, self.values = [], []

    @property
    def calls(self) -> int:
        return len(self.values)

    def add(self, angles: np.ndarray, values: np.ndarray) -> None:
        """One call's host copies of its peaks ([B, k], angles [B, k] or
        [B, k, 2])."""
        self.angles.append(np.concatenate([angles[r] for r in self.runs]))
        self.values.append(np.concatenate([values[r] for r in self.runs]))

    def failed_calls(self) -> int:
        """Calls whose checked answers are not all numbers."""
        return sum(not (np.isfinite(a).all() and np.isfinite(v).all())
                   for a, v in zip(self.angles, self.values))

    def gaps(self, ref: dict) -> dict:
        """The widest gaps of this block's served answers, over its calls,
        from the reference's answers at the same windows: a served angle
        against the nearest of the reference's candidates for its peak
        (the peak's bin, or a neighbour the reference cannot tell from it
        at the cell's precision: common.peaks_1d, peaks_2d)."""
        two_d = ref["angles"].ndim == 3
        ra, rv, rc = canonical(ref["angles"], ref["values"],
                               ref["candidates"], two_d=two_d)
        a, v = canonical(np.stack(self.angles), np.stack(self.values),
                         two_d=two_d)             # [calls, n, k(, 2)]
        if two_d:
            da = np.abs(a[..., None, :] - rc).max(-1).min(-1)
        else:
            da = np.abs(a[..., None] - rc).min(-1)
        return {"angle_gap_deg": _max(da), "value_gap": _max(np.abs(v - rv))}


def _max(a: np.ndarray) -> float:
    return float("nan") if np.isnan(a).any() else float(a.max())


def merge(gaps: list) -> dict:
    """The widest of several blocks' gaps (nan if any is nan)."""
    out = {}
    for name in NAMES:
        vals = [g[name] for g in gaps]
        out[name] = (float("nan") if any(math.isnan(x) for x in vals)
                     else max(vals))
    return out


def verdict(gaps: dict, limits: dict) -> bool:
    """Every gap a number within its limit."""
    return all(gaps[n] <= limits[n] for n in NAMES)
