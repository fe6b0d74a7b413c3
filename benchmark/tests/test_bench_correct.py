"""What decides `correct`, on the CPU at sizes a test can hold:

* the port's CPU path (the kernels' plain versions) agrees with each plain
  reference within the cell's limits, and its answers sit near the planted
  directions;
* the control (the reference in float32 with TF32 products, put in the
  program's place) fails the limits;
* a run with the timed path broken underneath comes out not correct, once
  for each fault the cells can have: an answer altered where it is
  produced, half of each window's samples left out (the mean taken over
  the rest), and the subspace step returning its starting state unchanged.
"""

import numpy as np
import pytest
import torch

from harness import checks, traffic
from harness.runner import build_config
from harness.spec import Cell

CELLS = ["ula16_music.hop1024", "ura64_wideband.survey"]


@pytest.mark.parametrize("name", CELLS)
def test_the_port_agrees_with_the_reference(tiny_run, name):
    result = tiny_run(name)
    assert result["correct"], result
    assert result["failed"] == 0
    for c in result["checks"].values():
        assert c["value"] <= c["limit"] / 10


@pytest.mark.parametrize("name", CELLS)
def test_the_reference_finds_the_planted_directions(spec, name):
    from reference.common import Prec
    cell = Cell(spec, name)
    ring = traffic.make_ring(cell.fields, cell.traffic, 9, "cpu", 32 * 1024,
                             1)
    x, dirs = ring[0]
    a = cell.reference().answers(x, cell.config["doa_config"], 0,
                                 torch.arange(0, 32, 8), Prec("float64"))
    got = np.sort(a["angles"].numpy().reshape(4, 2, -1)[..., 0], axis=1)
    want = np.sort(np.array([d[0] for d in dirs]))
    assert np.abs(got - want).max() < 1.0


@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails(spec, name):
    """The reference at TF32 in the program's place reads over the limits
    (readings.control_reading, as the limits were set from on the card)."""
    import readings
    cell = Cell(spec, name)
    size = {"ula16_music.hop1024": (64 * 1024, 2, 64),
            "ura64_wideband.survey": (32 * 1024, 1, 8)}[name]
    r = readings.control_reading(cell, 11, torch.device("cpu"), *size)
    limits = cell.traffic["check"]["limits"]
    assert not checks.verdict(r, limits), r


# ---------------------------------------------------------------------
# faults planted in the timed path
# ---------------------------------------------------------------------

def _altered(fn, angles_at):
    """fn's answers with the first angle of every 8th window moved by 0.05°
    (1-D peaks: (values, angles); 2-D: (values, az, el))."""
    def broken(*args, **kwargs):
        out = list(fn(*args, **kwargs))
        a = out[angles_at].clone()
        a[::8, 0] += 0.05
        out[angles_at] = a
        return tuple(out)
    return broken


def _half_samples(fn, frames_at=0, per_chunk=None):
    """fn's chunk Grams from the first half of each chunk's rows, doubled:
    half of each window left out, the mean taken over the rest."""
    def broken(x, *args, **kwargs):
        g = kwargs.get("g", args[0] if args else None)
        rows = x[: (x.shape[0] // g) * g].reshape(-1, g, x.shape[1])
        kept = rows.clone()
        kept[:, g // 2:] = 0.0
        return fn(kept.reshape(-1, x.shape[1]), *args, **kwargs) * 2.0
    return broken


def _state_unchanged(fn):
    """The MGS rounds returning their starting state (the warm start's
    init) unchanged."""
    def broken(E, num_sources, rounds, init=None):
        Vt, W, Vt_prev = fn(E, num_sources, rounds, init)
        if init is None:
            return Vt, W, Vt_prev
        B = E.shape[0]
        start = init.reshape(-1, *init.shape[-2:])
        start = start.repeat_interleave(B // start.shape[0], dim=0)
        return start, W, Vt_prev
    return broken


FAULTS = {
    ("ula16_music.hop1024", "answer_altered"):
        ("music_scan_peaks", lambda p: _altered(p, 1)),
    ("ula16_music.hop1024", "half_the_samples"):
        ("chunk_gram", _half_samples),
    ("ula16_music.hop1024", "state_unchanged"):
        ("mgs_iterate", _state_unchanged),
    ("ura64_wideband.survey", "answer_altered"):
        ("peaks2d", lambda p: _altered(p, 1)),
    ("ura64_wideband.survey", "half_the_samples"):
        ("wideband_fft_gram", _half_samples),
    ("ura64_wideband.survey", "state_unchanged"):
        ("mgs_iterate", _state_unchanged),
}


@pytest.mark.parametrize("name,fault", sorted(FAULTS))
def test_a_broken_timed_path_is_not_correct(tiny_run, monkeypatch, name,
                                            fault):
    from doa_tpu_torch import plan
    kernel, breaker = FAULTS[name, fault]
    wrapper, plain = plan.KERNELS[kernel]
    monkeypatch.setitem(plan.KERNELS, kernel, (wrapper, breaker(plain)))
    result = tiny_run(name)
    assert not result["correct"], result


def test_the_cell_builds_the_port_config(spec):
    for name in CELLS:
        cfg = build_config(Cell(spec, name).fields)
        assert cfg.snapshot_size == 1024 and cfg.num_sources == 2
