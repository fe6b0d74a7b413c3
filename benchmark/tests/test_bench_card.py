"""On the card, at a size a test run can hold: a run of each cell comes
out correct, with its traced reading; the control (the reference at TF32
in the program's place) comes out over the limits. Run on the chip with
``python -m pytest benchmark/tests -q -m card``."""

import pytest

from harness import checks
from harness.runner import run_cell
from harness.spec import Cell

SIZES = {"ula16_music.hop1024": (1 << 22, 2, 256),
         "ura64_wideband.survey": (1 << 19, 2, 64)}


@pytest.mark.card
@pytest.mark.parametrize("name", sorted(SIZES))
@pytest.mark.parametrize("trace", [False, True])
def test_a_run_on_the_card_is_correct(card, spec, tmp_path, name, trace):
    samples, blocks, count = SIZES[name]
    result, notes = run_cell(Cell(spec, name), 2 ** 31 + 99, 1.0, trace,
                             device=card, samples=samples, blocks=blocks,
                             windows_per_block=count,
                             trace_path=str(tmp_path / "t.trace.json"))
    assert result["correct"], (result, notes)
    if trace:
        assert result["busy_s"] > 0 and result["metrics"]


@pytest.mark.card
@pytest.mark.parametrize("name", sorted(SIZES))
def test_the_control_fails_on_the_card(card, spec, name):
    import readings
    samples, blocks, count = SIZES[name]
    cell = Cell(spec, name)
    r = readings.control_reading(cell, 3, card, samples, blocks, count)
    assert not checks.verdict(r, cell.traffic["check"]["limits"]), r
