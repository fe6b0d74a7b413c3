"""The benchmark's CPU tests. The harness and the references import as top
level packages from benchmark/, the port from the repository's root.

Tests that need a CUDA card carry the ``card`` marker and take the
``card`` fixture, which skips them where torch sees none (decided when the
test runs, never when a module is imported)."""

import os
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [BENCH, os.path.dirname(BENCH)]


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; run on the chip with "
        "`python -m pytest benchmark/tests -m card`")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; torch sees none")
    return torch.device("cuda", 0)


@pytest.fixture
def spec():
    from harness.spec import load_spec
    return load_spec()


@pytest.fixture
def tiny_run(spec):
    """run(name, seed=..., cell=None) → the result of one CPU run of the
    cell at a size a test can hold."""
    from harness.runner import run_cell
    from harness.spec import Cell

    def run(name, seed=2 ** 31 + 17, cell=None, **kw):
        cell = cell or Cell(spec, name)
        kw = {**TINY[name], **kw}
        result, _ = run_cell(cell, seed, kw.pop("seconds"), False,
                             device="cpu", **kw)
        return result
    return run


# per cell: samples a call (32 windows: the warm start's least), blocks in
# the ring, checked windows a block, seconds of the window
TINY = {"ula16_music.hop1024": dict(samples=32 * 1024, blocks=2,
                                    windows_per_block=16, seconds=0.2),
        "ura64_wideband.survey": dict(samples=32 * 1024, blocks=1,
                                      windows_per_block=4, seconds=0.05)}
