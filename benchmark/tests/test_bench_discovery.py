"""The harness is driven by data: a cell, a configuration and a per-layer
metric added as files (and entries in BENCHMARK.json), with no edit to a
file that is there, are found by name and run."""

import json
import shutil

import pytest

from harness import runner, spec as spec_mod
from harness.spec import BENCH_DIR, Cell

NEW_METRIC = '''"""A metric added as a file alone: device ops a window."""
LAYER = "entry"
UNIT = "ops/window"
MOVES = "snapshots_per_s"


def read(ctx):
    return len(ctx.trace.ops) / ctx.trace.n_calls / ctx.shapes["B"]
'''


@pytest.fixture
def added(tmp_path, spec):
    """A copy of the benchmark with a configuration, a cell and a metric
    added as new files and new entries."""
    root = tmp_path / "checkout"
    shutil.copytree(BENCH_DIR, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p.relative_to(root): p.read_bytes()
              for p in (root / "benchmark").rglob("*") if p.is_file()}
    cfg = json.loads((root / "benchmark/configs/ula16_music.json").read_text())
    cfg["name"] = "ula8_music"
    cfg["doa_config"]["geometry"]["num_elements"] = 8
    (root / "benchmark/configs/ula8_music.json").write_text(json.dumps(cfg))
    wl = json.loads((root / "benchmark/workloads/ula16_music.hop1024.json")
                    .read_text())
    wl.update(config="ula8_music", overlap=512)
    (root / "benchmark/workloads/ula8_music.hop512.json").write_text(
        json.dumps(wl))
    (root / "benchmark/metrics/entry.ops_per_window.py").write_text(
        NEW_METRIC)
    s = json.loads(json.dumps(spec))
    s["configs"].append({"name": "ula8_music", "source": "test",
                         "file": "benchmark/configs/ula8_music.json",
                         "reduced": [], "why": "test"})
    s["workloads"].append({"name": "ula8_music.hop512",
                           "config": "ula8_music", "traffic": "hop512",
                           "chips": 1, "why": "test"})
    s["per_layer"].append({"name": "entry.ops_per_window",
                           "unit": "ops/window", "better": "lower",
                           "source": "device_trace", "layer": "entry",
                           "moves": "snapshots_per_s",
                           "workloads": ["ula8_music.hop512"]})
    (root / "BENCHMARK.json").write_text(json.dumps(s))
    return root, before


def test_added_files_change_no_file_there(added):
    root, before = added
    for rel, data in before.items():
        assert (root / rel).read_bytes() == data


def test_an_added_cell_config_and_metric_are_found(added):
    root, _ = added
    s = spec_mod.load_spec(root)
    cell = Cell(s, "ula8_music.hop512", root / "benchmark")
    assert cell.config_name == "ula8_music"
    assert cell.fields["geometry"]["num_elements"] == 8
    assert cell.fields["overlap"] == 512
    names = [m["name"] for m in cell.per_layer]
    # the metrics without a workloads list that move what the cell reports,
    # and the one listed for it
    assert names == ["entry.device_ops", "device.idle",
                     "entry.ops_per_window"]
    mod = cell.metric("entry.ops_per_window")
    assert (mod.LAYER, mod.UNIT, mod.MOVES) == ("entry", "ops/window",
                                                "snapshots_per_s")
    # the cells that were there keep their metrics
    old = Cell(s, "ula16_music.hop1024", root / "benchmark")
    assert "entry.ops_per_window" not in [m["name"] for m in old.per_layer]


def test_an_added_cell_runs(added, monkeypatch):
    root, _ = added
    s = spec_mod.load_spec(root)
    cell = Cell(s, "ula8_music.hop512", root / "benchmark")
    result, notes = runner.run_cell(cell, 5, 0.1, False, device="cpu",
                                    samples=40 * 512, blocks=1,
                                    windows_per_block=8)
    # the reference takes the added configuration from its file, the
    # overlap from the added traffic
    assert result["correct"], (result, notes)
    assert result["attempted"] >= 1
    assert set(result["metrics"]) == {"snapshots_per_s", "call_ms_p95",
                                      "setup_s"}


def test_an_unknown_cell_is_refused(spec):
    with pytest.raises(KeyError, match="no workload"):
        Cell(spec, "no.such.cell")
