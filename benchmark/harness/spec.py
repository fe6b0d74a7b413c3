"""The benchmark's data: BENCHMARK.json at the checkout's root, and the
files it names. Everything that belongs to one configuration, one cell or
one per-layer metric sits in a file of its own, found by its name:

* ``benchmark/configs/<config>.json``: the configuration's fields, its
  source and its plain reference (a module of ``benchmark/reference/``);
* ``benchmark/workloads/<cell>.json``: the cell's traffic, its correctness
  sample and limits;
* ``benchmark/metrics/<metric>.py``: a per-layer metric's reader.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


class Cell:
    """One entry of BENCHMARK.json's workloads, with its files read."""

    def __init__(self, spec: dict, name: str, bench_dir: Path = BENCH_DIR):
        entries = {w["name"]: w for w in spec["workloads"]}
        if name not in entries:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json; it has "
                           f"{sorted(entries)}")
        self.entry = entries[name]
        self.name = name
        self.chips = self.entry["chips"]
        self.traffic = _read_json(bench_dir / "workloads" / f"{name}.json")
        configs = {c["name"]: c for c in spec["configs"]}
        self.config_name = self.entry["config"]
        cfile = bench_dir.parent / configs[self.config_name]["file"]
        self.config = _read_json(cfile)
        self.end_to_end = [m for m in spec["end_to_end"]
                           if _applies(m, name, None)]
        reported = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in spec["per_layer"]
                          if _applies(m, name, reported)]
        self.bench_dir = bench_dir

    @property
    def fields(self) -> dict:
        """The DoaConfig fields of this cell: the configuration's, with the
        traffic's overlap (the hop is the traffic's)."""
        return dict(self.config["doa_config"],
                    overlap=self.traffic["overlap"])

    def reference(self):
        """The configuration's plain reference module."""
        return importlib.import_module(
            f"reference.{self.config['reference']}")

    def metric(self, name: str):
        """The reader module benchmark/metrics/<name>.py."""
        return load_metric(name, self.bench_dir)


def _applies(metric: dict, cell: str, reported) -> bool:
    """A metric with a workloads list applies to those cells; a per-layer
    one without applies to every cell that reports what it moves; an
    end-to-end one without, to every cell."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return reported is None or metric["moves"] in reported


def _read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_spec(root: Path = ROOT) -> dict:
    return _read_json(root / "BENCHMARK.json")


def load_metric(name: str, bench_dir: Path = BENCH_DIR):
    path = bench_dir / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
