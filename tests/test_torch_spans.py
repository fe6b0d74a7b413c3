"""The port's own spans (doa_tpu_torch.utils.profiling.span) on the CPU:
the tree a call leaves on a profiler's Chrome trace, no span object built
while nothing records, and no stage span inside a callable that the
benchmark's per-layer metrics span from outside (their ENTRIES)."""

import ast
import dataclasses
import glob
import importlib
import json
import os

import numpy as np
import pytest
import torch

from doa_tpu_torch.configs import PRESETS
from doa_tpu_torch.pipeline_torch import build_pipeline_torch
from doa_tpu_torch.utils import profiling
from doa_tpu_torch.utils.profiling import span, trace_to

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T = 32 * 1024            # 32 windows of 1024 samples: the warm start's least

# the spans every call of a cell opens inside its doa.call, and where the
# escalation's two host reads (the capture mean's, the windows') sit
STAGES = {"ula": {"doa.ingest", "doa.covariance", "doa.subspace",
                  "doa.scan"},
          "ura": {"doa.ingest", "doa.wb_front", "doa.wb_fusion",
                  "doa.peaks"}}
SYNC_PARENT = {"ula": "doa.subspace", "ura": "doa.wb_fusion"}


def _scene(geometry, rng):
    """Two tones at 10 dB a element on the array's own steering, as the
    interleaved float32 capture x[T, 2N]."""
    if geometry.kind == "ula":
        pos = np.stack([np.arange(geometry.num_elements), np.zeros(
            geometry.num_elements)], -1)
        dirs = [(np.cos(np.deg2rad(th)), 0.0) for th in (60.0, 110.0)]
    else:
        r, c = geometry.shape
        pos = np.stack(np.meshgrid(np.arange(r), np.arange(c),
                                   indexing="ij"), -1).reshape(-1, 2)
        dirs = [(np.cos(np.deg2rad(el)) * np.sin(np.deg2rad(az)),
                 np.sin(np.deg2rad(el))) for az, el in ((-20, 30), (25, 50))]
    n = np.arange(T)[:, None]
    x = sum(np.exp(2j * np.pi * f * n)
            * np.exp(-2j * np.pi * geometry.norm_spacing * (pos @ d))[None]
            for d, f in zip(dirs, (0.1, 0.31)))
    x = x + (rng.standard_normal(x.shape) + 1j * rng.standard_normal(
        x.shape)) * np.sqrt(0.05)
    return torch.from_numpy(x.astype(np.complex64).view(np.float32))


@pytest.fixture(scope="module")
def cells():
    """{"ula": the benchmark's ULA-16 headline shape (hop = S), "ura": c5}
    → (config, capture)."""
    rng = np.random.default_rng(27)
    ula = dataclasses.replace(PRESETS["c4_ula16_streaming"], overlap=0)
    ura = PRESETS["c5_ura64_wideband"]
    return {name: (cfg, _scene(cfg.geometry, rng))
            for name, cfg in (("ula", ula), ("ura", ura))}


def _pipe(cfg):
    return build_pipeline_torch(cfg, device="cpu", return_spectra=False)


def _traced_spans(tmp_path, fn, calls=2):
    """Run fn() `calls` times under trace_to → [(start, end, name)] of the
    trace's user spans, sorted by start."""
    with trace_to(str(tmp_path)):
        for _ in range(calls):
            fn()
    (path,) = glob.glob(str(tmp_path / "trace_*.json"))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                  if e.get("ph") == "X" and e.get("cat") == "user_annotation")


def _inside(span_, outer) -> bool:
    return outer[0] <= span_[0] and span_[1] <= outer[1]


def test_span_opens_only_while_a_profiler_records():
    """span() rests on torch.autograd.profiler._is_profiler_enabled (a
    private flag): off, one shared no-op context; on, a record_function."""
    assert torch.autograd.profiler._is_profiler_enabled is False
    off = span("doa.call")
    assert off is span("doa.scan") is profiling._OFF
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        assert torch.autograd.profiler._is_profiler_enabled is True
        on = span("doa.call")
        assert isinstance(on, torch.profiler.record_function)
        with on:
            pass
    assert torch.autograd.profiler._is_profiler_enabled is False
    assert span("doa.call") is off


@pytest.mark.parametrize("name", ["ula", "ura"])
def test_a_call_builds_no_span_without_a_profiler(cells, monkeypatch, name):
    def refuse(*a, **k):
        raise AssertionError("record_function built with no profiler")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    cfg, x = cells[name]
    res = _pipe(cfg).interleaved(x)
    assert torch.isfinite(res.peak_values["music"]).all()


@pytest.mark.parametrize("name", ["ula", "ura"])
def test_span_tree_of_a_call(cells, tmp_path, name):
    """Each call is one doa.call holding every other doa.* span of it: the
    cell's stages, and two doa.sync.escalation inside the subspace stage
    (the ULA) or the fusion stage (c5). The answers are the untraced
    call's."""
    cfg, x = cells[name]
    pipe = _pipe(cfg)
    quiet = pipe.interleaved(x)
    out = []
    spans = _traced_spans(tmp_path, lambda: out.append(pipe.interleaved(x)))
    calls = [s for s in spans if s[2] == "doa.call"]
    assert len(calls) == 2
    ours = [s for s in spans if s[2].startswith("doa.")]
    for call in calls:
        inner = [s for s in ours if s is not call and _inside(s, call)]
        names = [s[2] for s in inner]
        assert STAGES[name] <= set(names), names
        for stage in STAGES[name]:
            assert names.count(stage) == 1, (stage, names)
        syncs = [s for s in inner if s[2] == "doa.sync.escalation"]
        parent = next(s for s in inner if s[2] == SYNC_PARENT[name])
        assert len(syncs) == 2 and all(_inside(s, parent) for s in syncs)
    assert all(any(_inside(s, c) for c in calls) for s in ours)
    for res in out:
        for key in ("peak_values", "peak_angles"):
            torch.testing.assert_close(getattr(res, key)["music"],
                                       getattr(quiet, key)["music"],
                                       rtol=0, atol=0)


def _entries():
    """Every ENTRIES of the benchmark's per-layer metric files, read from
    their source ("module:attr" or "module:REGISTRY.key")."""
    out = set()
    for path in glob.glob(os.path.join(REPO, "benchmark", "metrics",
                                       "*.py")):
        with open(path) as f:
            tree = ast.parse(f.read())
        for node in tree.body:
            if (isinstance(node, ast.Assign)
                    and [t.id for t in node.targets
                         if isinstance(t, ast.Name)] == ["ENTRIES"]):
                out.update(ast.literal_eval(node.value))
    return sorted(out)


def _spanned(fn, name):
    def inner(*args, **kwargs):
        with torch.profiler.record_function(name):
            return fn(*args, **kwargs)
    return inner


def _wrap_entries(monkeypatch, entries):
    """Each entry replaced by a wrapper that opens a span named after it,
    as the benchmark's traced run does (harness/tracing.install_spans)."""
    for entry in entries:
        mod_name, path = entry.split(":")
        obj = importlib.import_module(mod_name)
        *parents, last = path.split(".")
        for p in parents:
            obj = obj[p] if isinstance(obj, dict) else getattr(obj, p)
        cur = obj[last] if isinstance(obj, dict) else getattr(obj, last)
        new = (tuple(_spanned(c, entry) for c in cur)
               if isinstance(cur, tuple) else _spanned(cur, entry))
        if isinstance(obj, dict):
            monkeypatch.setitem(obj, last, new)
        else:
            monkeypatch.setattr(obj, last, new)


@pytest.mark.parametrize("name", ["ula", "ura"])
def test_no_stage_span_inside_an_entry(cells, tmp_path, monkeypatch, name):
    """A device op belongs to the innermost open span: a stage span inside
    an entry would take the entry's ops from its metric. Only the host
    reads (doa.sync.*) and the escalation batch may open inside one."""
    entries = _entries()
    assert len(entries) == 5, entries
    _wrap_entries(monkeypatch, entries)
    cfg, x = cells[name]
    pipe = _pipe(cfg)          # the pipeline takes its callables when built
    spans = _traced_spans(tmp_path, lambda: pipe.interleaved(x), calls=1)
    opened = [s for s in spans if s[2] in entries]
    assert len({s[2] for s in opened}) == (3 if name == "ula" else 2)
    allowed = ("doa.sync.", "doa.escalate")
    for s in spans:
        if s[2].startswith("doa.") and not s[2].startswith(allowed):
            assert not any(_inside(s, e) for e in opened), s
    assert any(s[2].startswith("doa.sync.") and _inside(s, e)
               for s in spans for e in opened)
