"""The readers of the program's own spans (harness/stages.py and the seven
metrics on it) on a hand-written Chrome trace: two calls of 100 µs, the
program's stage spans around the harness's entry spans, two host syncs a
call, idle time inside the calls and between them. Every number below is
counted by hand from the trace."""

import json

import pytest

from harness import stages
from harness.roofline import BYTES_PER_S, bound_s, share_pct
from harness.runner import LayerContext
from harness.shapes import cell_shapes
from harness.spec import Cell, load_metric
from harness.tracing import Trace

COV = "doa_tpu_torch.pipeline_torch:cov_embedded"
SUB = "doa_tpu_torch.pipeline_torch:signal_subspace_from_E_T"
SCAN = "doa_tpu_torch.plan:KERNELS.music_scan_peaks"
FRONT = "doa_tpu_torch.pipeline_torch:wideband_cov_embedded"
FUSION = "doa_tpu_torch.pipeline_torch:wideband_music_cpx"
NEW = ("entry.host_syncs", "entry.idle", "covariance.roofline",
       "subspace.roofline", "scan.roofline", "wb_front.roofline",
       "wb_fusion.roofline")

# One call of the ULA's shape (µs from the call's start). Spans: (start,
# end, name). Ops: (launch, start, end, name, category); each op's
# innermost span is the one open at its launch.
ULA_SPANS = [(0, 100, "bench.call"), (2, 90, "doa.call"),
             (3, 5, "doa.ingest"),
             (5, 30, "doa.covariance"), (6, 28, COV),
             (31, 60, "doa.subspace"), (33, 59, SUB),
             (35, 51, "doa.sync.escalation"),
             (54, 58, "doa.sync.escalation"),
             (61, 70, "doa.scan"), (62, 69, SCAN),
             (90, 98, "bench.copy_out"), (99, 100, "bench.record")]
ULA_OPS = [(7, 8, 38, "k1", "kernel"),               # COV
           (29, 38, 40, "glue", "kernel"),           # doa.covariance
           (32, 40, 44, "mean", "kernel"),           # doa.subspace
           (34, 44, 50, "k4", "kernel"),             # SUB
           (36, 50, 51, "flag", "gpu_memcpy"),       # doa.sync.escalation
           (52, 52, 53, "k4", "kernel"),             # SUB
           (55, 55, 56, "flag", "gpu_memcpy"),       # doa.sync.escalation
           (63, 64, 74, "k2", "kernel"),             # SCAN
           (91, 91, 92, "answers", "gpu_memcpy")]    # bench.copy_out
# c5's shape: the front end, then the fusion with its two syncs, then the
# peaks outside it
URA_SPANS = [(0, 100, "bench.call"), (1, 95, "doa.call"),
             (1, 3, "doa.ingest"),
             (3, 20, "doa.wb_front"), (4, 19, FRONT),
             (21, 80, "doa.wb_fusion"), (22, 79, FUSION),
             (30, 41, "doa.sync.escalation"),
             (43, 60, "doa.sync.escalation"),
             (81, 94, "doa.peaks"),
             (95, 99, "bench.copy_out")]
URA_OPS = [(5, 5, 25, "kernel4", "kernel"),          # FRONT
           (23, 25, 40, "k4", "kernel"),             # FUSION
           (31, 40, 41, "flag", "gpu_memcpy"),       # doa.sync.escalation
           (42, 42, 44, "k4", "kernel"),             # FUSION
           (43, 44, 45, "flag", "gpu_memcpy"),       # doa.sync.escalation
           (61, 61, 85, "kernel5", "kernel"),        # FUSION
           (82, 85, 87, "peaks", "kernel"),          # doa.peaks
           (96, 96, 97, "answers", "gpu_memcpy")]    # bench.copy_out


def _write(tmp_path, spans, ops, calls=2, period=100, t0=1000.0):
    """A Chrome trace of `calls` copies of one call, `period` µs apart."""
    events, corr = [], 0
    for c in range(calls):
        off = t0 + c * period
        for a, b, name in spans:
            events.append({"ph": "X", "cat": "user_annotation", "name": name,
                           "ts": off + a, "dur": b - a})
        for launch, a, b, name, cat in ops:
            corr += 1
            events.append({"ph": "X", "cat": "cuda_runtime",
                           "name": "cudaLaunchKernel", "ts": off + launch,
                           "dur": 0.5, "args": {"correlation": corr}})
            events.append({"ph": "X", "cat": cat, "name": name,
                           "ts": off + a, "dur": b - a,
                           "args": {"correlation": corr}})
    path = tmp_path / "t.trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return Trace(str(path))


def _bytes_bound(us):
    """A work whose bound is `us` µs of memory traffic."""
    return {"bytes": BYTES_PER_S * us * 1e-6}


def _ctx(trace, works):
    ctx = LayerContext({}, {}, trace, {})
    ctx.works = works
    return ctx


@pytest.fixture
def ula(tmp_path):
    return _ctx(_write(tmp_path, ULA_SPANS, ULA_OPS),
                {"covariance_roofline": _bytes_bound(16),
                 "subspace_roofline": _bytes_bound(6.5),
                 "scan_roofline": _bytes_bound(5)})


@pytest.fixture
def ura(tmp_path):
    return _ctx(_write(tmp_path, URA_SPANS, URA_OPS),
                {"wb_front_roofline": _bytes_bound(10),
                 "wb_fusion_roofline": _bytes_bound(21)})


def _read(name, ctx):
    return load_metric(name).read(ctx)


def _twin(name, ctx):
    """The accepted roofline `name`, spanned from its ENTRIES, on the
    work the test gives it."""
    return share_pct(ctx, load_metric(name).ENTRIES, ctx.works[name])


def test_the_window_as_the_harness_reads_it(ula):
    tr = ula.trace
    assert (tr.t0, tr.t1, tr.n_calls) == (1000.0, 1200.0, 2)
    # ops 56 µs a call of the 200 µs window
    assert load_metric("device.idle").read(ula) == pytest.approx(0.44)


def test_host_syncs_a_call(ula, ura):
    assert _read("entry.host_syncs", ula) == 2.0
    assert _read("entry.host_syncs", ura) == 2.0
    assert stages.count_per_call(ula.trace, "doa.scan") == 1.0


def test_idle_inside_the_calls(ula, ura):
    # ULA: doa.call [2, 90] holds busy [8, 51], [52, 53], [55, 56],
    # [64, 74]: 55 of 88 µs, so 33 idle a call, 66 of the 200 µs window
    assert stages.idle_s_inside(ula.trace, "doa.call") == pytest.approx(
        66e-6)
    assert _read("entry.idle", ula) == pytest.approx(0.33)
    assert _read("entry.idle", ula) <= _read("device.idle", ula)
    # c5: doa.call [1, 95] holds busy [5, 41], [42, 45], [61, 87]: 65 of
    # 94 µs, 29 idle a call; the ops 66 µs a call with the answers' copy
    assert _read("entry.idle", ura) == pytest.approx(58 / 200)
    assert _read("device.idle", ura) == pytest.approx(1 - 2 * 66 / 200)


def test_the_stage_rooflines_against_their_twins(ula, ura):
    # doa.covariance: k1 30 + glue 2 = 32 µs a call; the twin reads k1's 30
    assert _read("covariance.roofline", ula) == pytest.approx(100 * 16 / 32)
    assert _twin("covariance_roofline", ula) == pytest.approx(100 * 16 / 30)
    # doa.subspace: mean 4 + k4 6 + 1 + the two flag reads 1 + 1 = 13 µs;
    # the twin reads the entry's own k4 launches, 7
    assert _read("subspace.roofline", ula) == pytest.approx(100 * 6.5 / 13)
    assert _twin("subspace_roofline", ula) == pytest.approx(100 * 6.5 / 7)
    assert _read("scan.roofline", ula) == pytest.approx(100 * 5 / 10)
    assert _twin("scan_roofline", ula) == pytest.approx(100 * 5 / 10)
    # doa.wb_front: kernel 4's 20 µs; doa.wb_fusion: k4 15 + 2, kernel 5
    # 24 and the two flag reads 1 + 1 = 43 µs; the twin 41; the peaks
    # (2 µs) lie outside both
    assert _read("wb_front.roofline", ura) == pytest.approx(100 * 10 / 20)
    assert _twin("wb_front_roofline", ura) == pytest.approx(100 * 10 / 20)
    assert _read("wb_fusion.roofline", ura) == pytest.approx(100 * 21 / 43)
    assert _twin("wb_fusion_roofline", ura) == pytest.approx(100 * 21 / 41)


def test_a_stage_of_another_cell_reads_nothing(ula, ura):
    for name in ("wb_front.roofline", "wb_fusion.roofline"):
        assert _read(name, ula) is None and ula.notes
    ura.works["covariance_roofline"] = _bytes_bound(16)
    assert _read("covariance.roofline", ura) is None
    assert any("no doa.covariance span" in n for n in ura.notes)


def test_an_ambiguous_nesting_reads_nothing(tmp_path):
    # the covariance entry also opens outside doa.covariance: its ops
    # could belong to the stage or not
    spans = ULA_SPANS + [(71, 80, COV)]
    ctx = _ctx(_write(tmp_path, spans, ULA_OPS),
               {"covariance_roofline": _bytes_bound(16)})
    assert _read("covariance.roofline", ctx) is None
    assert any("both inside and outside" in n for n in ctx.notes)


def test_a_program_without_spans_reads_nothing(tmp_path):
    """The parent's program opens no doa.* span: every new reader returns
    None with a note, and none raises."""
    spans = [s for s in ULA_SPANS if not s[2].startswith("doa.")]
    ctx = _ctx(_write(tmp_path, spans, ULA_OPS),
               {"covariance_roofline": _bytes_bound(16),
                "subspace_roofline": _bytes_bound(6.5),
                "scan_roofline": _bytes_bound(5),
                "wb_front_roofline": _bytes_bound(10),
                "wb_fusion_roofline": _bytes_bound(21)})
    for name in NEW:
        ctx.notes = []
        assert _read(name, ctx) is None and ctx.notes, name


@pytest.mark.parametrize("cell", ["ula16_music.hop1024",
                                  "ura64_wideband.survey"])
def test_the_new_files_leave_the_works_and_step_mfu(spec, tmp_path, cell):
    """The new metrics define no work and no ENTRIES and end in no
    `_roofline`: ctx.works, and step_mfu's sum over it, are the accepted
    metrics' alone."""
    c = Cell(spec, cell)
    mods = {m["name"]: c.metric(m["name"]) for m in c.per_layer}
    assert set(NEW) & set(mods)
    for name in NEW:
        mod = load_metric(name)
        assert not hasattr(mod, "work") and not hasattr(mod, "ENTRIES")
        assert not name.endswith("_roofline")
    shapes = cell_shapes(c.fields, c.traffic["samples_per_call"])
    every = {n: m.work(shapes) for n, m in mods.items() if hasattr(m, "work")}
    old = {n: m.work(shapes) for n, m in mods.items()
           if hasattr(m, "work") and n not in NEW}
    assert every == old and every
    trace = _write(tmp_path, ULA_SPANS, ULA_OPS)
    mfu = load_metric("step_mfu")
    assert mfu.read(_ctx(trace, every)) == mfu.read(_ctx(trace, old))
    assert mfu.read(_ctx(trace, every)) == pytest.approx(
        100 * sum(bound_s(w) for w in old.values()) / 100e-6)
