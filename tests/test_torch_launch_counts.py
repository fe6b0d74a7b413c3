"""The launch registry (doa_tpu_torch._build): every kernel wrapper counts
its launches there, as (kernel, form), and nowhere else; `counting()`
gives the launches of a block. Read from the package's source and on the
CPU, where no kernel launches."""

import ast
import os

import numpy as np
import pytest
import torch

import doa_tpu_torch
from doa_tpu_torch import PRESETS, _build
from doa_tpu_torch.io.synthetic import SourceSpec, synth_ula_iq
from doa_tpu_torch.pipeline_torch import build_pipeline_torch
from doa_tpu_torch.plan import KERNELS

PACKAGE = os.path.dirname(doa_tpu_torch.__file__)
# the wrappers no plan stage names count under their own names
UNPLANNED = {"chunk_embedded", "cov_windows", "subband_embedded",
             "subband_grams", "halo_ring"}
COUNTER_ATTRS = {"launches", "by_form", "by_epilogue", "by_route",
                 "tc_launches"}


def _modules():
    for root, dirs, files in os.walk(PACKAGE):
        dirs[:] = [d for d in dirs if not d.startswith(("_", "."))]
        for f in sorted(files):
            if f.endswith(".py"):
                path = os.path.join(root, f)
                with open(path) as fh:
                    yield (os.path.relpath(path, PACKAGE),
                           ast.parse(fh.read(), path))


def _count_sites():
    """{kernel: [module, ...]} of the _build.count(kernel, ...) calls."""
    sites = {}
    for rel, tree in _modules():
        for node in ast.walk(tree):
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "count"
                    and isinstance(node.func.value, ast.Name)
                    and node.func.value.id == "_build"):
                arg = node.args[0]
                assert isinstance(arg, ast.Constant), (rel, node.lineno)
                sites.setdefault(arg.value, []).append(rel)
    return sites


def test_no_module_keeps_a_counter_attribute():
    """No module reads or sets a launch counter of its own on a function
    (.launches, .by_form, .by_epilogue, .by_route, .tc_launches)."""
    found = [(rel, node.lineno, node.attr)
             for rel, tree in _modules() for node in ast.walk(tree)
             if isinstance(node, ast.Attribute)
             and node.attr in COUNTER_ATTRS]
    assert not found, found


def test_every_kernel_has_a_count_site():
    """Every kernel of plan.KERNELS, and each wrapper no plan stage names,
    is counted, in one module, under the name the plan or the wrapper
    gives it."""
    sites = _count_sites()
    assert set(sites) == set(KERNELS) | UNPLANNED, sites
    assert all(len(set(v)) == 1 for v in sites.values()), sites


def test_counting_holds_the_launches_of_its_block():
    """counting() holds the launches made inside its block alone, a nested
    block its own, and each count is one (kernel, form)."""
    _build.count("peaks2d", "ring")
    with _build.counting() as outer:
        _build.count("chunk_gram", "embedded")
        with _build.counting() as inner:
            assert not inner
            _build.count("mgs_iterate", "group")
            _build.count("mgs_iterate", "group")
            _build.count("music_scan")
        _build.count("chunk_gram", "embedded")
    _build.count("peaks2d", "ring")
    assert inner == {("mgs_iterate", "group"): 2, ("music_scan", None): 1}
    assert outer == {("chunk_gram", "embedded"): 2,
                     ("mgs_iterate", "group"): 2, ("music_scan", None): 1}
    with pytest.raises(KeyError):
        with _build.counting() as failed:
            _build.count("track")
            raise KeyError("the block fails")
    assert failed == {("track", None): 1}


@pytest.mark.parametrize("name", ["c2_ula8_2src", "c3_ula16_calib_smooth",
                                  "c4_ula16_streaming"])
def test_the_cpu_paths_count_nothing(name):
    """A pipeline on the CPU runs every stage's plain version: no launch
    is counted, through call and call.interleaved."""
    cfg = PRESETS[name]
    N, S = cfg.geometry.num_elements, cfg.snapshot_size
    x = synth_ula_iq([SourceSpec(theta_deg=60.0, freq_norm=0.1),
                      SourceSpec(theta_deg=110.0, freq_norm=0.31)],
                     N, 0.5, 4 * S, snr_db=10, seed=1).astype(np.complex64)
    pipe = build_pipeline_torch(cfg, device="cpu", return_spectra=False)
    with _build.counting() as n:
        pipe(x)
        pipe.interleaved(torch.from_numpy(x.view(np.float32)))
    assert not n


BELOW_THE_PIPELINE = ("ops", "tracking.py", "checkpoint.py", "pipeline.py")


def test_no_module_below_the_pipeline_imports_it():
    """The op modules, the tracker, the checkpoint and the complex-typed
    pipeline import nothing of pipeline_torch (the device check is
    cpx.checked_device)."""
    found = []
    for rel, tree in _modules():
        if not rel.startswith(BELOW_THE_PIPELINE):
            continue
        for node in ast.walk(tree):
            names = ([node.module or ""] if isinstance(node, ast.ImportFrom)
                     else [a.name for a in node.names]
                     if isinstance(node, ast.Import) else [])
            found += [(rel, node.lineno) for m in names
                      if m.endswith("pipeline_torch")]
    assert not found, found
