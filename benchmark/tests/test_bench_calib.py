"""The calibrated ULA-16 with smoothing (configuration ula16_calib, cell
ula16_calib.multipath) and the headline at hop 512 (ula16_music.hop512),
on the CPU at sizes a test can hold:

* the port's CPU path agrees with the plain reference reference/ula_smooth
  (angles within a tenth of the cell's limit; peak values within the
  limit: a peak's den is a deep null that FP32 resolves to a few percent,
  as a plain FP32 reference does too);
* the reference finds the three planted directions, the coherent pair
  among them, and misses the pair with no decorrelation (no FB, L = N) on
  the same seed;
* the control (the reference at TF32) fails the limits;
* faults planted in the timed path fail: FB skipped, smoothing skipped,
  the subspace step returning its start;
* the cold subspace at 2L = 24 escalates the same windows in the program
  and in the reference on a scene built to flag some;
* the per-layer metrics' work functions give PERF.md's bounds and grow
  with the call.
"""

import copy
import dataclasses

import numpy as np
import pytest
import torch

from harness import checks, traffic
from harness.roofline import bound_s
from harness.runner import build_config, run_cell
from harness.shapes import cell_shapes
from harness.spec import Cell, load_metric

CALIB = "ula16_calib.multipath"
HOP512 = "ula16_music.hop512"
SEED = 2 ** 31 + 17
# per cell: samples a call, blocks, checked windows a block, seconds
TINY = {CALIB: dict(samples=16 * 1024, blocks=2, windows_per_block=16,
                    seconds=0.1),
        HOP512: dict(samples=64 * 512, blocks=2, windows_per_block=16,
                     seconds=0.1)}


def _run(spec, name, seed=SEED):
    result, notes = run_cell(Cell(spec, name), seed, device="cpu",
                             trace=False, **TINY[name])
    return result, notes


@pytest.mark.parametrize("name", [CALIB, HOP512])
def test_the_port_agrees_with_the_reference(spec, name):
    result, notes = _run(spec, name)
    assert result["correct"], (result, notes)
    assert result["failed"] == 0
    c = result["checks"]
    assert c["angle_gap_deg"]["value"] <= c["angle_gap_deg"]["limit"] / 10
    assert c["value_gap"]["value"] <= c["value_gap"]["limit"]
    if name == HOP512:
        assert c["value_gap"]["value"] <= c["value_gap"]["limit"] / 10


def test_the_configuration_is_the_preset(spec):
    """Every DoaConfig field of ula16_calib is the c3 preset's."""
    from doa_tpu_torch.configs import PRESETS
    cfg = build_config(Cell(spec, CALIB).fields)
    want = dataclasses.replace(PRESETS["c3_ula16_calib_smooth"], overlap=0)
    assert cfg == want


def _planted(spec, seed, **changes):
    """The reference's sorted angles at 8 windows of one block of the
    cell's scene, with the configuration's fields changed as given, and
    the planted directions."""
    from reference.common import Prec
    cell = Cell(spec, CALIB)
    x, dirs = traffic.make_block(cell.fields, cell.traffic["scene"],
                                 32 * 1024, seed, 0, "cpu")
    cfg = dict(cell.config["doa_config"], **changes)
    a = cell.reference().answers(x, cfg, 0, torch.arange(0, 32, 4),
                                 Prec("float64"))
    return np.sort(a["angles"].numpy(), -1), np.array([d[0] for d in dirs])


def test_the_reference_finds_the_coherent_pair(spec):
    """The traffic's first two sources are the same tone (the pair), at
    the two lowest angles; the third is another tone. With FB and
    smoothing every planted direction is found within 0.1°; with neither
    (L = N, no FB) the pair is lost by more than 0.5°, the third source
    still found."""
    got, want = _planted(spec, 9)
    assert np.abs(got - want).max() < 0.1
    got, want = _planted(spec, 9, avg_method=0,
                         smoothing={"subarray_size": 16})
    err = np.abs(got - want).max(0)
    assert err[:2].min() > 0.5 and err[2] < 0.1


def test_the_reference_glue_is_the_programs():
    """The reference's correction (with a non-identity c), FB and
    smoothing in float64 against the program's cpx_ops in float32."""
    from doa_tpu_torch.ops import cpx_ops
    from reference import ula_smooth as ref
    gen = torch.Generator().manual_seed(3)
    z = torch.randn((4, 64, 16), generator=gen, dtype=torch.complex128)
    R = z.transpose(1, 2) @ z.conj() / 64
    c = torch.polar(1 + 0.1 * torch.randn(16, generator=gen,
                                          dtype=torch.float64),
                    0.3 * torch.randn(16, generator=gen,
                                      dtype=torch.float64))
    want = ref.smooth(*ref.forward_backward(*ref.correct(
        R.real, R.imag, c.real, c.imag)), 12)
    f = [t.float() for t in (R.real, R.imag, c.real, c.imag)]
    got = cpx_ops.spatial_smooth(*cpx_ops.forward_backward(
        *cpx_ops.apply_correction_to_cov(*f)), 12)
    for g, w in zip(got, want):
        assert g.shape == (4, 12, 12)
        torch.testing.assert_close(g.double(), w, rtol=0, atol=1e-5)


@pytest.mark.parametrize("name", [CALIB, HOP512])
def test_the_control_fails(spec, name):
    import readings
    cell = Cell(spec, name)
    size = {CALIB: (32 * 1024, 2, 32), HOP512: (64 * 1024, 2, 64)}[name]
    r = readings.control_reading(cell, 11, torch.device("cpu"), *size)
    assert not checks.verdict(r, cell.traffic["check"]["limits"]), r


# ---------------------------------------------------------------------
# faults planted in the timed path
# ---------------------------------------------------------------------

def _no_fb(Rr, Ri):
    return Rr, Ri


def _first_subarray(Rr, Ri, L):
    """The first L×L block alone, no mean over the subarrays."""
    return Rr[..., :L, :L], Ri[..., :L, :L]


def _cold_start(fn):
    """The rounds returning their cold start, MGS of E's first 2K rows."""
    from doa_tpu_torch.ops import cpx_ops

    def broken(E, num_sources, rounds, init=None):
        _, W, Vt_prev = fn(E, num_sources, rounds, init)
        return cpx_ops._mgs_rows(E[..., :2 * num_sources, :]), W, Vt_prev
    return broken


@pytest.mark.parametrize("fault", ["fb_skipped", "smoothing_skipped",
                                   "subspace_at_its_start"])
def test_a_broken_timed_path_is_not_correct(spec, monkeypatch, fault):
    from doa_tpu_torch import plan
    from doa_tpu_torch.ops import cpx_ops
    if fault == "fb_skipped":
        monkeypatch.setattr(cpx_ops, "forward_backward", _no_fb)
    elif fault == "smoothing_skipped":
        monkeypatch.setattr(cpx_ops, "spatial_smooth", _first_subarray)
    else:
        wrapper, plain = plan.KERNELS["mgs_iterate"]
        monkeypatch.setitem(plan.KERNELS, "mgs_iterate",
                            (wrapper, _cold_start(plain)))
    result, notes = _run(spec, CALIB)
    assert not result["correct"], (result, notes)


def test_the_cold_subspace_escalates_the_same_windows(spec, monkeypatch):
    """At −7 dB a element (seed 1) the detector flags some of the 32
    windows: the program's cold K4 at 2L = 24 (its plain version here)
    and the reference escalate the same ones."""
    from doa_tpu_torch.ops import cpx_ops
    from doa_tpu_torch.pipeline_torch import build_pipeline_torch
    from reference.common import Prec
    cell = Cell(spec, CALIB)
    scene = copy.deepcopy(cell.traffic["scene"])
    scene["snr_db"] = -7.0
    x, _ = traffic.make_block(cell.fields, scene, 32 * 1024, 1, 0, "cpu")
    flagged = []
    real = cpx_ops.escalate_flagged

    def spy(Ep, Vt, bad, *args):
        assert Ep.shape[-1] == 24
        flagged.extend(bad.nonzero()[:, 0].tolist())
        return real(Ep, Vt, bad, *args)
    monkeypatch.setattr(cpx_ops, "escalate_flagged", spy)
    res = build_pipeline_torch(build_config(cell.fields), device="cpu",
                               return_spectra=False).interleaved(x)
    ref = [w for w in range(32) if cell.reference().answers(
        x, cell.config["doa_config"], 0, torch.tensor([w]),
        Prec("float64"))["escalated"]]
    assert 0 < len(ref) < 32
    assert flagged == ref
    assert int(res.escalation_flagged) == len(ref)
    assert int(res.escalation_overflow) == 0


# ---------------------------------------------------------------------
# the work functions
# ---------------------------------------------------------------------

def _shapes(spec, T):
    return cell_shapes(Cell(spec, CALIB).fields, T)


def test_the_gram_bound(spec):
    """Kernel 8's bytes: 0.6511 ms at 2^24 (PERF.md row 8), 5.21 at
    2^27; its FP32 operations take less."""
    w = load_metric("planes_gram.roofline").work(_shapes(spec, 1 << 24))
    assert bound_s(w) * 1e3 == pytest.approx(0.6511, abs=5e-5)
    w = load_metric("planes_gram.roofline").work(_shapes(spec, 1 << 27))
    assert bound_s(w) * 1e3 == pytest.approx(5.21, abs=5e-3)
    assert w["ops"]["fp32"] / 67e12 < bound_s(w)


def test_the_smoothing_and_call_bounds(spec):
    """The glue's bytes ~0.125 ms at 2^27; the call's layers sum to the
    Gram's bound and the three smaller ones (L = 12)."""
    s = _shapes(spec, 1 << 27)
    glue = load_metric("smoothing.roofline").layer_work(s, 12)
    assert bound_s(glue) * 1e3 == pytest.approx(0.1252, abs=5e-5)
    works = load_metric("calib.step_mfu").layer_works(
        s, Cell(spec, CALIB).fields)
    assert set(works) == {"gram", "smoothing", "subspace", "scan"}
    assert bound_s(works["gram"]) > sum(bound_s(w) for k, w in works.items()
                                        if k != "gram")


@pytest.mark.parametrize("layer", ["gram", "smoothing", "subspace", "scan"])
def test_work_grows_with_the_call(spec, layer):
    fields = Cell(spec, CALIB).fields
    mfu = load_metric("calib.step_mfu")
    small = bound_s(mfu.layer_works(_shapes(spec, 1 << 26), fields)[layer])
    big = bound_s(mfu.layer_works(_shapes(spec, 1 << 27), fields)[layer])
    assert big == pytest.approx(2 * small, rel=0.02)
