"""Port parity of the command-line apps: `python -m doa_tpu_torch <cmd>
--device cpu` against `python -m doa_tpu <cmd>` on the same files, each
command's JSON line against the reference's (in-process, each package's
`cli.main`)."""

import contextlib
import io
import json
import os

import numpy as np
import pytest
import torch

from doa_tpu import cli as cli_jax
from doa_tpu_torch import cli

MED_TOL = 2e-3      # degrees: the medians are printed to 3 places
CAL_TOL = 2e-4      # gains and phases (rad), printed to 4 places
TRACK_TOL = 0.011   # degrees: the final track angles, printed to 2 places


def _lines(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return [json.loads(s) for s in buf.getvalue().strip().splitlines()]


def _both(argv):
    """Run one command in both packages → (the port's JSON lines, the
    reference's); "@" in an argument becomes the package's tag, so each
    writes its own outputs."""
    def fill(tag):
        return [a.replace("@", tag) for a in argv]
    return (_lines(cli.main, fill("t") + ["--device", "cpu"]),
            _lines(cli_jax.main, fill("j")))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every command once in each package, on shared input files: the
    calibration workflow of tests/test_cli.py, a c2 estimate with that
    calibration, MDL's K and a report, a c4 track and a small c2
    evaluate."""
    d = str(tmp_path_factory.mktemp("cli"))
    p = lambda name: os.path.join(d, name)  # noqa: E731
    out = {}
    out["simulate"] = _both([
        "simulate", "--preset", "c2_ula8_2src", "--angles", "60,110",
        "--samples", "32768", "--out", p("cap_@.npz")])
    for name, ang, snr in (("common", "90", "30"), ("pilot", "68", "25")):
        cli_jax.main(["simulate", "--preset", "c1_ula4_tone", "--elements",
                      "8", "--angles", ang, "--samples", "16384", "--snr",
                      snr, "--out", p(f"{name}.npz")])
    out["calibrate-phase"] = _both([
        "calibrate-phase", "--input", p("common.npz"), "--out",
        p("cal1_@.npz")])
    out["calibrate-elements"] = _both([
        "calibrate-elements", "--input", p("pilot.npz"), "--pilot", "68",
        "--phase-calib", p("cal1_@.npz"), "--out", p("cal2_@.npz")])
    out["estimate"] = _both([
        "estimate", "--preset", "c2_ula8_2src", "--input", p("cap_j.npz"),
        "--calib", p("cal2_@.npz"), "--num-sources", "auto", "--report",
        p("report_@.html"), "--spectra-out", p("spectra_@.npz")])
    cli_jax.main(["simulate", "--preset", "c4_ula16_streaming", "--angles",
                  "55,125", "--samples", "16384", "--out", p("track.npz")])
    out["track"] = _both([
        "track", "--preset", "c4_ula16_streaming", "--input",
        p("track.npz")])
    out["evaluate"] = _both([
        "evaluate", "--preset", "c2_ula8_2src", "--snrs", "0,10",
        "--trials", "2", "--windows", "4"])
    out["dir"] = d
    return out


def test_simulate_writes_the_reference_capture(runs):
    (got,), (want,) = runs["simulate"]
    d = runs["dir"]
    assert got["shape"] == want["shape"] == [32768, 8]
    assert got["true_angles_deg"] == want["true_angles_deg"]
    with np.load(os.path.join(d, "cap_t.npz")) as a, \
            np.load(os.path.join(d, "cap_j.npz")) as b:
        np.testing.assert_array_equal(a["samples"], b["samples"])
        assert json.loads(str(a["meta"])) == json.loads(str(b["meta"]))


def test_calibrate_phase_matches(runs):
    (got,), (want,) = runs["calibrate-phase"]
    assert set(got) == set(want)
    np.testing.assert_allclose(got["phase_offsets_rad"],
                               want["phase_offsets_rad"], atol=CAL_TOL)


def test_calibrate_elements_matches(runs):
    (got,), (want,) = runs["calibrate-elements"]
    assert set(got) == set(want)
    np.testing.assert_allclose(got["gains"], want["gains"], atol=CAL_TOL)
    ph = np.angle(np.exp(1j * (np.asarray(got["phases_rad"])
                               - np.asarray(want["phases_rad"]))))
    assert np.abs(ph).max() <= CAL_TOL, ph


def test_estimate_matches(runs):
    """The c2 estimate with the two-stage calibration, MDL's K and a
    report: the same keys, K, window counts, medians within 2e-3° and
    within 1.5° of the scene; the report and the spectra are written."""
    (got,), (want,) = runs["estimate"]
    assert set(got) == set(want)
    assert got["num_sources_auto"] == want["num_sources_auto"] == 2
    for est in ("music", "capon"):
        assert got[est]["windows"] == want[est]["windows"] == 16
        np.testing.assert_allclose(got[est]["median_angles_deg"],
                                   want[est]["median_angles_deg"],
                                   atol=MED_TOL)
        np.testing.assert_allclose(got[est]["median_angles_deg"],
                                   [60.0, 110.0], atol=1.5)
    html = open(got["report_written"]).read()
    assert got["report_written"].endswith("report_t.html")
    assert "base64" in html and "music" in html and "capon" in html
    with np.load(got["spectra_written"]) as a, \
            np.load(want["spectra_written"]) as b:
        assert set(a) == set(b) == {"music", "capon"}
        assert a["music"].shape == b["music"].shape


def test_track_matches(runs):
    (got,), (want,) = runs["track"]
    assert set(got) == set(want)
    assert got["windows"] == want["windows"]
    assert got["active_tracks"] == want["active_tracks"] >= 2
    g, w = got["final_track_angles_deg"], want["final_track_angles_deg"]
    assert [a is None for a in g] == [a is None for a in w]
    np.testing.assert_allclose([a for a in g if a is not None],
                               [a for a in w if a is not None],
                               atol=TRACK_TOL)


def test_evaluate_matches(runs):
    """One row per (SNR, estimator), as the reference's (whose pipeline
    lists Capon's peaks before MUSIC's: the rows are matched by key): the
    same window counts and resolution, RMSE and bias within 2e-3°, the
    same CRB (both packages' numpy ops/crb.py)."""
    got, want = (
        {(r["snr_db"], r["estimator"]): r for r in rows}
        for rows in runs["evaluate"])
    assert len(got) == 4 and set(got) == set(want)
    for key, g in got.items():
        w = want[key]
        assert set(g) == set(w)
        for k in ("num_windows", "resolve_prob"):
            assert g[k] == w[k], k
        for k in ("rmse_deg", "bias_deg"):
            assert abs(g[k] - w[k]) <= MED_TOL, (k, g[k], w[k])
        np.testing.assert_allclose(g["crb_deg"], w["crb_deg"], rtol=1e-12)


def test_mode_overrides_reach_the_port(runs):
    """--scan-mode, --subspace-check and an explicit --num-sources reach
    the port's config, as the reference's."""
    cap = os.path.join(runs["dir"], "cap_j.npz")
    (res,) = _lines(cli.main, ["estimate", "--preset", "c2_ula8_2src",
                               "--input", cap, "--scan-mode",
                               "hierarchical", "--subspace-check",
                               "--num-sources", "2", "--device", "cpu"])
    assert "num_sources_auto" not in res
    np.testing.assert_allclose(sorted(res["music"]["median_angles_deg"]),
                               [60.0, 110.0], atol=1.0)


def test_device_cuda_raises_without_a_card(runs):
    """The default device is the card: without one every command raises
    cpx.checked_device's RuntimeError, never runs on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cap = os.path.join(runs["dir"], "cap_j.npz")
    for argv in (["estimate", "--input", cap, "--preset", "c2_ula8_2src"],
                 ["estimate", "--input", cap, "--preset", "c2_ula8_2src",
                  "--device", "cuda"],
                 ["track", "--input", cap, "--preset", "c2_ula8_2src"]):
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.main(argv)
