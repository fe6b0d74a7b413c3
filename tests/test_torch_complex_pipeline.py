"""Port parity of the complex-typed public entry: doa_tpu_torch's
pipeline.build_pipeline and estimate_doa on the CPU against doa_tpu's
(doa_tpu/pipeline.py) on the same complex64 capture and correction, at
small widths, mirroring tests/test_pipeline_e2e.py; and the device rule
(no card: the default device raises)."""

import dataclasses

import numpy as np
import pytest
import torch

import doa_tpu
import doa_tpu_torch
from doa_tpu.configs import (ArrayGeometry, BeamspaceSpec, DoaConfig,
                             Estimator, GridSpec1D, GridSpec2D, PRESETS)
from doa_tpu.io import SourceSpec, synth_ula_iq, synth_ura_iq
from doa_tpu.pipeline import build_pipeline as build_jax
from doa_tpu_torch.pipeline import build_pipeline

ANGLE_TOL = 1e-3        # degrees: the narrowband standard (ROADMAP §C.3)
COV_TOL = 2e-5          # of max|R|
GRID_FREE = ("root_music_angles", "esprit_angles", "unitary_esprit_angles")
E = Estimator


def _ula(N, thetas, T, snr_db=10, seed=0, freqs=(0.1, 0.31, 0.33),
         **kw):
    return synth_ula_iq(
        [SourceSpec(theta_deg=t, freq_norm=f) for t, f in zip(thetas, freqs)],
        N, 0.5, T, snr_db=snr_db, seed=seed, **kw).astype(np.complex64)


def _correction(N, seed=7):
    rng = np.random.default_rng(seed)
    return ((1.0 + 0.3 * rng.standard_normal(N))
            * np.exp(1j * rng.uniform(-0.8, 0.8, N))).astype(np.complex64)


def _sorted(a):
    """Each window's angles sorted; (B, K, 2) az/el pairs by azimuth."""
    a = np.asarray(a)
    if a.ndim == 3:
        return np.take_along_axis(a, np.argsort(a[..., 0], -1)[..., None],
                                  -2)
    return np.sort(a, -1)


def _case(name):
    """→ (cfg, x, correction, scene angles or None, tolerance to the
    scene in degrees)."""
    c2 = PRESETS["c2_ula8_2src"]
    if name == "c1":
        return (PRESETS["c1_ula4_tone"], _ula(4, [72.3], 16 * 256), None,
                [72.3], 0.5)
    if name == "c1_correction":
        N = 4
        gains = 1.0 + 0.3 * np.random.default_rng(7).standard_normal(N)
        phases = np.random.default_rng(8).uniform(-0.8, 0.8, N)
        x = _ula(N, [64.0], 16 * 256, snr_db=15, seed=5, channel_gains=gains,
                 channel_phases=phases)
        c = (1.0 / (gains * np.exp(1j * phases))).astype(np.complex64)
        return PRESETS["c1_ula4_tone"], x, c, [64.0], 0.5
    if name == "c2":
        return c2, _ula(8, [60.0, 110.0], 8 * 2048, seed=1), None, \
            [60.0, 110.0], 1.0
    if name == "c3_smoothing":
        x = _ula(16, [70.0, 100.0, 40.0], 8 * 1024, snr_db=15, seed=2,
                 freqs=(0.1, 0.1, 0.33), correlated_pairs=[(0, 1)])
        return (PRESETS["c3_ula16_calib_smooth"], x, _correction(16), None,
                None)
    if name == "c4_overlap":
        return (PRESETS["c4_ula16_streaming"],
                _ula(16, [55.0, 125.0], 8192, seed=3, freqs=(0.1, 0.3)),
                None, [55.0, 125.0], 1.0)
    if name == "root_music":
        cfg = dataclasses.replace(
            c2, snapshot_size=512, estimators=(E.MUSIC, E.ROOT_MUSIC))
        return cfg, _ula(8, [60.0, 110.0], 8 * 512, snr_db=15, seed=4,
                         freqs=(0.1, 0.3)), None, [60.0, 110.0], 0.5
    if name == "seven_estimators":
        cfg = dataclasses.replace(c2, snapshot_size=256,
                                  estimators=tuple(Estimator))
        return cfg, _ula(8, [60.0, 110.0], 12 * 256, snr_db=15, seed=6,
                         freqs=(0.1, 0.3)), _correction(8, 3), None, None
    if name == "ura_esprit_2d":
        cfg = DoaConfig(
            geometry=ArrayGeometry(kind="ura", num_elements=16,
                                   norm_spacing=0.5, shape=(4, 4)),
            snapshot_size=256, num_sources=2,
            estimators=(E.MUSIC, E.ESPRIT),
            grid2d=GridSpec2D(num_az=61, num_el=31, az_lo_deg=-90.0,
                              az_hi_deg=90.0, el_lo_deg=0.0,
                              el_hi_deg=90.0),
            num_max_vals=2)
        x = synth_ura_iq([SourceSpec(az_deg=-20.0, el_deg=30.0,
                                     freq_norm=0.1),
                          SourceSpec(az_deg=35.0, el_deg=60.0,
                                     freq_norm=0.3)],
                         (4, 4), 0.5, 6 * 256, snr_db=15,
                         seed=9).astype(np.complex64)
        return cfg, x, None, None, None
    if name == "beamspace":
        cfg = DoaConfig(
            geometry=ArrayGeometry(kind="ula", num_elements=16,
                                   norm_spacing=0.5),
            snapshot_size=512, num_sources=2,
            estimators=(E.MUSIC, E.CAPON), grid=GridSpec1D(
                num_points=361, lo_deg=40.0, hi_deg=140.0),
            num_max_vals=2,
            beamspace=BeamspaceSpec(num_beams=8, center_deg=90.0))
        return cfg, _ula(16, [80.0, 100.0], 8 * 512, seed=11,
                         freqs=(0.1, 0.3)), None, [80.0, 100.0], 1.0
    if name == "irregular_overlap":
        cfg = dataclasses.replace(c2, snapshot_size=96, overlap=40,
                                  estimators=(E.MUSIC, E.BARTLETT))
        return cfg, _ula(8, [60.0, 110.0], 1500, snr_db=15, seed=12,
                         freqs=(0.1, 0.3)), None, None, None
    raise KeyError(name)


CASES = ("c1", "c1_correction", "c2", "c3_smoothing", "c4_overlap",
         "root_music", "seven_estimators", "ura_esprit_2d", "beamspace",
         "irregular_overlap")


@pytest.mark.parametrize("name", CASES)
def test_pipeline_matches_reference(name):
    """Every estimator's peak angles (refined; [az, el] on a URA) and
    every grid-free estimate within 1e-3° of doa_tpu's, the same keys,
    spectra and shapes; the covariance (return_covariance, on every
    second case) within 2e-5 of max|R|; where the scene is simple, every
    window within its tolerance of the planted angles. c2 enters through
    estimate_doa in both packages."""
    cfg, x, c, truth, tol = _case(name)
    want_R = CASES.index(name) % 2 == 1
    if name == "c2":
        ref = doa_tpu.estimate_doa(x, cfg, correction=c)
        out = doa_tpu_torch.estimate_doa(x, cfg, correction=c, device="cpu")
    else:
        ref = build_jax(cfg, return_covariance=want_R)(x, c)
        out = build_pipeline(cfg, return_covariance=want_R,
                             device="cpu")(x, c)
    assert sorted(out.spectra) == sorted(ref.spectra) == sorted(
        out.peak_angles)
    for k, P in out.spectra.items():
        assert P.shape == ref.spectra[k].shape and P.dtype == torch.float32
        a, a_ref = out.peak_angles[k].numpy(), np.asarray(ref.peak_angles[k])
        assert a.shape == a_ref.shape
        np.testing.assert_allclose(a, a_ref, atol=ANGLE_TOL, err_msg=k)
        # Bartlett's beams are too wide for the scene; beamspace Capon
        # peaks out of the beams' sector in both packages (ROADMAP §C.3)
        if truth is not None and k != "bartlett" and not (
                name == "beamspace" and k == "capon"):
            assert np.abs(_sorted(a) - truth).max() < tol, k
    for k in GRID_FREE:
        a_ref = getattr(ref, k)
        if a_ref is None:
            assert getattr(out, k) is None
            continue
        a = getattr(out, k).numpy()
        assert a.shape == np.shape(a_ref)
        np.testing.assert_allclose(_sorted(a), _sorted(a_ref),
                                   atol=ANGLE_TOL, err_msg=k)
        if truth is not None:
            assert np.abs(_sorted(a) - truth).max() < tol, k
    if want_R:
        R, R_ref = out.covariance.numpy(), np.asarray(ref.covariance)
        assert R.shape == R_ref.shape and R.dtype == np.complex64
        assert np.abs(R - R_ref).max() <= COV_TOL * np.abs(R_ref).max()
    else:
        assert out.covariance is None and ref.covariance is None


def test_call_carries_config_and_steering():
    """call.config is the port's config equal to the reference's,
    call.steering_matrix the beamspace steering on the device, equal to
    the reference's; a tensor capture and correction give the numpy
    ones' result."""
    cfg, x, _, _, _ = _case("beamspace")
    ref = build_jax(cfg)
    call = build_pipeline(cfg, device="cpu")
    assert call.config == doa_tpu_torch.as_config(cfg)
    assert call.steering_matrix.dtype == torch.complex64
    np.testing.assert_array_equal(call.steering_matrix.numpy(),
                                  np.asarray(ref.steering_matrix))
    c = _correction(16)
    a = call(x, c).peak_angles["music"]
    b = call(torch.from_numpy(x), torch.from_numpy(c)).peak_angles["music"]
    np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_default_device_raises_without_a_card():
    """With no card, the entry points and the device constructors raise
    at their default device; none carries on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from doa_tpu_torch.ops import covariance, steering
    cfg = PRESETS["c1_ula4_tone"]
    x = _ula(4, [72.3], 4 * 256)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_pipeline(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        doa_tpu_torch.estimate_doa(x, cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        covariance.init_streaming_carry(4, 256, 128)
    with pytest.raises(RuntimeError, match="CUDA"):
        steering.ula_steering(np.array([70.0], np.float32), 4, 0.5)
