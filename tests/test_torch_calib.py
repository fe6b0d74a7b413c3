"""Port parity of the calibration stage: doa_tpu_torch.calib against
doa_tpu.calib on the same numpy captures, the two-stage calibration end to
end through the port's planes pipeline, and artifacts written by each
package read by the other."""

import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import golden
from doa_tpu import calib as calib_jax
from doa_tpu.calib.element_cal import average_corrections as avg_jax
from doa_tpu.configs import PRESETS
from doa_tpu.io import SourceSpec, synth_ula_iq
from doa_tpu.pipeline_tpu import build_pipeline_tpu
from doa_tpu_torch import calib
from doa_tpu_torch.ops.cpx_ops import cov_from_stream
from doa_tpu_torch.pipeline_torch import build_pipeline_torch


def _impairments(N, seed=3):
    rng = np.random.default_rng(seed)
    chain = rng.uniform(-1.5, 1.5, N)
    chain[0] = 0.0
    gains = 1.0 + 0.25 * rng.standard_normal(N)
    phases = rng.uniform(-0.4, 0.4, N)
    return chain, gains * np.exp(1j * phases)


def _impair(x, chain, elem):
    return (golden.apply_phase_correction(x, -chain)
            * elem[None, :]).astype(np.complex64)


def _pilot_covariances(x, corr, S):
    """The port's planes-path windows (kernel 8's plain version) of the
    stage-1-corrected pilot capture → complex64 R [B, N, N]."""
    xr = torch.from_numpy(np.ascontiguousarray(x.real))
    xi = torch.from_numpy(np.ascontiguousarray(x.imag))
    from doa_tpu_torch.ops.cpx_ops import apply_correction_to_cov
    Rr, Ri = cov_from_stream(xr, xi, S, 0)
    Rr, Ri = apply_correction_to_cov(Rr, Ri, corr.real.float(),
                                     corr.imag.float())
    return torch.complex(Rr, Ri)


def test_phase_offset_matches_reference():
    """Stage 1 on an impaired common tone: phases within 1e-5 rad of
    doa_tpu's (the same mean of x·conj(x_ref), summed in another order);
    the correction is exp(−j·phi) within 1e-6."""
    x = golden.synthetic_ula_iq([90.0], 6, 0.5, 4096, snr_db=20, seed=1)
    x = _impair(x, np.array([0.0, 0.5, -0.9, 1.7, -2.9, 3.0]),
                np.ones(6)).astype(np.complex64)
    phi = calib.phase_offset_est(torch.from_numpy(x))
    phi_ref = np.asarray(calib_jax.phase_offset_est(jnp.asarray(x)))
    err = np.angle(np.exp(1j * (phi.numpy() - phi_ref)))
    assert phi.dtype == torch.float32 and np.abs(err).max() < 1e-5
    np.testing.assert_allclose(calib.phase_correction(phi).numpy(),
                               np.asarray(calib_jax.phase_correction(phi_ref)),
                               atol=1e-6)


def test_element_calibration_matches_reference():
    """Stage 2 per window and averaged: within 1e-4 of doa_tpu's (complex
    eigh in another LAPACK call; the reference-element normalisation removes
    the eigenvector's phase)."""
    N = 8
    x = golden.synthetic_ula_iq([75.0], N, 0.5, 8192, snr_db=25, seed=2)
    x = x * (1.0 + 0.2 * np.arange(N))[None, :] * np.exp(
        0.3j * np.arange(N))[None, :]
    R = golden.sample_covariance(golden.frame_samples(x, 1024, 0)).astype(
        np.complex64)
    c = calib.element_calibration(torch.from_numpy(R), 75.0, 0.5)
    c_ref = np.asarray(calib_jax.element_calibration(jnp.asarray(R), 75.0,
                                                     0.5))
    assert c.shape == (8, N) and c.dtype == torch.complex64
    np.testing.assert_allclose(c.numpy(), c_ref, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(calib.average_corrections(c).numpy(),
                               np.asarray(avg_jax(jnp.asarray(c_ref))),
                               rtol=1e-4, atol=1e-4)
    g = golden.element_calibration(R.mean(axis=0), 75.0, 0.5)
    np.testing.assert_allclose(
        calib.element_calibration(torch.from_numpy(R.mean(axis=0)[None]),
                                  75.0, 0.5)[0].numpy(), g, rtol=1e-3,
        atol=1e-4)


def test_apply_and_compose_match_reference():
    """Complex products within 1e-6 relative (torch and XLA may fuse the
    complex multiply's products differently)."""
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((16, 3)) + 1j * rng.standard_normal(
        (16, 3))).astype(np.complex64)
    a = np.exp(1j * np.array([0.1, 0.2, -0.4])).astype(np.complex64)
    b = np.array([2.0, 0.5, 1.25], dtype=np.complex64)
    np.testing.assert_allclose(
        calib.apply_correction(torch.from_numpy(x), torch.from_numpy(a)
                               ).numpy(),
        np.asarray(calib_jax.apply_correction(jnp.asarray(x), a)),
        rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        calib.compose_corrections(torch.from_numpy(a), torch.from_numpy(b)
                                  ).numpy(),
        np.asarray(calib_jax.compose_corrections(a, b)), rtol=1e-6,
        atol=1e-6)


def test_two_stage_calibration_end_to_end(tmp_path):
    """The reference's procedure through the port on c3's array: chain
    phases and element gains/phases on every capture; stage 1 from a common
    tone, stage 2 from a pilot at 68° (windows from the port's planes
    covariance); the artifact saved and reloaded; then c3 on the impaired
    scene with the loaded correction: angles within 1e-3° of doa_tpu's
    pipeline with the same correction, and within 0.5° of the truth in
    every window."""
    cfg = PRESETS["c3_ula16_calib_smooth"]
    N = 16
    chain, elem = _impairments(N)
    x_tone = synth_ula_iq([SourceSpec(theta_deg=90.0)], N, 0.5, 8192,
                          snr_db=25, seed=4)
    phi = calib.phase_offset_est(torch.from_numpy(_impair(x_tone, chain,
                                                          elem)))
    c1 = calib.phase_correction(phi)
    pilot = 68.0
    x_pilot = synth_ula_iq([SourceSpec(theta_deg=pilot)], N, 0.5, 16384,
                           snr_db=25, seed=5)
    R = _pilot_covariances(_impair(x_pilot, chain, elem), c1, 2048)
    c2 = calib.average_corrections(calib.element_calibration(R, pilot, 0.5))
    art = calib.CalibrationArtifact(
        phase_offsets=phi.numpy(), element_corrections=c2.numpy(),
        num_elements=N, norm_spacing=0.5, pilot_theta_deg=pilot)
    path = str(tmp_path / "cal")
    calib.save_calibration(path, art)
    corr = calib.load_calibration(path).correction_vector()
    np.testing.assert_allclose(
        corr, calib.compose_corrections(c1, c2).numpy(), rtol=1e-6,
        atol=1e-6)

    srcs = [SourceSpec(theta_deg=40.0, freq_norm=0.12),
            SourceSpec(theta_deg=70.0, freq_norm=0.12),
            SourceSpec(theta_deg=100.0, freq_norm=0.3)]
    x = _impair(synth_ula_iq(srcs, N, 0.5, 12 * 1024, snr_db=10, seed=3),
                chain, elem)
    out = build_pipeline_torch(cfg, device="cpu")(x, corr)
    ref = build_pipeline_tpu(dataclasses.replace(cfg, cov_impl="pallas"))(
        x, corr)
    a = np.sort(out.peak_angles["music"].numpy(), -1)
    a_ref = np.sort(np.asarray(ref.peak_angles["music"]), -1)
    np.testing.assert_allclose(a, a_ref, atol=1e-3)
    assert np.abs(a - [40.0, 70.0, 100.0]).max() < 0.5


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_artifact_crosses_packages(tmp_path, writer):
    """An artifact written by either package loads in the other with the
    same fields and correction vector (one .npz format)."""
    rng = np.random.default_rng(5)
    art_kw = dict(
        phase_offsets=rng.uniform(-1, 1, 6).astype(np.float32),
        element_corrections=(rng.standard_normal(6) + 1j * rng.standard_normal(
            6)).astype(np.complex64),
        num_elements=6, norm_spacing=0.5, pilot_theta_deg=68.0,
        created_unix=1.5e9)
    save, load = ((calib.save_calibration, calib_jax.load_calibration)
                  if writer == "port" else
                  (calib_jax.save_calibration, calib.load_calibration))
    make = (calib.CalibrationArtifact if writer == "port"
            else calib_jax.CalibrationArtifact)
    art = make(**art_kw)
    path = str(tmp_path / "cal.npz")
    save(path, art)
    back = load(path)
    for f in ("num_elements", "norm_spacing", "pilot_theta_deg",
              "created_unix", "version"):
        assert getattr(back, f) == getattr(art, f)
    np.testing.assert_array_equal(back.phase_offsets, art.phase_offsets)
    np.testing.assert_array_equal(back.element_corrections,
                                  art.element_corrections)
    np.testing.assert_array_equal(back.correction_vector(),
                                  art.correction_vector())
