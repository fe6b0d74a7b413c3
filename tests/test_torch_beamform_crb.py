"""Port parity of MVDR beamforming (ops/beamform.py, on (re, im) planes)
and the Cramér–Rao bounds (ops/crb.py, numpy) against doa_tpu's, on the
scenes of tests/test_beamform.py and tests/test_crb.py."""

import numpy as np
import pytest
import torch

import golden
from doa_tpu.cpx import Cpx
from doa_tpu.ops import beamform as beamform_jax
from doa_tpu.ops import crb as crb_jax
from doa_tpu_torch.ops import beamform, crb


def _planes(a):
    a = np.asarray(a)
    return (torch.from_numpy(np.ascontiguousarray(a.real, np.float32)),
            torch.from_numpy(np.ascontiguousarray(a.imag, np.float32)))


def _complex(planes):
    return planes[0].numpy() + 1j * planes[1].numpy()


def test_mvdr_weights_match_reference_with_unit_gain():
    """tests/test_beamform.py's unit-gain scene (70°, 120°, 8 windows of
    2048): the weights within 1e-5 of the largest of the reference's, and
    wᴴa = 1 within 1e-3 toward the look direction."""
    x = golden.synthetic_ula_iq([70.0, 120.0], 8, 0.5, 16384, snr_db=10,
                                seed=0)
    R = golden.sample_covariance(golden.frame_samples(x, 2048, 0)).astype(
        np.complex64)
    a = np.broadcast_to(golden.ula_steering(70.0, 8, 0.5).astype(
        np.complex64), (R.shape[0], 8)).copy()
    w = _complex(beamform.mvdr_weights_cpx(*_planes(R), *_planes(a)))
    w_ref = beamform_jax.mvdr_weights_cpx(
        Cpx.from_complex(R), Cpx.from_complex(a)).to_numpy()
    np.testing.assert_allclose(w, w_ref, atol=1e-5 * np.abs(w_ref).max())
    gain = np.einsum("bn,bn->b", w.conj(), a)
    np.testing.assert_allclose(gain.real, 1.0, atol=1e-3)
    np.testing.assert_allclose(gain.imag, 0.0, atol=1e-3)


def test_extraction_matches_reference_and_recovers_the_source():
    """tests/test_beamform.py's two-tone scene: the beamformed stream
    toward 70° within 2e-5 of max|y| of the reference's; correlation with
    the 70° source > 0.99, with the 120° one < 0.05, output power ≈ 1."""
    N, S, B = 8, 2048, 8
    T = B * S
    rng = np.random.default_rng(1)
    t = np.arange(T)
    s1 = np.exp(1j * 2 * np.pi * 0.11 * t)
    s2 = np.exp(1j * 2 * np.pi * 0.29 * t)
    noise = (rng.standard_normal((T, N)) + 1j * rng.standard_normal((T, N))
             ) * np.sqrt(0.005)
    x = (np.outer(s1, golden.ula_steering(70.0, N, 0.5))
         + np.outer(s2, golden.ula_steering(120.0, N, 0.5))
         + noise).astype(np.complex64)
    R = golden.sample_covariance(golden.frame_samples(x, S, 0)).astype(
        np.complex64)
    theta = np.full(B, 70.0, np.float32)
    y = _complex(beamform.extract_source_ula(*_planes(x), *_planes(R), theta,
                                             0.5, S))
    y_ref = beamform_jax.extract_source_ula(
        Cpx.from_complex(x), Cpx.from_complex(R), theta, 0.5, S).to_numpy()
    assert y.shape == y_ref.shape == (B, S)
    assert np.abs(y - y_ref).max() <= 2e-5 * np.abs(y_ref).max()
    yf = y.reshape(-1)
    corr = lambda s: np.abs(np.vdot(s, yf)) / (  # noqa: E731
        np.linalg.norm(s) * np.linalg.norm(yf))
    assert corr(s1) > 0.99 and corr(s2) < 0.05
    np.testing.assert_allclose(np.mean(np.abs(yf) ** 2), 1.0, rtol=0.05)


def test_apply_beamformer_matches_reference_and_numpy():
    """y[t] = Σ conj(w_n)·x[t, n] within 1e-5 of numpy's and the
    reference's (tests/test_beamform.py's random inputs)."""
    rng = np.random.default_rng(2)
    xw = (rng.standard_normal((3, 16, 4))
          + 1j * rng.standard_normal((3, 16, 4))).astype(np.complex64)
    w = (rng.standard_normal((3, 4))
         + 1j * rng.standard_normal((3, 4))).astype(np.complex64)
    y = _complex(beamform.apply_beamformer_cpx(*_planes(xw), *_planes(w)))
    np.testing.assert_allclose(y, np.einsum("bsn,bn->bs", xw, w.conj()),
                               rtol=1e-4, atol=1e-5)
    y_ref = beamform_jax.apply_beamformer_cpx(
        Cpx.from_complex(xw), Cpx.from_complex(w)).to_numpy()
    np.testing.assert_allclose(y, y_ref, atol=1e-5)


@pytest.mark.parametrize("kw", [
    dict(theta_deg=[70.0], kind="deterministic"),
    dict(theta_deg=[60.0, 110.0]),
    dict(theta_deg=[85.0, 95.0], amplitudes=[1.0, 0.5]),
    dict(theta_deg=[60.0, 110.0],
         correlation=np.array([[1.0, 0.9], [0.9, 1.0]])),
])
def test_crb_ula_equal_to_reference(kw):
    """crb_ula_deg gives arrays equal to the reference's (a numpy copy),
    and so do the steering derivatives and the closed form."""
    args = dict(num_elements=8, norm_spacing=0.5, snr_db=5.0,
                n_snapshots=128)
    np.testing.assert_array_equal(crb.crb_ula_deg(**kw, **args),
                                  crb_jax.crb_ula_deg(**kw, **args))
    for a, b in zip(crb._ula_a_d(kw["theta_deg"], 8, 0.5),
                    crb_jax._ula_a_d(kw["theta_deg"], 8, 0.5)):
        np.testing.assert_array_equal(a, b)
    assert crb.crb_single_source_ula_closed_form(70.0, 8, 0.5, 10.0, 256) \
        == crb_jax.crb_single_source_ula_closed_form(70.0, 8, 0.5, 10.0, 256)


@pytest.mark.parametrize("kind", ["stochastic", "deterministic"])
def test_crb_ura_equal_to_reference(kind):
    """crb_ura_deg (K, 2) on a 4×4 URA equal to the reference's."""
    args = ([-20.0, 35.0], [30.0, 60.0], (4, 4), 0.5, 10.0, 256)
    got = crb.crb_ura_deg(*args, kind=kind)
    assert got.shape == (2, 2)
    np.testing.assert_array_equal(got, crb_jax.crb_ura_deg(*args, kind=kind))
