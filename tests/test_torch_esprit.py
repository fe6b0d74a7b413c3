"""Port parity of ESPRIT: doa_tpu_torch's ops/esprit.py (the complex
signal subspace, the Newton–Schulz inverse, the characteristic
polynomial, LS-ESPRIT, 2-D ESPRIT and Unitary ESPRIT) against doa_tpu's
on the same numpy covariances; and the coherent wideband route (cssm and
cssm_auto on a small URA, cssm on a ULA) with the grid-free estimators
against build_pipeline_tpu."""

import dataclasses

import numpy as np
import pytest
import torch

import golden
from doa_tpu.configs import (ArrayGeometry, DoaConfig, Estimator,
                             GridSpec1D, GridSpec2D, WidebandSpec)
from doa_tpu.cpx import Cpx
from doa_tpu.io.synthetic import (SourceSpec, synth_wideband_ula_iq,
                                  synth_wideband_ura_iq)
from doa_tpu.ops import esprit as esprit_jax
from doa_tpu.pipeline_tpu import build_pipeline_tpu
from doa_tpu_torch.ops import esprit
from doa_tpu_torch.pipeline_torch import build_pipeline_torch


def _ula_R(thetas=(60.0, 110.0), N=8, B=12, snr_db=15, seed=7):
    x = golden.synthetic_ula_iq(list(thetas), N, 0.5, B * 512,
                                snr_db=snr_db, seed=seed)
    return golden.sample_covariance(
        golden.frame_samples(x, 512, 0)).astype(np.complex64)


def _ura_R(sources=((30.0, 50.0), (120.0, 30.0)), shape=(4, 4), B=8,
           S=256, seed=2):
    """(B, N, N) covariances of uncorrelated unit sources at (az, el)
    degrees on a URA, noise at −10 dB."""
    rng = np.random.default_rng(seed)
    A = np.stack([golden.ura_steering(az, el, shape, 0.5)
                  for az, el in sources], -1)                   # (N, K)
    K, N = len(sources), A.shape[0]
    s = (rng.standard_normal((B * S, K))
         + 1j * rng.standard_normal((B * S, K))) / np.sqrt(2)
    n = (rng.standard_normal((B * S, N))
         + 1j * rng.standard_normal((B * S, N))) * np.sqrt(0.05)
    return golden.sample_covariance(golden.frame_samples(
        s @ A.T + n, S, 0)).astype(np.complex64)


def _planes(R):
    return (torch.from_numpy(np.ascontiguousarray(R.real)),
            torch.from_numpy(np.ascontiguousarray(R.imag)))


def _c64(R):
    return torch.from_numpy(np.ascontiguousarray(R))


def test_signal_subspace_and_pieces_match_reference():
    """The complex signal basis (its projector within 1e-5), the
    Newton–Schulz inverse of its Gram and the Faddeev–LeVerrier
    coefficients of a 3×3 Ψ (within 1e-5 of their largest entry)."""
    R = _ula_R((40.0, 75.0, 120.0), N=16)
    Es = esprit.signal_subspace_cpx(_c64(R), 3).numpy()
    Es_j = esprit_jax.signal_subspace_cpx(Cpx.from_complex(R), 3).to_numpy()
    proj = lambda E: np.einsum("bnk,bmk->bnm", E, E.conj())  # noqa: E731
    np.testing.assert_allclose(proj(Es), proj(Es_j), atol=1e-5)
    E1 = np.ascontiguousarray(Es_j[:, :-1])
    G = np.einsum("bnk,bnl->bkl", E1.conj(), E1)
    Gi = esprit._ns_inverse(_c64(G)).numpy()
    Gi_j = esprit_jax._ns_inverse(Cpx.from_complex(G)).to_numpy()
    np.testing.assert_allclose(Gi, Gi_j, atol=1e-5 * np.abs(Gi_j).max())
    np.testing.assert_allclose(np.einsum("bkl,blm->bkm", Gi, G),
                               np.broadcast_to(np.eye(3), G.shape),
                               atol=1e-4)
    Psi = np.einsum("bkl,bnl,bnm->bkm", Gi_j, E1.conj(), Es_j[:, 1:])
    c = esprit._char_poly_coeffs(_c64(Psi.astype(np.complex64))).numpy()
    c_j = esprit_jax._char_poly_coeffs(Cpx.from_complex(Psi)).to_numpy()
    np.testing.assert_allclose(c, c_j, atol=1e-5 * np.abs(c_j).max())
    np.testing.assert_allclose(c[:, -1], 1.0)


@pytest.mark.parametrize("N,thetas", [(8, (60.0, 110.0)),
                                      (9, (60.0, 110.0)),
                                      (16, (40.0, 75.0, 120.0))])
def test_esprit_and_unitary_esprit_match_reference(N, thetas):
    """LS-ESPRIT and Unitary ESPRIT (an even and an odd N): sorted angles
    within 1e-3° of the reference's and within 0.5° of the scene."""
    R = _ula_R(thetas, N=N)
    K = len(thetas)
    for port, ref in ((esprit.esprit_cpx, esprit_jax.esprit_cpx),
                      (esprit.unitary_esprit_cpx,
                       esprit_jax.unitary_esprit_cpx)):
        th = port(*_planes(R), K, 0.5).numpy()
        th_j = np.asarray(ref(Cpx.from_complex(R), K, 0.5))
        assert th.shape == (12, K)
        np.testing.assert_allclose(th, th_j, atol=1e-3)
        assert np.abs(th - np.array(thetas)).max() < 0.5


def test_esprit_2d_matches_reference():
    """2-D ESPRIT on a 4×4 URA: the (az, el) pairs, sorted by azimuth,
    within 1e-3° of the reference's and within 0.5° of the scene."""
    R = _ura_R()
    az, el = esprit.esprit_2d_cpx(*_planes(R), 2, 0.5, (4, 4))
    az_j, el_j = esprit_jax.esprit_2d_cpx(Cpx.from_complex(R), 2, 0.5,
                                          (4, 4))
    np.testing.assert_allclose(az.numpy(), np.asarray(az_j), atol=1e-3)
    np.testing.assert_allclose(el.numpy(), np.asarray(el_j), atol=1e-3)
    np.testing.assert_allclose(az.numpy(), np.broadcast_to([30.0, 120.0],
                                                           (8, 2)), atol=0.5)
    np.testing.assert_allclose(el.numpy(), np.broadcast_to([50.0, 30.0],
                                                           (8, 2)), atol=0.5)


def _pair_sorted(a):
    a = np.asarray(a)
    return np.take_along_axis(a, np.argsort(a[..., 0], -1)[..., None], 1)


@pytest.mark.parametrize("fusion", ["cssm", "cssm_auto"])
def test_ura_coherent_esprit_matches_reference(fusion):
    """tests/test_wideband_fast.py's 4×4 URA scene (F = 16, a 61×31 az/el
    grid, 5 windows) under cssm and cssm_auto with MUSIC and ESPRIT: the
    front end, R_coh, cold K4 + K3, the 2-D peaks, and 2-D ESPRIT on
    R_coh → esprit_angles (B, K, 2). MUSIC's peaks and ESPRIT's pairs,
    each pair-sorted, within 5e-3° (the wideband bound of
    tests/test_torch_cssm.py)."""
    cfg = DoaConfig(
        geometry=ArrayGeometry(kind="ura", num_elements=16, shape=(4, 4),
                               norm_spacing=0.5),
        snapshot_size=16 * 128, num_sources=2, num_max_vals=2,
        estimators=(Estimator.MUSIC, Estimator.ESPRIT),
        grid2d=GridSpec2D(num_az=61, num_el=31),
        wideband=WidebandSpec(num_subbands=16, fractional_bw=0.1,
                              fusion=fusion))
    x = synth_wideband_ura_iq(
        [SourceSpec(az_deg=-20.0, el_deg=30.0, freq_norm=0.0,
                    bandwidth_norm=0.5),
         SourceSpec(az_deg=35.0, el_deg=60.0, freq_norm=0.0,
                    bandwidth_norm=0.5)],
        (4, 4), 0.5, 16 * 128 * 5, fractional_bw=0.1, snr_db=15,
        seed=3).astype(np.complex64)
    ref = build_pipeline_tpu(dataclasses.replace(cfg, cov_impl="pallas"))(x)
    out = build_pipeline_torch(cfg, device="cpu")(x)
    for a, a_ref in ((out.peak_angles["music"], ref.peak_angles["music"]),
                     (out.esprit_angles, ref.esprit_angles)):
        assert a.shape == (5, 2, 2)
        np.testing.assert_allclose(_pair_sorted(a.numpy()),
                                   _pair_sorted(a_ref), atol=5e-3)
    med = np.median(_pair_sorted(out.esprit_angles.numpy()), axis=0)
    np.testing.assert_allclose(med, [[-20.0, 30.0], [35.0, 60.0]], atol=1.0)
    assert out.root_music_angles is None
    assert out.unitary_esprit_angles is None


def test_ula_coherent_grid_free_estimators_match_reference():
    """ULA-8, F = 8 cssm (tests/test_torch_cssm.py's scene, 47 windows)
    with root-MUSIC, ESPRIT, Unitary ESPRIT and min-norm on R_coh:
    sorted angles within 5e-3° of the reference's."""
    E = Estimator
    cfg = DoaConfig(
        geometry=ArrayGeometry(kind="ula", num_elements=8, norm_spacing=0.5),
        snapshot_size=256, num_sources=2, num_max_vals=2,
        estimators=(E.MUSIC, E.ROOT_MUSIC, E.ESPRIT, E.UNITARY_ESPRIT,
                    E.MIN_NORM),
        grid=GridSpec1D(num_points=256),
        wideband=WidebandSpec(num_subbands=8, fractional_bw=0.1,
                              fusion="cssm"))
    x = synth_wideband_ula_iq(
        [SourceSpec(theta_deg=t, freq_norm=0.0, bandwidth_norm=0.5)
         for t in (62.0, 111.0)], 8, 0.5, 47 * 256, fractional_bw=0.1,
        snr_db=15, seed=3).astype(np.complex64)
    ref = build_pipeline_tpu(dataclasses.replace(cfg, cov_impl="pallas"))(x)
    out = build_pipeline_torch(cfg, device="cpu")(x)
    for key in ("root_music_angles", "esprit_angles",
                "unitary_esprit_angles"):
        a, a_ref = getattr(out, key).numpy(), np.asarray(getattr(ref, key))
        assert a.shape == a_ref.shape == (47, 2)
        np.testing.assert_allclose(a, a_ref, atol=5e-3)
    for key in ("music", "min_norm"):
        np.testing.assert_allclose(
            np.sort(out.peak_angles[key].numpy(), -1),
            np.sort(np.asarray(ref.peak_angles[key]), -1), atol=5e-3)
