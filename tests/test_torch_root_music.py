"""Port parity of root-MUSIC: doa_tpu_torch's ops/root_music.py (the
Aberth–Ehrlich root finder, the root selection, root_music_cpx) and
cpx_ops.noise_projector_from_signal against doa_tpu's on the same numpy
inputs; and the fused path with all five estimators (MUSIC, root-MUSIC,
ESPRIT, Unitary ESPRIT, min-norm) against build_pipeline_tpu."""

import dataclasses
import importlib

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import golden
from doa_tpu.configs import ArrayGeometry, DoaConfig, Estimator, GridSpec1D
from doa_tpu.cpx import Cpx
from doa_tpu.io import SourceSpec, synth_ula_iq
from doa_tpu.ops import cpx_ops as cj
from doa_tpu.ops.root_music import polynomial_roots_cpx as roots_jax
from doa_tpu.ops.root_music import root_music_cpx as root_music_jax
from doa_tpu.pipeline_tpu import build_pipeline_tpu
from doa_tpu_torch.ops import cpx_ops
from doa_tpu_torch.pipeline_torch import build_pipeline_torch

# the module: doa_tpu_torch.ops exports the function root_music under its
# name, as doa_tpu.ops does
root_music = importlib.import_module("doa_tpu_torch.ops.root_music")

N, K = 8, 2


def _covariances(thetas=(60.0, 110.0), B=16, seed=1, snr_db=10):
    x = golden.synthetic_ula_iq(list(thetas), N, 0.5, B * 256,
                                snr_db=snr_db, seed=seed)
    return golden.sample_covariance(
        golden.frame_samples(x, 256, 0)).astype(np.complex64)


def _planes(R):
    return (torch.from_numpy(np.ascontiguousarray(R.real)),
            torch.from_numpy(np.ascontiguousarray(R.imag)))


def test_polynomial_roots_match_reference_and_numpy():
    """The root-MUSIC polynomials of a scene (degree 2N − 2 = 14): each
    window's roots, sorted by angle, within 1e-4 of the reference's, and
    p(z) at every root below 1e-4 of Σ|c| (numpy's companion roots are
    the oracle of the set)."""
    R = _covariances(B=6)
    Mr, Mi = cpx_ops.noise_projector(*_planes(R), K)
    M = (Mr + 1j * Mi).numpy()
    c = np.stack([np.trace(M, offset=l, axis1=-2, axis2=-1)
                  for l in range(-(N - 1), N)], -1).astype(np.complex64)
    z = root_music.polynomial_roots_cpx(torch.from_numpy(c)).numpy()
    zj = roots_jax(Cpx.from_complex(c)).to_numpy()
    assert z.shape == zj.shape == (6, 2 * N - 2)
    by_angle = lambda r: np.take_along_axis(  # noqa: E731
        r, np.argsort(np.angle(r) + 1e-3 * np.abs(r), -1), -1)
    np.testing.assert_allclose(by_angle(z), by_angle(zj), atol=1e-4)
    for b in range(6):
        p = np.polyval(c[b, ::-1].astype(np.complex128), z[b])
        assert np.abs(p).max() < 1e-4 * np.abs(c[b]).sum()
        ref = np.sort_complex(np.roots(c[b, ::-1].astype(np.complex128)))
        got = np.sort_complex(z[b].astype(np.complex128))
        np.testing.assert_allclose(got, ref, atol=2e-3)


def test_root_selection_breaks_ties_as_top_k():
    """Roots of equal |z|, and fewer inside the circle than K: the
    selection takes the lower index first among equal scores, the
    reference's lax.top_k order."""
    mags = np.array([[0.9, 0.95, 0.95, 1.2, 0.95, 1.1],
                     [1.1, 1.3, 0.5, 1.2, 1.4, 1.5],
                     [1.1, 1.3, 1.2, 1.2, 1.4, 1.5]], np.float32)
    ang = np.linspace(0.1, 3.0, 6, dtype=np.float32)
    roots = (mags * np.exp(1j * ang)).astype(np.complex64)
    for k in (1, 2, 3):
        got = root_music.select_inside(torch.from_numpy(roots), k).numpy()
        mag = np.abs(roots)
        score = np.where(mag < 1.0, 1.0 - mag, np.inf).astype(np.float32)
        _, idx = jax.lax.top_k(-jnp.asarray(score), k)
        np.testing.assert_array_equal(
            got, np.take_along_axis(roots, np.asarray(idx), -1))


def test_noise_projector_from_signal_matches_reference():
    """M = I − E_s E_sᴴ from the embedded power subspace, within 1e-6."""
    R = _covariances()
    V = np.array(cj.signal_subspace_embedded(Cpx.from_complex(R), K,
                                             iters=16))
    Mr, Mi = cpx_ops.noise_projector_from_signal(torch.from_numpy(V))
    M = cj.noise_projector_from_signal(jnp.asarray(V))
    np.testing.assert_allclose(Mr.numpy(), np.asarray(M.re), atol=1e-6)
    np.testing.assert_allclose(Mi.numpy(), np.asarray(M.im), atol=1e-6)


@pytest.mark.parametrize("projector", ["eigh", "subspace"])
def test_root_music_matches_reference(projector):
    """Sorted angles within 1e-3° of the reference's, on eigh's noise
    projector or the power subspace's (the pipelines' two routes), and
    within 0.5° of the scene (60°, 110°; and 40°, 75°, 120° at K = 3)."""
    for thetas in ((60.0, 110.0), (40.0, 75.0, 120.0)):
        k = len(thetas)
        R = _covariances(thetas, snr_db=15)
        Rc = Cpx.from_complex(R)
        nproj = nproj_j = None
        if projector == "subspace":
            V = np.array(cj.signal_subspace_embedded(Rc, k, iters=16))
            nproj = cpx_ops.noise_projector_from_signal(torch.from_numpy(V))
            nproj_j = cj.noise_projector_from_signal(jnp.asarray(V))
        th = root_music.root_music_cpx(*_planes(R), k, 0.5,
                                       noise_proj=nproj).numpy()
        th_j = np.asarray(root_music_jax(Rc, k, 0.5, noise_proj=nproj_j))
        assert th.shape == (16, k)
        np.testing.assert_allclose(th, th_j, atol=1e-3)
        assert np.abs(th - np.array(thetas)).max() < 0.5


def test_root_music_takes_one_source_twice_in_both_packages():
    """ULA-16, 70°/110° at 10 dB, S = 1024 (the headline's scene; golden
    seed 2, 64 windows) on the power subspace's noise projector: in
    window 34 the reference's rule takes 110°'s root twice (both roots of
    its conjugate-reciprocal pair land inside the unit circle in FP32)
    and loses 70°. The port gives the same angles in every window, that
    one included, within 1e-3°."""
    x = golden.synthetic_ula_iq([70.0, 110.0], 16, 0.5, 64 * 1024,
                                snr_db=10, seed=2)
    R = golden.sample_covariance(golden.frame_samples(x, 1024, 0)).astype(
        np.complex64)
    Rc = Cpx.from_complex(R)
    V = np.array(cj.signal_subspace_embedded(Rc, K, iters=16))
    th_j = np.asarray(root_music_jax(
        Rc, K, 0.5, noise_proj=cj.noise_projector_from_signal(
            jnp.asarray(V))))
    th = root_music.root_music_cpx(
        *_planes(R), K, 0.5,
        noise_proj=cpx_ops.noise_projector_from_signal(
            torch.from_numpy(V))).numpy()
    np.testing.assert_allclose(th, th_j, atol=1e-3)
    lost = np.abs(th_j - [70.0, 110.0]).max(-1) > 0.5
    assert list(np.nonzero(lost)[0]) == [34]
    np.testing.assert_allclose(th_j[34], [110.0, 110.0], atol=0.05)


_ALL5 = (Estimator.MUSIC, Estimator.ROOT_MUSIC, Estimator.ESPRIT,
         Estimator.UNITARY_ESPRIT, Estimator.MIN_NORM)


@pytest.mark.parametrize("return_spectra", [True, False])
def test_five_estimators_fused_path_matches_reference(return_spectra):
    """ULA-8, S = 256, 64 windows on the fused path (K1, warm K4 and K3 or
    K2 as plain versions; R = unembed(E) made for the grid-free
    estimators; the power subspace feeding root-MUSIC's noise projector
    and min-norm's weight): MUSIC and min-norm peaks within 1e-3°, the
    three grid-free estimators' sorted angles within 1e-3°, equal
    escalation counts, the plan naming the fused route's kernels."""
    cfg = DoaConfig(
        geometry=ArrayGeometry(kind="ula", num_elements=N, norm_spacing=0.5),
        snapshot_size=256, num_sources=K, estimators=_ALL5,
        grid=GridSpec1D(num_points=256), num_max_vals=2)
    x = synth_ula_iq([SourceSpec(theta_deg=60.0, freq_norm=0.1),
                      SourceSpec(theta_deg=110.0, freq_norm=0.3)],
                     N, 0.5, 64 * 256, snr_db=10,
                     seed=1).astype(np.complex64)
    ref = build_pipeline_tpu(
        dataclasses.replace(cfg, cov_impl="pallas", scan_mode="pallas"),
        return_spectra=return_spectra)(x)
    pipe = build_pipeline_torch(cfg, device="cpu",
                                return_spectra=return_spectra)
    assert pipe.fast_path
    assert pipe.plan.kernels == {
        "covariance": "chunk_gram", "covariance_planes": "planes_chunk_gram",
        "subspace": "mgs_iterate",
        "scan": "music_scan" if return_spectra else "music_scan_peaks"}
    out = pipe(x)
    for key in ("music", "min_norm"):
        np.testing.assert_allclose(out.peak_angles[key].numpy(),
                                   np.asarray(ref.peak_angles[key]),
                                   atol=1e-3)
    assert sorted(out.spectra) == sorted(ref.spectra) == (
        ["min_norm", "music"] if return_spectra else [])
    for key in ("root_music_angles", "esprit_angles",
                "unitary_esprit_angles"):
        a, a_ref = getattr(out, key).numpy(), np.asarray(getattr(ref, key))
        assert a.shape == a_ref.shape == (64, K)
        np.testing.assert_allclose(a, a_ref, atol=1e-3)
        assert np.abs(a - [60.0, 110.0]).max() < 1.0
    assert int(out.escalation_flagged) == int(ref.escalation_flagged)
    assert int(out.escalation_overflow) == int(ref.escalation_overflow)
