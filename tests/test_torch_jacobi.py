"""Port parity of the parallel Jacobi eigensolver: doa_tpu_torch's
ops/jacobi.py against doa_tpu's on the same numpy matrices (golden.py
scenes, embedded as the pipelines embed them), and the c3 planes path
with subspace_method="jacobi" against build_pipeline_tpu."""

import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import golden
from doa_tpu.configs import Estimator, PRESETS
from doa_tpu.cpx import Cpx, embed_hermitian
from doa_tpu.io import SourceSpec, synth_ula_iq
from doa_tpu.ops import jacobi as jacobi_jax
from doa_tpu.pipeline_tpu import build_pipeline_tpu
from doa_tpu_torch.ops import jacobi
from doa_tpu_torch.pipeline_torch import build_pipeline_torch


def _embedded(N=8, B=6, seed=1, smooth=0):
    """E(R) f32[B, 2N', 2N'] of a two-source scene, S = 256; smooth = L
    smooths R to L×L first (c3's 12 of 16: 2N' = 24)."""
    x = golden.synthetic_ula_iq([60.0, 110.0], N, 0.5, B * 256, snr_db=10,
                                seed=seed)
    R = golden.sample_covariance(golden.frame_samples(x, 256, 0))
    if smooth:
        R = golden.spatial_smooth(R, smooth)
    return np.array(embed_hermitian(Cpx.from_complex(R.astype(
        np.complex64))))


@pytest.mark.parametrize("n", [4, 8, 24])
def test_schedule_and_bases_equal_reference(n):
    """The copied numpy schedule and one-hot bases are the reference's."""
    s, ce, se = jacobi._schedule_bases(n)
    s_j, ce_j, se_j = jacobi_jax._schedule_bases(n)
    for a, b in ((s, s_j), (ce, ce_j), (se, se_j)):
        np.testing.assert_array_equal(a, b)
    pairs = {tuple(p) for r in s for p in r}
    assert len(pairs) == n * (n - 1) // 2


@pytest.mark.parametrize("smooth", [0, 12])
def test_eigh_jacobi_matches_reference(smooth):
    """Eigenvalues ascending, each within 1.5e-5 relative of the
    reference's and of float64 eigh's (ten FP32 sweeps: the reference's
    own sit up to 9.3e-6 from float64 here); the eigenvectors orthonormal
    and V diag(w) Vᵀ = E within 1e-5 of max|E| (a doubled spectrum leaves
    each pair's basis free, so the vectors themselves are not compared)."""
    E = _embedded(N=16 if smooth else 8, smooth=smooth)
    w, V = jacobi.eigh_jacobi(torch.from_numpy(E))
    w_j, _ = jacobi_jax.eigh_jacobi(jnp.asarray(E))
    scale = np.abs(E).max()
    np.testing.assert_allclose(w.numpy(), np.asarray(w_j), rtol=1.5e-5)
    w_ref = torch.linalg.eigh(torch.from_numpy(E).double())[0]
    np.testing.assert_allclose(w.numpy(), w_ref.numpy(), rtol=1.5e-5)
    assert bool((w[..., 1:] >= w[..., :-1]).all())
    V = V.double()
    eye = torch.eye(E.shape[-1], dtype=torch.float64)
    assert float((V.transpose(-1, -2) @ V - eye).abs().max()) < 1e-5
    rec = (V * w.double()[..., None, :]) @ V.transpose(-1, -2)
    assert float((rec - torch.from_numpy(E).double()).abs().max()) \
        < 1e-5 * scale


@pytest.mark.parametrize("smallest", [True, False])
@pytest.mark.parametrize("smooth", [0, 12])
def test_subspace_projector_matches_reference(smooth, smallest):
    """The projector onto the noise (or signal) eigenvectors within 1e-5
    of the reference's (its entries are at most 1)."""
    E = _embedded(N=16 if smooth else 8, smooth=smooth)
    n = E.shape[-1]
    dim = n - 4 if smallest else 4
    P = jacobi.subspace_projector_jacobi(torch.from_numpy(E), dim,
                                         smallest=smallest)
    P_j = jacobi_jax.subspace_projector_jacobi(jnp.asarray(E), dim,
                                               smallest=smallest)
    np.testing.assert_allclose(P.numpy(), np.asarray(P_j), rtol=0,
                               atol=1e-5)
    tr = torch.diagonal(P, dim1=-2, dim2=-1).sum(-1)
    np.testing.assert_allclose(tr.numpy(), dim, atol=1e-4)


_C3_SOURCES = [SourceSpec(theta_deg=40.0, freq_norm=0.12),
               SourceSpec(theta_deg=70.0, freq_norm=0.12),   # coherent pair
               SourceSpec(theta_deg=100.0, freq_norm=0.3)]


@pytest.mark.parametrize("return_spectra", [True, False])
def test_c3_jacobi_pipeline_matches_reference(return_spectra):
    """c3 with subspace_method="jacobi" (validate_tpu.py's scene, 8
    windows, a correction): kernel 8's plain version, correction, FB,
    smoothing to L = 12, Jacobi's noise projector on the 24-wide
    embedding shared by MUSIC and min-norm, root-MUSIC on eigh's, as the
    reference. Peak angles within 1e-3°, root-MUSIC's sorted angles
    within 1e-3°, escalation counts equal (zero: no power subspace)."""
    cfg = dataclasses.replace(
        PRESETS["c3_ula16_calib_smooth"], subspace_method="jacobi",
        estimators=(Estimator.MUSIC, Estimator.MIN_NORM,
                    Estimator.ROOT_MUSIC))
    x = synth_ula_iq(_C3_SOURCES, 16, 0.5, 8 * 1024, snr_db=10,
                     seed=3).astype(np.complex64)
    rng = np.random.default_rng(1)
    c = ((1.0 + 0.1 * rng.standard_normal(16))
         * np.exp(1j * rng.uniform(-0.3, 0.3, 16))).astype(np.complex64)
    ref = build_pipeline_tpu(dataclasses.replace(cfg, cov_impl="pallas"),
                             return_spectra=return_spectra)(x, c)
    pipe = build_pipeline_torch(cfg, device="cpu",
                                return_spectra=return_spectra)
    assert dict(pipe.plan) == {"covariance": "plain"}
    out = pipe(x, c)
    for key in ("music", "min_norm"):
        a = out.peak_angles[key].numpy()
        assert a.shape == (8, 3)
        np.testing.assert_allclose(a, np.asarray(ref.peak_angles[key]),
                                   atol=1e-3)
        assert (key in out.spectra) == return_spectra
    np.testing.assert_allclose(out.root_music_angles.numpy(),
                               np.asarray(ref.root_music_angles), atol=1e-3)
    assert out.esprit_angles is None and out.unitary_esprit_angles is None
    assert int(out.escalation_flagged) == int(ref.escalation_flagged) == 0
