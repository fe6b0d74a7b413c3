"""Port parity of the planes path's estimators: doa_tpu_torch's Capon,
Bartlett, eigh noise projector, dense MUSIC denominators and cold subspace
iteration against doa_tpu's cpx_ops, on the same numpy covariances."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import golden
from doa_tpu.configs import ArrayGeometry, GridSpec1D
from doa_tpu.cpx import Cpx
from doa_tpu.ops import cpx_ops as cj
from doa_tpu_torch.ops import cpx_ops
from doa_tpu_torch.ops.steering import ula_grid

N, K, G = 8, 2, 181


def _covariances(B=6, seed=1, snr_db=10):
    """(B, N, N) c64 windows of a two-source scene, S = 256."""
    x = golden.synthetic_ula_iq([60.0, 110.0], N, 0.5, B * 256,
                                snr_db=snr_db, seed=seed)
    return golden.sample_covariance(
        golden.frame_samples(x, 256, 0)).astype(np.complex64)


def _planes(R):
    return (torch.from_numpy(np.ascontiguousarray(R.real)),
            torch.from_numpy(np.ascontiguousarray(R.imag)))


def _grid():
    A = ula_grid(ArrayGeometry(kind="ula", num_elements=N, norm_spacing=0.5),
                 GridSpec1D(num_points=G))
    At = torch.from_numpy(np.concatenate([A.real, A.imag], -1))
    return A, At


def _spectra_close(P, P_ref, rtol):
    np.testing.assert_allclose(P.numpy(), np.asarray(P_ref), rtol=rtol,
                               atol=rtol * np.abs(np.asarray(P_ref)).max())


@pytest.mark.parametrize("method", ["cholesky", "newton"])
def test_capon_matches_reference(method):
    """Normalised Capon spectra within 1e-4 relative (Cholesky and
    triangular solves, or 24 Newton–Schulz rounds, in another order)."""
    R = _covariances()
    A, At = _grid()
    P = cpx_ops.capon_spectrum(*_planes(R), At, diag_load=1e-4,
                               method=method)
    P_ref = cj.capon_spectrum_cpx(Cpx.from_complex(R), Cpx.from_complex(A),
                                  diag_load=1e-4, method=method)
    assert P.shape == (6, G)
    _spectra_close(P, P_ref, 1e-4)


def test_bartlett_matches_reference():
    """Normalised Bartlett spectra within 1e-5 relative."""
    R = _covariances()
    A, At = _grid()
    P = cpx_ops.bartlett_spectrum(*_planes(R), At)
    P_ref = cj.bartlett_spectrum_cpx(Cpx.from_complex(R), Cpx.from_complex(A))
    _spectra_close(P, P_ref, 1e-5)


def test_noise_projector_matches_reference():
    """M = E_n E_nᴴ from the 2N-embedding eigh: a projector (M² = M within
    1e-5), equal to the reference's within 1e-5 (eigh's eigenvectors differ
    by rotations within the noise subspace; the projector does not)."""
    R = _covariances()
    Mr, Mi = cpx_ops.noise_projector(*_planes(R), K)
    M_ref = cj.noise_projector_cpx(Cpx.from_complex(R), K)
    np.testing.assert_allclose(Mr.numpy(), np.asarray(M_ref.re), atol=1e-5)
    np.testing.assert_allclose(Mi.numpy(), np.asarray(M_ref.im), atol=1e-5)
    M = torch.complex(Mr, Mi)
    torch.testing.assert_close(M @ M, M, rtol=0, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_music_denominators_match_reference(dtype):
    """The dense denominators of both branches in each compute_dtype:
    subspace form within 1e-5 (f32) / 2e-3 (bf16: the same bf16-rounded
    inputs, sums in another order) / 1e-5 (int8: exact integer sums, one
    scale); projector form within 1e-5 / 2e-3 / 1e-5 of ‖a‖² = N."""
    R = _covariances()
    A, At = _grid()
    Rj = Cpx.from_complex(R)
    V_emb = cj.signal_subspace_embedded(Rj, K, iters=8)
    den = cpx_ops.music_denominator_subspace(
        torch.from_numpy(np.array(V_emb)), At, dtype)
    den_ref = cj.music_denominator_subspace(V_emb, Cpx.from_complex(A),
                                            compute_dtype=jnp.dtype(dtype))
    tol = {"float32": 1e-5, "bfloat16": 2e-3, "int8": 1e-5}[dtype]
    np.testing.assert_allclose(den.numpy(), np.asarray(den_ref), rtol=0,
                               atol=tol * N)
    M_ref = cj.noise_projector_cpx(Rj, K)
    Mr, Mi = (torch.from_numpy(np.array(p)) for p in M_ref)
    den2 = cpx_ops.music_denominator_cpx(
        Mr, Mi, torch.from_numpy(np.ascontiguousarray(A.real)),
        torch.from_numpy(np.ascontiguousarray(A.imag)), dtype)
    den2_ref = cj.music_denominator_cpx(M_ref, Cpx.from_complex(A),
                                        compute_dtype=jnp.dtype(dtype))
    np.testing.assert_allclose(den2.numpy(), np.asarray(den2_ref), rtol=0,
                               atol=tol * N)


@pytest.mark.parametrize("snr_db,imbalance", [(10, False), (-6, True)])
def test_cold_subspace_matches_reference(snr_db, imbalance):
    """Cold signal_subspace_embedded (8 rounds, escalation armed) on the
    smoothed-size embedding: projectors V Vᵀ within 1e-4 and equal
    escalation counts — at 10 dB (none flagged) and on windows whose
    weak direction sits near the noise (some flagged)."""
    rng = np.random.default_rng(3)
    B, n, S = 12, 12, 64
    a = np.exp(-1j * np.pi * np.cos(np.deg2rad([[50.0], [75.0], [120.0]]))
               * np.arange(n))                                  # (3, n)
    amp = np.array([1.0, 1.0, 0.05 if imbalance else 1.0])
    s = (rng.standard_normal((B, S, 3)) + 1j * rng.standard_normal(
        (B, S, 3))) * amp / np.sqrt(2)
    noise = 10 ** (-snr_db / 20) * (rng.standard_normal((B, S, n))
                                    + 1j * rng.standard_normal((B, S, n)))
    X = s @ a + noise / np.sqrt(2)
    R = (np.einsum("bti,btj->bij", X, X.conj()) / S).astype(np.complex64)
    kw = dict(iters=8, escalate_extra=40, escalate_gap=3.0,
              escalate_tol=0.05, escalate_signal_floor=2.5,
              escalate_capacity=1024, return_stats=True)
    V, (fl, ov) = cpx_ops.signal_subspace_embedded(*_planes(R), 3, **kw)
    V_ref, (fl_ref, ov_ref) = cj.signal_subspace_embedded(
        Cpx.from_complex(R), 3, **kw)
    V_ref = np.asarray(V_ref)
    assert V.shape == V_ref.shape == (B, 2 * n, 6)
    P = (V @ V.transpose(-1, -2)).numpy()
    P_ref = V_ref @ np.swapaxes(V_ref, -1, -2)
    np.testing.assert_allclose(P, P_ref, atol=1e-4)
    assert (int(fl), int(ov)) == (int(fl_ref), int(ov_ref))
    if imbalance:
        assert int(fl) > 0
