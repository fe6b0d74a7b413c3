"""Port parity: doa_tpu_torch's MUSIC scan (plain paths of kernels K3 and
K2) and find_local_max against doa_tpu's Pallas kernels in interpret mode
and doa_tpu.ops.peaks, on the same numpy inputs."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import golden
from doa_tpu.cpx import Cpx, embed_vector
from doa_tpu.ops import cpx_ops as ops_jax
from doa_tpu.ops.pallas.music_scan import (music_scan_pallas,
                                           music_scan_peaks_pallas)
from doa_tpu.ops.peaks import find_local_max as find_local_max_jax
from doa_tpu_torch.ops.cuda import music_scan as ms
from doa_tpu_torch.ops.peaks import find_local_max


def _setup(B=37, N=8, G=250, K=2, S=256, seed=3):
    """Scene subspaces V (JAX layout f32[B, 2N, 2K]) and the embedded
    grid Ã f32[G, 2N]. B = 37 is not a multiple of the reference's window
    block (128/2K); G = 250 is not a multiple of 128."""
    x = golden.synthetic_ula_iq([60.0, 110.0, 85.0][:max(K, 2)], N, 0.5,
                                B * S, snr_db=10, seed=seed)
    R = golden.sample_covariance(golden.frame_samples(x, S, 0))
    A = golden.ula_steering(np.linspace(0, 180, G), N, 0.5).astype(
        np.complex64)
    V = np.array(ops_jax.signal_subspace_embedded(Cpx.from_complex(R), K,
                                                  iters=16))
    At = np.array(embed_vector(Cpx.from_complex(A)))
    return V, At


def _vt(V):
    return torch.from_numpy(np.ascontiguousarray(np.swapaxes(V, 1, 2)))


def test_music_scan_matches_pallas():
    """P = 1/den: compared on den (the reciprocal amplifies f32 noise at
    the nulls without bound), rtol 1e-5 plus atol 1e-5·max‖a‖² for the
    cancellation in ‖a‖² − ‖Vᵀã‖²."""
    V, At = _setup()
    P_ref = np.asarray(music_scan_pallas(jnp.asarray(V), jnp.asarray(At),
                                         interpret=True))
    P = ms.music_scan(_vt(V), torch.from_numpy(At)).numpy()
    assert P.shape == P_ref.shape == (37, 250)
    nrm = (At * At).sum(-1).max()
    np.testing.assert_allclose(1.0 / P, 1.0 / P_ref, rtol=1e-5,
                               atol=1e-5 * nrm)


@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_music_scan_peaks_matches_pallas(k):
    """Fused scan + peaks: identical bin indices (refine off: locs are
    exactly x_min + idx·dx) and refined angles within 1e-4°."""
    V, At = _setup(K=2 if k < 3 else 3)
    Vj, Aj = jnp.asarray(V), jnp.asarray(At)
    Vt, At_t = _vt(V), torch.from_numpy(At)
    v0_ref, l0_ref = music_scan_peaks_pallas(Vj, Aj, k, 0.0, 180.0,
                                             refine=False, interpret=True)
    v0, l0 = ms.music_scan_peaks(Vt, At_t, k, 0.0, 180.0, refine=False)
    assert l0.shape == (37, k)
    np.testing.assert_array_equal(l0.numpy(), np.asarray(l0_ref))
    # values are dmin/den: dmin sits at a MUSIC null, where
    # ‖a‖² − ‖Vᵀã‖² cancels, so its f32 relative error is
    # ~1e-6·‖a‖²/dmin (measured up to 4e-4 here; the reference's own
    # fused-vs-unfused check uses 5e-2)
    np.testing.assert_allclose(v0.numpy(), np.asarray(v0_ref), rtol=1e-2)
    v1_ref, l1_ref = music_scan_peaks_pallas(Vj, Aj, k, 0.0, 180.0,
                                             refine=True, interpret=True)
    v1, l1 = ms.music_scan_peaks(Vt, At_t, k, 0.0, 180.0, refine=True)
    np.testing.assert_allclose(l1.numpy(), np.asarray(l1_ref), atol=1e-4)


def test_fused_peaks_equal_unfused_rule():
    """K2's plain version equals K3 → normalise → find_local_max on the
    same den (the fused kernel's contract), including the fallback row
    of a flat spectrum."""
    V, At = _setup(B=9)
    Vt, At_t = _vt(V), torch.from_numpy(At)
    Vt[0] = 0.0                          # den = ‖a‖² is flat: no peak
    for refine in (False, True):
        v, l = ms.music_scan_peaks(Vt, At_t, 2, 0.0, 180.0, refine=refine)
        P = ms.music_scan(Vt, At_t)
        P = P / P.max(dim=-1, keepdim=True).values
        v_ref, l_ref = find_local_max(P, 2, 0.0, 180.0, refine=refine)
        np.testing.assert_allclose(l.numpy(), l_ref.numpy(), atol=1e-4)
        np.testing.assert_allclose(v.numpy(), v_ref.numpy(), rtol=1e-5)
    assert float(v[0, 0]) == 1.0


def _spectra_with_ties(B=24, G=64, seed=7):
    """Positive integer-valued spectra: plateaus, equal peaks, monotone
    rows (no interior maximum) and a constant row."""
    rng = np.random.default_rng(seed)
    P = rng.integers(1, 6, size=(B, G)).astype(np.float32)
    P[1, 10:14] = 9.0                     # plateau
    P[2, :] = np.arange(1, G + 1)         # monotone: fallback to argmax
    P[3, :] = 4.0                         # constant
    P[4, [5, 20, 40]] = 9.0               # three equal peaks
    return P


@pytest.mark.parametrize("k", [1, 2, 4, 6])
@pytest.mark.parametrize("refine", [False, True])
def test_find_local_max_matches_reference(k, refine):
    P = _spectra_with_ties()
    v_ref, l_ref = find_local_max_jax(jnp.asarray(P), k, 0.0, 180.0,
                                      refine=refine)
    v, l = find_local_max(torch.from_numpy(P), k, 0.0, 180.0, refine=refine)
    np.testing.assert_array_equal(v.numpy(), np.asarray(v_ref))
    np.testing.assert_allclose(l.numpy(), np.asarray(l_ref), atol=1e-5)


def test_fused_peaks_size_rule_and_devices():
    V, At = _setup(B=4)
    with pytest.raises(ValueError, match="k"):
        ms.music_scan_peaks(_vt(V), torch.from_numpy(At), 5, 0.0, 180.0)
    with pytest.raises(ValueError, match="device"):
        ms.music_scan(torch.empty((2, 4, 16), device="meta"),
                      torch.empty((250, 16), device="meta"),
                      torch.empty((250,), device="meta"))
