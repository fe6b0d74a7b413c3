"""Port parity of source counting: doa_tpu_torch's ops/model_order.py
(the eigenvalues of the 2N embedding, AIC and MDL) against
doa_tpu/ops/model_order.py on the same covariances (tests/
test_model_order.py's scenes): the same counts, window by window."""

import numpy as np
import pytest
import torch

import golden
from doa_tpu.cpx import Cpx
from doa_tpu.ops import model_order as model_order_jax
from doa_tpu_torch.ops import model_order


def _R(thetas, N=8, S=2048, snr=10, seed=0, B=8):
    x = golden.synthetic_ula_iq(list(thetas), N, 0.5, B * S, snr_db=snr,
                                seed=seed)
    R = golden.sample_covariance(golden.frame_samples(x, S, 0)).astype(
        np.complex64)
    return R, S


def _planes(R):
    return (torch.from_numpy(np.ascontiguousarray(R.real)),
            torch.from_numpy(np.ascontiguousarray(R.imag)))


def test_eigenvalues_match_reference():
    """Ascending eigenvalues within 1e-5 of the largest of the
    reference's, and within tests/test_model_order.py's bound of numpy's
    complex eigvalsh."""
    R, _ = _R([60.0, 110.0])
    w = model_order.eigenvalues(*_planes(R)).numpy()
    w_j = np.asarray(model_order_jax.eigenvalues_cpx(Cpx.from_complex(R)))
    assert w.shape == (8, 8)
    np.testing.assert_allclose(w, w_j, rtol=0, atol=1e-5 * np.abs(w_j).max())
    np.testing.assert_allclose(w, np.linalg.eigvalsh(R), rtol=2e-3,
                               atol=1e-3)


@pytest.mark.parametrize("criterion", ["mdl", "aic"])
@pytest.mark.parametrize("truth,snr,max_k", [
    (1, 10, None), (2, 10, None), (3, 10, None), (2, 5, None), (2, 10, 4),
    (3, 10, 2), (0, 10, None)])
def test_counts_equal_reference(criterion, truth, snr, max_k):
    """estimate_num_sources gives the reference's count in every window,
    for MDL and AIC, with the default max_k (N − 1) and a given one; on
    these scenes MDL finds the planted count where max_k allows it, and
    AIC never counts fewer than MDL."""
    thetas = [50.0, 90.0, 130.0][:truth]
    R, S = _R(thetas, snr=snr, seed=truth + snr)
    if truth == 0:                 # noise alone: unit white covariances
        R, S = _R([], snr=snr, seed=11)
    k = model_order.estimate_num_sources(*_planes(R), S, criterion, max_k)
    k_j = np.asarray(model_order_jax.estimate_num_sources(
        Cpx.from_complex(R), S, criterion, max_k))
    assert k.dtype == torch.int32 and k.shape == (8,)
    np.testing.assert_array_equal(k.numpy(), k_j)
    if criterion == "mdl":
        want = truth if max_k is None else min(truth, max_k)
        assert (k.numpy() == want).mean() >= 0.9, k
    else:
        k_mdl = model_order.estimate_num_sources(*_planes(R), S, "mdl",
                                                 max_k)
        assert bool((k >= k_mdl).all())


def test_unknown_criterion_raises():
    R, S = _R([60.0])
    with pytest.raises(ValueError):
        model_order.estimate_num_sources(*_planes(R), S, "bic")
