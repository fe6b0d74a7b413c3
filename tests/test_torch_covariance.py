"""Port parity: doa_tpu_torch's planes-path covariance (the plain versions
of kernels 8 and 12) against doa_tpu's Pallas kernels in interpret mode,
and the covariance chain of the planes path (correction, FB, smoothing)
against compute_covariances_cpx, on the same numpy capture."""

import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import golden
from doa_tpu.configs import AvgMethod, PRESETS, SmoothingSpec
from doa_tpu.cpx import Cpx
from doa_tpu.ops.pallas.covariance import chunk_grams_pallas, cov_windows_pallas
from doa_tpu.pipeline_tpu import compute_covariances_cpx
from doa_tpu_torch.ops import cpx_ops
from doa_tpu_torch.ops.cuda import covariance as cov
from doa_tpu_torch.pipeline_torch import compute_covariances


def _capture(N, T, seed=3):
    return golden.synthetic_ula_iq([60.0, 110.0], N, 0.5, T, snr_db=10,
                                   seed=seed).astype(np.complex64)


def _planes(x, layout):
    """(xr, xi) torch planes of the c64 capture: separate contiguous
    arrays, or the element-stride-2 views of its interleaved bytes."""
    if layout == "planar":
        return (torch.from_numpy(np.ascontiguousarray(x.real)),
                torch.from_numpy(np.ascontiguousarray(x.imag)))
    v = torch.from_numpy(x.view(np.float32)).view(x.shape[0], x.shape[1], 2)
    return v[..., 0], v[..., 1]


def _correction(N, seed=0):
    rng = np.random.default_rng(seed)
    return ((1.0 + 0.1 * rng.standard_normal(N))
            * np.exp(1j * rng.uniform(-0.3, 0.3, N))).astype(np.complex64)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout", ["planar", "stride2"])
def test_chunk_grams_match_pallas(dtype, layout):
    """Unnormalised chunk planes over an odd chunk count (7 chunks of 128)
    plus a ragged tail: within 1e-5·max|R| (both sum true products of the
    same, possibly bf16-rounded, inputs in f32; only the order differs)."""
    N, g = 8, 128
    x = _capture(N, 7 * g + 40)
    xr, xi = _planes(x, layout)
    if layout == "stride2":
        assert xr.stride() == (2 * N, 2)
    ref = chunk_grams_pallas(Cpx.from_complex(x), g,
                             compute_dtype=jnp.dtype(dtype), interpret=True)
    rr, ri = cov.chunk_grams(xr, xi, g, dtype)
    assert rr.shape == ri.shape == (7, N, N)
    scale = np.abs(np.asarray(ref.re)).max()
    np.testing.assert_allclose(rr.numpy(), np.asarray(ref.re), rtol=0,
                               atol=1e-5 * scale)
    np.testing.assert_allclose(ri.numpy(), np.asarray(ref.im), rtol=0,
                               atol=1e-5 * scale)


def test_chunk_grams_int8_raises():
    x = _capture(4, 256)
    xr, xi = _planes(x, "planar")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        cov.chunk_grams(xr, xi, 64, "int8")


@pytest.mark.parametrize("S,overlap", [(256, 128), (256, 192), (256, 200),
                                       (128, 100)])
def test_cov_windows_match_pallas(S, overlap):
    """cov_windows at gcd(S, hop) ≥ 64 (chunk Grams + prefix sums) and
    below (one Gram per window: hop 56 and 28, gcd 8 and 4): within
    rtol 1e-5, atol 1e-6·max|R| (prefix sums cancel over a short
    capture)."""
    N = 4
    x = _capture(N, 2048 + 37, seed=4)
    ref = cov_windows_pallas(Cpx.from_complex(x), S, overlap, interpret=True)
    rr, ri = cov.cov_windows(*_planes(x, "stride2"), S, overlap)
    B = (x.shape[0] - S) // (S - overlap) + 1
    assert rr.shape == (B, N, N)
    scale = np.abs(np.asarray(ref.re)).max()
    np.testing.assert_allclose(rr.numpy(), np.asarray(ref.re), rtol=1e-5,
                               atol=1e-6 * scale)
    np.testing.assert_allclose(ri.numpy(), np.asarray(ref.im), rtol=1e-5,
                               atol=1e-6 * scale)
    # and the golden windows (the reference's own test tolerance)
    R_gold = golden.sample_covariance(golden.frame_samples(x, S, overlap))
    np.testing.assert_allclose(rr.numpy() + 1j * ri.numpy(), R_gold,
                               rtol=3e-4, atol=2e-5)


@pytest.mark.parametrize("overlap,fb,smooth,dtype", [
    (0, True, True, "float32"), (512, True, True, "float32"),
    (300, False, True, "float32"), (0, True, False, "bfloat16"),
    (512, False, False, "float32")])
def test_covariance_chain_matches_reference(overlap, fb, smooth, dtype):
    """cov_from_stream + correction + FB + smoothing (c3's chain) against
    compute_covariances_cpx with the Pallas chunk kernel: rtol 1e-5,
    atol 1e-5·max|R|."""
    c3 = PRESETS["c3_ula16_calib_smooth"]
    cfg = dataclasses.replace(
        c3, overlap=overlap, cov_dtype=dtype,
        avg_method=c3.avg_method if fb else AvgMethod.NONE,
        smoothing=c3.smoothing if smooth else SmoothingSpec())
    assert cfg.smoothing.enabled == smooth
    x = _capture(16, 6 * 1024 + 100, seed=5)
    c = _correction(16)
    ref = compute_covariances_cpx(
        Cpx.from_complex(x), cfg, correction=Cpx.from_complex(c),
        cov_impl="pallas", interpret=True)
    cr = torch.from_numpy(np.ascontiguousarray(c.real))
    ci = torch.from_numpy(np.ascontiguousarray(c.imag))
    rr, ri = compute_covariances(*_planes(x, "stride2"), cfg, (cr, ci))
    assert rr.shape == np.asarray(ref.re).shape
    scale = np.abs(np.asarray(ref.re)).max()
    np.testing.assert_allclose(rr.numpy(), np.asarray(ref.re), rtol=1e-5,
                               atol=1e-5 * scale)
    np.testing.assert_allclose(ri.numpy(), np.asarray(ref.im), rtol=1e-5,
                               atol=1e-5 * scale)


def test_covariance_ops_match_reference():
    """apply_correction_to_cov, forward_backward and spatial_smooth on the
    same planes: bit-equal (the same elementwise FP32 operations)."""
    from doa_tpu.ops import cpx_ops as cj
    rng = np.random.default_rng(6)
    Z = rng.standard_normal((3, 40, 10)) + 1j * rng.standard_normal(
        (3, 40, 10))
    R = np.einsum("bti,btj->bij", Z, Z.conj()).astype(np.complex64)
    c = _correction(10, seed=2)
    Rj = Cpx.from_complex(R)
    rr = torch.from_numpy(np.ascontiguousarray(R.real))
    ri = torch.from_numpy(np.ascontiguousarray(R.imag))
    cr = torch.from_numpy(np.ascontiguousarray(c.real))
    ci = torch.from_numpy(np.ascontiguousarray(c.imag))
    pairs = [
        (cpx_ops.apply_correction_to_cov(rr, ri, cr, ci),
         cj.apply_correction_to_cov(Rj, Cpx.from_complex(c))),
        (cpx_ops.forward_backward(rr, ri), cj.forward_backward_cpx(Rj)),
        (cpx_ops.spatial_smooth(rr, ri, 7), cj.spatial_smooth_cpx(Rj, 7)),
    ]
    for (pr, pi), ref in pairs:
        np.testing.assert_array_equal(pr.numpy(), np.asarray(ref.re))
        np.testing.assert_array_equal(pi.numpy(), np.asarray(ref.im))
