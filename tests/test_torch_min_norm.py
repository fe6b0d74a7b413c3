"""Port parity of min-norm: doa_tpu_torch's ops/min_norm.py (the weight
from the embedded signal basis, the subspace and projector denominators)
against doa_tpu's on the same numpy inputs; and call.scan_capture's
grid-free angles per block against the reference's scan_capture."""

import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import golden
from doa_tpu.configs import ArrayGeometry, DoaConfig, Estimator, GridSpec1D
from doa_tpu.cpx import Cpx
from doa_tpu.io import SourceSpec, synth_ula_iq
from doa_tpu.ops import cpx_ops as cj
from doa_tpu.ops import min_norm as min_norm_jax
from doa_tpu.pipeline_tpu import build_pipeline_tpu
from doa_tpu_torch.ops import min_norm
from doa_tpu_torch.pipeline_torch import build_pipeline_torch

N, K, G = 8, 2, 181


def _scene():
    """tests/test_min_norm.py's scene (70°, 130° at 12 dB, S = 512):
    covariances, their embedded power subspace and the 1° grid."""
    x = golden.synthetic_ula_iq([70.0, 130.0], N, 0.5, 16384, snr_db=12,
                                seed=5)
    R = golden.sample_covariance(golden.frame_samples(x, 512, 0)).astype(
        np.complex64)
    V = np.array(cj.signal_subspace_embedded(Cpx.from_complex(R), K,
                                             iters=24))
    A = golden.ula_steering(np.linspace(0, 180, G), N, 0.5).astype(
        np.complex64)
    return R, V, A


def _t(a):
    return torch.from_numpy(np.array(a))


def test_weight_from_signal_matches_reference():
    """w̃ within 1e-5 of its largest entry; its first entry exactly 1."""
    _, V, _ = _scene()
    w = min_norm.min_norm_weight_from_signal(_t(V)).numpy()
    w_j = np.asarray(min_norm_jax.min_norm_weight_from_signal(
        jnp.asarray(V)))
    np.testing.assert_allclose(w, w_j, atol=1e-5 * np.abs(w_j).max())
    np.testing.assert_array_equal(w[:, 0], 1.0)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("route", ["subspace", "projector"])
def test_denominators_match_reference(route, compute_dtype):
    """den = |aᴴw|² on the power subspace's route and the eigh
    projector's, within tests/test_min_norm.py:70's rtol 5e-3, atol 1e-5
    of the reference's on the same route and inputs."""
    R, V, A = _scene()
    Ac = Cpx.from_complex(A)
    Ar, Ai = _t(A.real), _t(A.imag)
    jdt = jnp.dtype(compute_dtype)
    if route == "subspace":
        den = min_norm.min_norm_denominator_subspace(_t(V), Ar, Ai,
                                                     compute_dtype)
        den_j = min_norm_jax.min_norm_denominator_subspace(
            jnp.asarray(V), Ac, compute_dtype=jdt)
    else:
        M = cj.noise_projector_cpx(Cpx.from_complex(R), K)
        den = min_norm.min_norm_denominator_cpx(
            _t(np.asarray(M.re)), _t(np.asarray(M.im)), Ar, Ai,
            compute_dtype)
        den_j = min_norm_jax.min_norm_denominator_cpx(M, Ac,
                                                      compute_dtype=jdt)
    assert den.shape == (32, G)
    np.testing.assert_allclose(den.numpy(), np.asarray(den_j), rtol=5e-3,
                               atol=1e-5)
    # each window's spectrum peaks at one of the two sources
    P = min_norm.min_norm_spectrum_subspace(_t(V), Ar, Ai).numpy()
    top = np.linspace(0, 180, G)[P.argmax(-1)]
    assert np.minimum(abs(top - 70.0), abs(top - 130.0)).max() < 1.5


def test_scan_capture_keeps_grid_free_angles():
    """call.scan_capture with MUSIC, root-MUSIC, ESPRIT, Unitary ESPRIT
    and min-norm (tests/test_torch_pipeline.py's narrowband scan_capture
    case: ULA-8, S = 256, overlap 64, 3 blocks): per block, the peaks and
    the three grid-free angles stacked (M, B_blk, K), each within 1e-3° of
    the reference's scan_capture (the grid-free ones sorted, as both
    packages sort them), and equal to the per-block call on each block
    with its carry."""
    from doa_tpu.ops.pallas.cov_embedded import interleave_factor
    E = Estimator
    S, OV = 256, 64
    cfg = DoaConfig(
        geometry=ArrayGeometry(kind="ula", num_elements=N, norm_spacing=0.5),
        snapshot_size=S, overlap=OV, num_sources=K,
        estimators=(E.MUSIC, E.ROOT_MUSIC, E.ESPRIT, E.UNITARY_ESPRIT,
                    E.MIN_NORM),
        grid=GridSpec1D(num_points=361), num_max_vals=2, scan_mode="pallas")
    M, T_blk = 3, 5 * (S - OV)
    x = synth_ula_iq([SourceSpec(theta_deg=70.0, freq_norm=0.12),
                      SourceSpec(theta_deg=120.0, freq_norm=0.3)],
                     N, 0.5, M * T_blk, snr_db=15, seed=9)
    blocks = np.ascontiguousarray(x.astype(np.complex64)).view(
        np.float32).reshape(M, T_blk, 2 * N)
    tp = interleave_factor(N)
    ref = build_pipeline_tpu(dataclasses.replace(cfg, cov_impl="pallas"),
                             return_spectra=False)
    out_ref = ref.scan_capture(blocks.reshape(M, T_blk // tp, 2 * N * tp))
    pipe = build_pipeline_torch(cfg, device="cpu", return_spectra=False)
    out = pipe.scan_capture(blocks)
    keys = ("root_music_angles", "esprit_angles", "unitary_esprit_angles")
    assert set(out) == {"peak_values", "peak_angles"} | set(keys)
    assert set(out) == set(out_ref)
    for est in ("music", "min_norm"):
        np.testing.assert_allclose(out["peak_angles"][est].numpy(),
                                   np.asarray(out_ref["peak_angles"][est]),
                                   atol=1e-3)
    B_blk = out["peak_angles"]["music"].shape[1]
    C = (S - OV) * -(-OV // (S - OV))
    for key in keys:
        a = out[key].numpy()
        assert a.shape == (M, B_blk, K)
        np.testing.assert_allclose(a, np.asarray(out_ref[key]), atol=1e-3)
        for m in range(1, M):
            r = getattr(pipe.interleaved(np.concatenate(
                [blocks[m - 1][-C:], blocks[m]])), key).numpy()
            np.testing.assert_allclose(a[m], r, atol=1e-4)
