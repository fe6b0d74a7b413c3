"""Port parity of DFT beamspace: doa_tpu_torch's ops/beamspace.py (the beam
matrix, its embedding, the beamspace steering, the projections of E(R)
and of the covariance planes) against doa_tpu/ops/beamspace.py on the
same numpy inputs, and build_pipeline_torch with beamspace against
build_pipeline_tpu (tests/test_beamspace.py's configs at small T)."""

import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import golden
from doa_tpu.configs import (ArrayGeometry, BeamspaceSpec, DoaConfig,
                             Estimator, GridSpec1D)
from doa_tpu.cpx import Cpx
from doa_tpu.ops import beamspace as beamspace_jax
from doa_tpu.pipeline_tpu import build_pipeline_tpu
from doa_tpu_torch.ops import beamspace
from doa_tpu_torch.plan import kernel_routes
from doa_tpu_torch.pipeline_torch import build_pipeline_torch, load_state


def _x(thetas=(80.0, 100.0), B=12, seed=3):
    """tests/test_beamspace.py's scene: ULA-16, 10 dB, B windows of 1024."""
    return golden.synthetic_ula_iq(list(thetas), 16, 0.5, B * 1024,
                                   snr_db=10, seed=seed).astype(np.complex64)


def _cfg(subspace_method="power", grid=None, estimators=None):
    """tests/test_beamspace.py:65-86's config: ULA-16, S = 1024, K = 2, a
    40–140° grid of 512, Nb = 8 beams at 90°."""
    return DoaConfig(
        geometry=ArrayGeometry(kind="ula", num_elements=16,
                               norm_spacing=0.5),
        snapshot_size=1024, num_sources=2,
        estimators=estimators or (Estimator.MUSIC, Estimator.CAPON),
        grid=grid or GridSpec1D(num_points=512, lo_deg=40.0, hi_deg=140.0),
        num_max_vals=2,
        beamspace=BeamspaceSpec(num_beams=8, center_deg=90.0),
        subspace_method=subspace_method)


# --- the pieces -----------------------------------------------------------

@pytest.mark.parametrize("N,Nb,center,d", [
    (16, 8, 90.0, 0.5), (16, 6, 90.0, 0.5), (16, 5, 60.0, 0.5),
    (8, 4, 120.0, 0.4), (32, 12, 75.0, 0.5)])
def test_beam_matrix_bit_equal(N, Nb, center, d):
    """dft_beam_matrix, embed_beam_matrix and beamspace_steering equal the
    reference's bit for bit; the beams are orthonormal."""
    Bm = beamspace.dft_beam_matrix(N, Nb, center, d)
    Bm_j = beamspace_jax.dft_beam_matrix(N, Nb, center, d)
    assert Bm.dtype == np.complex64 and Bm.shape == (N, Nb)
    np.testing.assert_array_equal(Bm, Bm_j)
    np.testing.assert_array_equal(beamspace.embed_beam_matrix(Bm),
                                  beamspace_jax.embed_beam_matrix(Bm_j))
    np.testing.assert_allclose(Bm.conj().T @ Bm, np.eye(Nb), atol=1e-6)
    A = golden.ula_steering(np.linspace(0, 180, 181), N, d).astype(
        np.complex64)
    np.testing.assert_array_equal(beamspace.beamspace_steering(A, Bm),
                                  beamspace_jax.beamspace_steering(A, Bm_j))


def test_beam_choice_at_the_tie_follows_numpys_argsort():
    """ULA-16, Nb = 8 at 90°: beams k = 4 and k = 12 tie at circular
    distance 0.25 from the centre; numpy's default argsort picks one of
    them, and the port's matrix holds the same one."""
    N = 16
    k = np.arange(N)
    f = ((k / N) + 0.5) % 1.0 - 0.5
    dist = np.abs(((f - 0.0) + 0.5) % 1.0 - 0.5)
    assert dist[4] == dist[12] == 0.25
    order = np.argsort(dist)
    assert {order[7], order[8]} == {4, 12}        # the tie sits at the cut
    Bm = beamspace.dft_beam_matrix(N, 8, 90.0, 0.5)
    n = np.arange(N)
    picked = [int(np.argmin([np.abs(Bm[:, j] - np.exp(
        -2j * np.pi * n * kk / N) / 4).max() for kk in k])) for j in range(8)]
    assert picked == sorted(order[:8].tolist())
    np.testing.assert_array_equal(
        Bm, beamspace_jax.dft_beam_matrix(N, 8, 90.0, 0.5))


def test_projections_match_reference():
    """beamspace_embedded (B̃ᵀ E B̃) and beamspace_covariance (Bᴴ R B on the
    planes) within 1e-6 of the largest entry of the reference's, and the
    embedding of one equals the other."""
    x = _x(B=8)
    R = golden.sample_covariance(golden.frame_samples(x, 1024, 0)).astype(
        np.complex64)
    Bm = beamspace.dft_beam_matrix(16, 8, 90.0, 0.5)
    Bt = beamspace.embed_beam_matrix(Bm)
    Rc = Cpx.from_complex(R)
    from doa_tpu.cpx import embed_hermitian
    E = np.array(embed_hermitian(Rc))
    Eb = beamspace.beamspace_embedded(torch.from_numpy(E),
                                      torch.from_numpy(Bt)).numpy()
    Eb_j = np.asarray(beamspace_jax.beamspace_embedded(jnp.asarray(E), Bt))
    assert Eb.shape == (8, 16, 16)
    np.testing.assert_allclose(Eb, Eb_j, rtol=0,
                               atol=1e-6 * np.abs(Eb_j).max())
    Rbr, Rbi = beamspace.beamspace_covariance(
        torch.from_numpy(R.real.copy()), torch.from_numpy(R.imag.copy()),
        torch.from_numpy(Bm))
    Rb_j = beamspace_jax.beamspace_cov_cpx(Rc, Bm)
    tol = 1e-6 * np.abs(np.asarray(Rb_j.re)).max()
    np.testing.assert_allclose(Rbr.numpy(), np.asarray(Rb_j.re), rtol=0,
                               atol=tol)
    np.testing.assert_allclose(Rbi.numpy(), np.asarray(Rb_j.im), rtol=0,
                               atol=tol)
    np.testing.assert_allclose(
        Eb, np.asarray(embed_hermitian(Rb_j)), rtol=0, atol=tol)


def test_plan_sizes_subspace_and_scan_at_the_beams():
    """Under beamspace the covariance stage is the array's (K1 at 2N = 32)
    and the subspace and scan stages are planned at 2·Nb = 16."""
    from doa_tpu_torch.ops.cuda.cov_embedded import gram_takes
    from doa_tpu_torch.plan import subspace_n2
    cfg = _cfg()
    assert subspace_n2(cfg) == 16
    routes = kernel_routes(cfg, return_spectra=False)
    assert routes["covariance"] == ("chunk_gram", gram_takes(32))
    assert routes["subspace"][0] == "mgs_iterate"
    assert routes["scan"] == ("music_scan_peaks", True)
    wide = dataclasses.replace(cfg, geometry=ArrayGeometry(
        kind="ula", num_elements=48, norm_spacing=0.5))
    # ULA-48: K1 does not take 2N = 96; the beams' 2·Nb = 16 scan does
    r48 = kernel_routes(wide, return_spectra=False)
    assert r48["covariance"] == ("chunk_gram", False)
    assert r48["subspace"] == ("mgs_iterate", True)
    assert r48["scan"] == ("music_scan_peaks", True)


# --- the pipelines --------------------------------------------------------

def _assert_close(out, ref, keys=("music", "capon"), spectra=True):
    """Angles within 1e-3° (each window's sorted), and the normalised
    spectra P = dmin/den as tests/test_torch_pipeline.py's
    _assert_spectra_match holds them: each row's scale (dmin, at a null
    that FP32 cancellation resolves to a few percent) within 5e-2, then
    every bin within 1e-4·P + 5e-2·P²."""
    for key in keys:
        a = np.sort(out.peak_angles[key].numpy(), -1)
        a_ref = np.sort(np.asarray(ref.peak_angles[key]), -1)
        assert a.shape == a_ref.shape
        np.testing.assert_allclose(a, a_ref, atol=1e-3)
        if spectra:
            P, P_ref = out.spectra[key].numpy(), np.asarray(ref.spectra[key])
            row = np.median(P / P_ref, axis=-1, keepdims=True)
            np.testing.assert_allclose(row, 1.0, rtol=5e-2)
            assert np.all(np.abs(P / row - P_ref)
                          <= 1e-4 * P_ref + 5e-2 * P_ref ** 2)
        else:
            assert key not in out.spectra


@pytest.mark.parametrize("subspace_method,entry,return_spectra", [
    ("power", "numpy", True), ("power", "interleaved", True),
    ("power", "numpy", False), ("eigh", "numpy", True)])
def test_pipeline_matches_reference(subspace_method, entry, return_spectra):
    """MUSIC + Capon with beamspace against build_pipeline_tpu (its fused
    covariance kernel in interpret mode): the fused route (K1 in element
    space, E projected, the power subspace and the scan at 2·Nb) through
    the numpy and interleaved entries, and eigh on the planes route (R
    projected); angles within 1e-3°, spectra over the same 512 angles."""
    cfg = _cfg(subspace_method)
    x = _x()
    ref = build_pipeline_tpu(dataclasses.replace(cfg, cov_impl="pallas"),
                             return_spectra=return_spectra)(x)
    pipe = build_pipeline_torch(cfg, device="cpu",
                                return_spectra=return_spectra)
    assert pipe.steering_planes[0].shape == (512, 8)
    out = (pipe(x) if entry == "numpy"
           else pipe.interleaved(x.view(np.float32)))
    _assert_close(out, ref, spectra=return_spectra)
    if return_spectra:
        assert out.spectra["music"].shape == (12, 512)
    for key in ("music", "capon"):
        got = np.sort(out.peak_angles[key].numpy(), -1).mean(0)
        np.testing.assert_allclose(got, [80.0, 100.0], atol=0.4)


def test_no_out_of_sector_fake_peaks():
    """The full 0–180° grid (721 points): the unit-norm beamspace steering
    keeps out-of-sector angles from peaking (tests/test_beamspace.py:
    109-125), as in the reference."""
    cfg = _cfg(grid=GridSpec1D(num_points=721),
               estimators=(Estimator.MUSIC,))
    x = _x()
    ref = build_pipeline_tpu(dataclasses.replace(cfg, cov_impl="pallas"))(x)
    out = build_pipeline_torch(cfg, device="cpu")(x)
    _assert_close(out, ref, keys=("music",))
    got = np.sort(out.peak_angles["music"].numpy(), -1).mean(0)
    np.testing.assert_allclose(got, [80.0, 100.0], atol=0.4)


def test_covariance_and_state_take_the_beams():
    """return_covariance gives the projected R_b (B, Nb, Nb) within 1e-5 of
    the reference's largest entry; load_state(beams=) takes the
    reference's beam matrix and steering, and gives the pipeline's own
    results; a steering of the element-space shape is refused."""
    cfg = _cfg(estimators=(Estimator.MUSIC,))
    x = _x(B=6)
    ref_pipe = build_pipeline_tpu(dataclasses.replace(cfg, cov_impl="pallas"),
                                  return_covariance=True)
    ref = ref_pipe(x)
    own = build_pipeline_torch(cfg, device="cpu", return_covariance=True)
    out = own(x)
    assert out.covariance.shape == (6, 8, 8)
    R_re, R_im = (np.asarray(p) for p in ref.covariance)
    tol = 1e-5 * np.abs(R_re).max()
    np.testing.assert_allclose(out.covariance.real.numpy(), R_re, rtol=0,
                               atol=tol)
    np.testing.assert_allclose(out.covariance.imag.numpy(), R_im, rtol=0,
                               atol=tol)
    A_re, A_im = (np.asarray(p) for p in ref_pipe.steering_planes)
    Bm_j = beamspace_jax.dft_beam_matrix(16, 8, 90.0, 0.5)
    state = load_state(A_re, A_im, device="cpu", beams=Bm_j)
    torch.testing.assert_close(state["A_re"], own.steering_planes[0],
                               rtol=0, atol=0)
    res = build_pipeline_torch(cfg, device="cpu", state=state)(x)
    torch.testing.assert_close(res.peak_angles["music"],
                               out.peak_angles["music"], rtol=0, atol=0)
    A16 = golden.ula_steering(np.linspace(40, 140, 512), 16, 0.5)
    with pytest.raises(ValueError, match="steering"):
        build_pipeline_torch(cfg, device="cpu", state=load_state(
            A16.real, A16.imag, device="cpu"))
    with pytest.raises(ValueError, match="beam matrix"):
        load_state(A_re, A_im, device="cpu", beams=Bm_j[:, :6])
