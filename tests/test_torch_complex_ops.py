"""Port parity of the complex-typed ops (the complex pipeline's,
doa_tpu/pipeline.py): doa_tpu_torch's ops/covariance.py, subspace.py,
steering.py (the device functions), music.py, capon.py, bartlett.py and
the complex halves of root_music.py and min_norm.py against doa_tpu's on
the same numpy inputs from seeded generators."""

import importlib

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import golden
from doa_tpu import ops as ops_jax
from doa_tpu.ops import bartlett as bartlett_jax
from doa_tpu.ops import capon as capon_jax
from doa_tpu.ops import covariance as cov_jax
from doa_tpu.ops import min_norm as min_norm_jax
from doa_tpu.ops import music as music_jax
from doa_tpu.ops import steering as steer_jax
from doa_tpu.ops import subspace as subspace_jax
import doa_tpu_torch.ops as ops_t
from doa_tpu_torch.ops import bartlett, capon, covariance, min_norm, music
from doa_tpu_torch.ops import steering, subspace

# the modules: both packages' ops export the function root_music under
# the module's name
root_music = importlib.import_module("doa_tpu_torch.ops.root_music")
root_music_jax = importlib.import_module("doa_tpu.ops.root_music")

N, K = 8, 2
COV_TOL = 2e-5          # of max|R|: the covariance standard (ROADMAP §C.3)
ANGLE_TOL = 1e-3        # degrees: the narrowband standard (ROADMAP §C.3)
# den = 1/P of the unnormalized spectra, relative to each window's largest
# den: both packages take FP32 products of the same inputs in different
# orders (and eigh / Cholesky of different libraries), which moves den by
# a few FP32 roundings of its largest terms, ~1e-6 of the largest den
DEN_TOL = 1e-5


def _capture(T, seed=1, thetas=(60.0, 110.0), snr_db=10):
    return golden.synthetic_ula_iq(list(thetas), N, 0.5, T, snr_db=snr_db,
                                   seed=seed).astype(np.complex64)


def _covariances(B=16, S=256, seed=1, thetas=(60.0, 110.0), snr_db=10):
    x = _capture(B * S, seed, thetas, snr_db)
    return golden.sample_covariance(
        golden.frame_samples(x, S, 0)).astype(np.complex64)


def _assert_cov(R, R_ref):
    R, R_ref = np.asarray(R), np.asarray(R_ref)
    assert R.shape == R_ref.shape
    scale = np.abs(R_ref).max()
    assert np.abs(R - R_ref).max() <= COV_TOL * scale


def _grid(G=181):
    return golden.ula_steering(np.linspace(0, 180, G), N, 0.5).astype(
        np.complex64)


# ---------------------------------------------------------------------
# covariance.py
# ---------------------------------------------------------------------

@pytest.mark.parametrize("S,overlap,fb,L", [
    (64, 0, False, None),          # hop = S: one chunk a window
    (64, 48, False, None),         # hop | S: prefix sums of chunk Grams
    (96, 40, False, None),         # hop ∤ S: explicit frames
    (64, 32, True, None),          # FB
    (64, 0, False, 5),             # smoothing, M = 4
    (96, 40, True, 6),             # framing, FB and smoothing (M = 3)
])
def test_covariances_match_reference(S, overlap, fb, L):
    """cov_from_stream (then spatial_smooth) within 2e-5 of max|R| of the
    reference's, at regular and irregular overlaps, FB and smoothing."""
    x = _capture(1500)
    R = covariance.cov_from_stream(torch.from_numpy(x), S, overlap,
                                   fb_average=fb)
    R_ref = cov_jax.cov_from_stream(jnp.asarray(x), S, overlap,
                                    fb_average=fb)
    if L is not None:
        R = covariance.spatial_smooth(R, L)
        R_ref = cov_jax.spatial_smooth(R_ref, L)
    _assert_cov(R.numpy(), R_ref)
    assert R.shape[0] == (1500 - S) // (S - overlap) + 1


def test_frames_and_sample_covariance_match_reference():
    """frame_samples equal to the reference's frames; sample_covariance
    (with FB) and forward_backward within 2e-5 of max|R|; no window from
    a capture shorter than S."""
    x = _capture(700)
    f = covariance.frame_samples(torch.from_numpy(x), 64, 24)
    f_ref = np.asarray(cov_jax.frame_samples(jnp.asarray(x), 64, 24))
    np.testing.assert_array_equal(f.numpy(), f_ref)
    for fb in (False, True):
        _assert_cov(covariance.sample_covariance(f, fb).numpy(),
                    cov_jax.sample_covariance(jnp.asarray(f_ref), fb))
    R = _covariances(B=4)
    _assert_cov(covariance.forward_backward(torch.from_numpy(R)).numpy(),
                cov_jax.forward_backward(jnp.asarray(R)))
    assert covariance.frame_samples(torch.from_numpy(x[:40]), 64, 0).shape \
        == (0, 64, N)


def test_streaming_carry_matches_reference():
    """Three streaming steps (hop 32, S = 96) from the zero ring: the
    ring and each step's R within 2e-5 of max|R| of the reference's,
    and the last R equal to cov_from_stream's last window."""
    x = _capture(96)
    c = covariance.init_streaming_carry(N, 96, 32, device="cpu")
    c_ref = cov_jax.init_streaming_carry(N, 96, 32)
    assert c.shape == c_ref.shape and not c.any()
    for i in range(3):
        chunk = x[32 * i:32 * (i + 1)]
        c, R = covariance.streaming_covariance(c, torch.from_numpy(chunk),
                                               96, 32)
        c_ref, R_ref = cov_jax.streaming_covariance(
            c_ref, jnp.asarray(chunk), 96, 32)
        _assert_cov(c.numpy(), c_ref)
        _assert_cov(R.numpy(), R_ref)
    _assert_cov(R[None].numpy(), cov_jax.cov_from_stream(
        jnp.asarray(x), 96, 64))
    with pytest.raises(ValueError, match="hop must divide"):
        covariance.streaming_covariance(c, torch.from_numpy(x[:40]), 96, 40)


# ---------------------------------------------------------------------
# subspace.py, steering.py
# ---------------------------------------------------------------------

@pytest.mark.parametrize("eigh_batch", [None, 5])
def test_eigh_and_subspaces_match_reference_through_projectors(
        eigh_batch, monkeypatch):
    """Eigenvalues within 1e-5 of the largest; the noise and signal
    subspaces through their projectors (eigenvectors carry an arbitrary
    phase) within 1e-5. The input is made Hermitian only to rounding, as
    a window sum is; both packages symmetrize it. With eigh_batch 5 the
    16 windows go to eigh in four calls (EIGH_BATCH, cuSOLVER's batch
    limit), with results equal to one call's."""
    if eigh_batch is not None:
        whole = subspace.eigh_batched(torch.from_numpy(_covariances()))
        monkeypatch.setattr(subspace, "EIGH_BATCH", eigh_batch)
        parts = subspace.eigh_batched(torch.from_numpy(_covariances()))
        for a, b in zip(parts, whole):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
    R = _covariances()
    rng = np.random.default_rng(0)
    R = (R + 1e-6 * np.abs(R).max() * rng.standard_normal(R.shape)).astype(
        np.complex64)
    w, _ = subspace.eigh_batched(torch.from_numpy(R))
    w_ref, _ = subspace_jax.eigh_batched(jnp.asarray(R))
    np.testing.assert_allclose(w.numpy(), np.asarray(w_ref),
                               atol=1e-5 * np.abs(w_ref).max())
    proj = lambda V: np.einsum("...nk,...mk->...nm", V, V.conj())  # noqa
    for fn, fn_ref in ((subspace.noise_subspace, subspace_jax.noise_subspace),
                       (subspace.signal_subspace,
                        subspace_jax.signal_subspace)):
        V = fn(torch.from_numpy(R), K).numpy()
        V_ref = np.asarray(fn_ref(jnp.asarray(R), K))
        assert V.shape == V_ref.shape
        np.testing.assert_allclose(proj(V), proj(V_ref), atol=1e-5)


def test_device_steering_matches_reference():
    """ula_steering and ura_steering at f32 angles of shape (3, 5), as
    tensors (kept on their device) and as numpy (device="cpu"): within
    2e-6 of the reference's (FP32 phases of the same order, sin and cos
    of two libraries)."""
    rng = np.random.default_rng(3)
    th = rng.uniform(0, 180, (3, 5)).astype(np.float32)
    el = rng.uniform(0, 90, (3, 5)).astype(np.float32)
    a_ref = np.asarray(steer_jax.ula_steering(th, N, 0.5))
    for a in (steering.ula_steering(torch.from_numpy(th), N, 0.5),
              steering.ula_steering(th, N, 0.5, device="cpu")):
        assert a.dtype == torch.complex64 and a.shape == (3, 5, N)
        np.testing.assert_allclose(a.numpy(), a_ref, atol=2e-6)
    u = steering.ura_steering(torch.from_numpy(th), torch.from_numpy(el),
                              (4, 3), 0.5)
    u_ref = np.asarray(steer_jax.ura_steering(th, el, (4, 3), 0.5))
    assert u.shape == (3, 5, 12)
    np.testing.assert_allclose(u.numpy(), u_ref, atol=2e-6)


# ---------------------------------------------------------------------
# music.py, capon.py, bartlett.py, min_norm.py: spectra and peaks
# ---------------------------------------------------------------------

def _spectra(name, R, A):
    """(port, reference) unnormalized spectrum of one estimator."""
    Rt, At = torch.from_numpy(R), torch.from_numpy(A)
    Rj, Aj = jnp.asarray(R), jnp.asarray(A)
    if name == "music":
        return (music.music_spectrum(Rt, At, K, normalize=False),
                music_jax.music_spectrum(Rj, Aj, K, normalize=False))
    if name == "capon":
        return (capon.capon_spectrum(Rt, At, 1e-4, normalize=False),
                capon_jax.capon_spectrum(Rj, Aj, 1e-4, normalize=False))
    if name == "bartlett":
        return (bartlett.bartlett_spectrum(Rt, At, normalize=False),
                bartlett_jax.bartlett_spectrum(Rj, Aj, normalize=False))
    return (min_norm.min_norm_spectrum(Rt, At, K, normalize=False),
            min_norm_jax.min_norm_spectrum(Rj, Aj, K, normalize=False))


@pytest.mark.parametrize("name", ["music", "capon", "bartlett", "min_norm"])
def test_spectra_match_reference(name):
    """The unnormalized spectra as den = 1/P (Bartlett: P itself, its
    quadratic form) within DEN_TOL of each window's largest; the
    normalized spectra's peaks within 1e-3° (find_local_max, refined)."""
    R, A = _covariances(), _grid()
    P, P_ref = _spectra(name, R, A)
    P, P_ref = P.numpy(), np.asarray(P_ref)
    assert P.shape == P_ref.shape == (16, 181) and P.dtype == np.float32
    q, q_ref = (P, P_ref) if name == "bartlett" else (1 / P, 1 / P_ref)
    rel = np.abs(q - q_ref) / np.abs(q_ref).max(-1, keepdims=True)
    assert rel.max() <= DEN_TOL, rel.max()
    Pn = torch.from_numpy(P / P.max(-1, keepdims=True))
    v, loc = ops_t.find_local_max(Pn, K, 0.0, 180.0, refine=True)
    v_ref, loc_ref = ops_jax.find_local_max(
        jnp.asarray(P_ref / P_ref.max(-1, keepdims=True)), K, 0.0, 180.0,
        refine=True)
    np.testing.assert_allclose(loc.numpy(), np.asarray(loc_ref),
                               atol=ANGLE_TOL)
    if name != "bartlett":      # Bartlett's beams are too wide to split them
        assert np.abs(np.sort(loc.numpy(), -1) - [60, 110]).max() < 1.0


def test_noise_projector_and_min_norm_weight_match_reference():
    """M = E_n E_nᴴ within 1e-5; w within 1e-5 of its largest entry,
    w[0] = 1."""
    R = _covariances()
    M = music.noise_projector(torch.from_numpy(R), K).numpy()
    np.testing.assert_allclose(
        M, np.asarray(music_jax.noise_projector(jnp.asarray(R), K)),
        atol=1e-5)
    w = min_norm.min_norm_weight(torch.from_numpy(R), K).numpy()
    w_ref = np.asarray(min_norm_jax.min_norm_weight(jnp.asarray(R), K))
    np.testing.assert_allclose(w, w_ref, atol=1e-5 * np.abs(w_ref).max())
    np.testing.assert_allclose(w[:, 0], 1.0, atol=1e-6)


# ---------------------------------------------------------------------
# the complex root finder, root-MUSIC, root min-norm
# ---------------------------------------------------------------------

def _by_angle(r):
    return np.take_along_axis(r, np.argsort(np.angle(r) + 1e-3 * np.abs(r),
                                            -1), -1)


def test_polynomial_roots_match_reference_and_numpy():
    """Root-MUSIC's polynomials (degree 2N − 2) of a scene: the roots
    within 1e-4 of the reference's complex root finder, and of numpy's
    companion roots within 2e-3."""
    R = _covariances(B=6)
    c = root_music.root_music_coeffs(torch.from_numpy(R), K).numpy()
    c_ref = np.asarray(root_music_jax.root_music_coeffs(jnp.asarray(R), K))
    np.testing.assert_allclose(c, c_ref, atol=1e-5 * np.abs(c_ref).max())
    z = root_music.polynomial_roots(torch.from_numpy(c)).numpy()
    z_ref = np.asarray(root_music_jax.polynomial_roots(jnp.asarray(c)))
    assert z.shape == z_ref.shape == (6, 2 * N - 2)
    np.testing.assert_allclose(_by_angle(z), _by_angle(z_ref), atol=1e-4)
    for b in range(6):
        ref = np.sort_complex(np.roots(c[b, ::-1].astype(np.complex128)))
        np.testing.assert_allclose(np.sort_complex(z[b]), ref, atol=2e-3)


def test_polynomial_roots_guard_a_zero_derivative():
    """p(z) = z² + c1·z + c0 with c1 = −2·z₀ for the root finder's first
    start point z₀: Horner gives p'(z₀) = z₀ + (z₀ + c1) = 0 exactly, so
    the first step takes the guard (p'(z) replaced by 1). Both packages
    start from the same points, hit it, and reach numpy's roots."""
    z0 = root_music.polynomial_roots(
        torch.ones((1, 3), dtype=torch.complex64), num_iters=0).numpy()
    z0_ref = np.asarray(root_music_jax.polynomial_roots(
        jnp.ones((1, 3), jnp.complex64), num_iters=0))
    np.testing.assert_array_equal(z0, z0_ref)
    c = np.array([[0.3 - 0.2j, -2 * z0[0, 0], 1.0]], np.complex64)
    _, dp = root_music._poly_and_deriv(torch.from_numpy(c),
                                       torch.from_numpy(z0))
    _, dp_ref = root_music_jax._poly_and_deriv(jnp.asarray(c),
                                               jnp.asarray(z0))
    assert dp[0, 0] == 0 and np.asarray(dp_ref)[0, 0] == 0
    z = root_music.polynomial_roots(torch.from_numpy(c)).numpy()
    z_ref = np.asarray(root_music_jax.polynomial_roots(jnp.asarray(c)))
    assert np.isfinite(z).all()
    np.testing.assert_allclose(np.sort_complex(z[0]),
                               np.sort_complex(z_ref[0]), atol=1e-5)
    ref = np.sort_complex(np.roots(c[0, ::-1].astype(np.complex128)))
    np.testing.assert_allclose(np.sort_complex(z[0]), ref, atol=1e-5)


@pytest.mark.parametrize("thetas", [(60.0, 110.0), (40.0, 75.0, 120.0)])
def test_root_music_and_root_min_norm_match_reference(thetas):
    """Sorted angles within 1e-3° of the reference's (root-MUSIC through
    the exported name, root min-norm), and within 0.5° of the scene; the
    root selection equal to the reference's."""
    k = len(thetas)
    R = _covariances(thetas=thetas, snr_db=15)
    th = ops_t.root_music(torch.from_numpy(R), k, 0.5).numpy()
    th_ref = np.asarray(ops_jax.root_music(jnp.asarray(R), k, 0.5))
    assert th.shape == (16, k)
    np.testing.assert_allclose(th, th_ref, atol=ANGLE_TOL)
    assert np.abs(th - np.array(thetas)).max() < 0.5
    mn = min_norm.root_min_norm(torch.from_numpy(R), k, 0.5).numpy()
    mn_ref = np.asarray(min_norm_jax.root_min_norm(jnp.asarray(R), k, 0.5))
    np.testing.assert_allclose(mn, mn_ref, atol=ANGLE_TOL)
    assert np.abs(mn - np.array(thetas)).max() < 0.5
    roots = root_music_jax.polynomial_roots(
        root_music_jax.root_music_coeffs(jnp.asarray(R), k))
    sel = root_music.select_signal_roots(torch.from_numpy(np.array(roots)),
                                         k).numpy()
    np.testing.assert_array_equal(
        sel, np.asarray(root_music_jax.select_signal_roots(roots, k)))


def test_root_music_goes_non_finite_in_the_same_windows_as_the_reference():
    """ULA-16, 70°/110° at 10 dB, S = 1024 (the headline's scene; golden
    seed 3, windows 64–79 and 248–255 of 256): in windows 73 and 255 the
    reference's complex root finder lets a root escape to |z| > 20 within
    its first iterations, where p(z) of degree 2N − 2 = 30 overflows FP32,
    and returns non-finite angles (ROADMAP §C.3). The port returns them
    in the same two windows and agrees within 1e-3° on the others."""
    x = golden.synthetic_ula_iq([70.0, 110.0], 16, 0.5, 256 * 1024,
                                snr_db=10, seed=3)
    f = golden.frame_samples(x, 1024, 0)[np.r_[64:80, 248:256]]
    R = golden.sample_covariance(f).astype(np.complex64)
    th = ops_t.root_music(torch.from_numpy(R), 2, 0.5).numpy()
    th_ref = np.asarray(ops_jax.root_music(jnp.asarray(R), 2, 0.5))
    bad = ~np.isfinite(th).all(-1)
    np.testing.assert_array_equal(bad, ~np.isfinite(th_ref).all(-1))
    assert list(np.nonzero(bad)[0]) == [9, 23]          # windows 73, 255
    np.testing.assert_allclose(th[~bad], th_ref[~bad], atol=ANGLE_TOL)
    assert np.abs(th[~bad] - [70.0, 110.0]).max() < 0.5
    z = root_music.polynomial_roots(root_music.root_music_coeffs(
        torch.from_numpy(R[[9, 23]]), 2), num_iters=6)
    assert not torch.isfinite(z).all()


def test_ops_exports_the_reference_surface():
    """doa_tpu_torch.ops exports doa_tpu.ops.__all__ name for name, each
    a callable (root_music the function, as in the reference)."""
    assert ops_t.__all__ == ops_jax.__all__
    for name in ops_jax.__all__:
        assert callable(getattr(ops_t, name)), name
    assert ops_t.root_music is root_music.root_music
