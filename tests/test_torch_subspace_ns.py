"""Port parity: kernel 11's plain version (the cold Newton–Schulz subspace)
against doa_tpu's Pallas subspace kernel in interpret mode, the port's
orth="ns" chain against doa_tpu's, and the subspace guard's four functions
against doa_tpu.ops.cpx_ops, on the same numpy E stacks."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import golden
from doa_tpu.cpx import Cpx, embed_hermitian
from doa_tpu.io import SourceSpec, synth_ula_iq
from doa_tpu.ops import cpx_ops as ops_jax
from doa_tpu.ops.pallas.subspace import (packed_to_batched,
                                         subspace_packed_pallas)
from doa_tpu_torch import _build
from doa_tpu_torch.ops import cpx_ops
from doa_tpu_torch.ops.cuda import subspace_ns as sns


def _E(N, K, B=40, S=256, seed=3, angles=(60.0, 110.0, 88.0)):
    """B windows of test_fused_path.py's scene (K sources at 60°, 110°,
    88°, or the first K of `angles`), embedded → f32[B, 2N, 2N]."""
    x = golden.synthetic_ula_iq(list(angles[:max(K, 2)]), N, 0.5, B * S,
                                snr_db=10, seed=seed)
    R = golden.sample_covariance(golden.frame_samples(x, S, 0))
    return np.array(embed_hermitian(Cpx.from_complex(R)), np.float32)


def _hard_E(B=16, S=2048):
    """tests/test_power_subspace.py's guard scene (amplitude 30 : 1 at
    60°/110°, 20 dB, 8 elements), B windows."""
    x = synth_ula_iq(
        [SourceSpec(theta_deg=60.0, freq_norm=0.1, amplitude=30.0),
         SourceSpec(theta_deg=110.0, freq_norm=0.31, amplitude=1.0)],
        8, 0.5, B * S, snr_db=20, seed=6)
    R = golden.sample_covariance(golden.frame_samples(x, S, 0))
    return np.array(embed_hermitian(Cpx.from_complex(R)), np.float32)


def _proj_t(Vt):
    """Projector of the rows of Vt (B, 2K, 2N)."""
    Vt = np.asarray(Vt)
    return np.einsum("bki,bkj->bij", Vt, Vt)


def _proj(V):
    """Projector of the columns of V (B, 2N, 2K)."""
    V = np.asarray(V)
    return np.einsum("bik,bjk->bij", V, V)


@pytest.mark.parametrize("N,K", [(16, 2), (8, 2), (8, 3)])
@pytest.mark.parametrize("squarings", [0, 2])
def test_kernel_plain_matches_pallas(N, K, squarings):
    """subspace_ns_plain against subspace_packed_pallas (interpret mode)
    → packed_to_batched: projectors within 2e-5
    (test_fused_path.py's projector tolerance), rows orthonormal to 1e-5
    (the reference's own rows reach 8e-6 at (8, 3)). Both run 8 rounds
    without squaring,
    4 rounds of E⁴ with two (test_fused_path.py's iters=16): at 2 rounds
    of E⁴ the three-source windows are not yet converged, and rounding
    differences there move projectors by ~6e-5."""
    E = _E(N, K)
    B = E.shape[0]
    iters = 16 if squarings else 8
    Vp = subspace_packed_pallas(jnp.asarray(E), K, iters=iters,
                                squarings=squarings, interpret=True)
    V_ref = np.asarray(packed_to_batched(Vp, B, K))
    Vt = sns.subspace_ns(torch.from_numpy(E), K, iters=iters,
                         squarings=squarings)
    assert Vt.shape == (B, 2 * K, 2 * N)
    np.testing.assert_allclose(_proj_t(Vt), _proj(V_ref), atol=2e-5)
    orth = np.einsum("bki,bli->bkl", Vt.numpy(), Vt.numpy())
    np.testing.assert_allclose(orth, np.broadcast_to(np.eye(2 * K),
                                                     orth.shape), atol=1e-5)


def _orth_err(Vt):
    """Per window ‖Vt Vtᵀ − I‖∞ of rows Vt (B, 2K, 2N)."""
    Vt = np.asarray(Vt)
    eye = np.eye(Vt.shape[1])
    return np.abs(np.einsum("bki,bli->bkl", Vt, Vt) - eye).max(axis=(1, 2))


def test_mirror_scene_leaves_e4_unconverged_in_the_reference():
    """The headline's scene, 70° and 110° on 16 elements (mirror images
    about broadside), 16 windows of 1024: two rounds of E⁴ (iters 8,
    squarings 2) leave doa_tpu's kernel with rows 1e-2 or more from
    orthonormal, and the plain version with the same error window by
    window (within 1e-3); eight rounds of E converge in both."""
    E = _E(16, 2, B=16, S=1024, angles=(70.0, 110.0))
    for sq, converged in ((2, False), (0, True)):
        Vp = subspace_packed_pallas(jnp.asarray(E), 2, iters=8,
                                    squarings=sq, interpret=True)
        ref = _orth_err(np.swapaxes(np.asarray(packed_to_batched(Vp, 16, 2)),
                                    1, 2))
        plain = _orth_err(sns.subspace_ns_plain(torch.from_numpy(E), 2,
                                                iters=8, squarings=sq))
        np.testing.assert_allclose(plain, ref, atol=1e-3)
        if converged:
            assert ref.max() < 1e-5 and plain.max() < 1e-5
        else:
            assert ref.max() > 1e-2 and plain.max() > 1e-2


@pytest.mark.parametrize("squarings", [0, 1, 2])
def test_ns_orth_matches_reference(squarings):
    """cpx_ops.signal_subspace_from_E_T(orth="ns") against doa_tpu's: the
    same chain (no symmetrisation after squaring), projectors within 2e-5;
    `pack` changes nothing."""
    E = _E(16, 2, B=12)
    kw = dict(iters=8, squarings=squarings, orth="ns")
    V_ref = ops_jax.signal_subspace_from_E_T(jnp.asarray(E), 2, **kw)
    Et = torch.from_numpy(E)
    Vt = cpx_ops.signal_subspace_from_E_T(Et, 2, **kw)
    np.testing.assert_allclose(_proj_t(Vt), _proj_t(V_ref), atol=2e-5)
    for pack in (1, 3):
        torch.testing.assert_close(
            cpx_ops.signal_subspace_from_E_T(Et, 2, pack=pack, **kw), Vt,
            rtol=0, atol=0)


def test_ns_differs_from_the_kernel_only_by_the_symmetrisation():
    """Without squarings the two chains are one; with them, the kernel's
    plain version and orth="ns" agree in projector."""
    Et = torch.from_numpy(_E(8, 2, B=8))
    for sq in (0, 2):
        a = sns.subspace_ns_plain(Et, 2, iters=8, squarings=sq)
        b = cpx_ops.signal_subspace_from_E_T(Et, 2, iters=8, squarings=sq,
                                             orth="ns")
        if sq == 0:
            torch.testing.assert_close(a, b, rtol=0, atol=0)
        np.testing.assert_allclose(_proj_t(a), _proj_t(b), atol=2e-5)


def test_ns_rejects_mgs_only_options():
    E = torch.from_numpy(_E(8, 2, B=4))
    init = torch.zeros((1, 4, 16))
    for kw, msg in ((dict(init=init), "init"),
                    (dict(escalate_extra=4), "escalation"),
                    (dict(return_stats=True), "stats"),
                    (dict(pack=0), "pack"),
                    (dict(orth="qr"), "orth")):
        kw.setdefault("orth", "ns")
        with pytest.raises(ValueError, match=msg):
            cpx_ops.signal_subspace_from_E_T(E, 2, **kw)


def test_kernel_wrapper_checks():
    """The wrapper's shape and device rules; rounds as the reference's."""
    E = torch.from_numpy(_E(8, 2, B=4))
    with pytest.raises(ValueError, match="device"):
        sns.subspace_ns(E.to("meta"), 2)
    with pytest.raises(ValueError, match="f32"):
        sns.subspace_ns(E.double(), 2)
    with pytest.raises(ValueError, match="num_sources"):
        sns.subspace_ns(E, 9)
    assert [sns.ns_rounds(8, s) for s in (0, 1, 2, 3, 4)] == [8, 4, 2, 1, 1]
    with _build.counting() as n:
        sns.subspace_ns(E, 2)
    assert not n                                  # the CPU takes the plain


def _guard_scene():
    """8 windows of the hard scene with the 4-iteration Newton–Schulz
    subspace (the spread defeats it: the guard flags them all), then 8
    healthy windows with a converged MGS subspace → (E, V_emb)."""
    Eh = torch.from_numpy(_hard_E(B=8))
    Eg = torch.from_numpy(_E(8, 2, B=8))
    Vh = sns.subspace_ns_plain(Eh, 2, iters=4, squarings=0).transpose(1, 2)
    Vg = cpx_ops.signal_subspace_from_E(Eg, 2, iters=8)
    return torch.cat([Eh, Eg]), torch.cat([Vh, Vg])


def test_subspace_residual_and_capture_gap_match():
    """The residual within 1e-5, the capture gap's two Rayleigh values
    within 1e-4 relative, on windows flagged and healthy."""
    E, V = _guard_scene()
    En, Vn = jnp.asarray(E.numpy()), jnp.asarray(V.numpy())
    r_ref = np.asarray(ops_jax.subspace_residual(En, Vn))
    r = cpx_ops.subspace_residual(E, V).numpy()
    np.testing.assert_allclose(r, r_ref, rtol=1e-4, atol=1e-5)
    g_ref = ops_jax.capture_gap(En, Vn)
    g = cpx_ops.capture_gap(E, V)
    for a, b in zip(g, g_ref):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-4,
                                   atol=1e-4 * np.abs(b).max())


def test_eigh_subspace_matches():
    E = _E(8, 2, B=8)
    V_ref = ops_jax.eigh_signal_subspace_from_E(jnp.asarray(E), 2)
    V = cpx_ops.eigh_signal_subspace_from_E(torch.from_numpy(E), 2)
    assert V.shape == (8, 16, 4)
    np.testing.assert_allclose(_proj(V), _proj(V_ref), atol=1e-5)


def test_guarded_subspace_matches():
    """guarded_signal_subspace: the same windows replaced (flag residual
    ≥ 1: the hard scene's eight), the residual elsewhere within 1e-5. The
    replaced windows' eigh projectors agree within 1e-4: at the scene's
    spread (‖E‖ / eigengap ≈ 900) two f32 eigh solvers differ by about
    900·2⁻²⁴ ≈ 5e-5; the healthy windows keep their own subspace."""
    E, V = _guard_scene()
    V_ref, r_ref = ops_jax.guarded_signal_subspace(
        jnp.asarray(E.numpy()), jnp.asarray(V.numpy()), 2, tol=0.05)
    Vg, r = cpx_ops.guarded_signal_subspace(E, V, 2, tol=0.05)
    r, r_ref = r.numpy(), np.asarray(r_ref)
    np.testing.assert_array_equal(r >= 1.0, r_ref >= 1.0)
    np.testing.assert_array_equal(r >= 1.0, np.arange(16) < 8)
    np.testing.assert_allclose(r, r_ref, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(_proj(Vg), _proj(V_ref), atol=1e-4)
    torch.testing.assert_close(Vg[8:], V[8:], rtol=0, atol=0)
    np.testing.assert_array_equal(np.asarray(V_ref)[8:], V[8:].numpy())
