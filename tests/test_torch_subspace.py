"""Port parity: doa_tpu_torch's MGS subspace iteration, warm start and
escalation detector against doa_tpu.ops.cpx_ops on the same E stacks."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import golden
from doa_tpu.configs import ArrayGeometry, DoaConfig
from doa_tpu.cpx import Cpx, embed_hermitian
from doa_tpu.io import SourceSpec, synth_ula_iq
from doa_tpu.ops import cpx_ops as ops_jax
from doa_tpu_torch.ops import cpx_ops


def _E_scene(N=8, S=256, B=40, imbalance_db=0.0, seed=3):
    amp = 10 ** (-imbalance_db / 20)
    x = synth_ula_iq([SourceSpec(theta_deg=60.0, freq_norm=0.1),
                      SourceSpec(theta_deg=110.0, freq_norm=0.3,
                                 amplitude=amp)],
                     N, 0.5, B * S, snr_db=10, seed=seed)
    R = golden.sample_covariance(golden.frame_samples(x, S, 0))
    return np.array(embed_hermitian(Cpx.from_complex(R)), np.float32)


def _planted_E(lams_per_window):
    """One shared eigenbasis, one eigenvalue vector per window (as
    tests/test_power_subspace.py) → E f32[B, n2, n2]."""
    n2 = len(lams_per_window[0])
    rng = np.random.default_rng(11)
    Q, _ = np.linalg.qr(rng.standard_normal((n2, n2)).astype(np.float32))
    return np.stack([(Q * np.asarray(l, np.float32)) @ Q.T
                     for l in lams_per_window]).astype(np.float32)


def _proj(Vt):
    Vt = np.asarray(Vt)
    return np.einsum("bki,bkj->bij", Vt, Vt)


def _esc(N, S):
    cfg = DoaConfig(geometry=ArrayGeometry(kind="ula", num_elements=N),
                    snapshot_size=S, num_sources=2)
    return cfg.escalate_kwargs


@pytest.mark.parametrize("N", [8, 16])
def test_warm_start_projectors_match(N):
    """The pipeline's warm start (capture-mean subspace at 8 iterations,
    then 2 E-applies per window; B = 40 ≥ 32 so the reference would warm
    start too): projectors within 2e-5, as tests/test_fused_path.py."""
    E = _E_scene(N=N)
    esc = _esc(N, 256)
    Vb_j = ops_jax.signal_subspace_from_E_T(
        jnp.mean(jnp.asarray(E), axis=0)[None], 2, iters=8, **esc)
    V_j, st_j = ops_jax.signal_subspace_from_E_T(
        jnp.asarray(E), 2, iters=2,
        init=jnp.broadcast_to(Vb_j, (E.shape[0],) + Vb_j.shape[1:]),
        return_stats=True, **esc)
    Et = torch.from_numpy(E)
    Vb = cpx_ops.signal_subspace_from_E_T(Et.mean(0, keepdim=True), 2,
                                          iters=8, **esc)
    V, st = cpx_ops.signal_subspace_from_E_T(
        Et, 2, iters=2, init=Vb.expand(E.shape[0], -1, -1),
        return_stats=True, **esc)
    np.testing.assert_allclose(_proj(V), _proj(V_j), atol=2e-5)
    orth = np.einsum("bki,bli->bkl", V.numpy(), V.numpy())
    np.testing.assert_allclose(orth, np.broadcast_to(np.eye(4), orth.shape),
                               atol=5e-6)
    assert (int(st[0]), int(st[1])) == (int(st_j[0]), int(st_j[1])) == (0, 0)


def test_cold_iteration_matches():
    E = _E_scene(N=8, B=12)
    V_j = ops_jax.signal_subspace_from_E_T(jnp.asarray(E), 2, iters=8)
    V = cpx_ops.signal_subspace_from_E_T(torch.from_numpy(E), 2, iters=8)
    np.testing.assert_allclose(_proj(V), _proj(V_j), atol=2e-5)


def test_imbalanced_scene_flags_like_reference():
    """25 dB source imbalance (tests/test_power_subspace.py's
    escalation scene): the cold iteration flags windows, the counts equal
    the reference's, and the escalated subspaces agree."""
    E = _E_scene(N=16, S=1024, B=8, imbalance_db=25.0, seed=100)
    esc = _esc(16, 1024)
    V_j, (f_j, o_j) = ops_jax.signal_subspace_from_E_T(
        jnp.asarray(E), 2, iters=8, return_stats=True, **esc)
    V, (f, o) = cpx_ops.signal_subspace_from_E_T(
        torch.from_numpy(E), 2, iters=8, return_stats=True, **esc)
    assert int(f_j) > 0, "scene no longer flags windows"
    assert (int(f), int(o)) == (int(f_j), int(o_j))
    np.testing.assert_allclose(_proj(V), _proj(V_j), atol=1e-4)


@pytest.mark.parametrize("capacity", [1024, 2])
def test_escalation_counts_and_capacity(capacity):
    """Planted spectra with four flagged windows: equal (flagged,
    overflow) counts; at capacity 2 the two worst windows escalate and the
    others stay at the base iteration, as in the reference."""
    n2 = 16
    verybad = [100.0, 100.0, 0.11, 0.11] + [0.1] * (n2 - 4)
    mild = [100.0, 100.0, 0.2, 0.2] + [0.1] * (n2 - 4)
    healthy = [100.0, 100.0, 50.0, 50.0] + [0.1] * (n2 - 4)
    E = _planted_E([mild, verybad, healthy, verybad, mild, healthy])
    kw = dict(iters=8, escalate_extra=60, escalate_capacity=capacity,
              return_stats=True)
    V_j, (f_j, o_j) = ops_jax.signal_subspace_from_E_T(jnp.asarray(E), 2,
                                                       **kw)
    V, (f, o) = cpx_ops.signal_subspace_from_E_T(torch.from_numpy(E), 2,
                                                 **kw)
    assert (int(f), int(o)) == (int(f_j), int(o_j))
    assert (int(f), int(o)) == ((4, 0) if capacity > 4 else (4, 2))
    np.testing.assert_allclose(_proj(V), _proj(V_j), atol=1e-4)
    V_off = cpx_ops.signal_subspace_from_E_T(torch.from_numpy(E), 2,
                                             iters=8).numpy()
    changed = [b for b in range(6)
               if not np.array_equal(V.numpy()[b], V_off[b])]
    assert changed == ([0, 1, 3, 4] if capacity > 4 else [1, 3])


def test_detector_and_flags_match():
    E = _planted_E([[100.0, 100.0, 0.14, 0.14] + [0.1] * 12,
                    [100.0, 100.0, 50.0, 50.0] + [0.1] * 12])
    V = cpx_ops.signal_subspace_from_E_T(torch.from_numpy(E), 2, iters=4)
    Vn = V.numpy()
    W = np.einsum("bkn,bnm->bkm", Vn, E)
    scale = np.trace(E, axis1=1, axis2=2) / 16
    ref = ops_jax.escalation_detector(jnp.asarray(W), jnp.asarray(Vn), 16,
                                      scale=jnp.asarray(scale))
    got = cpx_ops.escalation_detector(torch.from_numpy(W), V, 16,
                                      scale=torch.from_numpy(scale))
    # gamma, gamma_max to rtol 1e-4; res = sqrt(‖W‖² − ‖C‖²) sits at
    # its f32 cancellation floor (~3e-4, see the reference) in a converged
    # window, so it is compared to 1e-3 absolute (flags use tol 0.05)
    for a, b, atol in zip(got, ref, (1e-6, 1e-6, 1e-3)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=atol)
    bad, score = cpx_ops.escalation_flags(*got, 3.0, 0.05, 2.5)
    bad_j, score_j = ops_jax.escalation_flags(*ref, 3.0, 0.05, 2.5)
    np.testing.assert_array_equal(bad.numpy(), np.asarray(bad_j))
    # score = res/tol + max(gap − gamma, 0) carries res's floor / 0.05
    np.testing.assert_allclose(score.numpy(), np.asarray(score_j), rtol=1e-4,
                               atol=1e-3 / 0.05)


def test_only_mgs_is_ported():
    """The two orthonormalisations of the reference, 'mgs' and 'ns', are
    ported (tests/test_torch_subspace_ns.py holds 'ns'); any other name
    raises."""
    E = torch.from_numpy(_E_scene(N=8, B=4))
    assert cpx_ops.signal_subspace_from_E_T(E, 2, orth="ns").shape == (
        4, 4, 16)
    with pytest.raises(ValueError, match="mgs"):
        cpx_ops.signal_subspace_from_E_T(E, 2, orth="qr")


def test_init_per_group_of_windows():
    """An init of m rows starts window b from row b // (B // m) (the
    wideband path's one init per subband): the same as running each group
    alone from its own row; an expanded single init is one group."""
    E = torch.from_numpy(_E_scene(N=8, B=12))
    Vb = cpx_ops.signal_subspace_from_E_T(
        E.reshape(3, 4, 16, 16).mean(dim=1), 2, iters=8)     # (3, 4, 16)
    out = cpx_ops.mgs_iterate(E, 2, 3, Vb)
    for grp in range(3):
        part = cpx_ops.mgs_iterate(E[4 * grp:4 * grp + 4], 2, 3,
                                   Vb[grp:grp + 1])
        for o, p in zip(out, part):
            torch.testing.assert_close(o[4 * grp:4 * grp + 4], p, rtol=0,
                                       atol=0)
    one = cpx_ops.mgs_iterate(E, 2, 3, Vb[:1].expand(12, -1, -1))
    torch.testing.assert_close(
        one[0], cpx_ops.mgs_iterate(E, 2, 3, Vb[:1])[0], rtol=0, atol=0)
    with pytest.raises(ValueError, match="divide"):
        cpx_ops.mgs_iterate(E, 2, 3, Vb[:1].expand(5, -1, -1).contiguous())
