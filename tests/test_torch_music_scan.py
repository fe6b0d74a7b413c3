"""Port parity: doa_tpu_torch's MUSIC scan (plain paths of kernels K3 and
K2) and find_local_max against doa_tpu's Pallas kernels in interpret mode
and doa_tpu.ops.peaks, on the same numpy inputs; and K3's tensor-core
form on the CPU: its operand layouts with 2N padding, its grid of
(stretch, window group) blocks and its two-accumulator 3×TF32 arithmetic,
modelled by the shared mainloop's model (test_torch_fusion_split)."""

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
from doa_tpu_torch.ops.cuda.scan_tc import (fusion_bins, fusion_kp,
                                            subspace_fragments, tf32_split)
from doa_tpu_torch.ops.peaks import find_local_max
from test_torch_fusion_split import _kernel_den


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


# (2K, 2N) of K3's tested shapes: the headline's, c3's, c5's (2N = 128)
# and a 10x10 URA's, whose 2N pads to the mainloop's multiple of 16
K3_SHAPES = [(4, 32), (6, 24), (4, 128), (2, 200)]


@pytest.mark.parametrize("k2,n2", K3_SHAPES)
def test_music_scan_matches_pallas(k2, n2):
    """P = 1/den: compared on den (the reciprocal amplifies f32 noise at
    the nulls without bound), rtol 1e-5 plus atol 1e-5·max‖a‖² for the
    cancellation in ‖a‖² − ‖Vᵀã‖²."""
    V, At = _setup(N=n2 // 2, K=k2 // 2)
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


def _unpad_tiles(tiles, G, n2, k2):
    """scan_tiles' A' → (hi, lo) f32[G, 2N], and what lies past G, 2N."""
    GB, KP = 2 * fusion_bins(k2), fusion_kp(n2)
    nJ = tiles.shape[0]
    # [j][plane][KP/4 c][GB/8 r][8 row][4 e] → g = GB·j + 8r + row,
    # n = 4c + e
    planes = tiles.permute(0, 3, 4, 1, 2, 5).reshape(nJ * GB, 2, KP)
    return planes[:G, :, :n2], planes[G:], planes[:G, :, n2:]


@pytest.mark.parametrize("k2,n2", K3_SHAPES)
def test_k3_layouts_reassemble_with_padding(k2, n2):
    """A' (scan_tiles) and V' (subspace_fragments) hold every operand once,
    at the mainloop's address, with zeros past G, B and 2N."""
    rng = np.random.default_rng(n2)
    B, G = 45, 301                      # ragged: 2 window tiles, odd G
    Vt = torch.from_numpy(rng.standard_normal((B, k2, n2)).astype(np.float32))
    At = torch.from_numpy(rng.standard_normal((G, n2)).astype(np.float32))
    tiles = ms.scan_tiles(At, k2)
    GB, KP = 2 * fusion_bins(k2), fusion_kp(n2)
    assert tiles.shape == (-(-G // GB), 2, KP // 4, GB // 8, 8, 4)
    planes, past_g, past_n = _unpad_tiles(tiles, G, n2, k2)
    hi, lo = tf32_split(At)
    assert torch.equal(planes[:, 0], hi) and torch.equal(planes[:, 1], lo)
    assert not past_g.any() and not past_n.any()
    Vf = subspace_fragments(Vt[None])[0]
    nT, MT = -(-B // 32), k2 // 2
    assert Vf.shape == (nT, KP // 8, MT, 4, 32, 4)
    # [T][s][i][w][lane (g, t)][e = 2c + h] → window 32T + 8w + g,
    # k = 2i + h, n = 8s + 4c + t
    V = Vf.reshape(nT, KP // 8, MT, 4, 8, 4, 2, 2).permute(
        0, 3, 4, 2, 7, 1, 6, 5).reshape(nT * 32, k2, KP)
    assert torch.equal(V[:B, :, :n2], Vt)
    assert not V[B:].any() and not V[:, :, n2:].any()


def _k3_model(Vt, At, nrm, sms=132):
    """P f32[B, G] as K3 forms it: the grid of window_groups (every block
    one stretch of bins and `per` window tiles; each (tile, stretch) must
    be reached once), the shared mainloop's den from the wrapper's
    layouts, then the epilogue's IEEE 1/den."""
    B, k2, n2 = Vt.shape
    G = At.shape[0]
    tiles, Vf = ms.scan_tiles(At, k2)[None], subspace_fragments(Vt[None])
    nT, nJ = Vf.shape[1], tiles.shape[1]
    groups, per = ms.window_groups(nJ, nT, sms)
    assert (groups - 1) * per < nT <= groups * per
    P = torch.full((nT * 32, G), float("nan"))
    for grp in range(groups):
        T0, T1 = grp * per, min((grp + 1) * per, nT)
        rows = slice(32 * T0, 32 * T1)
        assert bool(P[rows].isnan().all())
        den = _kernel_den(Vf[:, T0:T1], tiles, nrm[None], k2, n2)[0]
        P[rows] = 1.0 / den
    assert not bool(P.isnan().any())
    return P[:B]


@pytest.mark.parametrize("k2,n2", K3_SHAPES)
def test_k3_model_exact_inputs_equal_plain(k2, n2):
    """Quarter-step V, integer A, nrm above every Σy²: every sum exact, so
    K3's grid, layouts and epilogue give music_scan_plain bit for bit
    (chip_smoke's exact-input case), over several window groups."""
    rng = np.random.default_rng(k2 * n2)
    B, G = 300, 157
    Vt = torch.from_numpy(rng.integers(-2, 3, (B, k2, n2))
                          .astype(np.float32) / 4)
    At = torch.from_numpy(rng.integers(-3, 4, (G, n2)).astype(np.float32))
    nrm = torch.from_numpy(300000.0 + rng.integers(0, 64, G)
                           .astype(np.float32))
    P = _k3_model(Vt, At, nrm, sms=8)
    assert torch.equal(P, ms.music_scan_plain(Vt, At, nrm))


def test_k3_model_within_tolerance_of_float64_on_c5_scene():
    """On a c5-like scene (8x8 URA, 2N = 128, the exact signal subspace of
    two sources, so den cancels to ~0 at their bins) the 3×TF32 model's
    den is within chip_smoke's 1e-5·max‖a‖² of den in float64."""
    from doa_tpu_torch.ops.steering import ura_grid
    from doa_tpu_torch.configs import ArrayGeometry, GridSpec2D
    geo = ArrayGeometry(kind="ura", num_elements=64, shape=(8, 8),
                        norm_spacing=0.5)
    A = ura_grid(geo, GridSpec2D(num_az=37, num_el=19))       # (G, 64) c64
    At = torch.from_numpy(np.concatenate([A.real, A.imag], -1)
                          .astype(np.float32))
    rng = np.random.default_rng(5)
    B = 40
    Vt = np.empty((B, 4, 128), np.float32)
    for b in range(B):
        src = A[rng.integers(0, A.shape[0], 2)]               # (2, 64)
        emb = np.concatenate([np.concatenate([src.real, src.imag], -1),
                              np.concatenate([-src.imag, src.real], -1)])
        Vt[b] = np.linalg.qr(emb.T.astype(np.float64))[0].T
    Vt = torch.from_numpy(Vt)
    nrm = (At * At).sum(-1)
    den = 1.0 / _k3_model(Vt, At, nrm)
    y = torch.einsum("bkn,gn->bkg", Vt.double(), At.double())
    den64 = nrm.double() - (y * y).sum(1)
    err = float((den.double() - den64.clamp_min(0)).abs().max())
    assert err <= 1e-5 * float(nrm.max()), err
    assert float(den64.min()) < 1e-3           # the scene reaches its nulls
