"""The 3×TF32 split and the operand layouts of the wideband fusion
kernel (doa_tpu_torch/csrc/wideband_scan.cu) on the CPU.

`tf32_split` is checked on its bits and as a product against float64.
The kernel itself runs only on the card; here `_kernel_model` reads the
wrapper's two layouts (`subspace_fragments`, `steering_tiles`) by the
kernel's own address arithmetic (wgmma's A register fragments, the
shared-memory descriptors' LBO/SBO, the epilogue's window and bin map)
and must give the plain version bit for bit on exact inputs and the
reference's spectrum on a scene."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from doa_tpu.ops.pallas.wideband_scan import wideband_fused_spectrum_pallas
from doa_tpu_torch.ops.cuda import wideband_scan as ws
from doa_tpu_torch.ops.cuda.scan_tc import tf32_split


def _normal_floats(n, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(n) * 10.0 ** rng.uniform(-30, 30, n)
    return torch.from_numpy(x.astype(np.float32))


def _rna11(x):
    """float64 reference: x rounded to 11 significant bits, half away from
    zero."""
    m, e = np.frexp(x.astype(np.float64))
    return np.sign(m) * np.floor(np.abs(m) * 2048.0 + 0.5) * 2.0 ** (e - 11)


def test_split_hi_lo_are_tf32_and_round_half_away():
    x = _normal_floats(1 << 16, 0)
    # ties: the low 13 bits exactly 0x1000, both signs
    ties = (torch.arange(1, 1025, dtype=torch.int32) << 13) | 0x1000
    ties = (ties + (127 << 23)).view(torch.float32)
    x = torch.cat([x, ties, -ties, torch.tensor([1.0, -2.0, 0.75])])
    hi, lo = tf32_split(x)
    assert int((hi.view(torch.int32) & 0x1FFF).abs().max()) == 0
    assert int((lo.view(torch.int32) & 0x1FFF).abs().max()) == 0
    np.testing.assert_array_equal(hi.numpy().astype(np.float64),
                                  _rna11(x.numpy()))
    r = x.numpy().astype(np.float64) - hi.numpy()   # exact in float64
    np.testing.assert_array_equal(lo.numpy().astype(np.float64), _rna11(r))


def test_split_sum_gives_x():
    """hi + lo == x wherever x has at most 22 significant bits (two TF32
    values carry 22) and lo is a normal float; otherwise within
    2^-22·|x|."""
    rng = np.random.default_rng(1)
    n = 1 << 16
    mant = (1 << 21) + rng.integers(0, 1 << 21, n)
    x22 = (rng.choice([-1.0, 1.0], n) * mant
           * 2.0 ** rng.integers(-100, 100, n)).astype(np.float32)
    x22 = torch.from_numpy(x22)
    hi, lo = tf32_split(x22)
    assert torch.equal(hi + lo, x22)
    x = _normal_floats(n, 2)
    hi, lo = tf32_split(x)
    err = np.abs(hi.numpy().astype(np.float64) + lo.numpy() - x.numpy())
    assert (err <= 2.0 ** -22 * np.abs(x.numpy())).all()


def _scene(F, B, n2, k2, G, seed):
    rng = np.random.default_rng(seed)
    V = np.linalg.qr(rng.standard_normal((F, B, n2, k2)))[0].astype(
        np.float32)
    At = rng.standard_normal((F, G, n2)).astype(np.float32)
    return V, At


def test_split_product_den_against_float64():
    """den from the triplicated product hi·hi + hi·lo + lo·hi (each
    product exact in float64, as the tensor cores form it) within
    2^-20·‖a‖² of den in float64 (test_fusion_matches_reference's scene)."""
    V, At = _scene(4, 10, 16, 4, 157, 4)
    Vt = torch.from_numpy(np.ascontiguousarray(np.swapaxes(V, -1, -2)))
    A = torch.from_numpy(At)
    vh, vl = (t.double() for t in tf32_split(Vt))
    ah, al = (t.double() for t in tf32_split(A))
    y3 = (torch.einsum("fbkn,fgn->fbkg", vh, ah)
          + torch.einsum("fbkn,fgn->fbkg", vh, al)
          + torch.einsum("fbkn,fgn->fbkg", vl, ah))
    y = torch.einsum("fbkn,fgn->fbkg", Vt.double(), A.double())
    nrm = (A.double() ** 2).sum(-1)
    den3 = nrm[:, None] - (y3 * y3).sum(2)
    den = nrm[:, None] - (y * y).sum(2)
    assert float(((den3 - den).abs() / nrm[:, None]).max()) <= 2.0 ** -20


def _kernel_model(Vt, At, nrm):
    """P as the kernel forms it: den by the mainloop's model
    (_kernel_den) from the wrapper's layouts, then pass B in FP32."""
    F, B, K2, n2 = Vt.shape
    den = _kernel_den(ws.subspace_fragments(Vt), ws.steering_tiles(At, K2),
                      nrm, K2, n2)[:, :B]
    acc = torch.zeros(den.shape[1:])
    for f in range(F):
        acc = acc + den[f].min(-1, keepdim=True).values / den[f]
    return acc * (1.0 / F)


def _kernel_den(Vf, tiles, nrm, K2, n2):
    """den f32[F, 32·tiles, G] as the shared mainloop (csrc/scan_tc.cuh)
    forms it from V' (Vf: F stacks of window tiles) and A' (tiles: F
    stacks of stretches): each thread's A fragments
    (lane (g, t) of warp w: rows 16w+g, 16w+g+8 at columns t, t+4 of a
    k-step), each warpgroup's B operand read through its descriptors (no
    swizzle: 16-byte core-matrix rows, LBO = GB/8·128 bytes a k-column,
    SBO = 128 a row group, the lo plane KP/4·LBO on), hi·hi and the two
    correction terms in their own sums (float64 here: exact on exact
    inputs), then the epilogue's map (row 16w+g+8h of m64 tile i is
    window 8w+g at k = 2i+h; column n of warpgroup h is bin h·NT+n), the
    sum over k in k order and max(nrm − Σ, tiny) in FP32."""
    F, G = nrm.shape
    NT, KP = ws.fusion_bins(K2), ws.fusion_kp(n2)
    GB, MT, S = 2 * NT, K2 // 2, KP // 8
    nT, nJ = Vf.shape[1], tiles.shape[1]
    V4 = Vf.reshape(F, nT, S, MT, 4, 32, 4)
    A = torch.zeros((F, nT, MT, 64, KP))
    for w in range(4):
        for lane in range(32):
            g, t = divmod(lane, 4)
            for e, (dr, dc) in enumerate(((0, 0), (8, 0), (0, 4), (8, 4))):
                A[:, :, :, 16 * w + g + dr, t + dc::8] = (
                    V4[:, :, :, :, w, lane, e].permute(0, 1, 3, 2))
    tiles = tiles.reshape(F, nJ, -1)
    lbo = GB // 8 * 128
    h, p, r, e, s, c, q = np.meshgrid(
        np.arange(2), np.arange(2), np.arange(NT // 8), np.arange(8),
        np.arange(S), np.arange(2), np.arange(4), indexing="ij")
    off = (h * (NT // 8) * 128 + 2 * s * lbo + p * (KP // 4) * lbo
           + c * lbo + r * 128 + e * 16 + q * 4) // 4
    idx = torch.zeros((2, 2, NT, KP), dtype=torch.int64)
    idx[h, p, 8 * r + e, 8 * s + 4 * c + q] = torch.from_numpy(off)
    Bm = tiles[:, :, idx].double()              # (F, nJ, h, p, NT, KP)
    ah, al = (t.double() for t in tf32_split(A))
    bh, bl = Bm[:, :, :, 0], Bm[:, :, :, 1]
    mm = "ftirk,fjhnk->ftijhrn"
    hh = torch.einsum(mm, ah, bh).float()
    cr = (torch.einsum(mm, ah, bl) + torch.einsum(mm, al, bh)).float()
    y = hh + cr                                  # (F, nT, MT, nJ, 2, 64, NT)
    y = y.reshape(F, nT, MT, nJ, 2, 4, 2, 8, NT)  # row = 16w + 8h' + g
    part = torch.zeros((F, nT, 4, 8, nJ, 2, NT))
    for k in range(K2):
        yk = y[:, :, k // 2, :, :, :, k % 2]      # (F, nT, nJ, 2, w, g, NT)
        part = part + (yk * yk).permute(0, 1, 4, 5, 2, 3, 6)
    part = part.reshape(F, nT * 32, nJ * GB)[:, :, :G]
    return torch.clamp_min(nrm[:, None, :] - part,
                           torch.finfo(torch.float32).tiny)


@pytest.mark.parametrize("k2,n2,B,G", [(2, 16, 37, 300), (4, 20, 100, 1000),
                                       (4, 128, 33, 129), (6, 24, 40, 70),
                                       (8, 16, 64, 65)])
def test_kernel_layouts_exact(k2, n2, B, G):
    """Quarter-step V, integer A, nrm above every Σy²: every sum exact, so
    the kernel's layouts and maps give the plain version bit for bit
    (chip_smoke's exact-input case; ragged B, G and 2N)."""
    rng = np.random.default_rng(k2 + n2)
    F = 3
    Vt = torch.from_numpy(rng.integers(-2, 3, (F, B, k2, n2))
                          .astype(np.float32) / 4)
    At = torch.from_numpy(rng.integers(-3, 4, (F, G, n2)).astype(np.float32))
    nrm = torch.from_numpy(300000.0 + rng.integers(0, 64, (F, G))
                           .astype(np.float32))
    P = _kernel_model(Vt, At, nrm)
    Pp = ws.wideband_fused_spectrum_plain(Vt, At, nrm)
    assert torch.equal(P, Pp)


@pytest.mark.parametrize("F,B,n2,k2,G", [(4, 10, 16, 4, 157),
                                         (3, 40, 24, 6, 100)])
def test_kernel_model_matches_reference(F, B, n2, k2, G):
    """The kernel's 3×TF32 arithmetic on its layouts against the
    reference's two-pass kernel (interpret mode) on orthonormal
    subspaces, at test_fusion_matches_reference's tolerance."""
    V, At = _scene(F, B, n2, k2, G, F)
    ref = np.asarray(wideband_fused_spectrum_pallas(
        jnp.asarray(V), jnp.asarray(At), block_b=8, interpret=True))
    Vt = torch.from_numpy(np.ascontiguousarray(np.swapaxes(V, -1, -2)))
    A = torch.from_numpy(At)
    P = _kernel_model(Vt, A, (A * A).sum(-1))
    np.testing.assert_allclose(P.numpy(), ref, rtol=2e-4, atol=2e-4)


def test_workspace_groups():
    """The den workspace: F·B·Gs floats under the cap; above it, windows
    in groups of a multiple of 32 (every group at least one tile)."""
    assert ws.workspace_bytes(16, 2048, 16471) == 16 * 2048 * 16472 * 4
    assert ws.workspace_bytes(16, 2048, 16471, cap=1 << 30) == (
        16 * 992 * 16472 * 4)
    assert ws.workspace_bytes(2, 100, 10, cap=1) == 2 * 32 * 12 * 4
