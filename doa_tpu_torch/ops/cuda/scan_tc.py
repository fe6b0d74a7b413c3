"""The operand layouts and the 3×TF32 split of the tensor-core MUSIC
scan (csrc/scan_tc.cuh), shared by the wideband fusion kernel 5
(ops/cuda/wideband_scan.py) and the spectrum kernel K3
(ops/cuda/music_scan.py).

The mainloop multiplies the windows' subspaces Vt f32[B, 2K, 2N] by the
embedded steering Ã f32[G, 2N] in 3×TF32 on wgmma: A' (the steering,
split into hi and lo planes and laid out per stretch of bins as the
shared-memory descriptors read it) once per steering stack, V' (the
subspaces in wgmma's register-fragment order, split in the kernel) every
call. 2N is padded with zero columns to a multiple of 16, windows to a
multiple of 32 and bins to a whole stretch; a zero column adds 0 to every
product, so exact inputs stay exact.
"""

from __future__ import annotations

import torch

TC_K2 = (2, 4, 6, 8)            # subspace ranks the mainloop is built for
WINDOW_TILE = 32                # windows a tile of V'
SMEM_MAX = 232448               # a block's shared memory on sm_90


def fusion_bins(k2: int) -> int:
    """Bins a warpgroup of the mainloop covers at 2K = k2 (csrc's bins_of);
    a block covers twice as many."""
    return 64 if k2 <= 4 else 32


def fusion_kp(n2: int) -> int:
    """The contraction 2N padded to whole pairs of the mainloop's k-steps
    (16)."""
    return -(-n2 // 16) * 16


def smem_bytes(k2: int, n2: int) -> int:
    """A block's shared memory (csrc's smem_of): barrier and nrm (1 KiB),
    then the A' stretch of 2·fusion_bins(k2) bins, both planes."""
    return 1024 + 8 * fusion_kp(n2) * 2 * fusion_bins(k2)


def tc_takes(k2: int, n2: int) -> bool:
    """The shapes the mainloop is built for: 2K in TC_K2 and an A'
    stretch that fits a block's shared memory (2N ≤ 224 at 2K ≤ 4, ≤ 448
    at 2K = 6, 8)."""
    return k2 in TC_K2 and smem_bytes(k2, n2) <= SMEM_MAX


def most_n2(k2: int) -> int:
    """The largest 2N the mainloop takes at 2K = k2."""
    return (SMEM_MAX - 1024) // (16 * fusion_bins(k2)) // 16 * 16



def tf32_split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """f32 x → (hi, lo), both TF32 values (the low 13 bits zero): hi =
    x rounded to 10 mantissa bits, half away from zero (cvt.rna.tf32.f32),
    lo = x − hi rounded the same way. hi·b + (hi·b_lo + lo·b) is the
    3×TF32 product; hi + lo is x to within 2^-22·|x| (exactly where x has
    at most 22 significant bits). The kernels split their V' fragments
    with the same bit operations."""
    def rna(v):
        return ((v.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)
    x = x.contiguous()
    hi = rna(x)
    return hi, rna(x - hi)


def steering_tiles(At_emb: torch.Tensor, k2: int) -> torch.Tensor:
    """The mainloop's A' of At_emb f32[F, G, 2N] at 2K = k2: split by
    tf32_split and laid out per stretch of GB = 2·fusion_bins(k2) bins as
    [plane hi, lo][KP/4 k-columns][GB/8 row groups][8 rows][4], zero past
    G and 2N → f32[F, ceil(G/GB), 2, KP/4, GB/8, 8, 4]."""
    F, G, n2 = At_emb.shape
    GB, KP = 2 * fusion_bins(k2), fusion_kp(n2)
    nJ = -(-G // GB)
    planes = At_emb.new_zeros((F, nJ * GB, 2, KP))
    planes[:, :G, 0, :n2], planes[:, :G, 1, :n2] = tf32_split(At_emb)
    # g = GB·j + 8r + row, n = 4c + e
    return planes.view(F, nJ, GB // 8, 8, 2, KP // 4, 4).permute(
        0, 1, 4, 5, 2, 3, 6).contiguous()


def subspace_fragments(Vt: torch.Tensor) -> torch.Tensor:
    """The mainloop's V' of Vt f32[F, B, 2K, 2N]: per tile of 32 windows the
    A fragments of wgmma's register layout, [k-step s][m64 tile i][warp w]
    [lane (g, t)][4] with (v[8w+g, 2i, 8s+t], v[8w+g, 2i+1, 8s+t],
    v[8w+g, 2i, 8s+t+4], v[8w+g, 2i+1, 8s+t+4]), zero past B and 2N →
    f32[F, ceil(B/32), KP/8, 2K/2, 4, 32, 4]."""
    F, B, K2, n2 = Vt.shape
    KP, Bp = fusion_kp(n2), -(-B // WINDOW_TILE) * WINDOW_TILE
    V = Vt.contiguous()
    if (Bp, KP) != (B, n2):
        V = Vt.new_zeros((F, Bp, K2, KP))
        V[:, :B, :, :n2] = Vt
    # b = 32T + 8w + g, k = 2i + h, n = 8s + 4e + t
    V = V.view(F, Bp // WINDOW_TILE, 4, 8, K2 // 2, 2, KP // 8, 2, 4)
    return V.permute(0, 1, 6, 4, 2, 3, 8, 7, 5).contiguous().view(
        F, Bp // WINDOW_TILE, KP // 8, K2 // 2, 4, 32, 4)
