"""MUSIC subspace scan: the spectrum kernel K3 and the fused scan + peaks
kernel K2 (csrc/music_scan.cu).

Port of doa_tpu/ops/pallas/music_scan.py. For a window's orthonormal
signal subspace Vt f32[2K, 2N] (transposed, rows orthonormal) and the
embedded steering grid Ã f32[G, 2N] ([re; im] per row):

    den[g] = ‖a_g‖² − Σ_k (Vt_k · ã_g)²,    P[g] = 1 / max(den[g], tiny)

K3 runs the product on the tensor cores in 3×TF32, on the mainloop of the
wideband fusion kernel (ops/cuda/scan_tc.py gives its layouts: A' of the
grid once per grid, `steering_tiles`, which a pipeline builds once and
passes in; V' of the subspaces every call), with 2K in {2, 4, 6, 8}
(`scan_tc.tc_takes`). Other shapes (2K of 10 to 16, or 2N past the
mainloop's shared-memory cap) take K3's CUDA-core form, FP32 FMAs on
tiles of Aᵀ and Vt in shared memory (`fma_takes`); `scan_takes` is the
union of the two. K2 reads Vt f32[B, 2K, 2N] and Aᵀ f32[2N, G] as they are,
FP32 FMAs on the CUDA cores; it keeps the whole grid of one window in
shared memory and writes only (B, k) peak values and angles; its rule is
ops/peaks.py::find_local_max on Pn = dmin/den (normalisation is free:
P/max P = dmin/den), with the reference's sentinels: _NEG marks "no
peak", and a bin past the grid never exists here (no padding), so it is
never a peak nor the minimum — what the TPU kernel's _PAD_NRM ensured.
"""

from __future__ import annotations

import ctypes

import torch

from doa_tpu_torch import _build
from doa_tpu_torch.cpx import fp32_matmuls
from doa_tpu_torch.ops.cuda.scan_tc import (SMEM_MAX, WINDOW_TILE,
                                            fusion_bins, fusion_kp,
                                            steering_tiles,
                                            subspace_fragments, tc_takes)

_NEG = -1e30            # "no peak" sentinel
MAX_FUSED_K = 4         # peaks per window the fused kernel returns
MAX_FUSED_G = 8192      # grid bins the fused kernel keeps in shared memory
#                         (2·G floats ≤ 64 KiB of the 227 KiB a block has)
SCAN_WAVES = 4          # K3's grid: about this many blocks an SM
FMA_GT, FMA_BT = 128, 16  # K3's CUDA-core form: bins, windows a block
_P = ctypes.c_void_p
_I = ctypes.c_int
_SIG = {
    "doa_music_scan": [_P, _P, _P, _P] + [_I] * 6 + [_P],
    "doa_music_scan_fma": [_P, _P, _P, _P] + [_I] * 4 + [_P],
    "doa_music_scan_peaks": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                             ctypes.c_float, ctypes.c_float, _I, _P],
}


def _check_args(Vt, At_emb, nrm):
    if Vt.dim() != 3 or At_emb.dim() != 2 or Vt.shape[-1] != At_emb.shape[-1]:
        raise ValueError(f"need Vt[B, 2K, 2N] and At_emb[G, 2N], got "
                         f"{tuple(Vt.shape)} and {tuple(At_emb.shape)}")
    if Vt.dtype != torch.float32 or At_emb.dtype != torch.float32:
        raise ValueError("Vt and At_emb must be float32")
    if Vt.device != At_emb.device:
        raise ValueError(f"Vt on {Vt.device}, At_emb on {At_emb.device}")
    if nrm is None:
        nrm = (At_emb * At_emb).sum(dim=-1)
    return nrm


def music_den_plain(Vt: torch.Tensor, At_emb: torch.Tensor,
                    nrm: torch.Tensor) -> torch.Tensor:
    """den f32[B, G] = max(nrm − Σ_k (Vt·ã)², tiny), in true FP32."""
    with fp32_matmuls():
        y = torch.matmul(Vt, At_emb.T)                  # (B, 2K, G)
    den = nrm - (y * y).sum(dim=-2)
    return den.clamp_min(torch.finfo(torch.float32).tiny)


def music_scan_plain(Vt, At_emb, nrm=None):
    """Plain PyTorch version of K3 → P f32[B, G]."""
    nrm = _check_args(Vt, At_emb, nrm)
    return 1.0 / music_den_plain(Vt, At_emb, nrm)


def fma_takes(k2: int, n2: int) -> bool:
    """The shapes K3's CUDA-core form takes: Aᵀ's tile of FMA_GT bins and
    FMA_BT windows' Vt within a block's shared memory."""
    return k2 >= 1 and 4 * n2 * (FMA_GT + FMA_BT * k2) <= SMEM_MAX


def scan_takes(k2: int, n2: int) -> bool:
    """The shapes K3 is built for: the tensor-core mainloop's
    (scan_tc.tc_takes: 2K in {2, 4, 6, 8}, 2N ≤ 224 at 2K ≤ 4 and ≤ 448 at
    2K = 6, 8) and the CUDA-core form's (fma_takes: 2N ≤ 151 at 2K = 16)."""
    return tc_takes(k2, n2) or fma_takes(k2, n2)


def scan_tiles(At_emb: torch.Tensor, k2: int) -> torch.Tensor | None:
    """K3's A' of the grid At_emb f32[G, 2N] at 2K = k2 (steering_tiles of
    a one-grid stack): made once per grid, passed to music_scan; None
    where K3 runs its CUDA-core form, which reads At_emb as it is."""
    if not tc_takes(k2, At_emb.shape[-1]):
        return None
    return steering_tiles(At_emb[None], k2)[0]


def window_groups(stretches: int, tiles: int, sms: int):
    """K3's grid rule → (window groups, tiles a group): about SCAN_WAVES
    blocks for each of the card's `sms` SMs, the window tiles split
    evenly, so the last of the waves is nearly full."""
    want = min(tiles, -(-SCAN_WAVES * sms // stretches))
    per = -(-tiles // want)
    return -(-tiles // per), per


def music_scan(Vt: torch.Tensor, At_emb: torch.Tensor,
               nrm: torch.Tensor | None = None,
               tiles: torch.Tensor | None = None) -> torch.Tensor:
    """K3: Vt f32[B, 2K, 2N], At_emb f32[G, 2N], nrm f32[G] = ‖a_g‖²
    (computed if None), tiles = scan_tiles(At_emb, 2K) (made here if None)
    → unnormalised pseudospectrum P f32[B, G].

    A CPU tensor takes the plain version; a CUDA tensor launches the
    tensor-core form where tc_takes(2K, 2N) holds, else the CUDA-core form
    where fma_takes does, and raises otherwise or if the launch fails."""
    nrm = _check_args(Vt, At_emb, nrm)
    if Vt.device.type == "cpu":
        return music_scan_plain(Vt, At_emb, nrm)
    if not Vt.is_cuda:
        raise ValueError(f"unsupported device {Vt.device}")
    B, K2, n2 = Vt.shape
    G = At_emb.shape[0]
    nrm = nrm.to(torch.float32).contiguous()
    stream = torch.cuda.current_stream(Vt.device).cuda_stream
    P = torch.empty((B, G), dtype=torch.float32, device=Vt.device)
    lib = _build.load("music_scan", _SIG)
    if tc_takes(K2, n2):
        GB, KP = 2 * fusion_bins(K2), fusion_kp(n2)
        if tiles is None:
            tiles = scan_tiles(At_emb, K2)
        elif (tuple(tiles.shape) != (-(-G // GB), 2, KP // 4, GB // 8, 8, 4)
              or tiles.device != Vt.device or not tiles.is_contiguous()):
            raise ValueError(f"tiles {tuple(tiles.shape)} on {tiles.device} "
                             f"are not scan_tiles of a ({G}, {n2}) grid at "
                             f"2K = {K2}")
        Vf = subspace_fragments(Vt[None])
        nT = -(-B // WINDOW_TILE)
        sms = torch.cuda.get_device_properties(
            Vt.device).multi_processor_count
        _, per = window_groups(-(-G // GB), nT, sms)
        err = lib.doa_music_scan(
            Vf.data_ptr(), tiles.data_ptr(), nrm.data_ptr(), P.data_ptr(), B,
            K2, fusion_bins(K2), KP, G, per, stream)
        _build.check(err, "doa_music_scan")
    elif fma_takes(K2, n2):
        Vt = Vt.contiguous()
        At_T = At_emb.T.contiguous()
        err = lib.doa_music_scan_fma(Vt.data_ptr(), At_T.data_ptr(),
                                     nrm.data_ptr(), P.data_ptr(), B, K2, n2,
                                     G, stream)
        _build.check(err, "doa_music_scan_fma")
    else:
        raise ValueError(f"music_scan kernel does not take 2K = {K2} at "
                         f"2N = {n2} (scan_takes)")
    music_scan.launches += 1
    return P


music_scan.launches = 0


def music_scan_peaks_plain(Vt, At_emb, k: int, x_min: float, x_max: float,
                           refine: bool = True, nrm=None):
    """Plain PyTorch version of K2 → (vals, locs) each f32[B, k]: the
    exact rule of doa_tpu's _scan_peaks_kernel."""
    nrm = _check_args(Vt, At_emb, nrm)
    den = music_den_plain(Vt, At_emb, nrm)
    B, G = den.shape
    dmin = den.min(dim=-1, keepdim=True).values
    Pn = dmin / den
    iota = torch.arange(G, device=den.device).expand(B, G)
    left = torch.cat([Pn[:, :1], Pn[:, :-1]], dim=1)
    right = torch.cat([Pn[:, 1:], Pn[:, -1:]], dim=1)
    interior = (iota >= 1) & (iota <= G - 2)
    neg = torch.full_like(Pn, _NEG)
    masked = torch.where(interior & (Pn > left) & (Pn >= right), Pn, neg)
    gidx = torch.where(den == dmin, iota, G).min(dim=-1, keepdim=True).values
    vals_l, idx_l = [], []
    for _ in range(k):
        v = masked.max(dim=-1, keepdim=True).values
        i = torch.where(masked == v, iota, G).min(dim=-1, keepdim=True).values
        masked = torch.where(iota == i, neg, masked)
        vals_l.append(v)
        idx_l.append(i)
    vals = torch.cat(vals_l, dim=-1)
    idx = torch.cat(idx_l, dim=-1)
    have_any = vals[:, :1] > 0.5 * _NEG
    best_val = torch.where(have_any, vals[:, :1], torch.ones_like(dmin))
    best_idx = torch.where(have_any, idx[:, :1], gidx)
    valid = vals > 0.5 * _NEG
    vals = torch.where(valid, vals, best_val)
    idx = torch.where(valid, idx, best_idx)
    frac = idx.to(torch.float32)
    if refine:
        pick = lambda off: torch.gather(  # noqa: E731
            den, 1, (idx + off).clamp(0, G - 1))
        q0, qm, qp = pick(0), pick(-1), pick(1)
        dden = qm - 2.0 * q0 + qp
        d = torch.where(dden.abs() > 0, 0.5 * (qm - qp) / dden,
                        torch.zeros_like(dden))
        d = d.clamp(-0.5, 0.5)
        frac = frac + torch.where((idx > 0) & (idx < G - 1), d,
                                  torch.zeros_like(d))
    dx = (x_max - x_min) / (G - 1)
    return vals, x_min + frac * dx


def music_scan_peaks(Vt: torch.Tensor, At_emb: torch.Tensor, k: int,
                     x_min: float, x_max: float, refine: bool = True,
                     nrm: torch.Tensor | None = None):
    """K2: fused scan + normalise + peaks → (vals, locs) each f32[B, k];
    the (B, G) spectrum never leaves shared memory. Needs
    k ≤ MAX_FUSED_K and 3 ≤ G ≤ MAX_FUSED_G (the pipeline's size rule
    picks K3 + find_local_max otherwise).

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel and raises if that fails."""
    nrm = _check_args(Vt, At_emb, nrm)
    G = At_emb.shape[0]
    if not 1 <= k <= MAX_FUSED_K or not 3 <= G <= MAX_FUSED_G:
        raise ValueError(f"fused scan+peaks needs 1 ≤ k ≤ {MAX_FUSED_K} and "
                         f"3 ≤ G ≤ {MAX_FUSED_G} (k={k}, G={G})")
    if Vt.device.type == "cpu":
        return music_scan_peaks_plain(Vt, At_emb, k, x_min, x_max, refine,
                                      nrm)
    if not Vt.is_cuda:
        raise ValueError(f"unsupported device {Vt.device}")
    B, K2, n2 = Vt.shape
    Vt = Vt.contiguous()
    At_T = At_emb.T.contiguous()
    nrm = nrm.to(torch.float32).contiguous()
    lib = _build.load("music_scan", _SIG)
    vals = torch.empty((B, k), dtype=torch.float32, device=Vt.device)
    locs = torch.empty((B, k), dtype=torch.float32, device=Vt.device)
    dx = (x_max - x_min) / (G - 1)
    err = lib.doa_music_scan_peaks(
        Vt.data_ptr(), At_T.data_ptr(), nrm.data_ptr(), vals.data_ptr(),
        locs.data_ptr(), B, K2, n2, G, k, x_min, dx, int(refine),
        torch.cuda.current_stream(Vt.device).cuda_stream)
    _build.check(err, "doa_music_scan_peaks")
    music_scan_peaks.launches += 1
    return vals, locs


music_scan_peaks.launches = 0
