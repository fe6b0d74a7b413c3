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
union of the two.

K2 writes only (B, k) peak values and angles; its rule is
ops/peaks.py::find_local_max on Pn = dmin/den (normalisation is free:
P/max P = dmin/den), with the reference's sentinels: _NEG marks "no
peak", and a bin past the grid never exists here (no padding), so it is
never a peak nor the minimum — what the TPU kernel's _PAD_NRM ensured.
Its tensor-core form runs K3's mainloop on the same A' (V' it stages
from Vt itself) and keeps den of a tile of 32 windows × G bins in shared
memory through the peak rule (`peaks_tc_takes`: the mainloop's shapes
with that tile within a block's shared memory); its CUDA-core form, one
window a block in FP32 FMAs on Aᵀ f32[2N, G], takes the other shapes
(`peaks_fma_takes`); `peaks_takes` is the union. `peaks_tiles` makes
the form's grid operand (A' or Aᵀ) once per grid.
"""

from __future__ import annotations

import ctypes
import functools

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
    "doa_music_scan_peaks_tc": [_P, _P, _P, _P, _P] + [_I] * 7
                               + [ctypes.c_float, ctypes.c_float, _I, _I,
                                  _P],
    "doa_music_scan_peaks_fma": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                 ctypes.c_float, ctypes.c_float, _I, _P],
}
DEN_PAD = 8             # K2's den rows in shared memory: nJ·GB + 8 floats


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


@functools.lru_cache(maxsize=None)
def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _check_tiles(tiles, shape, Vt, what, G, n2, k2):
    if (tuple(tiles.shape) != shape or tiles.device != Vt.device
            or not tiles.is_contiguous()):
        raise ValueError(f"tiles {tuple(tiles.shape)} on {tiles.device} "
                         f"are not {what} of a ({G}, {n2}) grid at "
                         f"2K = {k2}")


def music_den_plain(Vt: torch.Tensor, At_emb: torch.Tensor,
                    nrm: torch.Tensor) -> torch.Tensor:
    """den f32[B, G] = max(nrm − Σ_k (Vt·ã)², tiny).

    y = Vt·ã is rounded once to FP32 from a float64 sum: each product of
    two FP32 values is exact in float64 and the sum's error over 2N terms
    is far below half an FP32 unit, so y is the nearest FP32 value
    whatever order a BLAS sums in. An FP32 product sums in the BLAS's
    own order and can sit an FP32 unit off, enough to tie two nulls 1.3
    units of ‖a‖² apart that the reference's kernel tells apart. Then
    Σ_k y_k² in FP32 in k order and nrm − Σ in FP32."""
    with fp32_matmuls():
        y = torch.matmul(Vt.double(), At_emb.T.double()).float()
    part = y[..., 0, :] * y[..., 0, :]                  # (B, G)
    for i in range(1, y.shape[-2]):
        part = part + y[..., i, :] * y[..., i, :]
    den = nrm - part
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
        _check_tiles(tiles, (-(-G // GB), 2, KP // 4, GB // 8, 8, 4), Vt,
                     "scan_tiles", G, n2, K2)
        Vf = subspace_fragments(Vt[None])
        nT = -(-B // WINDOW_TILE)
        _, per = window_groups(-(-G // GB), nT, _sm_count(Vt.device))
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
    _build.count("music_scan")
    return P


def music_scan_peaks_plain(Vt, At_emb, k: int, x_min: float, x_max: float,
                           refine: bool = True, nrm=None):
    """Plain PyTorch version of K2 → (vals, locs) each f32[B, k]: the
    exact rule of doa_tpu's _scan_peaks_kernel."""
    nrm = _check_args(Vt, At_emb, nrm)
    return peaks_from_den_plain(music_den_plain(Vt, At_emb, nrm), k, x_min,
                                x_max, refine)


def peaks_from_den_plain(den, k: int, x_min: float, x_max: float,
                         refine: bool = True):
    """K2's peak rule on den f32[B, G] → (vals, locs) each f32[B, k]."""
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


def peaks_smem_bytes(k2: int, n2: int, G: int) -> int:
    """Shared memory of K2's tensor-core form (csrc's peaks_smem_of):
    barriers and the dmin merge (1 KiB), two A' stretches, a window
    tile's V', nrm and the den tile of 32 rows of Gp + DEN_PAD floats,
    Gp = G in whole stretches."""
    GB, KP = 2 * fusion_bins(k2), fusion_kp(n2)
    Gp = -(-G // GB) * GB
    return (1024 + 2 * 8 * KP * GB + 4 * WINDOW_TILE * k2 * KP + 4 * Gp
            + 4 * WINDOW_TILE * (Gp + DEN_PAD))


def peaks_tc_takes(k2: int, n2: int, G: int) -> bool:
    """The shapes K2's tensor-core form takes: the mainloop's (tc_takes)
    with the den tile, the two-stretch ring, V' and nrm within a block's
    shared memory (G ≤ 1024 at the headline's 2K = 4, 2N = 32)."""
    return (tc_takes(k2, n2) and 3 <= G <= 2048
            and peaks_smem_bytes(k2, n2, G) <= SMEM_MAX)


def peaks_fma_takes(k2: int, n2: int, G: int) -> bool:
    """The shapes K2's CUDA-core form takes: one window a block with den,
    its masked row and the window's Vt in shared memory, G ≤ MAX_FUSED_G."""
    return (k2 >= 1 and n2 >= 1 and 3 <= G <= MAX_FUSED_G
            and 4 * (2 * G + k2 * n2) <= SMEM_MAX)


def scan_peaks_form(k2: int, n2: int, G: int) -> str | None:
    """The form of K2 that takes (2K, 2N, G): "tc" (the tensor-core form,
    where peaks_tc_takes), else "fma" (the CUDA-core form, where
    peaks_fma_takes), or None for a shape K2 does not take."""
    if peaks_tc_takes(k2, n2, G):
        return "tc"
    return "fma" if peaks_fma_takes(k2, n2, G) else None


def peaks_takes(k2: int, n2: int, G: int) -> bool:
    """The shapes K2 is built for: those scan_peaks_form gives a form."""
    return scan_peaks_form(k2, n2, G) is not None


def peaks_tiles(At_emb: torch.Tensor, k2: int) -> torch.Tensor:
    """K2's grid operand at 2K = k2, made once per grid and passed to
    music_scan_peaks: A' (scan_tiles) where the tensor-core form takes the
    shape, else Aᵀ f32[2N, G] for the CUDA-core form."""
    G, n2 = At_emb.shape
    if peaks_tc_takes(k2, n2, G):
        return scan_tiles(At_emb, k2)
    return At_emb.T.contiguous()


def _peaks_tc(Vt, tiles, nrm, k, x_min, dx, refine, lib=None):
    """K2's tensor-core form on the card → (vals, locs); nrm f32[G]
    contiguous, tiles = scan_tiles(At_emb, 2K); `lib` another build of
    this source's C ABI (the package's if None). No launch count."""
    B, K2, n2 = Vt.shape
    G = nrm.shape[0]
    GB, KP = 2 * fusion_bins(K2), fusion_kp(n2)
    _check_tiles(tiles, (-(-G // GB), 2, KP // 4, GB // 8, 8, 4), Vt,
                 "scan_tiles", G, n2, K2)
    Vt = Vt.contiguous()
    vals = torch.empty((B, k), dtype=torch.float32, device=Vt.device)
    locs = torch.empty((B, k), dtype=torch.float32, device=Vt.device)
    lib = lib or _build.load("music_scan", _SIG)
    err = lib.doa_music_scan_peaks_tc(
        Vt.data_ptr(), tiles.data_ptr(), nrm.data_ptr(), vals.data_ptr(),
        locs.data_ptr(), B, K2, fusion_bins(K2), n2, KP, G, k, x_min, dx,
        int(refine), min(-(-B // WINDOW_TILE), _sm_count(Vt.device)),
        torch.cuda.current_stream(Vt.device).cuda_stream)
    _build.check(err, "doa_music_scan_peaks_tc")
    return vals, locs


def _peaks_fma(Vt, At_T, nrm, k, x_min, dx, refine, lib=None):
    """K2's CUDA-core form on the card → (vals, locs); nrm f32[G]
    contiguous, At_T = Aᵀ f32[2N, G]; `lib` as _peaks_tc's. No launch
    count."""
    B, K2, n2 = Vt.shape
    G = nrm.shape[0]
    _check_tiles(At_T, (n2, G), Vt, "Aᵀ", G, n2, K2)
    Vt = Vt.contiguous()
    vals = torch.empty((B, k), dtype=torch.float32, device=Vt.device)
    locs = torch.empty((B, k), dtype=torch.float32, device=Vt.device)
    lib = lib or _build.load("music_scan", _SIG)
    err = lib.doa_music_scan_peaks_fma(
        Vt.data_ptr(), At_T.data_ptr(), nrm.data_ptr(), vals.data_ptr(),
        locs.data_ptr(), B, K2, n2, G, k, x_min, dx, int(refine),
        torch.cuda.current_stream(Vt.device).cuda_stream)
    _build.check(err, "doa_music_scan_peaks_fma")
    return vals, locs


def music_scan_peaks(Vt: torch.Tensor, At_emb: torch.Tensor, k: int,
                     x_min: float, x_max: float, refine: bool = True,
                     nrm: torch.Tensor | None = None,
                     tiles: torch.Tensor | None = None):
    """K2: fused scan + normalise + peaks → (vals, locs) each f32[B, k];
    the (B, G) spectrum never leaves the chip. Needs k ≤ MAX_FUSED_K and
    3 ≤ G ≤ MAX_FUSED_G (the pipeline's size rule picks K3 +
    find_local_max otherwise); tiles = peaks_tiles(At_emb, 2K) (made here
    if None).

    A CPU tensor takes the plain version; a CUDA tensor launches the form
    scan_peaks_form(2K, 2N, G) names, counted as ("music_scan_peaks",
    form), and raises where it names none or if the launch fails."""
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
    form = scan_peaks_form(K2, n2, G)
    if form is None:
        raise ValueError(f"music_scan_peaks kernel does not take 2K = {K2} "
                         f"at 2N = {n2}, G = {G} (peaks_takes)")
    if tiles is None:
        tiles = peaks_tiles(At_emb, K2)
    nrm = nrm.to(torch.float32).contiguous()
    dx = (x_max - x_min) / (G - 1)
    launch = _peaks_tc if form == "tc" else _peaks_fma
    out = launch(Vt, tiles, nrm, k, x_min, dx, refine)
    _build.count("music_scan_peaks", form)
    return out
