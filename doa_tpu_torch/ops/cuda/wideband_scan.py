"""Fused wideband subband scan + incoherent fusion (csrc/wideband_scan.cu).

Port of doa_tpu/ops/pallas/wideband_scan.py::wideband_fused_spectrum_pallas.
For per-subband signal subspaces Vt f32[F, B, 2K, 2N] (the port's
transposed layout: rows orthonormal; the reference's V f32[F, B, 2N, 2K]
swapped) and the embedded per-subband steering Ã f32[F, G, 2N]:

    den_f[b, g] = max(‖a_fg‖² − Σ_k (Vt_fb[k] · ã_fg)², tiny)
    P[b, g]     = (1/F) Σ_f dmin_f[b] / den_f[b, g],  dmin_f = min_g den_f

— the mean over subbands of the max-normalised reciprocal MUSIC spectra
(P_f / max P_f = dmin_f / den_f). On the card each den is computed once,
its products on the tensor cores in 3×TF32 (scan_tc.tf32_split), into a
workspace f32[F, B, G] that a second kernel streams into P; the plain
version is true FP32.
"""

from __future__ import annotations

import ctypes

import torch

from doa_tpu_torch import _build
from doa_tpu_torch.ops.cuda.music_scan import music_den_plain
from doa_tpu_torch.ops.cuda.scan_tc import (
    TC_K2, WINDOW_TILE, fusion_bins, fusion_kp, most_n2, steering_tiles,
    subspace_fragments, tc_takes)

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIG = {"doa_fusion_den": [_P, _P, _P, _P, _P] + [_I] * 9 + [_P],
        "doa_fusion_sum": [_P, _P, _P] + [_I] * 6 + [_P]}
FUSION_K2 = TC_K2              # subspace ranks the kernel is built for
# the most workspace (den, F·B·G f32) one launch holds; beyond it the
# windows run in groups (dmin is per window, so grouping is exact)
WORKSPACE_CAP = 4 << 30


def fusion_takes(k2: int, n2: int) -> bool:
    """The shapes kernel 5 is built for: its mainloop's (scan_tc.tc_takes:
    2K in FUSION_K2, 2N under the shared-memory cap)."""
    return tc_takes(k2, n2)


def _check_args(Vt, At_emb, nrm):
    if (Vt.dim() != 4 or At_emb.dim() != 3 or Vt.shape[0] != At_emb.shape[0]
            or Vt.shape[-1] != At_emb.shape[-1]):
        raise ValueError(f"need Vt[F, B, 2K, 2N] and At_emb[F, G, 2N], got "
                         f"{tuple(Vt.shape)} and {tuple(At_emb.shape)}")
    if Vt.dtype != torch.float32 or At_emb.dtype != torch.float32:
        raise ValueError("Vt and At_emb must be float32")
    if Vt.device != At_emb.device:
        raise ValueError(f"Vt on {Vt.device}, At_emb on {At_emb.device}")
    if nrm is None:
        nrm = (At_emb * At_emb).sum(dim=-1)
    if tuple(nrm.shape) != tuple(At_emb.shape[:2]):
        raise ValueError(f"nrm {tuple(nrm.shape)} does not fit "
                         f"{tuple(At_emb.shape[:2])}")
    return nrm


def wideband_fused_spectrum_plain(Vt, At_emb, nrm=None,
                                  return_dmin: bool = False):
    """Plain PyTorch version → P f32[B, G] (and, under return_dmin, dmin
    f32[F, B]): a loop over subbands of music_den_plain, accumulating
    dmin_f / den_f."""
    nrm = _check_args(Vt, At_emb, nrm)
    F = Vt.shape[0]
    acc, mins = None, []
    for f in range(F):
        den = music_den_plain(Vt[f], At_emb[f], nrm[f])
        dm = den.min(dim=-1, keepdim=True).values
        mins.append(dm[:, 0])
        q = dm / den
        acc = q if acc is None else acc + q
    P = acc * (1.0 / F)
    return (P, torch.stack(mins)) if return_dmin else P


def _tiles_of(At_emb, k2):
    """steering_tiles(At_emb, k2), made once per stack: kept on the tensor
    while it is unchanged (its version counter), as the pipeline hands the
    same steering stack to every call."""
    key = (At_emb._version, k2)
    kept = getattr(At_emb, "_fusion_tiles", None)
    if kept is None or kept[0] != key:
        kept = (key, steering_tiles(At_emb, k2))
        At_emb._fusion_tiles = kept
    return kept[1]


def workspace_bytes(F: int, B: int, G: int,
                    cap: int = WORKSPACE_CAP) -> int:
    """Bytes of the den workspace a call at (F, B, G) allocates."""
    return F * _group_windows(F, B, G, cap) * _row(G) * 4


def _row(G):
    return -(-G // 4) * 4


def _group_windows(F, B, G, cap):
    per = F * _row(G) * 4
    return min(B, max(WINDOW_TILE, cap // per // WINDOW_TILE * WINDOW_TILE))


def _fused_cuda(Vt, At_emb, nrm, cap=WORKSPACE_CAP, return_dmin=False):
    F, B, K2, n2 = Vt.shape
    G = At_emb.shape[1]
    KP = fusion_kp(n2)
    Af = _tiles_of(At_emb, K2)
    Vf = subspace_fragments(Vt)
    nrm = nrm.to(device=Vt.device, dtype=torch.float32).contiguous()
    Gs, nb_max = _row(G), _group_windows(F, B, G, cap)
    den = torch.empty((F * nb_max * Gs,), dtype=torch.float32,
                      device=Vt.device)
    dmin = torch.full((F, B), float("inf"), dtype=torch.float32,
                      device=Vt.device)
    P = torch.empty((B, G), dtype=torch.float32, device=Vt.device)
    lib = _build.load("wideband_scan", _SIG)
    stream = torch.cuda.current_stream(Vt.device).cuda_stream
    for b0 in range(0, B, nb_max):
        nb = min(nb_max, B - b0)
        _build.check(lib.doa_fusion_den(
            Vf.data_ptr(), Af.data_ptr(), nrm.data_ptr(), den.data_ptr(),
            dmin.data_ptr(), F, B, b0, nb, K2, fusion_bins(K2), KP, G, Gs,
            stream), "doa_fusion_den")
        _build.check(lib.doa_fusion_sum(
            den.data_ptr(), dmin.data_ptr(), P.data_ptr(), F, B, b0, nb, G,
            Gs, stream), "doa_fusion_sum")
    return (P, dmin) if return_dmin else P


def wideband_fused_spectrum(Vt: torch.Tensor, At_emb: torch.Tensor,
                            nrm: torch.Tensor | None = None,
                            return_dmin: bool = False):
    """The fusion kernel: Vt f32[F, B, 2K, 2N], At_emb f32[F, G, 2N],
    nrm f32[F, G] = ‖a_fg‖² (computed if None) → fused spectrum
    P f32[B, G]; under return_dmin also dmin f32[F, B], each subband's
    min_g den_f, the values pass A writes for pass B (the same launch:
    the hierarchical scan's refine reads them). 2K must be one of
    FUSION_K2; 2N at most 224 (2K ≤ 4) or 448.

    A CPU tensor takes the plain version; a CUDA tensor runs the kernel
    and raises if that fails. It counts one launch a call (_build.count),
    which covers the split and layout of the operands, pass A (den and
    dmin) and pass B (P) of every window group."""
    nrm = _check_args(Vt, At_emb, nrm)
    if Vt.device.type == "cpu":
        return wideband_fused_spectrum_plain(Vt, At_emb, nrm, return_dmin)
    if not Vt.is_cuda:
        raise ValueError(f"unsupported device {Vt.device}")
    K2, n2 = Vt.shape[2:]
    if not fusion_takes(K2, n2):
        raise ValueError(f"wideband_fusion kernel takes 2K in {FUSION_K2} "
                         f"and 2N ≤ {most_n2(K2)} there, got 2K = {K2}, "
                         f"2N = {n2}")
    out = _fused_cuda(Vt, At_emb, nrm, return_dmin=return_dmin)
    _build.count("wideband_fusion")
    return out
