"""Fused wideband subband scan + incoherent fusion (csrc/wideband_scan.cu).

Port of doa_tpu/ops/pallas/wideband_scan.py::wideband_fused_spectrum_pallas.
For per-subband signal subspaces Vt f32[F, B, 2K, 2N] (the port's
transposed layout: rows orthonormal; the reference's V f32[F, B, 2N, 2K]
swapped) and the embedded per-subband steering Ã f32[F, G, 2N]:

    den_f[b, g] = max(‖a_fg‖² − Σ_k (Vt_fb[k] · ã_fg)², tiny)
    P[b, g]     = (1/F) Σ_f dmin_f[b] / den_f[b, g],  dmin_f = min_g den_f

— the mean over subbands of the max-normalised reciprocal MUSIC spectra
(P_f / max P_f = dmin_f / den_f), in two passes; den never leaves the
kernel. Every product is true FP32.
"""

from __future__ import annotations

import ctypes

import torch

from doa_tpu_torch import _build
from doa_tpu_torch.ops.cuda.music_scan import music_den_plain

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIG = {"doa_wideband_fusion": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P]}
FUSION_K2 = (2, 4, 6, 8)        # subspace ranks the kernel is built for


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


def wideband_fused_spectrum_plain(Vt, At_emb, nrm=None):
    """Plain PyTorch version → P f32[B, G]: a loop over subbands of
    music_den_plain, accumulating dmin_f / den_f."""
    nrm = _check_args(Vt, At_emb, nrm)
    F = Vt.shape[0]
    acc = None
    for f in range(F):
        den = music_den_plain(Vt[f], At_emb[f], nrm[f])
        q = den.min(dim=-1, keepdim=True).values / den
        acc = q if acc is None else acc + q
    return acc * (1.0 / F)


def wideband_fused_spectrum(Vt: torch.Tensor, At_emb: torch.Tensor,
                            nrm: torch.Tensor | None = None) -> torch.Tensor:
    """The fusion kernel: Vt f32[F, B, 2K, 2N], At_emb f32[F, G, 2N],
    nrm f32[F, G] = ‖a_fg‖² (computed if None) → fused spectrum
    P f32[B, G]. 2K must be one of FUSION_K2.

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel (two passes) and raises if that fails."""
    nrm = _check_args(Vt, At_emb, nrm)
    if Vt.device.type == "cpu":
        return wideband_fused_spectrum_plain(Vt, At_emb, nrm)
    if not Vt.is_cuda:
        raise ValueError(f"unsupported device {Vt.device}")
    F, B, K2, n2 = Vt.shape
    G = At_emb.shape[1]
    if K2 not in FUSION_K2:
        raise ValueError(f"wideband_fusion kernel takes 2K in {FUSION_K2}, "
                         f"got {K2}")
    Vt = Vt.contiguous()
    At_T = At_emb.transpose(1, 2).contiguous()          # (F, 2N, G)
    nrm = nrm.to(torch.float32).contiguous()
    dmin = torch.full((F, B), float("inf"), dtype=torch.float32,
                      device=Vt.device)
    P = torch.empty((B, G), dtype=torch.float32, device=Vt.device)
    lib = _build.load("wideband_scan", _SIG)
    err = lib.doa_wideband_fusion(
        Vt.data_ptr(), At_T.data_ptr(), nrm.data_ptr(), dmin.data_ptr(),
        P.data_ptr(), F, B, K2, n2, G,
        torch.cuda.current_stream(Vt.device).cuda_stream)
    _build.check(err, "doa_wideband_fusion")
    wideband_fused_spectrum.launches += 1
    return P


wideband_fused_spectrum.launches = 0
