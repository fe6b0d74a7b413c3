"""Wideband front end: interleaved capture → per-subband embedded
covariance windows E_sub f32[F, B, 2N, 2N].

Port of the "fft" variant of doa_tpu/ops/pallas/wideband_cov.py
(wideband_cov_embedded_pallas → subband_fft_embedded_pallas). The capture
x[T, 2N] (the bytes of a complex64 (T, N) buffer) is framed into
M = T // F frames of F consecutive samples, f32[M, F·2N] — a free
reshape; trailing samples are dropped. The kernel (csrc/wideband_cov.cu)
takes the F-point DFT of every frame and, per chunk of g frames and per
subband, the Gram with the correction c cᴴ and 1/S_sub folded in. Windows
are strided prefix-sum differences over the chunks, as on the narrowband
path: S_sub = S / F, hop_sub = max(S_sub − overlap // F, 1),
g = gcd(S_sub, hop_sub). There is no forward-backward averaging on this
path, as in the reference. F must be a power of two (the reference's
"fft" variant); other F take the dense-channelizer kernel, not ported.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from doa_tpu_torch import _build
from doa_tpu_torch.cpx import fp32_matmuls
from doa_tpu_torch.ops.cuda.cov_embedded import (correction_pattern,
                                                 window_sums)

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIG = {"doa_wideband_fft_gram": [_P, _P, _P, _P, _P, _I, _I, _I, _I,
                                  ctypes.c_float, _P]}


def dft_twiddles(F: int) -> np.ndarray:
    """f32[F, 2]: (re, im) of exp(−2πj·k/F), k = 0 … F−1 (W[f, t] is row
    f·t mod F). Values within 1e-12 of an integer are that integer, so
    ±1 and ±j are exact, as in the reference's FFT butterflies."""
    w = np.exp(-2j * np.pi * np.arange(F) / F)
    tw = np.stack([w.real, w.imag], axis=-1)
    snap = np.abs(tw - np.round(tw)) < 1e-12
    return np.where(snap, np.round(tw), tw).astype(np.float32)


def _check_frames(xf, cr, ci, F: int, N: int, g: int):
    if xf.dim() != 2 or xf.shape[1] != F * 2 * N:
        raise ValueError(f"need frames f32[M, F·2N] = [M, {F * 2 * N}], got "
                         f"{tuple(xf.shape)}")
    if cr.shape != (N,) or ci.shape != (N,):
        raise ValueError(f"need cr, ci f32[{N}], got {tuple(cr.shape)}, "
                         f"{tuple(ci.shape)}")
    n = xf.shape[0] // g
    if n < 1:
        raise ValueError(f"{xf.shape[0]} frames hold no chunk of {g}")
    return n


def subband_chunk_grams_plain(xf: torch.Tensor, cr, ci, *, F: int, N: int,
                              g: int, scale: float) -> torch.Tensor:
    """Plain PyTorch version of the kernel → f32[F, n, 2N, 2N]:
    torch.fft.fft over each frame's F samples, then per (subband, chunk)
    the complex Gram as true-FP32 batched products of the planes, the
    correction, the scale and the embedding. A float64 `xf` takes the DFT
    and the Grams in float64 and rounds them once to float32."""
    n = _check_frames(xf, cr, ci, F, N, g)
    dt = torch.float64 if xf.dtype == torch.float64 else torch.float32
    xc = torch.view_as_complex(
        xf[:n * g].to(dt).reshape(n * g, F, N, 2).contiguous())
    Y = torch.fft.fft(xc, dim=1)                          # (n·g, F, N)
    Y = Y.reshape(n, g, F, N).permute(2, 0, 1, 3)          # (F, n, g, N)
    Yr, Yi = Y.real, Y.imag
    with fp32_matmuls():
        rr = (torch.matmul(Yr.transpose(-1, -2), Yr)
              + torch.matmul(Yi.transpose(-1, -2), Yi)).to(torch.float32)
        ri = (torch.matmul(Yi.transpose(-1, -2), Yr)
              - torch.matmul(Yr.transpose(-1, -2), Yi)).to(torch.float32)
    Wre, Wim = correction_pattern(cr.to(torch.float32), ci.to(torch.float32))
    er = (rr * Wre - ri * Wim) * scale
    ei = (rr * Wim + ri * Wre) * scale
    return torch.cat([torch.cat([er, -ei], dim=-1),
                      torch.cat([ei, er], dim=-1)], dim=-2)


def subband_chunk_grams(xf: torch.Tensor, cr: torch.Tensor,
                        ci: torch.Tensor, *, F: int, N: int, g: int,
                        scale: float) -> torch.Tensor:
    """The front-end kernel: frames xf f32[M, F·2N] → per-chunk embedded
    subband covariances f32[F, n, 2N, 2N], n = M // g, with the
    correction (cr, ci f32[N]) and `scale` folded in.

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel (csrc/wideband_cov.cu) and raises if that fails."""
    n = _check_frames(xf, cr, ci, F, N, g)
    if xf.device.type == "cpu":
        return subband_chunk_grams_plain(xf, cr, ci, F=F, N=N, g=g,
                                         scale=scale)
    if not xf.is_cuda:
        raise ValueError(f"unsupported device {xf.device}")
    if xf.dtype != torch.float32:
        raise ValueError(f"the kernel takes float32 frames, got {xf.dtype}")
    if not (N % 4 == 0 and N <= 64 or N % 2 == 0 and N <= 32 or N <= 16):
        raise ValueError(f"wideband_fft_gram kernel takes N a multiple of 4 "
                         f"up to 64, even up to 32, or up to 16; got {N}")
    if F * n > 2 ** 31 - 1:
        raise ValueError(f"{F} subbands x {n} chunks exceed one launch")
    xf = xf[:n * g].contiguous()
    tw = torch.from_numpy(dft_twiddles(F)).to(xf.device)
    cr = cr.to(torch.float32).contiguous()
    ci = ci.to(torch.float32).contiguous()
    out = torch.empty((F, n, 2 * N, 2 * N), dtype=torch.float32,
                      device=xf.device)
    lib = _build.load("wideband_cov", _SIG)
    err = lib.doa_wideband_fft_gram(
        xf.data_ptr(), tw.data_ptr(), cr.data_ptr(), ci.data_ptr(),
        out.data_ptr(), F, N, g, n, scale,
        torch.cuda.current_stream(xf.device).cuda_stream)
    _build.check(err, "doa_wideband_fft_gram")
    subband_chunk_grams.launches += 1
    return out


subband_chunk_grams.launches = 0


def subband_framing(F: int, snapshot_size: int, overlap: int):
    """→ (S_sub, hop_sub, g) of the reference's subband framing."""
    if snapshot_size % F:
        raise ValueError(f"snapshot_size ({snapshot_size}) must be divisible "
                         f"by num_subbands ({F})")
    S_sub = snapshot_size // F
    hop_sub = max(S_sub - overlap // F, 1)
    return S_sub, hop_sub, math.gcd(S_sub, hop_sub)


def wideband_cov_embedded(xil: torch.Tensor, cr: torch.Tensor,
                          ci: torch.Tensor, *, N: int, F: int,
                          snapshot_size: int,
                          overlap: int = 0) -> torch.Tensor:
    """xil: the capture as x[T, 2N] (or any shape with the same bytes);
    cr/ci: f32[N] correction → per-subband embedded covariance windows
    E_sub f32[F, B, 2N, 2N], normalised by S_sub, the correction folded
    per subband (exact: it commutes with the per-channel DFT)."""
    if F < 1 or F & (F - 1):
        raise NotImplementedError(
            f"num_subbands={F} is not a power of two: the dense-channelizer "
            f"front end it needs is not ported (ROADMAP.md, queue B.7)")
    S_sub, hop_sub, g = subband_framing(F, snapshot_size, overlap)
    x = xil.reshape(-1, 2 * N).to(torch.float32)
    M = x.shape[0] // F
    if M < S_sub:
        raise ValueError(f"capture of {x.shape[0]} samples is shorter than "
                         f"one window ({snapshot_size})")
    B = (M - S_sub) // hop_sub + 1
    n = M // g
    xf = x[:n * g * F].reshape(n * g, F * 2 * N)         # frames (free)
    E = subband_chunk_grams(xf, cr, ci, F=F, N=N, g=g, scale=1.0 / S_sub)
    return window_sums(E, B, S_sub // g, hop_sub // g)
