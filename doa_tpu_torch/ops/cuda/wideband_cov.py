"""Wideband front end: interleaved capture → per-subband embedded
covariance windows E_sub f32[F, B, 2N, 2N].

Port of doa_tpu/ops/pallas/wideband_cov.py (wideband_cov_embedded_pallas
and its three variants). The capture x[T, 2N] (the bytes of a complex64
(T, N) buffer) is framed into M = T // F frames of F consecutive samples,
f32[M, F·2N] — a free reshape; trailing samples are dropped. Windows are
strided prefix-sum differences over chunks of g subband samples, as on the
narrowband path: S_sub = S / F, hop_sub = max(S_sub − overlap // F, 1),
g = gcd(S_sub, hop_sub). There is no forward-backward averaging on this
path, as in the reference. The correction c cᴴ is folded per subband
(exact: it commutes with the per-channel DFT). The variants:

* "fft" (power-of-two F; "auto" picks it there): kernel 4, the ring
  kernel of csrc/wideband_cov.cu on the frames, takes the F-point DFT of
  every frame and, per chunk and subband, the Gram with the correction
  and 1/S_sub folded in.
* "embedded" ("auto" for any other F): the reference's composition, the
  dense channelizer Y = frames @ K (channelizer_matrix; a plain true-FP32
  matmul, as the reference leaves it to XLA), then kernel 7's function on
  Y: per chunk and subband the embedded Gram with the correction and
  1/S_sub. On the card the stage (subband_embedded_frames) is one launch
  of the ring kernel on the frames, whose direct DFT takes any F: no
  channelizer matrix and no Y. Kernel 7 itself (subband_embedded, the
  ring kernel's stream source) serves a caller that has a Y.
* "uhat": the same channelizer, kernel 10 (the ring kernel's third
  source, csrc/wideband_cov.cu): per chunk and subband the
  interleaved-basis Gram, then window sums and uhat_windows_to_embedded
  (FB off).
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from doa_tpu_torch import _build
from doa_tpu_torch.cpx import fp32_matmuls
from doa_tpu_torch.ops.cuda.cov_embedded import (correction_pattern,
                                                 uhat_windows_to_embedded,
                                                 window_sums)

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIG = {"doa_wideband_fft_gram": [_P, _P, _P, _P, _P, _I, _I, _I, _I,
                                  ctypes.c_float, _P],
        "doa_subband_embedded": [_P, _P, _P, _P, _I, _I, _I, _I,
                                 ctypes.c_float, _P],
        "doa_subband_gram": [_P, _P, _I, _I, _I, _I, _P]}


def dft_twiddles(F: int) -> np.ndarray:
    """f32[F, 2]: (re, im) of exp(−2πj·k/F), k = 0 … F−1 (W[f, t] is row
    f·t mod F). Values within 1e-12 of an integer are that integer, so
    ±1 and ±j are exact, as in the reference's FFT butterflies."""
    w = np.exp(-2j * np.pi * np.arange(F) / F)
    tw = np.stack([w.real, w.imag], axis=-1)
    snap = np.abs(tw - np.round(tw)) < 1e-12
    return np.where(snap, np.round(tw), tw).astype(np.float32)


_TWIDDLES: dict = {}


def twiddles_on(F: int, device) -> torch.Tensor:
    """dft_twiddles(F) on `device`, copied there once a (F, device)."""
    key = (F, torch.device(device))
    tw = _TWIDDLES.get(key)
    if tw is None:
        tw = _TWIDDLES[key] = torch.from_numpy(dft_twiddles(F)).to(device)
    return tw


def kernel_takes(N: int) -> bool:
    """The element counts the front-end kernels (the ring kernel: 4 and
    7; 10) are built for."""
    return N % 4 == 0 and N <= 64 or N % 2 == 0 and N <= 32 or N <= 16


def _check_stream(y, F: int, N: int, g: int, cr=None, ci=None) -> int:
    """The shape checks of the front-end kernels' input — frames or the
    channelized stream, f32[M, F·2N], and the correction f32[N] where the
    kernel takes one → the chunk count n = M // g."""
    if y.dim() != 2 or y.shape[1] != F * 2 * N:
        raise ValueError(f"need f32[M, F·2N] = [M, {F * 2 * N}], got "
                         f"{tuple(y.shape)}")
    if cr is not None and (cr.shape != (N,) or ci.shape != (N,)):
        raise ValueError(f"need cr, ci f32[{N}], got {tuple(cr.shape)}, "
                         f"{tuple(ci.shape)}")
    n = y.shape[0] // g
    if n < 1:
        raise ValueError(f"{y.shape[0]} rows hold no chunk of {g}")
    return n


def _kernel_stream(y: torch.Tensor, F: int, N: int, n: int, g: int):
    """The checks every launch of the ring kernel shares → y's first n·g
    rows, contiguous."""
    if not y.is_cuda:
        raise ValueError(f"unsupported device {y.device}")
    if y.dtype != torch.float32:
        raise ValueError(f"the kernel takes float32 input, got {y.dtype}")
    if not kernel_takes(N):
        raise ValueError(f"the front-end kernels take N a multiple of 4 up "
                         f"to 64, even up to 32, or up to 16; got {N}")
    if F * n > 2 ** 31 - 1:
        raise ValueError(f"{F} subbands x {n} chunks exceed one launch")
    y = y[:n * g].contiguous()
    if y.data_ptr() % 8:
        raise ValueError("the kernel reads complex samples: its input must "
                         "start on an 8-byte boundary")
    return y


def _ring(x: torch.Tensor, cr, ci, *, F: int, N: int, g: int, n: int,
          scale: float, frames: bool) -> torch.Tensor:
    """One launch of the ring kernel (csrc/wideband_cov.cu) on a CUDA
    tensor x f32[M, F·2N] → E f32[F, n, 2N, 2N]: on the frames, the group's
    subbands by the DFT (frames=True, kernel 4's entry), or on the
    channelized stream, its column blocks (kernel 7's entry)."""
    x = _kernel_stream(x, F, N, n, g)
    cr = cr.to(torch.float32).contiguous()
    ci = ci.to(torch.float32).contiguous()
    out = torch.empty((F, n, 2 * N, 2 * N), dtype=torch.float32,
                      device=x.device)
    lib = _build.load("wideband_cov", _SIG)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if frames:
        tw = twiddles_on(F, x.device)
        err = lib.doa_wideband_fft_gram(
            x.data_ptr(), tw.data_ptr(), cr.data_ptr(), ci.data_ptr(),
            out.data_ptr(), F, N, g, n, scale, stream)
        _build.check(err, "doa_wideband_fft_gram")
    else:
        err = lib.doa_subband_embedded(
            x.data_ptr(), cr.data_ptr(), ci.data_ptr(), out.data_ptr(), F, N,
            g, n, scale, stream)
        _build.check(err, "doa_subband_embedded")
    return out


def _embedded_grams(Yr, Yi, cr, ci, scale: float) -> torch.Tensor:
    """Planes Yr, Yi f32|f64[..., g, N] of subband samples → the embedded
    covariance chunks f32[..., 2N, 2N] of R = Σ y yᴴ, with the correction
    (cr, ci) folded as (c cᴴ) ∘ R and then `scale`: true-FP32 batched
    products (float64 planes: float64 products, rounded once)."""
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


def subband_chunk_grams_plain(xf: torch.Tensor, cr, ci, *, F: int, N: int,
                              g: int, scale: float) -> torch.Tensor:
    """Plain PyTorch version of kernel 4 → f32[F, n, 2N, 2N]:
    torch.fft.fft over each frame's F samples, then per (subband, chunk)
    the embedded Gram (_embedded_grams). A float64 `xf` takes the DFT and
    the Grams in float64 and rounds them once to float32."""
    n = _check_stream(xf, F, N, g, cr, ci)
    dt = torch.float64 if xf.dtype == torch.float64 else torch.float32
    xc = torch.view_as_complex(
        xf[:n * g].to(dt).reshape(n * g, F, N, 2).contiguous())
    Y = torch.fft.fft(xc, dim=1)                          # (n·g, F, N)
    Y = Y.reshape(n, g, F, N).permute(2, 0, 1, 3)          # (F, n, g, N)
    return _embedded_grams(Y.real, Y.imag, cr, ci, scale)


def subband_chunk_grams(xf: torch.Tensor, cr: torch.Tensor,
                        ci: torch.Tensor, *, F: int, N: int, g: int,
                        scale: float) -> torch.Tensor:
    """The front-end kernel: frames xf f32[M, F·2N] → per-chunk embedded
    subband covariances f32[F, n, 2N, 2N], n = M // g, with the
    correction (cr, ci f32[N]) and `scale` folded in.

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel (csrc/wideband_cov.cu) and raises if that fails."""
    n = _check_stream(xf, F, N, g, cr, ci)
    if xf.device.type == "cpu":
        return subband_chunk_grams_plain(xf, cr, ci, F=F, N=N, g=g,
                                         scale=scale)
    out = _ring(xf, cr, ci, F=F, N=N, g=g, n=n, scale=scale, frames=True)
    _build.count("wideband_fft_gram")
    return out


def channelizer_matrix(F: int, N: int) -> np.ndarray:
    """(F·2N, F·2N) f32 K with (frames @ K) = the channelized-interleaved
    stream (doa_tpu's channelizer_matrix, bit for bit):
    K[t·2N+a, f·2N+b] = Wr[f,t]·I[a,b] + Wi[f,t]·Sw[a,b], W the F-point DFT
    (W[f,t] = exp(−2πj·f·t/F)) and Sw[2n, 2n+1] = 1, Sw[2n+1, 2n] = −1,
    the interleaved "multiply by j", so that per complex pair
    y = Wr·x + Wi·(j-swap of x) reproduces (Wr + jWi)(xr + jxi)."""
    f = np.arange(F)[:, None]
    t = np.arange(F)[None, :]
    Wc = np.exp(-2j * np.pi * f * t / F)
    eye = np.eye(2 * N, dtype=np.float64)
    Sw = np.zeros((2 * N, 2 * N), np.float64)
    n = np.arange(N)
    Sw[2 * n, 2 * n + 1] = 1.0
    Sw[2 * n + 1, 2 * n] = -1.0
    K = (np.einsum("ft,ab->tafb", Wc.real, eye)
         + np.einsum("ft,ab->tafb", Wc.imag, Sw))
    return K.reshape(F * 2 * N, F * 2 * N).astype(np.float32)


_CHANNELIZERS: dict = {}


def channelizer_on(F: int, N: int, device) -> torch.Tensor:
    """channelizer_matrix(F, N) on `device`, copied there once a
    (F, N, device)."""
    key = (F, N, torch.device(device))
    K = _CHANNELIZERS.get(key)
    if K is None:
        K = _CHANNELIZERS[key] = torch.from_numpy(
            channelizer_matrix(F, N)).to(device)
    return K


def channelize_frames(xf: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """Frames xf f32[M, F·2N] → the channelized stream Y f32[M, F·2N]
    (column block f = subband f's interleaved samples): one dense matmul
    with the channelizer matrix K, in true FP32 (never TF32)."""
    with fp32_matmuls():
        return torch.matmul(xf, K)


def subband_embedded_plain(y: torch.Tensor, cr, ci, *, F: int, N: int,
                           g: int, scale: float) -> torch.Tensor:
    """Plain PyTorch version of kernel 7 → f32[F, n, 2N, 2N]: subband f's
    complex samples are the (re, im) pairs of Y's column block f; per
    (subband, chunk) the embedded Gram with the correction and `scale`
    (_embedded_grams). A float64 `y` is multiplied in float64."""
    n = _check_stream(y, F, N, g, cr, ci)
    dt = torch.float64 if y.dtype == torch.float64 else torch.float32
    yc = y[:n * g].to(dt).reshape(n, g, F, N, 2).permute(2, 0, 1, 3, 4)
    return _embedded_grams(yc[..., 0], yc[..., 1], cr, ci, scale)


def subband_embedded(y: torch.Tensor, cr: torch.Tensor, ci: torch.Tensor,
                     *, F: int, N: int, g: int,
                     scale: float) -> torch.Tensor:
    """Kernel 7: the channelized stream y f32[M, F·2N] → per-chunk
    embedded subband covariances f32[F, n, 2N, 2N], n = M // g, with the
    correction (cr, ci f32[N]) and `scale` folded in.

    A CPU tensor takes the plain version; a CUDA tensor launches the ring
    kernel's stream source (csrc/wideband_cov.cu) and raises if that
    fails."""
    n = _check_stream(y, F, N, g, cr, ci)
    if y.device.type == "cpu":
        return subband_embedded_plain(y, cr, ci, F=F, N=N, g=g, scale=scale)
    out = _ring(y, cr, ci, F=F, N=N, g=g, n=n, scale=scale, frames=False)
    _build.count("subband_embedded")
    return out


def subband_embedded_frames_plain(xf: torch.Tensor, cr, ci, *, F: int,
                                  N: int, g: int, scale: float,
                                  K: torch.Tensor | None = None
                                  ) -> torch.Tensor:
    """Plain PyTorch version of the "embedded" variant's stage on the
    frames xf f32[M, F·2N] → f32[F, n, 2N, 2N]: the reference's
    composition, channelize_frames with K (channelizer_on where None),
    then subband_embedded_plain."""
    if K is None:
        K = channelizer_on(F, N, xf.device)
    return subband_embedded_plain(channelize_frames(xf, K), cr, ci, F=F,
                                  N=N, g=g, scale=scale)


def subband_embedded_frames(xf: torch.Tensor, cr: torch.Tensor,
                            ci: torch.Tensor, *, F: int, N: int, g: int,
                            scale: float,
                            K: torch.Tensor | None = None) -> torch.Tensor:
    """The "embedded" variant's stage: frames xf f32[M, F·2N] → per-chunk
    embedded subband covariances f32[F, n, 2N, 2N], kernel 7's function
    of the channelized frames.

    A CPU tensor takes the plain version (the reference's composition,
    with K); a CUDA tensor launches the ring kernel once on the frames
    (csrc/wideband_cov.cu, the direct DFT at any F: no channelizer, no Y;
    K is not read) and raises if that fails."""
    n = _check_stream(xf, F, N, g, cr, ci)
    if xf.device.type == "cpu":
        return subband_embedded_frames_plain(xf, cr, ci, F=F, N=N, g=g,
                                             scale=scale, K=K)
    out = _ring(xf, cr, ci, F=F, N=N, g=g, n=n, scale=scale, frames=True)
    _build.count("subband_embedded_frames")
    return out


def _check_sb_group(sb_group) -> None:
    if not isinstance(sb_group, int) or sb_group < 1:
        raise ValueError(f"sb_group must be a positive int, got {sb_group!r}")


def subband_grams_plain(y: torch.Tensor, *, F: int, N: int,
                        g: int) -> torch.Tensor:
    """Plain PyTorch version of kernel 10 → f32[F, n, 2N, 2N]: per
    (subband, chunk) the interleaved-basis Gram Yᵀ Y of Y's column block,
    a true-FP32 batched product (float64 `y`: in float64, rounded once)."""
    n = _check_stream(y, F, N, g)
    dt = torch.float64 if y.dtype == torch.float64 else torch.float32
    yc = y[:n * g].to(dt).reshape(n, g, F, 2 * N).permute(2, 0, 1, 3)
    with fp32_matmuls():
        return torch.matmul(yc.transpose(-1, -2), yc).to(torch.float32)


def subband_grams(y: torch.Tensor, *, F: int, N: int, g: int,
                  sb_group: int = 1) -> torch.Tensor:
    """Kernel 10: the channelized stream y f32[M, F·2N] → unnormalised
    per-chunk interleaved-basis Grams f32[F, n, 2N, 2N], n = M // g.

    sb_group (a positive int) is accepted for parity with the reference,
    where it groups subbands into one MXU product; the kernel groups
    subbands by its own plan, and the output never depends on it. A CPU
    tensor takes the plain version; a CUDA tensor launches the kernel (the
    ring kernel's uhat source, csrc/wideband_cov.cu) and raises if that
    fails."""
    n = _check_stream(y, F, N, g)
    _check_sb_group(sb_group)
    if y.device.type == "cpu":
        return subband_grams_plain(y, F=F, N=N, g=g)
    y = _kernel_stream(y, F, N, n, g)
    out = torch.empty((F, n, 2 * N, 2 * N), dtype=torch.float32,
                      device=y.device)
    lib = _build.load("wideband_cov", _SIG)
    err = lib.doa_subband_gram(
        y.data_ptr(), out.data_ptr(), F, N, g, n,
        torch.cuda.current_stream(y.device).cuda_stream)
    _build.check(err, "doa_subband_gram")
    _build.count("subband_grams")
    return out


def subband_framing(F: int, snapshot_size: int, overlap: int):
    """→ (S_sub, hop_sub, g) of the reference's subband framing."""
    if snapshot_size % F:
        raise ValueError(f"snapshot_size ({snapshot_size}) must be divisible "
                         f"by num_subbands ({F})")
    S_sub = snapshot_size // F
    hop_sub = max(S_sub - overlap // F, 1)
    return S_sub, hop_sub, math.gcd(S_sub, hop_sub)


def resolve_variant(F: int, variant: str) -> str:
    """"auto" → "fft" for a power-of-two F, "embedded" otherwise (the
    reference's dispatch); "fft" needs a power of two, as there."""
    if variant == "auto":
        return "embedded" if F & (F - 1) else "fft"
    if variant not in ("fft", "embedded", "uhat"):
        raise ValueError(f"unknown front-end variant {variant!r} (auto, fft, "
                         f"embedded, uhat)")
    if variant == "fft" and F & (F - 1):
        raise ValueError(f"the fft variant needs a power-of-two number of "
                         f"subbands, got {F}")
    return variant


def wideband_cov_embedded(xil: torch.Tensor, cr: torch.Tensor,
                          ci: torch.Tensor, *, N: int, F: int,
                          snapshot_size: int, overlap: int = 0,
                          variant: str = "auto", sb_group: int = 1,
                          K: torch.Tensor | None = None,
                          kernel=None) -> torch.Tensor:
    """xil: the capture as x[T, 2N] (or any shape with the same bytes);
    cr/ci: f32[N] correction → per-subband embedded covariance windows
    E_sub f32[F, B, 2N, 2N], normalised by S_sub, the correction folded
    per subband. variant: "auto" | "fft" | "embedded" | "uhat" (module
    docstring); sb_group: the reference's subband grouping ("uhat"; a
    positive int, no effect on the result); K: the channelizer matrix on
    xil's device (channelizer_matrix; None takes channelizer_on's) for
    "uhat" and the plain "embedded" stage (the card's does not read it);
    kernel: the variant's Gram stage, subband_chunk_grams ("fft"),
    subband_embedded_frames ("embedded", on the frames) or subband_grams
    ("uhat", on Y) by default; the pipelines pass its plain version where
    their kernel plan says so."""
    variant = resolve_variant(F, variant)
    _check_sb_group(sb_group)
    S_sub, hop_sub, g = subband_framing(F, snapshot_size, overlap)
    x = xil.reshape(-1, 2 * N).to(torch.float32)
    M = x.shape[0] // F
    if M < S_sub:
        raise ValueError(f"capture of {x.shape[0]} samples is shorter than "
                         f"one window ({snapshot_size})")
    B = (M - S_sub) // hop_sub + 1
    n = M // g
    n_win, stride = S_sub // g, hop_sub // g
    xf = x[:n * g * F].reshape(n * g, F * 2 * N)         # frames (free)
    if variant == "fft":
        E = (kernel or subband_chunk_grams)(xf, cr, ci, F=F, N=N, g=g,
                                           scale=1.0 / S_sub)
        return window_sums(E, B, n_win, stride)
    if variant == "embedded":
        E = (kernel or subband_embedded_frames)(xf, cr, ci, F=F, N=N, g=g,
                                               scale=1.0 / S_sub, K=K)
        return window_sums(E, B, n_win, stride)
    Y = channelize_frames(xf, K if K is not None
                          else channelizer_on(F, N, x.device))
    U = (kernel or functools.partial(subband_grams, sb_group=sb_group))(
        Y, F=F, N=N, g=g)
    return uhat_windows_to_embedded(window_sums(U, B, n_win, stride), N,
                                    1.0 / S_sub, correction_pattern(cr, ci),
                                    fb=False)
