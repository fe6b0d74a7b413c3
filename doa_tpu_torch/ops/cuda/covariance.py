"""Covariance planes from sample planes: the chunk-Gram kernel 8 and the
window-Gram kernel 12 (csrc/covariance.cu).

Port of doa_tpu/ops/pallas/covariance.py. The planes path carries a
capture as two f32[T, N] planes xr, xi: separate arrays, or the strided
views x[..., 0], x[..., 1] of an interleaved complex64 capture x f32[T, N, 2]
(element stride 2; the kernels read them in place, with no split pass).
With Z = [Xr | Xi], one Gram ZᵀZ gives all four real blocks, folded to

    Rr = XrᵀXr + XiᵀXi = TL + BR,    Ri = XiᵀXr − XrᵀXi = BL − TR.

* chunk_grams (kernel 8): unnormalised chunk planes f32[T // g, N, N] ×2,
  true FP32 or bf16-rounded inputs with FP32 accumulation;
* cov_windows (the public entry cov_windows_pallas): windows of S samples
  at every hop = S − overlap, normalised by S. gcd(S, hop) ≥ 64 goes
  through kernel 8 and strided prefix sums; smaller gcds through kernel 12.

Each kernel has named forms, each chosen by a predicate with no fallback:

* kernel 8 (`chunk_form`, by the planes' layout, `planes_layout`):
  "ring_interleaved" (the two views of one interleaved buffer with
  contiguous rows) and "ring_planar" (separate planes of contiguous rows,
  4 | N) run on K1's bulk-copy ring mainloop (csrc/gram_ring.cuh);
  "staged" takes any other strides;
* kernel 12 (`windows_form`, by N, S and the overlap): "chunk_sums" sums
  each window from its gcd-chunk Grams, held on chip; "per_window"
  computes each window's Gram from its S rows, where the open windows do
  not fit a block.

`chunk_grams.by_form` and `cov_windows.by_form` count the launches of each
form beside `launches`.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from doa_tpu_torch import _build
from doa_tpu_torch.cpx import fp32_matmuls
from doa_tpu_torch.ops.cuda.cov_embedded import window_sums

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_SIG = {
    "doa_planes_chunk_grams": [_P, _P, _L, _L, _I, _P, _P, _I, _I, _I, _I,
                               _P],
    "doa_planes_cov_windows": [_P, _P, _L, _L, _I, _P, _P, _I, _I, _I, _I,
                               _P],
    "doa_planes_chunk_grams_ring": [_P, _P, _I, _P, _P, _I, _I, _I, _I, _P],
    "doa_planes_window_sums": [_P, _P, _L, _L, _I, _P, _P, _I, _I, _I, _I,
                               _I, _P],
}
_DTYPE_CODE = {"float32": 0, "bfloat16": 1}
GRAM_ROUTE_MIN_GCD = 64     # cov_windows: chunk Grams at gcd(S, hop) ≥ this
_WINDOW_BATCH = 4096        # cov_windows_plain: windows a bmm


def _check_dtype(compute_dtype: str) -> None:
    if compute_dtype == "int8":
        raise NotImplementedError(
            "cov_dtype='int8' on the planes path: the reference casts "
            "unscaled float planes to int8 and no reference test pins that "
            "mode, so it is not ported (ROADMAP.md §C)")
    if compute_dtype not in _DTYPE_CODE:
        raise ValueError(f"unsupported compute_dtype {compute_dtype!r}")


def _check_planes(xr: torch.Tensor, xi: torch.Tensor) -> int:
    if (xr.dim() != 2 or xr.shape != xi.shape or xr.dtype != torch.float32
            or xi.dtype != torch.float32):
        raise ValueError(f"need planes xr, xi f32[T, N] of one shape, got "
                         f"{tuple(xr.shape)} {xr.dtype} and "
                         f"{tuple(xi.shape)} {xi.dtype}")
    if xr.device != xi.device:
        raise ValueError(f"xr on {xr.device}, xi on {xi.device}")
    return xr.shape[1]


def _fold(G: torch.Tensor, N: int):
    """(..., 2N, 2N) Gram of [Xr | Xi] → (Rr, Ri) = (TL + BR, BL − TR)."""
    return (G[..., :N, :N] + G[..., N:, N:], G[..., N:, :N] - G[..., :N, N:])


def planes_takes(N: int) -> bool:
    """The element counts kernels 8 and 12 are built for: 2N a multiple of
    4 up to 64, or N ≤ 15."""
    return 2 * N % 4 == 0 and 2 * N <= 64 or N <= 15


CHUNK_FORMS = ("ring_interleaved", "ring_planar", "staged")
WINDOW_FORMS = ("chunk_sums", "per_window")


class PlanesArgs(NamedTuple):
    """Planes f32[T, N] as the kernels read them (planes_layout)."""
    xr: torch.Tensor
    xi: torch.Tensor
    rs: int         # row stride
    es: int         # element stride
    load: int       # the staged forms' load form (csrc/covariance.cu)
    layout: str     # the ring form's layout


def planes_layout(xr: torch.Tensor, xi: torch.Tensor) -> PlanesArgs:
    """The one layout decision for planes f32[T, N] of any device: both
    must share their strides (else both are made contiguous). The ring
    form's layout is "interleaved" (the views x[..., 0], x[..., 1] of one
    buffer x f32[T, N, 2] with contiguous rows), "planar" (two planes of
    contiguous rows whose addresses are equal mod 16) or "strided"
    (anything else). The staged forms' load form: 0/1 the two views of one
    interleaved buffer (float4 when N is even and rows are 16-byte
    aligned, else float2), 2 separate planes with contiguous, 16-byte
    aligned rows and 4 | N, 3 anything else."""
    if xr.stride() != xi.stride():
        xr, xi = xr.contiguous(), xi.contiguous()
    N = xr.shape[1]
    rs, es = xr.stride()
    pr, pi = xr.data_ptr(), xi.data_ptr()
    if es == 2 and pi == pr + 4:
        layout = "interleaved" if rs == 2 * N else "strided"
        if rs % 2 == 0 and pr % 8 == 0:
            load = 0 if N % 2 == 0 and rs % 4 == 0 and pr % 16 == 0 else 1
        else:
            load = 3
    else:
        layout = ("planar" if (rs, es) == (N, 1) and (pr - pi) % 16 == 0
                  else "strided")
        load = (2 if es == 1 and N % 4 == 0 and rs % 4 == 0
                and pr % 16 == pi % 16 == 0 else 3)
    return PlanesArgs(xr, xi, rs, es, load, layout)


def chunk_form(N: int, layout: str) -> str | None:
    """Kernel 8's form for N elements in `layout` (planes_layout): the ring
    mainloop on an interleaved buffer (every N planes_takes takes) or on
    separate planes (4 | N), else the staged form; None where kernel 8
    takes no form (not planes_takes(N))."""
    if not planes_takes(N):
        return None
    if layout == "interleaved":
        return "ring_interleaved"
    if layout == "planar" and N % 4 == 0:
        return "ring_planar"
    return "staged"


def _window_slots(N: int, S: int, overlap: int):
    """→ (NS, W, threads) of kernel 12's chunk-sum form: NS = ceil(S/hop)
    window slots, W of them a thread (csrc/covariance.cu: 4 up to 16
    slots, else 16), a block of 4·ntri quads (ntri = (N/2)(N/2 + 1)/2
    upper-triangle 4 x 4 tiles of the 2N x 2N Gram) times ceil(NS/W)."""
    NS = -(-S // (S - overlap))
    W = 4 if NS <= 16 else 16
    nt = N // 2
    return NS, W, 4 * (nt * (nt + 1) // 2) * -(-NS // W)


def windows_form(N: int, S: int, overlap: int) -> str:
    """Kernel 12's form (the cov_windows route below gcd(S, hop) = 64):
    "chunk_sums" where N is even, 2N ≤ 32, the windows overlap (S/hop > 1:
    a chunk serves more than one window) and the NS open windows' slots
    fit a block (at most 448 threads of 16 slots, or 768 of 4); else
    "per_window" (e.g. hop = 1 at N = 16: S slots)."""
    NS, W, threads = _window_slots(N, S, overlap)
    if (N % 2 == 0 and N <= 16 and NS >= 2
            and threads <= (448 if W == 16 else 768)):
        return "chunk_sums"
    return "per_window"


def _kernel_args(xr: torch.Tensor, xi: torch.Tensor, N: int) -> PlanesArgs:
    """planes_layout for a launch: raises unless the planes are on the
    card and planes_takes(N)."""
    if not (xr.is_cuda and xi.is_cuda):
        raise ValueError(f"unsupported device {xr.device}")
    if not planes_takes(N):
        raise ValueError(f"the planes Gram kernels take 2N a multiple of 4 "
                         f"up to 64 or N ≤ 15, got N = {N}")
    return planes_layout(xr, xi)


def chunk_grams_plain(xr: torch.Tensor, xi: torch.Tensor, g: int,
                      compute_dtype="float32"):
    """Plain PyTorch version of kernel 8 (doa_tpu cpx_ops.chunk_grams_cpx):
    the stacked Z = [Xr | Xi] per chunk, one true-FP32 bmm, folded.
    bfloat16 rounds Z to bfloat16 first (the products stay exact in FP32)."""
    _check_dtype(compute_dtype)
    N = _check_planes(xr, xi)
    n = xr.shape[0] // g
    Z = torch.cat([xr[:n * g], xi[:n * g]], dim=-1).reshape(n, g, 2 * N)
    if compute_dtype == "bfloat16":
        Z = Z.to(torch.bfloat16).to(torch.float32)
    with fp32_matmuls():
        G = torch.bmm(Z.transpose(1, 2), Z)
    return _fold(G, N)


def chunk_grams(xr: torch.Tensor, xi: torch.Tensor, g: int,
                compute_dtype="float32"):
    """Kernel 8: unnormalised chunk planes (Rr, Ri) f32[T // g, N, N] of
    the sample planes xr, xi f32[T, N] (any row and element strides; the
    two views of an interleaved complex64 capture are read as whole rows).
    compute_dtype "float32" | "bfloat16"; "int8" raises.

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel in the form chunk_form(N, planes_layout(xr, xi).layout) names
    and raises if that fails."""
    _check_dtype(compute_dtype)
    N = _check_planes(xr, xi)
    n = xr.shape[0] // g
    if n < 1:
        raise ValueError(f"capture of {xr.shape[0]} samples holds no chunk "
                         f"of {g}")
    if xr.device.type == "cpu":
        return chunk_grams_plain(xr, xi, g, compute_dtype)
    xr, xi, rs, es, load, layout = _kernel_args(xr, xi, N)
    form = chunk_form(N, layout)
    rr = torch.empty((n, N, N), dtype=torch.float32, device=xr.device)
    ri = torch.empty_like(rr)
    lib = _build.load("covariance", _SIG)
    stream = torch.cuda.current_stream(xr.device).cuda_stream
    if form in ("ring_interleaved", "ring_planar"):
        err = lib.doa_planes_chunk_grams_ring(
            xr.data_ptr(), xi.data_ptr(), int(form == "ring_planar"),
            rr.data_ptr(), ri.data_ptr(), n, g, N,
            _DTYPE_CODE[compute_dtype], stream)
        _build.check(err, "doa_planes_chunk_grams_ring")
    else:
        err = lib.doa_planes_chunk_grams(
            xr.data_ptr(), xi.data_ptr(), rs, es, load, rr.data_ptr(),
            ri.data_ptr(), n, g, N, _DTYPE_CODE[compute_dtype], stream)
        _build.check(err, "doa_planes_chunk_grams")
    chunk_grams.launches += 1
    chunk_grams.by_form[form] += 1
    return rr, ri


chunk_grams.launches = 0
chunk_grams.by_form = dict.fromkeys(CHUNK_FORMS, 0)


def _framing(T: int, S: int, overlap: int):
    if not 0 <= overlap < S:
        raise ValueError(f"need 0 ≤ overlap < S, got {overlap}, {S}")
    if T < S:
        raise ValueError(f"capture of {T} samples is shorter than one "
                         f"window ({S})")
    hop = S - overlap
    return hop, math.gcd(S, hop), (T - S) // hop + 1


def cov_from_stream(xr, xi, snapshot_size: int, overlap: int,
                    compute_dtype="float32", grams=None):
    """Sample planes xr, xi f32[T, N] → covariance planes (Rr, Ri)
    f32[B, N, N], normalised by S (doa_tpu cpx_ops.cov_from_stream_cpx):
    chunk Grams of g = gcd(S, hop) samples (kernel 8), then strided
    prefix-sum differences give the windows at every hop for any
    0 ≤ overlap < S (n_win == 1: the chunks are the windows). grams:
    chunk_grams by default; the pipelines pass its plain version where
    their kernel plan says so."""
    S = snapshot_size
    hop, g, B = _framing(xr.shape[0], S, overlap)
    C = (grams or chunk_grams)(xr, xi, g, compute_dtype)
    return tuple(window_sums(c, B, S // g, hop // g) / S for c in C)


def cov_windows_plain(xr: torch.Tensor, xi: torch.Tensor, snapshot_size: int,
                      overlap: int):
    """Plain PyTorch version of cov_windows, routed as the kernels are:
    gcd(S, hop) ≥ 64 → chunk_grams_plain + strided prefix sums; else one
    true-FP32 Gram per window (hop-strided views of Z, a bounded batch of
    windows a bmm), divided by S, folded."""
    N = _check_planes(xr, xi)
    S = snapshot_size
    hop, g, B = _framing(xr.shape[0], S, overlap)
    if g >= GRAM_ROUTE_MIN_GCD:
        return tuple(window_sums(c, B, S // g, hop // g) / S
                     for c in chunk_grams_plain(xr, xi, g))
    Z = torch.cat([xr, xi], dim=-1)                     # (T, 2N)
    Zw = Z.unfold(0, S, hop)                             # (B, 2N, S) view
    # S as a tensor on Z's device: a CUDA tensor divided by a Python number
    # is multiplied by its rounded reciprocal, one rounding more than the
    # division the kernels (and the CPU) do
    St = torch.full((), S, dtype=Z.dtype, device=Z.device)
    rr, ri = [], []
    with fp32_matmuls():
        for lo in range(0, B, _WINDOW_BATCH):
            z = Zw[lo:lo + _WINDOW_BATCH]
            r = _fold(torch.bmm(z, z.transpose(1, 2)) / St, N)
            rr.append(r[0])
            ri.append(r[1])
    return torch.cat(rr), torch.cat(ri)


def cov_windows(xr: torch.Tensor, xi: torch.Tensor, snapshot_size: int,
                overlap: int):
    """Covariance windows (Rr, Ri) f32[B, N, N], normalised by S, at every
    hop = S − overlap offset (doa_tpu's cov_windows_pallas). gcd(S, hop)
    ≥ 64: kernel 8 chunk Grams and strided prefix sums (exact for any
    overlap); smaller gcds: kernel 12 in the form `windows_form` names,
    each window the ordered sum of its gcd-chunk Grams ("chunk_sums") or
    one Gram of its S rows ("per_window").

    A CPU tensor takes the plain version; on a CUDA tensor the kernel of
    its route launches or raises. `cov_windows.launches` counts kernel 12."""
    N = _check_planes(xr, xi)
    S = snapshot_size
    hop, g, B = _framing(xr.shape[0], S, overlap)
    if xr.device.type == "cpu":
        return cov_windows_plain(xr, xi, S, overlap)
    if g >= GRAM_ROUTE_MIN_GCD:
        return cov_from_stream(xr, xi, S, overlap)
    xr, xi, rs, es, load, _ = _kernel_args(xr, xi, N)
    form = windows_form(N, S, overlap)
    rr = torch.empty((B, N, N), dtype=torch.float32, device=xr.device)
    ri = torch.empty_like(rr)
    lib = _build.load("covariance", _SIG)
    stream = torch.cuda.current_stream(xr.device).cuda_stream
    if form == "chunk_sums":
        err = lib.doa_planes_window_sums(
            xr.data_ptr(), xi.data_ptr(), rs, es, load, rr.data_ptr(),
            ri.data_ptr(), B, S, hop, g, N, stream)
        _build.check(err, "doa_planes_window_sums")
    else:
        err = lib.doa_planes_cov_windows(
            xr.data_ptr(), xi.data_ptr(), rs, es, load, rr.data_ptr(),
            ri.data_ptr(), B, S, hop, N, stream)
        _build.check(err, "doa_planes_cov_windows")
    cov_windows.launches += 1
    cov_windows.by_form[form] += 1
    return rr, ri


cov_windows.launches = 0
cov_windows.by_form = dict.fromkeys(WINDOW_FORMS, 0)
