"""Interleaved-ingest covariance: raw capture → embedded windows E(R).

Port of doa_tpu/ops/pallas/cov_embedded.py (both variants). A
C-ordered complex64 capture (T, N) is, byte for byte, the float32 array
x[T, 2N] = [t0c0.re, t0c0.im, t0c1.re, …], so the capture enters with no
copy. The chunk-Gram kernel K1 (csrc/cov_gram.cu) reads it once and writes
the interleaved-basis Gram Û_c = Σ_t u_t u_tᵀ of every chunk of
g = gcd(S, hop) samples. Windows are strided prefix-sum differences over
the chunk stack (the reference's sliding windows, any overlap). The rest
runs as FP32 torch ops on the (B, 2N, 2N) windows: the change to the
planar basis, the embedding E = [[Rr, −Ri], [Ri, Rr]], the calibration
correction W = c cᴴ folded as (c cᴴ) ∘ R, forward-backward averaging and
the 1/S scale. All of these are permutations, sign flips and elementwise
products, so no matmul and no TF32 question arises there.

Kernel 9 (the second entry of csrc/cov_gram.cu) does the embedding, the
correction, FB and the 1/S scale in the Gram kernel's epilogue, chunk by
chunk. The stacked variant asks its stage for E (chunk_grams_uhat's
`embed`, and `windows` where a window spans chunks), and the stage takes
the epilogue gram_epilogue names: where a window is one chunk (g = S, no
overlap) kernel 9's entry, E being K1's U folded as
uhat_windows_to_embedded folds it, bit for bit; where windows overlap,
kernel 9's window entry, each window's E the sum of its chunks' E in
chunk order (ordered_window_sums), with no prefix sum and no torch pass
over the chunk stack; else (int8, the shapes kernel 9's window entry does
not take) K1, the prefix-sum windows and the torch fold. The "chunk"
variant sums the windows from kernel 9's per-chunk E at any overlap; no
pipeline selects it (the reference's pipelines do not either).
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from doa_tpu_torch import _build
from doa_tpu_torch.cpx import fp32_matmuls

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "int8": torch.int8}
_KERNEL_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIG = {"doa_chunk_gram": [_P, _P, _I, _I, _I, _I, _P],
        "doa_chunk_embedded": [_P, _P, _P, _P, _I, _I, _I, _I, _I,
                               ctypes.c_float, _P],
        "doa_chunk_windows": [_P, _P, _P, _P, _I, _I, _I, _I, _I,
                              ctypes.c_float, _I, _I, _P]}
VARIANTS = ("stacked", "chunk")
# chunk_grams_uhat.by_epilogue's keys
EPILOGUES = ("gram", "embedded", "windows")


def interleave_factor(N: int) -> int:
    """doa_tpu's TPACK: time steps per 128-lane row of the TPU layout (1
    when 2N ≥ 128). Nothing here is laid out by it; the pipelines' route
    rule reads it (plan.fused_route)."""
    return max(1, 128 // (2 * N))


def _perm_interleaved_to_planar(N: int) -> np.ndarray:
    """(2N, 2N) permutation P with (P u)[planar] = u[interleaved]:
    planar row c ← interleaved row 2c (re), planar row N+c ← 2c+1."""
    P = np.zeros((2 * N, 2 * N), np.float32)
    for c in range(N):
        P[c, 2 * c] = 1.0
        P[N + c, 2 * c + 1] = 1.0
    return P


def chunk_grams_uhat_plain(x: torch.Tensor, g: int, embed=None,
                           windows=None) -> torch.Tensor:
    """Plain PyTorch version of K1: x[n·g, 2N] → f32[n, 2N, 2N]; with
    embed = (N, scale, W, fb), each chunk's Gram then goes through
    uhat_windows_to_embedded (kernel 9's plain version, chunk_embedded_plain).
    With windows = (B, n_win, stride) too, the B windows' E f32[B, 2N, 2N]
    by the route the card's stage takes (gram_epilogue): kernel 9's window
    entry's plain version (chunk_windows_plain), or the Grams' prefix-sum
    windows (window_sums) folded.

    float32 and bfloat16 inputs are widened to float32 and multiplied in
    true FP32. int8 is multiplied in float64, which is exact for these
    integers, and rounded once to float32 — the same numbers as the
    kernel's exact int32 sum cast to float32."""
    n2 = x.shape[-1]
    if windows is not None and gram_epilogue(
            x.dtype, n2, *windows[1:]) == "windows":
        return chunk_windows_plain(x, g, *embed, windows)
    n = x.shape[0] // g
    xc = x[:n * g].reshape(n, g, n2)
    if x.dtype == torch.int8:
        xd = xc.to(torch.float64)
        U = torch.bmm(xd.transpose(1, 2), xd).to(torch.float32)
    else:
        xf = xc.to(torch.float32)
        with fp32_matmuls():
            U = torch.bmm(xf.transpose(1, 2), xf)
    if embed is None:
        return U
    if windows is not None:
        U = window_sums(U, *windows)
    return uhat_windows_to_embedded(U, *embed)


# Kernel 9's window entry (csrc/cov_gram.cu doa_chunk_windows): a lane
# holds one item of R, so 2N ≤ 40 of K1's widths (fold_slots(N) ≤ THREADS),
# and a chunk lies in at most WMAX windows.
WINDOWS_N2_MAX = 40
WINDOWS_WMAX = 4


def gram_epilogue(dtype, n2: int = 0, n_win: int = 1,
                  stride: int = 1) -> str:
    """The epilogue chunk_grams_uhat launches on the card when asked for
    E (`embed`) of 2N = n2 columns in windows of n_win chunks, stride
    chunks apart (`windows`; n_win = 1: the chunks are the windows):

    * "embedded", kernel 9's entry, where a window is one chunk and the
      rows are float32 or bfloat16 (its sums are K1's at every g:
      csrc/cov_gram.cu);
    * "windows", kernel 9's window entry, where windows span chunks
      (n_win > 1), the rows are float32 or bfloat16, 2N ≤ WINDOWS_N2_MAX
      and a chunk lies in at most WINDOWS_WMAX windows (overlaps up to
      ¾·S at g = hop); it takes every g;
    * "gram" otherwise (int8, which kernel 9 does not take, and the
      shapes its window entry does not take): K1, then window_sums where
      windows span chunks, then uhat_windows_to_embedded.

    The pipelines' plans name the covariance stage's form from this
    (plan.kernel_forms)."""
    dt = _DTYPES.get(dtype, dtype)
    if dt not in (torch.float32, torch.bfloat16):
        return "gram"
    if n_win == 1:
        return "embedded"
    takes = (n2 <= WINDOWS_N2_MAX
             and -(-n_win // stride) <= WINDOWS_WMAX)
    return "windows" if takes else "gram"


def chunk_grams_uhat(x: torch.Tensor, g: int, embed=None,
                     windows=None) -> torch.Tensor:
    """K1: per-chunk Grams Û_c = Σ_t u_t u_tᵀ of x[n·g, 2N] (float32,
    bfloat16 or int8; rows made contiguous here, at any element offset)
    → f32[n, 2N, 2N]. With embed = (N, scale, W, fb), each chunk's
    embedded covariance instead (uhat_windows_to_embedded of its Gram);
    with windows = (B, n_win, stride) too (n_win ≥ 2 chunks a window,
    window w from chunk w·stride), the B windows' E f32[B, 2N, 2N]. The
    card takes the epilogue gram_epilogue names: kernel 9's entry
    ("embedded"), kernel 9's window entry ("windows": each window the sum
    of its chunks' E in chunk order, ordered_window_sums), else K1, the
    prefix-sum windows and the torch fold ("gram").

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel (csrc/cov_gram.cu: a persistent grid over the chunks, 1-D bulk
    async copies into a shared-memory ring, the Gram's upper triangle,
    mirrored) and raises if that fails. `launches` counts K1's launches
    (kernel 9's entries' are chunk_embedded.launches), `by_epilogue` the
    card's calls by the epilogue they took ("gram", "embedded",
    "windows")."""
    if x.dim() != 2 or x.dtype not in _KERNEL_DTYPE_CODE:
        raise ValueError(f"need x[T, 2N] float32|bfloat16|int8, got "
                         f"{tuple(x.shape)} {x.dtype}")
    n2 = x.shape[1]
    n = x.shape[0] // g
    if n < 1:
        raise ValueError(f"capture of {x.shape[0]} samples holds no chunk "
                         f"of {g}")
    if embed is not None and 2 * embed[0] != n2:
        raise ValueError(f"embed's N = {embed[0]} does not match 2N = {n2}")
    if windows is not None:
        B, n_win, stride = windows
        if (embed is None or n_win < 2 or not 1 <= stride < n_win
                or B < 1 or (B - 1) * stride + n_win > n):
            raise ValueError(f"windows {windows} need embed, 1 ≤ stride < "
                             f"n_win and their chunks among the {n}")
    if x.device.type == "cpu":
        return chunk_grams_uhat_plain(x, g, embed, windows)
    if not x.is_cuda:
        raise ValueError(f"unsupported device {x.device}")
    _check_gram_width(n2, "chunk_gram")
    x = x[:n * g].contiguous()
    epilogue = (gram_epilogue(x.dtype, n2, *windows[1:]) if windows
                else gram_epilogue(x.dtype))
    if embed is not None and epilogue != "gram":
        E = (_launch_windows(x, g, *embed, windows) if windows
             else _launch_embedded(x, g, *embed))
        chunk_grams_uhat.by_epilogue[epilogue] += 1
        return E
    lib = _build.load("cov_gram", _SIG)
    out = torch.empty((n, n2, n2), dtype=torch.float32, device=x.device)
    err = lib.doa_chunk_gram(
        x.data_ptr(), out.data_ptr(), n, g, n2, _KERNEL_DTYPE_CODE[x.dtype],
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "doa_chunk_gram")
    chunk_grams_uhat.launches += 1
    chunk_grams_uhat.by_epilogue["gram"] += 1
    if embed is None:
        return out
    if windows is not None:
        out = window_sums(out, *windows)
    return uhat_windows_to_embedded(out, *embed)


chunk_grams_uhat.launches = 0
chunk_grams_uhat.by_epilogue = dict.fromkeys(EPILOGUES, 0)


def uhat_windows_to_embedded(Uw: torch.Tensor, N: int, scale: float, W,
                             fb: bool) -> torch.Tensor:
    """Interleaved-basis window Grams Uw f32[..., 2N, 2N] → embedded
    covariance E(R) f32[..., 2N, 2N], with W = (Wre, Wim) the planes of
    the correction c cᴴ and optional forward-backward averaging.

    With Ũ = P Uw Pᵀ = [[A, B], [C, D]] in the planar basis, R = Σ x xᴴ
    has Rr = A + D and Ri = C − B; every step is an FP32 elementwise op
    (the reference's permutation matmuls are exact, so the two agree)."""
    n2 = 2 * N
    lead = Uw.shape[:-2]
    U4 = Uw.reshape(-1, N, 2, N, 2)
    rr = (U4[:, :, 0, :, 0] + U4[:, :, 1, :, 1]) * scale
    ri = (U4[:, :, 1, :, 0] - U4[:, :, 0, :, 1]) * scale
    Wre, Wim = W
    rr, ri = rr * Wre - ri * Wim, rr * Wim + ri * Wre
    if fb:
        rr = 0.5 * (rr + rr.flip(-2, -1))
        ri = 0.5 * (ri - ri.flip(-2, -1))
    E = torch.cat([torch.cat([rr, -ri], dim=-1),
                   torch.cat([ri, rr], dim=-1)], dim=-2)
    return E.reshape(lead + (n2, n2))


def correction_pattern(cr: torch.Tensor, ci: torch.Tensor):
    """Planes (Wre, Wim) of W = c cᴴ for c = cr + j·ci."""
    return (cr[:, None] * cr[None, :] + ci[:, None] * ci[None, :],
            ci[:, None] * cr[None, :] - cr[:, None] * ci[None, :])


def gram_takes(n2: int) -> bool:
    """The widths K1 and kernel 9 are built for: 2N a multiple of 4 up to
    64, or even up to 30 (csrc/cov_gram.cu's register-tile forms)."""
    return n2 % 4 == 0 and n2 <= 64 or n2 % 2 == 0 and n2 <= 30


def _check_gram_width(n2: int, what: str) -> None:
    if not gram_takes(n2):
        raise ValueError(f"{what} kernel takes 2N a multiple of 4 up to "
                         f"64 or even up to 30, got 2N = {n2}")


def chunk_embedded_plain(x: torch.Tensor, g: int, N: int, scale: float,
                         W, fb: bool) -> torch.Tensor:
    """Plain PyTorch version of kernel 9: x[n·g, 2N] → each chunk's
    embedded covariance f32[n, 2N, 2N], K1's plain Gram followed by
    uhat_windows_to_embedded on every chunk (scale, the correction
    W = (Wre, Wim), FB)."""
    return chunk_grams_uhat_plain(x, g, (N, scale, W, fb))


def chunk_windows_plain(x: torch.Tensor, g: int, N: int, scale: float, W,
                        fb: bool, windows) -> torch.Tensor:
    """Plain PyTorch version of kernel 9's window entry: the embedded
    covariance of each chunk of g rows of x (chunk_embedded_plain), then
    windows = (B, n_win, stride) summed in chunk order
    (ordered_window_sums) → f32[B, 2N, 2N]."""
    B, n_win, stride = windows
    n = (B - 1) * stride + n_win
    return ordered_window_sums(
        chunk_embedded_plain(x[:n * g], g, N, scale, W, fb), B, n_win,
        stride)


def ordered_window_sums(E: torch.Tensor, B: int, n_win: int,
                        stride: int) -> torch.Tensor:
    """Embedded chunk stack E f32[n, 2N, 2N] → B windows f32[B, 2N, 2N],
    window w the sum of chunks w·stride … w·stride + n_win − 1 in chunk
    order, ((E_{w·stride} + E_{w·stride+1}) + …), as kernel 9's window
    epilogue sums them; like the kernel, the upper-right block −Ri is the
    negated sum of the lower-left block Ri (the same numbers, signed zeros
    included)."""
    last = (B - 1) * stride + 1
    out = E[0:last:stride].clone()
    for k in range(1, n_win):
        out += E[k:k + last:stride]
    N = E.shape[-1] // 2
    out[:, :N, N:] = -out[:, N:, :N]
    return out


def _launch_windows(x: torch.Tensor, g: int, N: int, scale: float, W,
                    fb: bool, windows) -> torch.Tensor:
    """Kernel 9's window entry (doa_chunk_windows) on contiguous CUDA rows
    x[n·g, 2N], float32 or bfloat16, windows = (B, n_win, stride) → E
    f32[B, 2N, 2N]; counted by chunk_embedded.launches."""
    B, n_win, stride = windows
    n = (B - 1) * stride + n_win
    Wre, Wim = (w.to(device=x.device, dtype=torch.float32).contiguous()
                for w in W)
    lib = _build.load("cov_gram", _SIG)
    out = torch.empty((B, 2 * N, 2 * N), dtype=torch.float32,
                      device=x.device)
    err = lib.doa_chunk_windows(
        x.data_ptr(), Wre.data_ptr(), Wim.data_ptr(), out.data_ptr(), n, g,
        2 * N, _KERNEL_DTYPE_CODE[x.dtype], int(fb), scale, n_win, stride,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "doa_chunk_windows")
    chunk_embedded.launches += 1
    return out


def _launch_embedded(x: torch.Tensor, g: int, N: int, scale: float, W,
                     fb: bool) -> torch.Tensor:
    """Kernel 9's entry (doa_chunk_embedded) on contiguous CUDA rows
    x[n·g, 2N], float32 or bfloat16 → E f32[n, 2N, 2N]; counted by
    chunk_embedded.launches, whichever wrapper asks."""
    n = x.shape[0] // g
    Wre, Wim = (w.to(device=x.device, dtype=torch.float32).contiguous()
                for w in W)
    lib = _build.load("cov_gram", _SIG)
    out = torch.empty((n, 2 * N, 2 * N), dtype=torch.float32,
                      device=x.device)
    err = lib.doa_chunk_embedded(
        x.data_ptr(), Wre.data_ptr(), Wim.data_ptr(), out.data_ptr(), n, g,
        2 * N, _KERNEL_DTYPE_CODE[x.dtype], int(fb), scale,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "doa_chunk_embedded")
    chunk_embedded.launches += 1
    return out


def chunk_embedded(x: torch.Tensor, g: int, N: int, scale: float, W,
                   fb: bool) -> torch.Tensor:
    """Kernel 9: per chunk of g rows of x[n·g, 2N] (float32 or bfloat16,
    contiguous rows) the Gram, the planar fold, the correction
    W = (Wre, Wim) f32[N, N] of c cᴴ, FB and the scale → E f32[n, 2N, 2N]
    (csrc/cov_gram.cu, doa_chunk_embedded), as chunk_embedded_plain.

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel and raises if that fails."""
    if (x.dim() != 2 or x.shape[1] != 2 * N
            or x.dtype not in (torch.float32, torch.bfloat16)):
        raise ValueError(f"need x[T, {2 * N}] float32|bfloat16, got "
                         f"{tuple(x.shape)} {x.dtype}")
    n = x.shape[0] // g
    if n < 1:
        raise ValueError(f"capture of {x.shape[0]} samples holds no chunk "
                         f"of {g}")
    if x.device.type == "cpu":
        return chunk_embedded_plain(x, g, N, scale, W, fb)
    if not x.is_cuda:
        raise ValueError(f"unsupported device {x.device}")
    _check_gram_width(2 * N, "chunk_embedded")
    return _launch_embedded(x[:n * g].contiguous(), g, N, scale, W, fb)


chunk_embedded.launches = 0


def window_sums(U: torch.Tensor, B: int, n_win: int,
                stride: int) -> torch.Tensor:
    """Chunk stack U f32[..., n, 2N, 2N] → B windows f32[..., B, 2N, 2N],
    window w the sum of chunks w·stride … w·stride + n_win − 1: strided
    differences of the prefix sums along the chunk axis (any overlap)."""
    if n_win == 1:                       # g = S: chunks are the windows
        return U[..., :B, :, :]
    lead = U.shape[:-3]
    csum = torch.cat([U.new_zeros(lead + (1,) + U.shape[-2:]),
                      torch.cumsum(U, dim=-3)], dim=-3)
    lo = csum[..., 0:(B - 1) * stride + 1:stride, :, :]
    hi = csum[..., n_win:n_win + (B - 1) * stride + 1:stride, :, :]
    return hi - lo


def cov_embedded(xil: torch.Tensor, cr: torch.Tensor, ci: torch.Tensor, *,
                 N: int, snapshot_size: int, overlap: int = 0,
                 fb: bool = False, compute_dtype="float32",
                 variant: str = "stacked",
                 kernel=None) -> torch.Tensor:
    """xil: the capture as x[T, 2N] (or any shape with the same bytes,
    e.g. doa_tpu's (T/TPACK, 2N·TPACK)); cr/ci: f32[N] correction →
    E(R) windows f32[B, 2N, 2N], normalised by S, with the correction
    and optional FB folded in. Any 0 ≤ overlap < S: chunks of
    g = gcd(S, hop) samples, n_win = S/g chunks a window.

    compute_dtype "float32" | "bfloat16" | "int8" (or the torch dtype):
    bfloat16 rounds a float32 capture to bfloat16 before the Gram (f32
    accumulation); int8 is the ingest-quantized mode and needs an int8
    capture (io.native.quantize_interleaved_int8).

    variant "stacked": the stage is asked for the windows' E (`embed`,
    and `windows` where a window spans chunks) and takes the epilogue
    gram_epilogue names on the card: kernel 9's entry where a window is
    one chunk (g = S), its window entry where windows overlap (float32 and
    bfloat16 rows, the shapes it takes), else K1's interleaved-basis chunk
    Grams, prefix-sum windows, then the embedding, correction and FB on
    the windows. "chunk": kernel 9's per-chunk E (embedding, correction,
    FB and 1/S in the kernel), then the prefix-sum windows. The int8 mode
    takes the stacked variant only, with K1's Grams.

    kernel: the variant's kernel stage, chunk_grams_uhat ("stacked") or
    chunk_embedded ("chunk") by default; the pipelines pass its plain
    version where their kernel plan says so."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; one of {VARIANTS}")
    dt = _DTYPES.get(compute_dtype, compute_dtype)
    S = snapshot_size
    hop = S - overlap
    g = math.gcd(S, hop)
    x = xil.reshape(-1, 2 * N)
    if dt == torch.int8:
        if variant != "stacked":
            raise ValueError("int8 ingest supports the stacked variant")
        if x.dtype != torch.int8:
            raise ValueError(
                "cov_dtype='int8' is the ingest-quantized mode: feed an "
                "int8 capture (io.native.quantize_interleaved_int8)")
    elif dt == torch.bfloat16:
        x = x.to(torch.bfloat16)
    elif dt == torch.float32:
        x = x.to(torch.float32)
    else:
        raise ValueError(f"unsupported compute_dtype {compute_dtype!r}")
    T = x.shape[0]
    if T < S:
        raise ValueError(f"capture of {T} samples is shorter than one "
                         f"window ({S})")
    n = T // g
    B = (T - S) // hop + 1
    n_win = S // g
    stride = hop // g
    W = correction_pattern(cr, ci)
    if variant == "chunk":
        # every step is linear in the chunk's Gram: E of a window is the
        # sum of its chunks' E
        E = (kernel or chunk_embedded)(x[:n * g], g, N, 1.0 / S, W, fb)
        return window_sums(E, B, n_win, stride)
    stage, embed = kernel or chunk_grams_uhat, (N, 1.0 / S, W, fb)
    if n_win == 1:
        # the chunks are the windows (B = n): E from the stage's epilogue
        return stage(x[:n * g], g, embed=embed)
    # every step of the fold is linear: the stage sums the windows
    return stage(x[:n * g], g, embed=embed, windows=(B, n_win, stride))
