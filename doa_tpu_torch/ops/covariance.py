"""Snapshot covariance on complex64 tensors (port of
doa_tpu/ops/covariance.py, the complex-typed path of ``pipeline.py``).

A capture x c64[T, N] becomes every window's sample covariance at once,
R c64[B, N, N], R_ij = (1/S) Σ_s x_si conj(x_sj), window b covering
samples [b·hop, b·hop + S), hop = S − overlap:

  * ``frame_samples`` + ``sample_covariance``: the frames (B, S, N) as a
    strided view, one batched complex product;
  * ``cov_from_stream``: where hop divides S, one Gram per hop-chunk
    (one complex ``torch.matmul``), and each window the difference of
    two prefix sums of those Grams, as the reference; an irregular
    overlap frames the capture explicitly.

Every product is true FP32 (cpx.fp32_matmuls). Every division by a
count divides the real and imaginary parts by that count as a tensor
on the data's device: a CUDA tensor divided by a Python number is
multiplied by its rounded reciprocal instead (ROADMAP.md §C.4), which
would set the card one rounding from the CPU. This module is the
complex-typed one; ``ops/cuda/covariance.py`` is the planes path's
kernel wrapper.
"""

from __future__ import annotations

import torch

from doa_tpu_torch.cpx import checked_device, fp32_matmuls


def _div_count(R: torch.Tensor, n: int) -> torch.Tensor:
    """R / n for a complex R and a count n: each part divided by n as an
    f32 tensor on R's device (a true division on the card too)."""
    d = torch.full((), n, dtype=torch.float32, device=R.device)
    return torch.complex(R.real / d, R.imag / d)


def _gram(xs: torch.Tensor) -> torch.Tensor:
    """xs c64[..., S, N] → Σ_s x_si conj(x_sj) c64[..., N, N]."""
    with fp32_matmuls():
        return torch.matmul(xs.transpose(-1, -2), xs.conj())


def frame_samples(x: torch.Tensor, snapshot_size: int, overlap: int):
    """x (T, N) → frames (B, S, N), a view; window b covers
    [b·hop, b·hop + S). Trailing samples that fill no window are
    dropped."""
    S = snapshot_size
    hop = S - overlap
    T, N = x.shape
    if T < S:
        return x.new_empty((0, S, N))
    return x.unfold(0, S, hop).transpose(-1, -2)


def sample_covariance(frames: torch.Tensor, fb_average: bool = False):
    """frames (B, S, N) → R (B, N, N), R_ij = (1/S) Σ_s x_si conj(x_sj)."""
    R = _div_count(_gram(frames), frames.shape[-2])
    if fb_average:
        R = forward_backward(R)
    return R


def cov_from_stream(x: torch.Tensor, snapshot_size: int, overlap: int,
                    fb_average: bool = False):
    """x c64[T, N] → R c64[B, N, N] without framing the overlapped
    windows: where hop = S − overlap divides S, the chunk Grams C_j of
    the hop-chunks and each window's Σ_{j=b}^{b+S/hop−1} C_j as the
    difference of two prefix sums; otherwise the explicit frames."""
    S = snapshot_size
    hop = S - overlap
    if S % hop != 0:
        return sample_covariance(frame_samples(x, S, overlap), fb_average)
    n = S // hop
    T, N = x.shape
    num_chunks = T // hop
    B = 0 if T < S else (T - S) // hop + 1
    C = _gram(x[:num_chunks * hop].reshape(num_chunks, hop, N))
    csum = torch.cat([C.new_zeros((1, N, N)), torch.cumsum(C, dim=0)])
    R = _div_count(csum[n:n + B] - csum[:B], S)
    if fb_average:
        R = forward_backward(R)
    return R


def forward_backward(R: torch.Tensor) -> torch.Tensor:
    """R_fb = (R + J conj(R) J) / 2."""
    return 0.5 * (R + R.flip(-2, -1).conj())


def spatial_smooth(R: torch.Tensor, subarray_size: int) -> torch.Tensor:
    """Forward spatial smoothing: the mean of the M = N − L + 1
    principal L×L sub-blocks, R (..., N, N) → (..., L, L)."""
    N = R.shape[-1]
    L = subarray_size
    M = N - L + 1
    acc = R[..., 0:L, 0:L]
    for m in range(1, M):
        acc = acc + R[..., m:m + L, m:m + L]
    return _div_count(acc, M)


def streaming_covariance(carry_csum: torch.Tensor, x_chunk: torch.Tensor,
                         snapshot_size: int, hop: int):
    """One sliding-window update: the ring carry_csum c64[S/hop, N, N] of
    the last chunk Grams and the new samples x_chunk c64[hop, N] →
    (the new ring, R of the latest full window = the ring's sum / S).
    hop must divide snapshot_size."""
    if snapshot_size % hop != 0:
        raise ValueError("hop must divide snapshot_size for streaming mode")
    C = _gram(x_chunk)
    new_carry = torch.cat([carry_csum[1:], C[None]], dim=0)
    return new_carry, _div_count(new_carry.sum(dim=0), snapshot_size)


def init_streaming_carry(num_elements: int, snapshot_size: int, hop: int,
                         dtype=torch.complex64, *, device="cuda"):
    """The zero ring of chunk Grams for ``streaming_covariance``, on the
    card unless the caller asks for the CPU (no card: RuntimeError)."""
    return torch.zeros((snapshot_size // hop, num_elements, num_elements),
                       dtype=dtype, device=checked_device(device))
