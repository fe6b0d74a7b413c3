"""Root-MUSIC for uniform linear arrays, grid-free (port of
doa_tpu/ops/root_music.py: its complex-typed functions, which the
complex pipeline (``pipeline.py``) calls, and its split-complex ones,
which the fused and planes paths call).

The noise-subspace polynomial D(z) = Σ_{l=-(N-1)}^{N-1} c_l z^{l+N-1},
c_l the l-th diagonal sum of the noise projector M = E_n E_nᴴ, is rooted
with a batched Aberth–Ehrlich iteration: a fixed number of iterations,
every root updated at once, every window at once, no host sync inside
the loop. The K roots inside the unit circle closest to it give
θ = acos(−arg(z) / (2π d)) (steering a_k = z^k, z = exp(−j 2π d cosθ)).

Complex values are complex64 tensors in both halves. The two halves
mirror two reference functions that differ in their arithmetic:
``polynomial_roots`` divides natively and guards p'(z) == 0 and a zero
denominator, as the reference's complex-typed root finder;
``polynomial_roots_cpx`` divides by the textbook (a·conj(b))/|b|² and
guards |b|² > 0, as its split-complex one.
"""

from __future__ import annotations

import math

import torch

from doa_tpu_torch.ops.cpx_ops import noise_projector
from doa_tpu_torch.ops.music import noise_projector as noise_projector_c64


def _poly_and_deriv_cpx(coeffs: torch.Tensor, z: torch.Tensor):
    """p(z) and p'(z) by Horner. coeffs c64[..., D+1] ascending powers;
    z c64[..., R] → (p, dp) each c64[..., R]."""
    D = coeffs.shape[-1] - 1
    p = coeffs[..., D:D + 1].expand(z.shape)
    dp = torch.zeros_like(z)
    for m in range(D - 1, -1, -1):
        dp = dp * z + p
        p = p * z + coeffs[..., m:m + 1]
    return p, dp


def _div(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a / b for complex tensors by the textbook formula
    (a·conj(b)) / |b|², the reference's Cpx division."""
    d = b.real * b.real + b.imag * b.imag
    return torch.complex((a.real * b.real + a.imag * b.imag) / d,
                         (a.imag * b.real - a.real * b.imag) / d)


def polynomial_roots_cpx(coeffs: torch.Tensor, num_iters: int = 60):
    """Batched Aberth–Ehrlich: coeffs c64[B, D+1] ascending powers, the
    leading one nonzero → roots c64[B, D]. Starts from a spiral slightly
    off the unit circle (radius 0.92–1.02), which breaks the conjugate
    symmetry so that symmetric root pairs do not stall each other; a
    zero p'(z) or a zero denominator is replaced by 1, as the reference."""
    D = coeffs.shape[-1] - 1
    coeffs = _div(coeffs, coeffs[..., -1:].expand(coeffs.shape))
    dev = coeffs.device
    k = torch.arange(D, dtype=torch.float32, device=dev)
    radius = 0.92 + 0.05 * (k % 3)
    ang = 2 * math.pi * (k + 0.25) / D + 0.1
    z = torch.complex(radius * torch.cos(ang), radius * torch.sin(ang))
    z = z.expand(coeffs.shape[:-1] + (D,))
    eye = torch.eye(D, dtype=torch.bool, device=dev)
    one = torch.ones((), dtype=coeffs.dtype, device=dev)
    for _ in range(num_iters):
        p, dp = _poly_and_deriv_cpx(coeffs, z)
        dp = torch.where(dp.real * dp.real + dp.imag * dp.imag > 0, dp, one)
        w = _div(p, dp)
        diff = z[..., :, None] - z[..., None, :]
        dr, di = diff.real, diff.imag
        d2 = torch.where(eye, 1.0, dr * dr + di * di)
        s = torch.complex(torch.where(eye, 0.0, dr / d2).sum(-1),
                          torch.where(eye, 0.0, -di / d2).sum(-1))
        denom = 1.0 - w * s
        denom = torch.where(
            denom.real * denom.real + denom.imag * denom.imag > 0, denom,
            one)
        z = z - _div(w, denom)
    return z


def select_inside(roots: torch.Tensor, num_sources: int) -> torch.Tensor:
    """The K roots strictly inside the unit circle with |z| closest to 1
    (score 1 − |z|, +inf outside), ties to the lower index: the order
    of the reference's top_k, by a stable ascending sort of the score."""
    mag = torch.sqrt(roots.real * roots.real + roots.imag * roots.imag)
    score = torch.where(mag < 1.0, 1.0 - mag, torch.inf)
    idx = torch.sort(score, dim=-1, stable=True).indices[..., :num_sources]
    return torch.gather(roots, -1, idx)


def root_music_cpx(Rr: torch.Tensor, Ri: torch.Tensor, num_sources: int,
                   norm_spacing: float, num_iters: int = 60,
                   noise_proj=None) -> torch.Tensor:
    """Covariance planes (Rr, Ri) f32[B, N, N] → DoA f32[B, K] degrees,
    ascending. noise_proj: the noise projector's planes (Mr, Mi)
    f32[B, N, N] computed elsewhere (noise_projector_from_signal of the
    power subspace); None takes cpx_ops.noise_projector (eigh), as the
    reference."""
    N = Rr.shape[-1]
    Mr, Mi = (noise_proj if noise_proj is not None
              else noise_projector(Rr, Ri, num_sources))
    diag = lambda M, l: torch.diagonal(  # noqa: E731
        M, offset=l, dim1=-2, dim2=-1).sum(-1)
    coeffs = torch.complex(
        torch.stack([diag(Mr, l) for l in range(-(N - 1), N)], dim=-1),
        torch.stack([diag(Mi, l) for l in range(-(N - 1), N)], dim=-1))
    roots = polynomial_roots_cpx(coeffs, num_iters=num_iters)
    sel = select_inside(roots, num_sources)
    cos_theta = (-torch.angle(sel) / (2 * math.pi * norm_spacing)).clamp(
        -1.0, 1.0)
    return torch.sort(torch.rad2deg(torch.arccos(cos_theta)), dim=-1).values


# ---------------------------------------------------------------------
# The complex-typed functions (pipeline.py)
# ---------------------------------------------------------------------

# p(z) and p'(z) by Horner: the same complex products in both halves
_poly_and_deriv = _poly_and_deriv_cpx


def polynomial_roots(coeffs: torch.Tensor, num_iters: int = 60):
    """Batched Aberth–Ehrlich on complex64: coeffs c64[B, D+1] ascending
    powers, the leading one nonzero → roots c64[B, D]. The start is
    polynomial_roots_cpx's spiral; the divisions are native complex
    ones, with a zero p'(z) and a zero denominator replaced by 1, as the
    reference's complex root finder."""
    D = coeffs.shape[-1] - 1
    coeffs = coeffs / coeffs[..., -1:]
    dev = coeffs.device
    k = torch.arange(D, dtype=torch.float32, device=dev)
    radius = 0.92 + 0.05 * (k % 3)
    ang = 2 * math.pi * (k + 0.25) / D + 0.1
    z = torch.complex(radius * torch.cos(ang), radius * torch.sin(ang))
    z = z.expand(coeffs.shape[:-1] + (D,))
    eye = torch.eye(D, dtype=torch.bool, device=dev)
    one = torch.ones((), dtype=coeffs.dtype, device=dev)
    zero = torch.zeros((), dtype=coeffs.dtype, device=dev)
    for _ in range(num_iters):
        p, dp = _poly_and_deriv(coeffs, z)
        w = p / torch.where(dp == 0, one, dp)
        diff = z[..., :, None] - z[..., None, :]
        s = torch.where(eye, zero, 1.0 / torch.where(eye, one, diff)).sum(-1)
        denom = 1.0 - w * s
        z = z - w / torch.where(denom == 0, one, denom)
    return z


def root_music_coeffs(R: torch.Tensor, num_sources: int) -> torch.Tensor:
    """R c64[B, N, N] → the polynomial's coefficients c64[B, 2N − 1],
    ascending: coeffs[.., l + N − 1] = Σ diag_l(E_n E_nᴴ)."""
    N = R.shape[-1]
    C = noise_projector_c64(R, num_sources)
    return torch.stack([torch.diagonal(C, offset=l, dim1=-2, dim2=-1).sum(-1)
                        for l in range(-(N - 1), N)], dim=-1)


def select_signal_roots(roots: torch.Tensor, num_sources: int):
    """The K roots strictly inside the unit circle nearest it
    (select_inside's rule: ties to the lower index, as lax.top_k)."""
    return select_inside(roots, num_sources)


def root_music(R: torch.Tensor, num_sources: int, norm_spacing: float,
               num_iters: int = 60) -> torch.Tensor:
    """R c64[B, N, N] → DoA f32[B, K] degrees, ascending."""
    roots = polynomial_roots(root_music_coeffs(R, num_sources),
                             num_iters=num_iters)
    sel = select_signal_roots(roots, num_sources)
    cos_theta = (-torch.angle(sel) / (2 * math.pi * norm_spacing)).clamp(
        -1.0, 1.0)
    return torch.sort(torch.rad2deg(torch.arccos(cos_theta)), dim=-1).values
