"""Min-Norm (Kumaresan–Tufts), spectral and rooted (port of
doa_tpu/ops/min_norm.py: its complex-typed functions for the complex
pipeline, ``pipeline.py``, and its split-complex ones for the fused and
planes paths).

Min-Norm scans against the one vector w of the noise subspace with
w[0] = 1 and the least norm,

    w = Pn e1 / (e1ᴴ Pn e1),   Pn = I − E_s E_sᴴ,   P(θ) = 1 / |a(θ)ᴴ w|²,

so the scan is two (B, 2N)·(2N, G) products where MUSIC's is
(B·2K, 2N)·(2N, G). From the power subspace, w comes from the embedded
signal basis V f32[B, 2N, 2K]: Pn ẽ1 = ẽ1 − V (Vᵀ ẽ1), Vᵀẽ1 being row 0
of V; from the eigh or Jacobi route, from the complex noise projector.
The rooted form roots W(z) = Σ w_n zⁿ. Every product is true FP32
(cpx.fp32_matmuls).
"""

from __future__ import annotations

import math

import torch

from doa_tpu_torch.cpx import fp32_matmuls
from doa_tpu_torch.ops.cpx_ops import _cast, spectrum_from_den
from doa_tpu_torch.ops.music import noise_projector
from doa_tpu_torch.ops.root_music import polynomial_roots

_TINY = torch.finfo(torch.float32).tiny


# ---------------------------------------------------------------------
# The complex-typed functions (pipeline.py)
# ---------------------------------------------------------------------

def min_norm_weight(R: torch.Tensor, num_sources: int) -> torch.Tensor:
    """R c64[B, N, N] → w c64[B, N], the noise-subspace vector of least
    norm with w[0] = 1: Pn e1 over its first (real) entry."""
    d = noise_projector(R, num_sources)[..., :, 0]
    return d / d[..., :1].real.clamp_min(_TINY)


def min_norm_spectrum(R: torch.Tensor, steering_mat: torch.Tensor,
                      num_sources: int, normalize: bool = True):
    """R (B, N, N), A (G, N) → P = 1/|aᴴw|² f32[B, G], each window
    divided by its maximum unless normalize is False."""
    w = min_norm_weight(R, num_sources)
    with fp32_matmuls():
        s = torch.matmul(w, steering_mat.conj().T)         # (B, G)
    return spectrum_from_den((s * s.conj()).real, normalize)


def root_min_norm(R: torch.Tensor, num_sources: int, norm_spacing: float,
                  num_iters: int = 60) -> torch.Tensor:
    """Grid-free Min-Norm on a ULA: root W(z) (degree N − 1), keep the K
    roots nearest the unit circle by |1 − |z||, inside or out (ties to
    the lower index), cos θ = +arg(z)/(2πd): with a_n = exp(−j2πd cosθ·n),
    aᴴw = W(e^{+j2πd cosθ}), the sign opposite to root-MUSIC's.
    R c64[B, N, N] → f32[B, K] degrees, ascending."""
    roots = polynomial_roots(min_norm_weight(R, num_sources),
                             num_iters=num_iters)
    score = (1.0 - roots.abs()).abs()
    idx = torch.sort(score, dim=-1, stable=True).indices[..., :num_sources]
    sel = torch.gather(roots, -1, idx)
    cos_theta = (torch.angle(sel) / (2 * math.pi * norm_spacing)).clamp(
        -1.0, 1.0)
    return torch.sort(torch.rad2deg(torch.arccos(cos_theta)), dim=-1).values


# ---------------------------------------------------------------------
# The split-complex functions (the fused and planes paths)
# ---------------------------------------------------------------------


def min_norm_weight_from_signal(V_emb: torch.Tensor) -> torch.Tensor:
    """Embedded signal basis V f32[B, 2N, 2K] → embedded weight
    w̃ f32[B, 2N] = (ẽ1 − V Vᵀẽ1) / (1 − ‖V[0, :]‖²), the denominator
    e1ᴴPn e1 held at FP32's least normal value from below."""
    v0 = V_emb[..., 0, :]                                # (B, 2K)
    with fp32_matmuls():
        d = -torch.matmul(V_emb, v0[..., None])[..., 0]
    d[..., 0] += 1.0
    return d / d[..., :1].clamp_min(_TINY)


def min_norm_denominator_subspace(V_emb: torch.Tensor, A_re: torch.Tensor,
                                  A_im: torch.Tensor,
                                  compute_dtype: str = "float32"):
    """den f32[B, G] = |a_gᴴ w_b|² from the embedded signal basis and the
    steering planes (A_re, A_im) f32[G, N]: Re(aᴴw) = ãᵀw̃ and
    Im(aᴴw) = (J̃ã)ᵀw̃ with ã = [ar; ai], J̃ã = [−ai; ar].
    compute_dtype casts the products' inputs as the reference's astype
    (bfloat16 rounds, int8 truncates)."""
    w = _cast(min_norm_weight_from_signal(V_emb), compute_dtype)
    At = _cast(torch.cat([A_re, A_im], dim=-1), compute_dtype)
    AJt = _cast(torch.cat([-A_im, A_re], dim=-1), compute_dtype)
    with fp32_matmuls():
        s_re = torch.matmul(w, At.T)
        s_im = torch.matmul(w, AJt.T)
    return s_re * s_re + s_im * s_im


def min_norm_spectrum_subspace(V_emb, A_re, A_im, normalize: bool = True,
                               compute_dtype: str = "float32"):
    """Embedded signal basis and steering planes → P f32[B, G]."""
    return spectrum_from_den(min_norm_denominator_subspace(
        V_emb, A_re, A_im, compute_dtype), normalize)


def min_norm_weight_cpx(Mr: torch.Tensor, Mi: torch.Tensor):
    """Complex noise projector planes (Mr, Mi) f32[B, N, N] → w's planes
    (wr, wi) f32[B, N]: M's first column over its first (real) entry."""
    d0 = Mr[..., :1, 0].clamp_min(_TINY)
    return Mr[..., :, 0] / d0, Mi[..., :, 0] / d0


def min_norm_denominator_cpx(Mr, Mi, A_re, A_im,
                             compute_dtype: str = "float32"):
    """den f32[B, G] = |aᴴw|² from the complex noise projector's planes."""
    wr, wi = min_norm_weight_cpx(Mr, Mi)
    c = lambda t: _cast(t, compute_dtype)  # noqa: E731
    wr, wi, ar, ai = c(wr), c(wi), c(A_re), c(A_im)
    with fp32_matmuls():
        s_re = torch.matmul(wr, ar.T) + torch.matmul(wi, ai.T)   # Re(aᴴw)
        s_im = torch.matmul(wi, ar.T) - torch.matmul(wr, ai.T)   # Im(aᴴw)
    return s_re * s_re + s_im * s_im
