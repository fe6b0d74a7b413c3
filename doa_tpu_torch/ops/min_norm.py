"""Min-Norm (Kumaresan–Tufts) spectra (port of the split-complex part of
doa_tpu/ops/min_norm.py).

Min-Norm scans against the one vector w of the noise subspace with
w[0] = 1 and the least norm,

    w = Pn e1 / (e1ᴴ Pn e1),   Pn = I − E_s E_sᴴ,   P(θ) = 1 / |a(θ)ᴴ w|²,

so the scan is two (B, 2N)·(2N, G) products where MUSIC's is
(B·2K, 2N)·(2N, G). From the power subspace, w comes from the embedded
signal basis V f32[B, 2N, 2K]: Pn ẽ1 = ẽ1 − V (Vᵀ ẽ1), Vᵀẽ1 being row 0
of V; from the eigh or Jacobi route, from the complex noise projector.
Every product is true FP32 (cpx.fp32_matmuls).
"""

from __future__ import annotations

import torch

from doa_tpu_torch.cpx import fp32_matmuls
from doa_tpu_torch.ops.cpx_ops import _cast, spectrum_from_den

_TINY = torch.finfo(torch.float32).tiny


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
