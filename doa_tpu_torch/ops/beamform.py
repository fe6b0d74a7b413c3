"""MVDR beamforming: extract each source's waveform after DoA (port of
doa_tpu/ops/beamform.py).

MVDR weights toward angle θ, w = R⁻¹a / (aᴴR⁻¹a) (unit gain toward θ,
interference and noise power least), solved on the real 2N embedding
with a Cholesky factor and two triangular solves, then applied window
by window: y[t] = wᴴ x[t]. Inputs and outputs are (re, im) f32 planes,
the convention of the port's ``*_cpx`` functions; every product is true
FP32 (cpx.fp32_matmuls).
"""

from __future__ import annotations

import torch

from doa_tpu_torch.cpx import embed_planes, fp32_matmuls
from doa_tpu_torch.ops.steering import ula_phase


def mvdr_weights_cpx(Rr: torch.Tensor, Ri: torch.Tensor, ar: torch.Tensor,
                     ai: torch.Tensor, diag_load: float = 1e-3):
    """Covariance planes f32[B, N, N] and each window's look direction
    a = ar + j·ai f32[B, N] → the weights' planes (wr, wi) f32[B, N].

    E(R)ũ = ã on the embedding (R loaded by diag_load·tr(R)/N and
    symmetrized, ½(E + Eᵀ), as jax.lax.linalg.cholesky does by default),
    w̃ = ũ / max(ãᵀũ, 1e-30); the embedded solution maps back to the
    complex weights exactly."""
    N = Rr.shape[-1]
    tr = torch.diagonal(Rr, dim1=-2, dim2=-1).sum(-1) / N
    eye = torch.eye(N, dtype=Rr.dtype, device=Rr.device)
    E = embed_planes(Rr + (diag_load * tr)[..., None, None] * eye, Ri)
    at = torch.cat([ar, ai], dim=-1)                       # (B, 2N)
    L, _ = torch.linalg.cholesky_ex(0.5 * (E + E.mT))
    with fp32_matmuls():
        u = torch.linalg.solve_triangular(L, at[..., None], upper=False)
        u = torch.linalg.solve_triangular(L.mT, u, upper=True)[..., 0]
    den = (at * u).sum(-1, keepdim=True)                   # Re(aᴴR⁻¹a)
    u = u / den.clamp_min(1e-30)
    return u[..., :N], u[..., N:]


def apply_beamformer_cpx(xr: torch.Tensor, xi: torch.Tensor,
                         wr: torch.Tensor, wi: torch.Tensor):
    """Framed samples' planes f32[B, S, N] and weights' planes f32[B, N]
    → the beamformed planes (yr, yi) f32[B, S], y[t] = Σ_n conj(w_n)·x[t, n]."""
    dot = lambda x, w: torch.matmul(x, w[..., None])[..., 0]  # noqa: E731
    with fp32_matmuls():
        # conj(w) = wr − j·wi
        yr = dot(xr, wr) + dot(xi, wi)
        yi = dot(xi, wr) - dot(xr, wi)
    return yr, yi


def extract_source_ula(xr: torch.Tensor, xi: torch.Tensor, Rr: torch.Tensor,
                       Ri: torch.Tensor, theta_deg, norm_spacing: float,
                       snapshot_size: int, diag_load: float = 1e-3):
    """Samples' planes f32[T, N], each window's covariance planes
    f32[B, N, N] and look angle theta_deg f32[B] → the beamformed stream
    (yr, yi) f32[B, S]: window b's MVDR toward its θ applied to its S
    samples (framed without overlap)."""
    N = xr.shape[-1]
    S = snapshot_size
    B = Rr.shape[0]
    theta = torch.deg2rad(torch.as_tensor(theta_deg, dtype=torch.float32,
                                          device=Rr.device))
    ph = ula_phase(theta, N, norm_spacing)                 # (B, N)
    wr, wi = mvdr_weights_cpx(Rr, Ri, torch.cos(ph), torch.sin(ph),
                              diag_load)
    return apply_beamformer_cpx(xr[:B * S].reshape(B, S, N),
                                xi[:B * S].reshape(B, S, N), wr, wi)
