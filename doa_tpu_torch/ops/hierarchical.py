"""Hierarchical (coarse → refine) MUSIC and Capon scans — port of
doa_tpu/ops/hierarchical.py.

A coarse dense scan finds each peak's basin (the MUSIC denominator is
aperture-smooth, so a ~1° grid does not miss a basin even where the null
is sharp); a refine stage then evaluates the exact denominator on a
micro-grid around each coarse peak, its steering made on the device at
those data-dependent angles, and takes a parabolic minimum. Resolution
no longer grows with the grid: the cost is the coarse scan plus
B·k·W steering vectors.

Tensors follow the port's transposed subspace layout: Vt f32[B, 2K, 2N],
rows orthonormal (the reference's V_emb f32[B, 2N, 2K] swapped). The
coarse scan is a callable the pipeline hands in from its plan (K2 with
refine=False, or K3 + normalise + peaks, kernel 6 on a 2-D grid); the
default is the reference's dense route in torch ops. Capon factors the
loaded 2N embedding once a window (cholesky_ex: no host sync) and reuses
the factor for the coarse scan and the refine. Every product runs in
true FP32.
"""

from __future__ import annotations

import math

import torch

from doa_tpu_torch.cpx import embed_planes, fp32_matmuls
from doa_tpu_torch.ops.cpx_ops import (music_denominator_subspace,
                                       spectrum_from_den)
from doa_tpu_torch.ops.peaks import find_local_max, find_local_max_2d


def _offsets(half_width_deg: float, num_points: int, ref: torch.Tensor):
    return torch.linspace(-half_width_deg, half_width_deg, num_points,
                          dtype=torch.float32, device=ref.device)


def ula_steering_rows(theta_deg: torch.Tensor, N: int,
                      norm_spacing: float) -> torch.Tensor:
    """Embedded ULA steering at angles theta_deg f32[...] → f32[..., 2N]
    ([cos; sin] of the phase −2π·d·cos θ·n, in the reference's order of
    products)."""
    theta = torch.deg2rad(theta_deg)
    k = torch.arange(N, dtype=torch.float32, device=theta.device)
    phase = (-2.0 * math.pi * norm_spacing) * torch.cos(theta)[..., None] * k
    return torch.cat([torch.cos(phase), torch.sin(phase)], dim=-1)


def ura_steering_rows(az_deg: torch.Tensor, el_deg: torch.Tensor, shape,
                      norm_spacing: float) -> torch.Tensor:
    """Embedded URA steering at (az, el) f32[...] each → f32[..., 2N]
    (direction cosines ux = cos el·sin az, uy = cos el·cos az; x-major
    flattening, as ops/steering.ura_grid)."""
    nx, ny = shape
    az = torch.deg2rad(az_deg)
    el = torch.deg2rad(el_deg)
    ux = torch.cos(el) * torch.sin(az)
    uy = torch.cos(el) * torch.cos(az)
    ix = torch.arange(nx, dtype=torch.float32, device=az.device)[:, None]
    iy = torch.arange(ny, dtype=torch.float32, device=az.device)[None, :]
    phase = (-2.0 * math.pi * norm_spacing) * (ux[..., None, None] * ix
                                               + uy[..., None, None] * iy)
    phase = phase.reshape(*az.shape, nx * ny)
    return torch.cat([torch.cos(phase), torch.sin(phase)], dim=-1)


def _den_at(Vt: torch.Tensor, at: torch.Tensor) -> torch.Tensor:
    """‖a‖² − ‖Vt·ã‖² for rows ã f32[B, ..., 2N] of unit-modulus steering
    (‖a‖² = N exactly) → f32[B, ...]."""
    B, n2 = at.shape[0], at.shape[-1]
    with fp32_matmuls():
        Y = torch.matmul(at.reshape(B, -1, n2), Vt.transpose(-1, -2))
    return (n2 // 2) - (Y * Y).sum(-1).reshape(at.shape[:-1])


def ula_denominator_at(Vt: torch.Tensor, theta_deg: torch.Tensor,
                       norm_spacing: float) -> torch.Tensor:
    """The exact MUSIC denominator of a ULA at angles theta_deg f32[B, ...]
    for the subspaces Vt f32[B, 2K, 2N] → f32[B, ...]."""
    at = ula_steering_rows(theta_deg, Vt.shape[-1] // 2, norm_spacing)
    return _den_at(Vt, at)


def ura_denominator_at(Vt: torch.Tensor, az_deg: torch.Tensor,
                       el_deg: torch.Tensor, shape,
                       norm_spacing: float) -> torch.Tensor:
    """The exact MUSIC denominator of a planar array at (az, el)
    f32[B, ...] each → f32[B, ...]."""
    return _den_at(Vt, ura_steering_rows(az_deg, el_deg, shape,
                                         norm_spacing))


def _take(t: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    return torch.gather(t, -1, i[..., None])[..., 0]


def parabolic_vertex(d: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """The offset, in steps, of the vertex of the parabola through
    d[i − 1], d[i], d[i + 1] along the last axis (the neighbours clamped
    to it), clipped to ±1; 0 at the axis ends or where the three points
    are collinear."""
    W = d.shape[-1]
    dm = _take(d, (i - 1).clamp(0, W - 1))
    d0 = _take(d, i)
    dp = _take(d, (i + 1).clamp(0, W - 1))
    curv = dm - 2.0 * d0 + dp
    delta = torch.where(curv.abs() > 0, 0.5 * (dm - dp) / curv,
                        torch.zeros_like(curv))
    return torch.where((i > 0) & (i < W - 1), delta.clamp(-1.0, 1.0),
                       torch.zeros_like(delta))


def parabolic_argmin(den: torch.Tensor, theta: torch.Tensor,
                     half_width_deg: float) -> torch.Tensor:
    """Argmin of den f32[..., W] over the micro-grid theta f32[..., W] and
    the parabolic vertex around it → the refined angle f32[...]."""
    W = den.shape[-1]
    i = torch.argmin(den, dim=-1)
    step = 2.0 * half_width_deg / (W - 1)
    return _take(theta, i) + parabolic_vertex(den, i) * step


def refine_peaks_ula(Vt: torch.Tensor, coarse_deg: torch.Tensor,
                     norm_spacing: float, half_width_deg: float = 1.5,
                     num_points: int = 33) -> torch.Tensor:
    """Each coarse peak f32[B, k] refined on [θc − hw, θc + hw]: the exact
    denominator at num_points angles, its argmin and parabolic vertex
    → f32[B, k]."""
    theta = coarse_deg[..., None] + _offsets(half_width_deg, num_points,
                                             coarse_deg)   # (B, k, W)
    den = ula_denominator_at(Vt, theta, norm_spacing)
    return parabolic_argmin(den, theta, half_width_deg)


def micro_grid_2d(az_deg: torch.Tensor, el_deg: torch.Tensor,
                  half_width_deg: float, num_points: int):
    """The W × W micro-grid around each (az, el) f32[B, k] → (az, el)
    f32[B, k, W, W] (az along the third axis, el along the fourth)."""
    offs = _offsets(half_width_deg, num_points, az_deg)
    W = num_points
    azg = (az_deg[..., None, None] + offs[:, None]).expand(
        *az_deg.shape, W, W)
    elg = (el_deg[..., None, None] + offs[None, :]).expand(
        *el_deg.shape, W, W)
    return azg, elg


def argbest_2d(m: torch.Tensor, azg: torch.Tensor, elg: torch.Tensor,
               largest: bool):
    """The (az, el) f32[B, k] of each micro-grid's argmin (or argmax) of
    m f32[B, k, W, W], and its flat index (first on ties)."""
    B, k, W, _ = m.shape
    flat = m.reshape(B, k, W * W)
    i = torch.argmax(flat, dim=-1) if largest else torch.argmin(flat, dim=-1)
    return (_take(azg.reshape(B, k, W * W), i),
            _take(elg.reshape(B, k, W * W), i), i)


def refine_peaks_ura(Vt: torch.Tensor, az_deg: torch.Tensor,
                     el_deg: torch.Tensor, shape, norm_spacing: float,
                     half_width_deg: float = 2.0, num_points: int = 9):
    """Each coarse (az, el) f32[B, k] refined on a W × W micro-grid of the
    exact denominator: its argmin, then the parabolic vertex of the az
    profile at the winning el and of the el profile at the winning az
    → (az, el) f32[B, k]."""
    W = num_points
    azg, elg = micro_grid_2d(az_deg, el_deg, half_width_deg, W)
    den = ura_denominator_at(Vt, azg, elg, shape, norm_spacing)
    az0, el0, i = argbest_2d(den, azg, elg, largest=False)
    ia, ie = i // W, i % W
    den_az = torch.gather(den, -1, ie[..., None, None].expand(
        *ie.shape, W, 1))[..., 0]                        # (B, k, W) over az
    den_el = torch.gather(den, -2, ia[..., None, None].expand(
        *ia.shape, 1, W))[..., 0, :]                     # (B, k, W) over el
    step = 2.0 * half_width_deg / (W - 1)
    return (az0 + parabolic_vertex(den_az, ia) * step,
            el0 + parabolic_vertex(den_el, ie) * step)


def _coarse_spectrum(Vt, At_emb, compute_dtype):
    """The reference's dense coarse scan: the max-normalised MUSIC
    spectrum f32[B, G] of the subspaces on the grid."""
    return spectrum_from_den(music_denominator_subspace(
        Vt.transpose(-1, -2), At_emb, compute_dtype).clamp_min(0.0))


def music_hierarchical_ula(Vt: torch.Tensor, At_emb: torch.Tensor,
                           num_peaks: int, norm_spacing: float,
                           coarse_rng=(0.0, 180.0),
                           half_width_deg: float = 1.5,
                           num_points: int = 33,
                           compute_dtype: str = "float32", coarse=None):
    """Coarse → refine MUSIC on a ULA: Vt f32[B, 2K, 2N], the coarse grid
    At_emb f32[G, 2N] over coarse_rng → (values f32[B, k], the coarse
    max-normalised peak values; angles f32[B, k], refined).

    coarse: Vt → (values, coarse angles) of the coarse scan's unrefined
    peaks (the pipeline's K2 or K3 route); None takes the dense scan at
    compute_dtype and find_local_max."""
    if coarse is None:
        vals, ang = find_local_max(
            _coarse_spectrum(Vt, At_emb, compute_dtype), num_peaks,
            coarse_rng[0], coarse_rng[1], refine=False)
    else:
        vals, ang = coarse(Vt)
    return vals, refine_peaks_ula(Vt, ang, norm_spacing, half_width_deg,
                                  num_points)


def music_hierarchical_ura(Vt: torch.Tensor, At_emb: torch.Tensor,
                           num_peaks: int, shape, norm_spacing: float,
                           grid2d, compute_dtype: str = "float32",
                           half_width_deg: float = 2.0,
                           num_points: int = 9, coarse=None):
    """Coarse → refine MUSIC on a planar array (az/el): the coarse grid is
    grid2d's (At_emb f32[Ga·Ge, 2N], az-major) → (values, az, el), each
    f32[B, k]. coarse: Vt → (values, az, el) of the coarse scan's
    unrefined 2-D peaks; None takes the dense scan and
    find_local_max_2d."""
    if coarse is None:
        P = _coarse_spectrum(Vt, At_emb, compute_dtype)
        vals, az, el = find_local_max_2d(
            P.reshape(P.shape[0], grid2d.num_az, grid2d.num_el), num_peaks,
            (grid2d.az_lo_deg, grid2d.az_hi_deg),
            (grid2d.el_lo_deg, grid2d.el_hi_deg), refine=False)
    else:
        vals, az, el = coarse(Vt)
    az, el = refine_peaks_ura(Vt, az, el, shape, norm_spacing,
                              half_width_deg, num_points)
    return vals, az, el


def capon_cholesky(Rr: torch.Tensor, Ri: torch.Tensor,
                   diag_load: float) -> torch.Tensor:
    """The Cholesky factor L f32[B, 2N, 2N] of E(R + load·tr(R)/N·I), one
    a window (cholesky_ex: no host sync)."""
    N = Rr.shape[-1]
    if diag_load > 0:
        tr = torch.diagonal(Rr, dim1=-2, dim2=-1).sum(-1) / N
        eye = torch.eye(N, dtype=Rr.dtype, device=Rr.device)
        Rr = Rr + (diag_load * tr)[..., None, None] * eye
    with fp32_matmuls():
        return torch.linalg.cholesky_ex(embed_planes(Rr, Ri))[0]


def capon_den_at(L: torch.Tensor, at: torch.Tensor) -> torch.Tensor:
    """den = ‖L⁻¹ã‖² for steering rows ã f32[B, ..., 2N], or one set
    f32[G, 2N] shared by every window, against the factors L f32[B, 2N,
    2N] → f32[B, ...]."""
    B, n2 = L.shape[0], L.shape[-1]
    if at.dim() == 2:
        rhs, lead = at.T.expand(B, n2, at.shape[0]), at.shape[:1]
    else:
        rhs, lead = at.reshape(B, -1, n2).transpose(1, 2), at.shape[1:-1]
    with fp32_matmuls():
        X = torch.linalg.solve_triangular(L, rhs, upper=False)
    return (X * X).sum(-2).reshape(B, *lead)


def capon_hierarchical_ula(Rr: torch.Tensor, Ri: torch.Tensor,
                           At_emb: torch.Tensor, num_peaks: int,
                           norm_spacing: float, diag_load: float = 1e-4,
                           coarse_rng=(0.0, 180.0),
                           half_width_deg: float = 1.5,
                           num_points: int = 33):
    """Coarse → refine Capon (MVDR) on a ULA: one factor of the loaded 2N
    embedding a window, the coarse spectrum on the grid At_emb f32[G, 2N]
    and its unrefined peaks, then ‖L⁻¹ã(θ)‖² on each peak's micro-grid
    and the parabolic vertex → (values, angles) f32[B, k]."""
    L = capon_cholesky(Rr, Ri, diag_load)
    vals, coarse = find_local_max(spectrum_from_den(capon_den_at(L, At_emb)),
                                  num_peaks, coarse_rng[0], coarse_rng[1],
                                  refine=False)
    theta = coarse[..., None] + _offsets(half_width_deg, num_points, coarse)
    den = capon_den_at(L, ula_steering_rows(theta, Rr.shape[-1],
                                            norm_spacing))
    return vals, parabolic_argmin(den, theta, half_width_deg)


def capon_hierarchical_ura(Rr: torch.Tensor, Ri: torch.Tensor,
                           At_emb: torch.Tensor, num_peaks: int, shape,
                           norm_spacing: float, grid2d,
                           diag_load: float = 1e-4,
                           half_width_deg: float = 2.0,
                           num_points: int = 9, peaks2d=None):
    """Coarse → refine Capon on a planar array: the coarse spectrum's
    unrefined 2-D peaks (peaks2d: the pipeline's 2-D peaks kernel, same
    signature as find_local_max_2d; None takes find_local_max_2d), then
    the argmin of ‖L⁻¹ã‖² on each peak's W × W micro-grid (no parabola,
    as the reference) → (values, az, el) f32[B, k]."""
    peaks2d = find_local_max_2d if peaks2d is None else peaks2d
    L = capon_cholesky(Rr, Ri, diag_load)
    P = spectrum_from_den(capon_den_at(L, At_emb))
    vals, az_c, el_c = peaks2d(
        P.reshape(P.shape[0], grid2d.num_az, grid2d.num_el), num_peaks,
        (grid2d.az_lo_deg, grid2d.az_hi_deg),
        (grid2d.el_lo_deg, grid2d.el_hi_deg), refine=False)
    azg, elg = micro_grid_2d(az_c, el_c, half_width_deg, num_points)
    den = capon_den_at(L, ura_steering_rows(azg, elg, shape, norm_spacing))
    az, el, _ = argbest_2d(den, azg, elg, largest=False)
    return vals, az, el
