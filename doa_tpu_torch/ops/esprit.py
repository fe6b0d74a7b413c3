"""ESPRIT, grid-free by shift invariance (port of doa_tpu/ops/esprit.py):
LS-ESPRIT for a ULA, 2-D LS-ESPRIT for a URA and Unitary ESPRIT.

The steps, batched over windows and free of any eig:

  1. the complex signal subspace E_s c64[B, N, K] by subspace iteration
     with complex modified Gram–Schmidt every iteration;
  2. the LS solution Ψ of E_s[:-1] Ψ ≈ E_s[1:] through the K×K normal
     equations, inverted by Newton–Schulz;
  3. the eigenvalues of the K×K Ψ as the roots of its characteristic
     polynomial (Faddeev–LeVerrier), rooted by root_music's Aberth–Ehrlich
     iteration; on a URA the eigenvectors too, by Cayley–Hamilton
     products, which pair the second axis' eigenvalues;
  4. θ = acos(−arg λ / (2π d)).

Every loop has a fixed trip count (16 subspace iterations, 16
Newton–Schulz steps, 40 root iterations) and no host sync. Complex
values are complex64 tensors and every product runs in true FP32
(cpx.fp32_matmuls): cuBLAS takes TF32 for complex products as for real
ones where it is allowed.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from doa_tpu_torch.cpx import fp32_matmuls
from doa_tpu_torch.ops.root_music import polynomial_roots_cpx


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched complex product (B, m, k) @ (B, k, n) in true FP32."""
    with fp32_matmuls():
        return torch.matmul(a, b)


def _herm(a: torch.Tensor) -> torch.Tensor:
    return a.transpose(-1, -2).conj()


def _gram(a: torch.Tensor) -> torch.Tensor:
    """AᴴA for A (B, m, k) → (B, k, k) Hermitian."""
    return _mm(_herm(a), a)


def _eye_like(k: int, batch, device) -> torch.Tensor:
    return torch.eye(k, dtype=torch.complex64, device=device).expand(
        tuple(batch) + (k, k))


def _ns_inverse(G: torch.Tensor, iters: int = 16) -> torch.Tensor:
    """Newton–Schulz inverse of a Hermitian positive definite G
    c64[B, k, k]: X ← X(2I − GX) from X₀ = I / (largest absolute row
    sum)."""
    k = G.shape[-1]
    norm = G.abs().sum(-1).max(-1).values
    eye = _eye_like(k, G.shape[:-2], G.device)
    X = eye * (1.0 / norm)[..., None, None]
    two_eye = eye * 2.0
    for _ in range(iters):
        X = _mm(X, two_eye - _mm(G, X))
    return X


def _mgs_cols_cpx(V: torch.Tensor) -> torch.Tensor:
    """Complex modified Gram–Schmidt over the K columns of V c64[B, N, K]:
    exact sequential deflation, which keeps a weak direction that a
    Gram-based orthonormaliser loses when closely spaced or imbalanced
    sources make the iterated columns collinear."""
    cols = []
    for i in range(V.shape[-1]):
        v = V[..., :, i]
        for u in cols:
            v = v - (u.conj() * v).sum(-1, keepdim=True) * u   # <u, v> u
        inv = torch.rsqrt((v.real * v.real + v.imag * v.imag).sum(
            -1, keepdim=True).clamp_min(1e-30))
        cols.append(v * inv)
    return torch.stack(cols, dim=-1)


def signal_subspace_cpx(R: torch.Tensor, num_sources: int,
                        iters: int = 16) -> torch.Tensor:
    """Orthonormal complex signal basis E_s c64[B, N, K] of R c64[B, N, N]
    by subspace iteration from R's first K columns, MGS every iteration
    (ESPRIT needs a complex-paired basis, which the real embedded one is
    not)."""
    V = _mgs_cols_cpx(R[..., :, :num_sources])
    for _ in range(iters):
        V = _mgs_cols_cpx(_mm(R, V))
    return V


def _char_poly_coeffs(Psi: torch.Tensor) -> torch.Tensor:
    """Characteristic polynomial of Ψ c64[B, K, K] by Faddeev–LeVerrier →
    ascending coefficients c64[B, K+1] of the monic
    p(λ) = λ^K + c_{K-1} λ^{K-1} + … + c_0."""
    K = Psi.shape[-1]
    batch = Psi.shape[:-2]
    eye = _eye_like(K, batch, Psi.device)
    coeffs = []                                   # c_{K-1}, …, c_0
    Mk = eye
    for k in range(1, K + 1):
        AM = _mm(Psi, Mk)
        ck = torch.diagonal(AM, dim1=-2, dim2=-1).sum(-1) * (-1.0 / k)
        coeffs.append(ck)
        Mk = AM + eye * ck[..., None, None]       # Ψ·M_k + c_k I
    ones = torch.ones(batch + (1,), dtype=Psi.dtype, device=Psi.device)
    return torch.cat([torch.stack(coeffs[::-1], dim=-1), ones], dim=-1)


def _angles(lam: torch.Tensor, norm_spacing: float) -> torch.Tensor:
    """Shift eigenvalues λ = exp(−j2πd cosθ) → θ degrees, ascending."""
    cos_theta = (-torch.angle(lam) / (2 * math.pi * norm_spacing)).clamp(
        -1.0, 1.0)
    return torch.sort(torch.rad2deg(torch.arccos(cos_theta)), dim=-1).values


def _psi(E1: torch.Tensor, E2: torch.Tensor) -> torch.Tensor:
    """The LS shift operator Ψ = (E1ᴴE1)⁻¹ E1ᴴE2."""
    return _mm(_ns_inverse(_gram(E1)), _mm(_herm(E1), E2))


def esprit_cpx(Rr: torch.Tensor, Ri: torch.Tensor, num_sources: int,
               norm_spacing: float, subspace_iters: int = 16,
               root_iters: int = 40) -> torch.Tensor:
    """LS-ESPRIT on a ULA: covariance planes (Rr, Ri) f32[B, N, N] → DoA
    f32[B, K] degrees, ascending."""
    Es = signal_subspace_cpx(torch.complex(Rr, Ri), num_sources,
                             iters=subspace_iters)
    Psi = _psi(Es[:, :-1, :], Es[:, 1:, :])
    lam = polynomial_roots_cpx(_char_poly_coeffs(Psi), num_iters=root_iters)
    return _angles(lam, norm_spacing)


def _eig_small_cpx(Psi: torch.Tensor, root_iters: int = 40):
    """Eigenvalues and eigenvectors of a small (K ≤ 4) batched complex
    matrix, eig-free: the eigenvalues as the roots of the characteristic
    polynomial; the eigenvector of λ_i as t_i = Π_{j≠i}(Ψ − λ_j I)·𝟙,
    normalised after each factor (for a diagonalisable Ψ the product maps
    any generic vector onto the λ_i eigenspace) → (lam c64[B, K],
    T c64[B, K, K] columns the eigenvectors). Assumes distinct
    eigenvalues."""
    K = Psi.shape[-1]
    batch = Psi.shape[:-2]
    lam = polynomial_roots_cpx(_char_poly_coeffs(Psi), num_iters=root_iters)
    eye = _eye_like(K, batch, Psi.device)
    cols = []
    for i in range(K):
        v = torch.ones(batch + (K, 1), dtype=Psi.dtype, device=Psi.device)
        for j in range(K):
            if j == i:
                continue
            v = _mm(Psi - eye * lam[..., j, None, None], v)
            nrm = torch.sqrt((v.real * v.real + v.imag * v.imag).sum(
                -2, keepdim=True))
            v = v / nrm.clamp_min(1e-30)
        cols.append(v)
    return lam, torch.cat(cols, dim=-1)


def esprit_2d_cpx(Rr: torch.Tensor, Ri: torch.Tensor, num_sources: int,
                  norm_spacing: float, shape, subspace_iters: int = 16,
                  root_iters: int = 40):
    """2-D LS-ESPRIT on a uniform rectangular array: covariance planes
    f32[B, N, N], N = nx·ny (x-major, as ops.steering.ura_grid) →
    (az_deg, el_deg) each f32[B, K], pairs aligned, sorted by azimuth.

    The x shift's Ψx gives the x direction cosines and the mixing T (its
    eigenvectors); the y eigenvalues pair as the Rayleigh quotients
    t_iᴴ(Ψy t_i)/t_iᴴt_i, since Ψx and Ψy share eigenvectors. Sources
    must have distinct x cosines."""
    nx, ny = shape
    K = num_sources
    Es = signal_subspace_cpx(torch.complex(Rr, Ri), K, iters=subspace_iters)
    B = Es.shape[0]
    E4 = Es.reshape(B, nx, ny, K)
    Psix = _psi(E4[:, :-1].reshape(B, (nx - 1) * ny, K),
                E4[:, 1:].reshape(B, (nx - 1) * ny, K))
    Psiy = _psi(E4[:, :, :-1].reshape(B, nx * (ny - 1), K),
                E4[:, :, 1:].reshape(B, nx * (ny - 1), K))
    lamx, T = _eig_small_cpx(Psix, root_iters=root_iters)
    W = _mm(Psiy, T)
    # ⟨t_i, w_i⟩ / ⟨t_i, t_i⟩ per column
    nre = (T.real * W.real + T.imag * W.imag).sum(-2)
    nim = (T.real * W.imag - T.imag * W.real).sum(-2)
    den = (T.real * T.real + T.imag * T.imag).sum(-2).clamp_min(1e-30)
    muy = torch.complex(nre / den, nim / den)             # (B, K)
    # steering phase −2πd(ux·ix + uy·iy): shift factor e^{−j2πd·u}
    scale = 2.0 * math.pi * norm_spacing
    ux = -torch.angle(lamx) / scale
    uy = -torch.angle(muy) / scale
    az = torch.rad2deg(torch.atan2(ux, uy))
    el = torch.rad2deg(torch.arccos(torch.sqrt(ux * ux + uy * uy).clamp(
        0.0, 1.0)))
    az, order = torch.sort(az, dim=-1, stable=True)
    return az, torch.gather(el, -1, order)


# ---------------------------------------------------------------------
# Unitary ESPRIT (Haardt–Nossek): after one complex→real transform the
# subspace, the LS invariance and the eigenvalues are real arithmetic,
# and forward-backward averaging is implicit in the transform
# ---------------------------------------------------------------------

def _real_signal_subspace(C: torch.Tensor, num_sources: int,
                          iters: int = 16) -> torch.Tensor:
    """Orthonormal top-K basis f32[B, N, K] of the real symmetric batch
    C f32[B, N, N] by subspace iteration from a fixed random orthonormal
    start (an O(1) overlap with every eigendirection) with MGS every
    iteration: exact deflation keeps the weak direction of a coherent
    pair that FB decorrelated, at any eigenvalue spread."""
    K = num_sources
    N = C.shape[-1]
    rng = np.random.default_rng(2024)
    V0, _ = np.linalg.qr(rng.standard_normal((N, K)).astype(np.float32))
    V = torch.from_numpy(np.ascontiguousarray(V0, dtype=np.float32)).to(
        C.device).expand(C.shape[:-2] + (N, K))

    def mgs(V):
        cols = []
        for i in range(K):
            v = V[..., :, i]
            for u in cols:
                v = v - (u * v).sum(-1, keepdim=True) * u
            v = v / torch.sqrt((v * v).sum(-1, keepdim=True).clamp_min(1e-30))
            cols.append(v)
        return torch.stack(cols, dim=-1)

    for _ in range(iters):
        V = mgs(_mm(C, V))
    return V


def _unitary_q_np(N: int) -> np.ndarray:
    """The unitary left-Π-real matrix Q_N (complex128, N×N)."""
    m = N // 2
    I = np.eye(m)
    P = I[::-1]
    if N % 2 == 0:
        top = np.concatenate([I, 1j * I], axis=1)
        bot = np.concatenate([P, -1j * P], axis=1)
        return np.concatenate([top, bot], axis=0) / np.sqrt(2)
    z = np.zeros((m, 1))
    top = np.concatenate([I, z, 1j * I], axis=1)
    mid = np.concatenate([z.T, [[np.sqrt(2)]], z.T], axis=1)
    bot = np.concatenate([P, z, -1j * P], axis=1)
    return np.concatenate([top, mid, bot], axis=0) / np.sqrt(2)


def unitary_esprit_cpx(Rr: torch.Tensor, Ri: torch.Tensor, num_sources: int,
                       norm_spacing: float, subspace_iters: int = 16,
                       root_iters: int = 40) -> torch.Tensor:
    """Unitary ESPRIT on a ULA: covariance planes f32[B, N, N] → DoA
    f32[B, K] degrees, ascending.

    C = Re(Q_Nᴴ R Q_N) (the real FB covariance); its real signal basis;
    the real LS invariance Υ = (K1 Es)⁺(K2 Es); Υ's eigenvalues ω by its
    characteristic polynomial and Aberth–Ehrlich (their real parts: real
    in the noiseless model); μ = −2·arctan(ω), θ = acos(μ/(2πd))."""
    N = Rr.shape[-1]
    dev = Rr.device
    QN = _unitary_q_np(N)
    QN1 = _unitary_q_np(N - 1)
    J2 = np.zeros((N - 1, N), np.float32)
    J2[np.arange(N - 1), np.arange(1, N)] = 1.0
    Mk = QN1.conj().T @ J2 @ QN                       # (N-1, N) complex
    t = lambda a: torch.from_numpy(  # noqa: E731
        np.ascontiguousarray(a.astype(np.float32))).to(dev)
    K1, K2 = t(2.0 * Mk.real), t(2.0 * Mk.imag)
    Qr, Qi = t(QN.real), t(QN.imag)
    with fp32_matmuls():
        # C = Re(Qᴴ R Q) = Qrᵀ(Rr Qr − Ri Qi) + Qiᵀ(Ri Qr + Rr Qi)
        T1 = torch.matmul(Rr, Qr) - torch.matmul(Ri, Qi)
        T2 = torch.matmul(Ri, Qr) + torch.matmul(Rr, Qi)
        C = torch.matmul(Qr.T, T1) + torch.matmul(Qi.T, T2)
        C = 0.5 * (C + C.transpose(-1, -2))
        Es = _real_signal_subspace(C, num_sources, iters=subspace_iters)
        A1 = torch.matmul(K1, Es)                     # (B, N-1, K)
        A2 = torch.matmul(K2, Es)
        G = torch.matmul(A1.transpose(-1, -2), A1)
        Ginv = _ns_inverse(torch.complex(G, torch.zeros_like(G))).real
        Ups = torch.matmul(Ginv, torch.matmul(A1.transpose(-1, -2), A2))
    lam = polynomial_roots_cpx(
        _char_poly_coeffs(torch.complex(Ups, torch.zeros_like(Ups))),
        num_iters=root_iters)
    mu = -2.0 * torch.arctan(lam.real)
    cos_theta = (mu / (2.0 * math.pi * norm_spacing)).clamp(-1.0, 1.0)
    return torch.sort(torch.rad2deg(torch.arccos(cos_theta)), dim=-1).values
