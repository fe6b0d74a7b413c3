"""Cramér-Rao bounds for DoA estimation — the statistical floor every
estimator in the framework is judged against (docs/ACCURACY.md). A copy
of doa_tpu/ops/crb.py (numpy only), kept here so that the port imports
nothing of doa_tpu.

The reference validates accuracy by eye against simulation (SURVEY §4);
BASELINE's quantitative metric is "DoA RMSE (deg)". A bound makes that
metric meaningful: RMSE/CRB says how much estimation efficiency is left
on the table, independent of scenario difficulty.

Host-side numpy analysis tool (K and N are tiny here; nothing in the
hot path) — formulas are Stoica & Nehorai's classic results:

  * deterministic (conditional) CRB — signal waveforms treated as
    unknown deterministic sequences:
        CRB = σ²/(2n) · [Re((Dᴴ Π_A^⊥ D) ∘ kron(1_q, Pᵀ))]⁻¹
  * stochastic (unconditional) CRB — signals ~ CN(0, P):
        CRB = σ²/(2n) · [Re((Dᴴ Π_A^⊥ D) ∘ kron(1_q, (P Aᴴ R⁻¹ A P)ᵀ))]⁻¹

with A the (N, K) steering matrix, D the (N, q·K) matrix of steering
derivatives (q parameters per source, columns ordered param-major:
column p·K + k is ∂a(θ_k)/∂param_p), Π_A^⊥ = I − A(AᴴA)⁻¹Aᴴ,
P the (K, K) source covariance, σ² the per-element noise power,
n the snapshot count, R = A P Aᴴ + σ² I.

Conventions match tests/golden.py / ops/steering.py exactly:
a(θ)_k = exp(-j·2π·d·k·cosθ) (ULA, θ from the array axis) and the
x-major planar layout of ura_steering; synth SNR convention is
per-source power = amplitude², σ² = 10^(-snr_db/10)
(io/synthetic.py::_add_noise_and_impair).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def _crb_core(A: np.ndarray, D: np.ndarray, P: np.ndarray,
              sigma2: float, n_snapshots: int,
              kind: str = "stochastic") -> np.ndarray:
    """Generic CRB matrix over the q·K real parameters (param-major
    column order, matching D). Returns (qK, qK), in the squared units of
    whatever the derivatives in D were taken with respect to."""
    N, K = A.shape
    qK = D.shape[1]
    if qK % K:
        raise ValueError(f"D has {qK} columns, not a multiple of K={K}")
    q = qK // K
    Ah = A.conj().T
    G = Ah @ A                                    # (K, K) Gram
    proj = A @ np.linalg.solve(G, Ah)             # Π_A
    DPD = D.conj().T @ (D - proj @ D)             # Dᴴ Π⊥ D, (qK, qK)
    if kind == "stochastic":
        R = A @ P @ Ah + sigma2 * np.eye(N)
        W = P @ Ah @ np.linalg.solve(R, A @ P)    # P Aᴴ R⁻¹ A P
    elif kind == "deterministic":
        W = P
    else:
        raise ValueError(f"kind must be stochastic|deterministic: {kind}")
    had = np.kron(np.ones((q, q)), W.T)
    fim = (2.0 * n_snapshots / sigma2) * np.real(DPD * had)
    return np.linalg.inv(fim)


def _ula_a_d(theta_deg, num_elements: int, norm_spacing: float):
    """Steering matrix + d a/dθ (θ in RADIANS) under the pinned sign."""
    theta = np.deg2rad(np.atleast_1d(np.asarray(theta_deg, float)))
    k = np.arange(num_elements, dtype=float)
    phase = -2.0 * np.pi * norm_spacing * np.cos(theta)[None, :] * k[:, None]
    A = np.exp(1j * phase)                        # (N, K)
    # d/dθ [-j·2πd·k·cosθ] = +j·2πd·k·sinθ
    D = (1j * 2.0 * np.pi * norm_spacing * np.sin(theta)[None, :]
         * k[:, None]) * A
    return A, D


def crb_ula_deg(theta_deg: Sequence[float], num_elements: int,
                norm_spacing: float, snr_db: float, n_snapshots: int,
                amplitudes: Optional[Sequence[float]] = None,
                correlation: Optional[np.ndarray] = None,
                kind: str = "stochastic") -> np.ndarray:
    """Per-source DoA CRB standard deviations in DEGREES for a ULA.

    snr_db/amplitudes use the synth convention (per-source power
    amplitude², noise σ² = 10^(-snr/10)); `correlation` optionally
    replaces the diagonal source covariance with an arbitrary (K, K)
    Hermitian PSD matrix of source powers/cross-powers."""
    theta = np.atleast_1d(np.asarray(theta_deg, float))
    K = theta.size
    A, D = _ula_a_d(theta, num_elements, norm_spacing)
    if correlation is not None:
        P = np.asarray(correlation, complex)
    else:
        amps = np.ones(K) if amplitudes is None else np.asarray(
            amplitudes, float)
        P = np.diag(amps.astype(complex) ** 2)
    sigma2 = 10.0 ** (-snr_db / 10.0)
    crb = _crb_core(A, D, P, sigma2, n_snapshots, kind=kind)
    return np.degrees(np.sqrt(np.diag(crb).real))


def _ura_a_d(az_deg, el_deg, shape, norm_spacing: float):
    """Planar steering + [∂a/∂az | ∂a/∂el] (radians), x-major layout."""
    az = np.deg2rad(np.atleast_1d(np.asarray(az_deg, float)))
    el = np.deg2rad(np.atleast_1d(np.asarray(el_deg, float)))
    nx, ny = shape
    ix = np.repeat(np.arange(nx, dtype=float), ny)   # x-major flatten
    iy = np.tile(np.arange(ny, dtype=float), nx)
    ux = np.cos(el) * np.sin(az)
    uy = np.cos(el) * np.cos(az)
    phase = -2.0 * np.pi * norm_spacing * (
        ix[:, None] * ux[None, :] + iy[:, None] * uy[None, :])
    A = np.exp(1j * phase)                           # (N, K)
    dux_daz = np.cos(el) * np.cos(az)
    duy_daz = -np.cos(el) * np.sin(az)
    dux_del = -np.sin(el) * np.sin(az)
    duy_del = -np.sin(el) * np.cos(az)
    fac = -1j * 2.0 * np.pi * norm_spacing
    D_az = fac * (ix[:, None] * dux_daz[None, :]
                  + iy[:, None] * duy_daz[None, :]) * A
    D_el = fac * (ix[:, None] * dux_del[None, :]
                  + iy[:, None] * duy_del[None, :]) * A
    return A, np.concatenate([D_az, D_el], axis=1)   # (N, 2K) param-major


def crb_ura_deg(az_deg: Sequence[float], el_deg: Sequence[float],
                shape, norm_spacing: float, snr_db: float,
                n_snapshots: int,
                amplitudes: Optional[Sequence[float]] = None,
                kind: str = "stochastic") -> np.ndarray:
    """(K, 2) per-source [az, el] CRB standard deviations in DEGREES for
    the planar array (x-major element layout of ops/steering.py)."""
    az = np.atleast_1d(np.asarray(az_deg, float))
    K = az.size
    A, D = _ura_a_d(az, el_deg, shape, norm_spacing)
    amps = np.ones(K) if amplitudes is None else np.asarray(
        amplitudes, float)
    P = np.diag(amps.astype(complex) ** 2)
    sigma2 = 10.0 ** (-snr_db / 10.0)
    crb = _crb_core(A, D, P, sigma2, n_snapshots, kind=kind)
    std = np.degrees(np.sqrt(np.diag(crb).real))     # param-major (2K,)
    return np.stack([std[:K], std[K:]], axis=1)


def crb_single_source_ula_closed_form(theta_deg: float, num_elements: int,
                                      norm_spacing: float, snr_db: float,
                                      n_snapshots: int) -> float:
    """Textbook single-source deterministic CRB std (degrees), UNIT
    source power: var = σ² / (2n·(2πd sinθ)²·N(N²−1)/12). For non-unit
    power p, divide σ² by p (equivalently fold p into snr_db). Used by
    the tests to pin the generic machinery."""
    N = num_elements
    sigma2 = 10.0 ** (-snr_db / 10.0)
    s = (2.0 * np.pi * norm_spacing
         * np.sin(np.deg2rad(theta_deg))) ** 2
    var = sigma2 / (2.0 * n_snapshots * s * N * (N * N - 1) / 12.0)
    return float(np.degrees(np.sqrt(var)))
