"""DFT beamspace preprocessing — port of doa_tpu/ops/beamspace.py.

Projects the N-element space onto Nb < N orthonormal DFT beams covering
a sector before the subspace scan:

    R_b = Bᴴ R B,   ǎ(θ) = Bᴴa(θ) / ‖Bᴴa(θ)‖,
    MUSIC_b: den(θ) = ‖ǎ‖² − ‖V_bᵀ ǎ‖²  (the noise-subspace fraction)

B's columns are Nb columns of the unitary N-point DFT whose spatial
frequencies lie closest to the sector centre, so BᴴB = I: beamspace
noise stays white and the narrowband subspace estimators run unchanged
on (R_b, ǎ) in dimension Nb. The unit norm of ǎ keeps out-of-sector
angles from peaking: there ǎ is an arbitrary unit vector whose
noise-subspace fraction is O((Nb − K)/Nb), never ≈ 0.

The beam matrix, its real embedding and the beamspace steering are host
numpy, made once a pipeline, as in the reference. The projections run
after the covariance stage (the element-space covariance kernels are
unchanged) as two FP32 products each.
"""

from __future__ import annotations

import numpy as np
import torch

from doa_tpu_torch.cpx import fp32_matmuls


def dft_beam_matrix(num_elements: int, num_beams: int,
                    center_deg: float, norm_spacing: float) -> np.ndarray:
    """Orthonormal DFT beam matrix B complex64 (N, Nb): the Nb DFT beams
    whose wrapped spatial frequency k/N lies closest (circularly) to
    −d·cos(center). Beams picked by numpy's default argsort of the
    distance, as the reference: at a tie (ULA-16, Nb = 8, 90°: k = 4 and
    k = 12 both at 0.25) that sort's order decides, so it is kept."""
    N, Nb = num_elements, num_beams
    if not (0 < Nb < N):
        raise ValueError("need 0 < num_beams < num_elements")
    u0 = -norm_spacing * np.cos(np.deg2rad(center_deg))
    k = np.arange(N)
    f = ((k / N) + 0.5) % 1.0 - 0.5                      # wrapped to [-1/2, 1/2)
    dist = np.abs(((f - u0) + 0.5) % 1.0 - 0.5)          # circular distance
    sel = np.sort(np.argsort(dist)[:Nb])
    n = np.arange(N)[:, None]
    B = np.exp(-2j * np.pi * n * (k[sel][None, :] / N)) / np.sqrt(N)
    return B.astype(np.complex64)


def beamspace_steering(A: np.ndarray, Bm: np.ndarray,
                       eps: float = 1e-6) -> np.ndarray:
    """Element steering A (G, N) → unit-norm beamspace steering
    ǎ complex64 (G, Nb) (the normalisation is load-bearing: module doc)."""
    Ab = A @ Bm.conj()
    nrm = np.linalg.norm(Ab, axis=-1, keepdims=True)
    return (Ab / np.maximum(nrm, eps)).astype(np.complex64)


def embed_beam_matrix(Bm: np.ndarray) -> np.ndarray:
    """Real 2N×2Nb embedding B̃ = [[Br, −Bi], [Bi, Br]] (cpx.embed_planes'
    convention), so E(R_b) = B̃ᵀ E(R) B̃."""
    Br = Bm.real.astype(np.float32)
    Bi = Bm.imag.astype(np.float32)
    top = np.concatenate([Br, -Bi], axis=1)
    bot = np.concatenate([Bi, Br], axis=1)
    return np.concatenate([top, bot], axis=0)


def beamspace_covariance(Rr: torch.Tensor, Ri: torch.Tensor,
                         Bm: torch.Tensor):
    """Covariance planes (Rr, Ri) f32[B, N, N] and the beam matrix Bm
    complex64 (N, Nb) → the planes of R_b = Bᴴ R B, f32[B, Nb, Nb]."""
    R = torch.complex(Rr, Ri)
    with fp32_matmuls():
        Rb = torch.matmul(torch.matmul(Bm.mH, R), Bm)
    return Rb.real.contiguous(), Rb.imag.contiguous()


def beamspace_covariance_complex(R: torch.Tensor,
                                 Bm: torch.Tensor) -> torch.Tensor:
    """The complex pipeline's projection (``pipeline.py``): R c64[B, N, N]
    and the beam matrix Bm c64 (N, Nb) → R_b = Bᴴ R B c64[B, Nb, Nb].
    The reference names this one ``beamspace_covariance``; here that
    name is the planes path's, so this one is named for its type."""
    with fp32_matmuls():
        return torch.matmul(torch.matmul(Bm.mH, R), Bm)


def beamspace_embedded(E: torch.Tensor, Bt: torch.Tensor) -> torch.Tensor:
    """Embedded covariance windows E f32[B, 2N, 2N] and B̃ f32[2N, 2Nb] →
    E_b = B̃ᵀ E B̃ f32[B, 2Nb, 2Nb]."""
    with fp32_matmuls():
        return torch.matmul(Bt.T, torch.matmul(E, Bt))
