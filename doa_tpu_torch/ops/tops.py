"""TOPS wideband DoA, the Test of Orthogonality of Projected Subspaces
(port of doa_tpu/ops/tops.py; Yoon, Kaplan & McClellan, IEEE Trans. SP
54(6), 2006). Fusion mode "tops": no focusing matrices and no preliminary
angles, the whole band used coherently through subspace geometry.

For window b, candidate angle θ and the reference subband r:

  * S_f: the complex signal subspace of subband f (N×K, orthonormal
    columns; ops/esprit.signal_subspace_cpx);
  * Φ_f(θ) = A_f(θ) ⊙ conj(A_r(θ)) carries the reference band's manifold
    to band f's (every steering entry is a unit phasor), U_f = Φ_f S_r;
  * U'_f = (I − â_f â_fᴴ) U_f, â = a/‖a‖, and D(θ) = [W_fᴴ U'_f]_{f≠r}
    (W_f band f's noise basis); P(θ) = 1/σ_min(D)², which is 1/λ_min of

        M(θ) = (F−1)(I − vᴴv) − Σ_{f≠r} C_fᴴC_f,
        v = â_rᴴ S_r,  C_f = S_fᴴU_f − (S_fᴴâ_f)(â_fᴴU_f).

The reference's algebra with the static-K unroll: a band is K + K²
complex products (G, N)·(N, B), here two GEMMs (the K columns of r and
the K² of C stacked along the window axis), and elementwise (B, G) work.
λ_min is closed-form for K ≤ 2 and the Jacobi eigenvalues of the
symmetrised 2K×2K real embedding (ops/jacobi.eigh_jacobi, 8 sweeps as the
reference passes) for K > 2.

Layout: the reference keeps its (K, K, G, B) axis order to dodge its TPU
tiles' padding; the port keeps the window axis before the grid axis,
(K, K, B, G), so the spectrum comes out (B, G) with no transpose and each
window's maximum is a reduction over contiguous memory. Complex values
are torch complex64, every product in true FP32 (cpx.fp32_matmuls): λ_min
cancels at the true DoA, where the peak is, so TF32 would move the peak.
"""

from __future__ import annotations

import math

import torch

from doa_tpu_torch.cpx import embed_planes, fp32_matmuls, unembed_planes
from doa_tpu_torch.ops.esprit import signal_subspace_cpx
from doa_tpu_torch.ops.jacobi import eigh_jacobi
from doa_tpu_torch.ops.wideband import subband_covariances

_TINY = torch.finfo(torch.float32).tiny


def _rows(S: torch.Tensor) -> torch.Tensor:
    """S c64[B, N, K] → its K columns stacked along the windows,
    c64[K·B, N] (row k·B + b is S[b, :, k])."""
    B, N, K = S.shape
    return S.permute(2, 0, 1).reshape(K * B, N)


def tops_leakage_row(A_ref: torch.Tensor, S_ref: torch.Tensor) -> torch.Tensor:
    """v[l, b, g] = (â_rᴴ S_r)_l, the band-independent steering-leakage
    row (â_fᴴΦ_f = â_rᴴ: the unit phasors cancel). A_ref c64[G, N] the
    reference band's steering (not normalised); S_ref c64[B, N, K] →
    c64[K, B, G] (the reference's (K, G, B) with the last two axes
    swapped)."""
    B, N, K = S_ref.shape
    a = A_ref.conj() * (1.0 / math.sqrt(N))
    with fp32_matmuls():
        return torch.matmul(_rows(S_ref), a.transpose(0, 1)).reshape(
            K, B, A_ref.shape[0])


def tops_accumulate_cc(S_bands: torch.Tensor, A_bands: torch.Tensor,
                       A_ref: torch.Tensor, S_ref: torch.Tensor,
                       v: torch.Tensor, w_bands):
    """Σ_f w_f C_fᴴC_f over the given bands, a loop over them (a sharded
    caller passes each rank's band slice and sums the results). S_bands
    c64[Fl, B, N, K], A_bands c64[Fl, G, N], A_ref c64[G, N] (not
    normalised), S_ref c64[B, N, K], v c64[K, B, G] (tops_leakage_row),
    w_bands the bands' weights f32[Fl] (0 on the reference band; host
    numbers, a sequence or a tensor).
    → (ccr, cci, mus): the planes of CC f32[K, K, B, G] and the
    incoherent MUSIC guard sum f32[B, G], over ALL the given bands, of
    the per-band signal-subspace MUSIC spectra, each max-normalised over
    the grid of its window (its den 1 − ‖S_fᴴâ_f‖² reuses r).

    A band of weight 0 adds nothing to CC, so its K² products are not
    formed (the reference adds 0·CC)."""
    Fl, B, N, K = S_bands.shape
    G = A_bands.shape[1]
    dev = S_bands.device
    w = torch.as_tensor(w_bands, dtype=torch.float32).tolist()
    inv = 1.0 / math.sqrt(N)
    A_ref_c = A_ref.conj()
    # rows (l, k, b) of X: conj(S_f[b, :, k]) ⊙ S_r[b, :, l]; S_r's copies
    # by row, made once
    S_ref_rep = _rows(S_ref).reshape(K, 1, B, N)
    rdt = S_bands.real.dtype
    cc = torch.zeros((K, K, B, G), dtype=S_bands.dtype, device=dev)
    mus = torch.zeros((B, G), dtype=rdt, device=dev)
    for f in range(Fl):
        Sc = _rows(S_bands[f]).conj()                         # (K·B, N)
        with fp32_matmuls():
            # r[k, b, g] = Σ_n conj(S_f[b, n, k]) â_f[g, n]
            r = torch.matmul(Sc, (A_bands[f] * inv).transpose(0, 1))
        r = r.reshape(K, B, G)
        if w[f] != 0.0:
            Phi = A_bands[f] * A_ref_c                        # (G, N)
            X = (Sc.reshape(1, K, B, N) * S_ref_rep).reshape(K * K * B, N)
            with fp32_matmuls():
                C = torch.matmul(X, Phi.transpose(0, 1))
            # C[l, k] = Σ_n Φ conj(S_f)_k S_r_l − r_k v_l, (B, G) each
            C = C.reshape(K, K, B, G)
            del X
            C.addcmul_(v[:, None], r[None, :], value=-1.0)
            # CC[l, m] += w Σ_k conj(C[l, k]) C[m, k]
            for k in range(K):
                cc.addcmul_(C[:, None, k].conj(), C[None, :, k], value=w[f])
            del C
        # the guard's band term: den = 1 − Σ_k |r_k|², clamped at 0
        den = torch.ones((B, G), dtype=rdt, device=dev)
        for k in range(K):
            den.sub_(r[k].real * r[k].real + r[k].imag * r[k].imag)
        Pf = 1.0 / den.clamp_(min=0.0).clamp_(min=_TINY)
        mus.add_(Pf / Pf.amax(dim=-1, keepdim=True))
        del r, den, Pf
    return cc.real.contiguous(), cc.imag.contiguous(), mus


def _lambda_min(ccr, cci, v, num_bands: int, jacobi_sweeps: int):
    """λ_min f32[B, G] of M = (F−1)(I − vᴴv) − CC: the closed form of a
    1×1 or Hermitian 2×2 M (its off-diagonal pair averaged), else the
    Jacobi eigenvalues of M's symmetrised real 2K×2K embedding."""
    K = ccr.shape[0]
    nb = float(num_bands - 1)

    def m(l, j):
        """M's (l, j) entry as planes: vᴴv's is conj(v_l) v_j."""
        vl, vj = v[l], v[j]
        vv_r = vl.real * vj.real + vl.imag * vj.imag
        vv_i = vl.real * vj.imag - vl.imag * vj.real
        eye = 1.0 if l == j else 0.0
        return nb * (eye - vv_r) - ccr[l, j], nb * (-vv_i) - cci[l, j]

    if K == 1:
        return m(0, 0)[0]
    if K == 2:
        a, d = m(0, 0)[0], m(1, 1)[0]
        (r01, i01), (r10, i10) = m(0, 1), m(1, 0)
        cr = 0.5 * (r01 + r10)
        ci = 0.5 * (i01 - i10)
        half = 0.5 * (a - d)
        return 0.5 * (a + d) - torch.sqrt(half * half + cr * cr + ci * ci)
    ent = [[m(l, j) for j in range(K)] for l in range(K)]
    Mr = torch.stack([torch.stack([e[0] for e in row], -1) for row in ent],
                     -2)                                 # (B, G, K, K)
    Mi = torch.stack([torch.stack([e[1] for e in row], -1) for row in ent],
                     -2)
    del ent
    E = embed_planes(Mr, Mi)
    E = 0.5 * (E + E.transpose(-1, -2))
    return eigh_jacobi(E, sweeps=jacobi_sweeps)[0][..., 0]


def tops_finalize(ccr, cci, v: torch.Tensor, num_bands: int,
                  jacobi_sweeps: int = 8, guard=None) -> torch.Tensor:
    """(the CC planes f32[K, K, B, G], the leakage row v c64[K, B, G], the
    band count F) → the max-normalised TOPS spectrum f32[B, G]:
    M = (F−1)(I − vᴴv) − CC, P = 1/λ_min(M). guard: the incoherent MUSIC
    sum f32[B, G] (tops_accumulate_cc); when given, P is multiplied by
    guard / F before the normalisation (the false-peak suppressor of
    tops_spectrum_cpx)."""
    lam = _lambda_min(ccr, cci, v, num_bands, jacobi_sweeps)
    P = 1.0 / lam.clamp(min=_TINY)
    if guard is not None:
        # F as a tensor: a true division on the card too (ROADMAP §C.4)
        P = P * (guard / torch.full((), float(num_bands), dtype=P.dtype,
                                    device=P.device))
    return P / P.amax(dim=-1, keepdim=True)


def tops_spectrum_cpx(S_sub: torch.Tensor, A_stack: torch.Tensor,
                      ref_band: int = 0, jacobi_sweeps: int = 8,
                      guard: bool = False) -> torch.Tensor:
    """S_sub c64[F, B, N, K] per-subband orthonormal signal subspaces,
    A_stack c64[F, G, N] per-subband steering → the TOPS pseudospectrum
    f32[B, G], max-normalised per window. ref_band: the reference subband
    r. guard=True multiplies by the incoherent signal-subspace MUSIC
    spectrum accumulated in the same loop, which suppresses TOPS's false
    peak where the manifold transform degenerates to the identity
    (broadside on a ULA) without masking a true source there. Default
    False here (the textbook estimator); the pipeline's default is on
    (configs.WidebandSpec.tops_guard)."""
    F = S_sub.shape[0]
    A_ref, S_ref = A_stack[ref_band], S_sub[ref_band]
    v = tops_leakage_row(A_ref, S_ref)
    w = [0.0 if f == ref_band else 1.0 for f in range(F)]
    ccr, cci, mus = tops_accumulate_cc(S_sub, A_stack, A_ref, S_ref, v, w)
    return tops_finalize(ccr, cci, v, F, jacobi_sweeps=jacobi_sweeps,
                         guard=mus if guard else None)


def tops_subspaces(R_sub: torch.Tensor, num_sources: int,
                   power_iters: int) -> torch.Tensor:
    """Subband covariances c64[F, B, N, N] → their complex signal
    subspaces c64[F, B, N, K] (signal_subspace_cpx, max(power_iters, 16)
    iterations, as the reference's wideband_tops_cpx)."""
    F, B, N, _ = R_sub.shape
    S = signal_subspace_cpx(R_sub.reshape(F * B, N, N), num_sources,
                            iters=max(power_iters, 16))
    return S.reshape(F, B, N, num_sources)


def wideband_tops_cpx(x, A_stack: torch.Tensor, W, cfg,
                      E_sub: torch.Tensor | None = None) -> torch.Tensor:
    """Stream-level TOPS: a capture x c64[T, N] with the DFT matrix W
    c64[F, F] (ops/wideband.subband_covariances), or the embedded subband
    covariances E_sub f32[F, B, 2N, 2N] of the front end (x and W unused)
    → f32[B, G], on the config's reference band and guard.

    The live set is E_sub or R_sub, the CC accumulator c64[K, K, B, G],
    one band's C as large, r, v and the guard sum: c5's call (G = 16471,
    B = 2048, K = 2, from its front end) peaks at 5.7 GiB above the
    capture it is given (chip_smoke.py phase 19, one H100 80GB HBM3)."""
    R_sub = (torch.complex(*unembed_planes(E_sub)) if E_sub is not None
             else subband_covariances(x, W, cfg))
    S_sub = tops_subspaces(R_sub, cfg.num_sources, cfg.power_iters)
    del R_sub
    return tops_spectrum_cpx(S_sub, A_stack,
                             ref_band=cfg.wideband.tops_ref_band,
                             guard=cfg.wideband.tops_guard)
