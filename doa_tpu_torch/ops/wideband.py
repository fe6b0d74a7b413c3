"""Wideband DoA by per-subband channelization and incoherent or coherent
fusion — port of the power path of doa_tpu/ops/wideband.py.

An F-point DFT channelizer splits the capture into F subband streams at
rate 1/F (ops/cuda/wideband_cov.py); a subband at baseband offset f sees
the effective element spacing d·(1 + f·fractional_bw).

* Incoherent fusion: each subband gets its own signal subspace and its
  own steering grid; the fused spectrum is the mean of the subbands'
  max-normalised MUSIC spectra (ops/cuda/wideband_scan.py).
* CSSM (coherent): unitary focusing matrices T_f rotate each subband
  covariance onto the reference manifold, R_coh = mean_f T_f R_f T_fᴴ,
  and the narrowband estimators run on R_coh. "cssm" focuses at a static
  direction set (focusing_matrices, host numpy, once per pipeline);
  "cssm_auto" peaks a coarse incoherent spectrum of the capture-mean
  subband covariances and focuses at runtime (runtime_focusing: steering
  at the found angles, Newton–Schulz polar factor).

* Hierarchical (incoherent, power subspaces): the coarse fused spectrum's
  unrefined peaks, then the fused metric (1/F) Σ_f dmin_f / den_f(θ) on
  a micro-grid around each peak, every subband's exact denominator at
  its own spacing (wideband_music_hierarchical).
* The incoherent scans the reference keeps off its fusion kernel (kernel
  5 takes the power subspaces at compute_dtype "float32" only): the
  power subspaces scanned in bfloat16 or int8 (power_spectra), and the
  eigh noise projectors of subspace_method "eigh" or "jacobi" scanned at
  any compute_dtype (subband_noise_projectors, projector_spectra), their
  mean as the reference's XLA scan takes it (fused_mean), as torch ops.
  wideband_music_cpx chooses between these and kernel 5
  (fusion_kernel_applies) for the pipeline and the stream entry alike.
* The complex-stream functions of the reference, which no pipeline of
  the port reaches (its builder always takes the front end): the DFT
  channelizer on a complex64 capture (dft_matrix, channelize_cpx),
  subband_covariances, subband_subspaces, _subband_spectra and
  wideband_music_cpx. TOPS is ops/tops.py.

Complex values are torch complex64; every product runs in true FP32
(cpx.fp32_matmuls).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from doa_tpu_torch.configs import DoaConfig
from doa_tpu_torch.cpx import embed_planes, fp32_matmuls, unembed_planes
from doa_tpu_torch.ops.covariance import cov_from_stream as cov_cpx
from doa_tpu_torch.ops.cuda.wideband_scan import wideband_fused_spectrum
from doa_tpu_torch.ops.cpx_ops import (music_denominator_cpx,
                                       music_denominator_subspace,
                                       noise_projector,
                                       signal_subspace_embedded,
                                       signal_subspace_from_E_T,
                                       spectrum_from_den)
from doa_tpu_torch.ops.hierarchical import (argbest_2d, micro_grid_2d,
                                            parabolic_vertex)
from doa_tpu_torch.ops.peaks import find_local_max, find_local_max_2d
from doa_tpu_torch.ops.subspace import EIGH_BATCH


def subband_center_freqs(num_subbands: int) -> np.ndarray:
    """Normalized center frequency of each DFT bin, in [-0.5, 0.5)."""
    return np.fft.fftfreq(num_subbands).astype(np.float32)


def subband_spacings(cfg: DoaConfig) -> np.ndarray:
    """Effective per-subband element spacings d·(1 + f·fractional_bw)."""
    freqs = subband_center_freqs(cfg.wideband.num_subbands)
    fbw = cfg.wideband.fractional_bw
    return (cfg.geometry.norm_spacing
            * (1.0 + freqs * fbw)).astype(np.float32)


def wideband_steering_stack(cfg: DoaConfig, A_fn) -> np.ndarray:
    """Per-subband steering matrices complex64[F, G, N]; A_fn(spacing) →
    (G, N) is the config's grid at a given spacing
    (pipeline._steering_fn)."""
    fbw = getattr(cfg.wideband, "fractional_bw", 0.0)
    freqs = subband_center_freqs(cfg.wideband.num_subbands)
    return np.stack([A_fn(cfg.geometry.norm_spacing * (1.0 + float(fn) * fbw))
                     for fn in freqs], axis=0)


def subband_subspaces_from_E(E_sub: torch.Tensor, cfg: DoaConfig,
                             iterate=None, Ebar=None) -> torch.Tensor:
    """Embedded per-subband covariances f32[F, B, 2N, 2N] → signal
    subspaces Vt f32[F, B, 2K, 2N] (transposed: rows orthonormal; the
    reference returns the swap, f32[F, B, 2N, 2K]). The (F, B) axes merge
    into one batch for the iteration.

    cfg.subspace_warm_start and B ≥ 32, or Ebar given: each window starts
    from its subband's capture-mean subspace (max(power_iters, 8)
    iterations on F matrices) and refines with power_iters_warm applies,
    the escalation detector armed at the subband operating point (S/F
    snapshots); the init is one row per subband, shared by that subband's
    B windows in the subspace kernel. Ebar f32[F, 2N, 2N] replaces the
    capture mean (a sharded caller passes the mean over every rank's
    windows and gates on the global window count, as the reference).
    Otherwise a cold start with power_iters and the config's squarings,
    detector off — as the reference. No escalation counts are returned,
    as in the reference. iterate: the MGS rounds
    (signal_subspace_from_E_T)."""
    F, B, n2, _ = E_sub.shape
    K = cfg.num_sources
    E = E_sub.reshape(F * B, n2, n2)
    if Ebar is not None or (cfg.subspace_warm_start and B >= 32):
        esc = cfg.escalate_kwargs_for(
            cfg.snapshot_size // cfg.wideband.num_subbands, n2=n2)
        Vt_bar = signal_subspace_from_E_T(
            E_sub.mean(dim=1) if Ebar is None else Ebar, K,
            iters=max(cfg.power_iters, 8), iterate=iterate, **esc)
        Vt = signal_subspace_from_E_T(E, K, iters=cfg.power_iters_warm,
                                      init=Vt_bar, iterate=iterate, **esc)
    else:
        Vt = signal_subspace_from_E_T(E, K, iters=cfg.power_iters,
                                      squarings=cfg.power_squarings,
                                      iterate=iterate)
    return Vt.reshape(F, B, 2 * K, n2)


# ---------------------------------------------------------------------
# The incoherent scans off kernel 5, and the complex-stream functions
# ---------------------------------------------------------------------

def power_spectra(Vt: torch.Tensor, As_emb: torch.Tensor,
                  compute_dtype: str):
    """Each subband's max-normalised MUSIC spectrum f32[B, G] on its power
    subspaces, one subband at a time: Vt f32[F, B, 2K, 2N], the embedded
    per-subband steering As_emb f32[F, G, 2N], den_f =
    music_denominator_subspace at compute_dtype."""
    for f in range(Vt.shape[0]):
        yield spectrum_from_den(music_denominator_subspace(
            Vt[f].transpose(-1, -2), As_emb[f], compute_dtype))


def projector_spectra(Mr: torch.Tensor, Mi: torch.Tensor, Xr: torch.Tensor,
                      Xi: torch.Tensor, compute_dtype: str):
    """Each subband's max-normalised MUSIC spectrum f32[B, G] on its noise
    projectors, one subband at a time: planes (Mr, Mi) f32[F, B, N, N],
    the per-subband steering planes (Xr, Xi) f32[F, G, N], den_f =
    music_denominator_cpx at compute_dtype."""
    for f in range(Mr.shape[0]):
        yield spectrum_from_den(music_denominator_cpx(
            Mr[f], Mi[f], Xr[f], Xi[f], compute_dtype))


def fused_sum(spectra) -> torch.Tensor:
    """The subband spectra's sum, accumulated one at a time, f32[B, G]
    (a sharded rank's partial fusion over its own subbands)."""
    acc = None
    for P in spectra:
        acc = P if acc is None else acc.add_(P)
    return acc


def divide(t: torch.Tensor, n) -> torch.Tensor:
    """t / n with n as a tensor: a true division on the card too, where a
    Python divisor is multiplied by its rounded reciprocal (ROADMAP
    §C.4)."""
    return t / torch.full((), n, dtype=t.real.dtype, device=t.device)


def fused_mean(spectra, F: int) -> torch.Tensor:
    """The incoherent fusion of the reference's XLA scan (its route where
    its fusion kernel does not apply: compute_dtype "bfloat16" or "int8"
    on the power subspaces, subspace_method "eigh" and "jacobi"): the
    mean of the F subband spectra, accumulated one at a time, f32[B, G]."""
    return divide(fused_sum(spectra), F)


def subband_den_minima(Vt: torch.Tensor, As_emb: torch.Tensor):
    """Each subband's minimum over the grid of its FP32 den, clamped to
    [tiny, ∞), f32[F, B]: the hierarchical refine's normaliser, which the
    reference takes from the FP32 den whatever compute_dtype is."""
    return torch.stack([music_denominator_subspace(
        Vt[f].transpose(-1, -2), As_emb[f]).clamp_min(0.0).amin(dim=-1)
        for f in range(Vt.shape[0])]).clamp_min(
            torch.finfo(torch.float32).tiny)


def subband_noise_projectors(E_sub: torch.Tensor, num_sources: int):
    """Embedded subband covariances f32[F, B, 2N, 2N] → each window's
    complex noise projector as planes (Mr, Mi) f32[F, B, N, N]
    (cpx_ops.noise_projector: eigh of the embedding, the 2(N − K)
    smallest eigenvectors), at most subspace.EIGH_BATCH windows an eigh
    call (cuSOLVER's batched limit, ROADMAP §C.3).

    The reference takes this projector under subspace_method "jacobi"
    too: its wideband scan calls noise_projector_cpx (eigh) for every
    method but "power", so the port does the same, not Jacobi's."""
    F, B, n2, _ = E_sub.shape
    Rr, Ri = unembed_planes(E_sub.reshape(F * B, n2, n2))
    parts = [noise_projector(Rr[i:i + EIGH_BATCH], Ri[i:i + EIGH_BATCH],
                             num_sources)
             for i in range(0, F * B, EIGH_BATCH)]
    N = n2 // 2
    return (torch.cat([p[0] for p in parts]).reshape(F, B, N, N),
            torch.cat([p[1] for p in parts]).reshape(F, B, N, N))


def dft_matrix(F: int) -> np.ndarray:
    """(F, F) complex64 DFT matrix W[f, t] = exp(−2πj f t / F)."""
    f = np.arange(F)[:, None]
    t = np.arange(F)[None, :]
    return np.exp(-2j * np.pi * f * t / F).astype(np.complex64)


def channelize_cpx(x: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """A capture x c64[T, N] and the DFT matrix W c64[F, F] → subband
    streams c64[F, T // F, N]: frames of F samples, one DFT each,
    out[f, m, n] = Σ_t W[f, t] x[m·F + t, n]; one complex GEMM."""
    F = W.shape[0]
    T, N = x.shape
    M = T // F
    xf = x[:M * F].reshape(M, F, N).permute(1, 0, 2).reshape(F, M * N)
    with fp32_matmuls():
        return torch.matmul(W, xf).reshape(F, M, N)


def subband_covariances(x: torch.Tensor, W: torch.Tensor,
                        cfg: DoaConfig) -> torch.Tensor:
    """A capture x c64[T, N] → the windowed subband covariances
    c64[F, B, N, N]: the channelized streams, each framed at S/F subband
    samples a window (one fused window spans a narrowband window's
    samples) with the overlap taken in the subband domain, hop
    max(S/F − overlap/F, 1), by ops/covariance.cov_from_stream."""
    F = W.shape[0]
    S = cfg.snapshot_size
    if S % F:
        raise ValueError("snapshot_size must be divisible by num_subbands")
    S_sub = S // F
    hop_sub = max(S_sub - cfg.overlap // F, 1)
    xs = channelize_cpx(x, W)
    return torch.stack([cov_cpx(xs[f], S_sub, S_sub - hop_sub)
                        for f in range(F)])


def subband_subspaces(R: torch.Tensor, cfg: DoaConfig) -> torch.Tensor:
    """Subband covariances R c64[F, B, N, N] → the embedded signal
    subspaces f32[F, B, 2N, 2K] (the reference's layout; the power path).
    A warm start (cfg.subspace_warm_start and B ≥ 32) is
    subband_subspaces_from_E on E(R); else each subband's cold MGS
    iteration with power_iters and the config's squarings, the escalation
    detector armed at the subband operating point (S/F snapshots) when
    there are no squarings."""
    F, B = R.shape[:2]
    if cfg.subspace_warm_start and B >= 32:
        E = embed_planes(R.real, R.imag)
        return subband_subspaces_from_E(E, cfg).transpose(-1, -2)
    esc = cfg.escalate_kwargs_for(cfg.snapshot_size
                                  // cfg.wideband.num_subbands)
    kw = esc if cfg.power_squarings == 0 else {}
    return torch.stack([signal_subspace_embedded(
        R[f].real.contiguous(), R[f].imag.contiguous(), cfg.num_sources,
        iters=cfg.power_iters, squarings=cfg.power_squarings, **kw)
        for f in range(F)])


def fusion_kernel_applies(cfg: DoaConfig) -> bool:
    """The reference's rule for its fusion kernel (_wb_fusion_resolved):
    incoherent wideband on the power subspaces at compute_dtype "float32"
    runs kernel 5; its other incoherent scans are XLA, torch ops here.
    plan.kernel_routes plans the "fusion" stage by this rule."""
    return cfg.subspace_method == "power" and cfg.compute_dtype == "float32"


def steering_planes(Xr: torch.Tensor, Xi: torch.Tensor):
    """Per-subband steering planes f32[F, G, N] → (Xr, Xi, As_emb
    f32[F, G, 2N], As_nrm f32[F, G] = ‖a_fg‖²), what the scans read. A
    caller that scans one stack every call makes them once: kernel 5
    keeps its tiles on As_emb."""
    Xr, Xi = Xr.contiguous(), Xi.contiguous()
    As_emb = torch.cat([Xr, Xi], dim=-1).contiguous()
    return Xr, Xi, As_emb, (As_emb * As_emb).sum(dim=-1)


def _scan_operands(x, W, cfg: DoaConfig, E_sub, iterate=None):
    """→ (Vt f32[F, B, 2K, 2N], None) on the power subspaces, else (None,
    (Mr, Mi)) the eigh noise projectors f32[F, B, N, N]; from E_sub, or
    from the capture x with the DFT W (the power subspaces there through
    subband_subspaces, as the reference)."""
    if cfg.subspace_method == "power":
        if E_sub is not None:
            return subband_subspaces_from_E(E_sub, cfg, iterate=iterate), None
        V = subband_subspaces(subband_covariances(x, W, cfg), cfg)
        return V.transpose(-1, -2).contiguous(), None
    if E_sub is None:
        R = subband_covariances(x, W, cfg)
        E_sub = embed_planes(R.real, R.imag)
    return None, subband_noise_projectors(E_sub, cfg.num_sources)


def _band_spectra(Vt, M, planes, compute_dtype: str):
    """Each subband's max-normalised spectrum f32[B, G], one at a time:
    power_spectra on Vt, else projector_spectra on M = (Mr, Mi)."""
    Xr, Xi, As_emb, _ = planes
    if Vt is not None:
        return power_spectra(Vt, As_emb, compute_dtype)
    return projector_spectra(*M, Xr, Xi, compute_dtype)


def _subband_spectra(x, A_stack: torch.Tensor, W, cfg: DoaConfig,
                     E_sub=None):
    """→ (P_sub f32[F, B, G], each subband's spectrum max-normalised, and
    the power subspaces V f32[F, B, 2N, 2K] or None). From the capture x
    c64[T, N] with the DFT W, or the embedded subband covariances E_sub
    f32[F, B, 2N, 2N] (x, W unused); A_stack c64[F, G, N]. The power path
    scans its subspaces at cfg.compute_dtype, the others the eigh noise
    projector (subband_noise_projectors)."""
    Vt, M = _scan_operands(x, W, cfg, E_sub)
    planes = steering_planes(A_stack.real, A_stack.imag)
    P = torch.stack(list(_band_spectra(Vt, M, planes, cfg.compute_dtype)))
    return P, None if Vt is None else Vt.transpose(-1, -2)


def wideband_music_cpx(x, A_stack, W, cfg: DoaConfig, E_sub=None, *,
                       planes=None, iterate=None, fusion=None,
                       return_dmin: bool = False):
    """Incoherent wideband MUSIC: the capture x c64[T, N] with the DFT
    matrix W c64[F, F], or the embedded subband covariances E_sub
    f32[F, B, 2N, 2N] (x, W unused), and the per-subband steering
    A_stack c64[F, G, N] (or planes = steering_planes of it, made once by
    a caller that scans the same stack every call) → the fused spectrum
    f32[B, G], the mean of the subbands' max-normalised spectra.

    Where fusion_kernel_applies: the fusion kernel (kernel 5, `fusion`,
    default ops/cuda/wideband_scan's wrapper; its plain version on a CPU
    tensor), as the reference's kernel route; otherwise the fused mean of
    the subband spectra (_band_spectra), the reference's XLA scan.
    iterate: the MGS rounds of the power subspaces. return_dmin (power
    subspaces only) → (P, Vt f32[F, B, 2K, 2N], dmin f32[F, B]) for the
    hierarchical refine: dmin from kernel 5's same launch, else from each
    subband's FP32 den (subband_den_minima), as the reference."""
    if planes is None:
        planes = steering_planes(A_stack.real, A_stack.imag)
    As_emb, As_nrm = planes[2:]
    Vt, M = _scan_operands(x, W, cfg, E_sub, iterate)
    if fusion_kernel_applies(cfg):
        out = (fusion or wideband_fused_spectrum)(Vt, As_emb, As_nrm,
                                                  return_dmin=return_dmin)
        return (out[0], Vt, out[1]) if return_dmin else out
    P = fused_mean(_band_spectra(Vt, M, planes, cfg.compute_dtype),
                   As_emb.shape[0])
    return (P, Vt, subband_den_minima(Vt, As_emb)) if return_dmin else P


# ---------------------------------------------------------------------
# Coherent fusion: CSSM with unitary RSS focusing (Hung & Kaveh)
# ---------------------------------------------------------------------

def focusing_directions(cfg: DoaConfig):
    """J focusing directions spanning the scan field of view (doa_tpu's
    rule: J = num_focus_angles or 2N, interior points of the grid's
    range) → theta_deg (J,) for a ULA; (az_deg, el_deg) each (J,) for a
    URA, on a ceil(√J) × ceil(√J) az/el lattice."""
    J = cfg.wideband.num_focus_angles or 2 * cfg.geometry.num_elements
    if cfg.geometry.kind == "ula":
        return np.linspace(cfg.grid.lo_deg, cfg.grid.hi_deg,
                           J + 2)[1:-1].astype(np.float64)
    g2 = cfg.grid2d
    ja = int(np.ceil(np.sqrt(J)))
    az = np.linspace(g2.az_lo_deg, g2.az_hi_deg, ja + 2)[1:-1]
    el = np.linspace(g2.el_lo_deg, g2.el_hi_deg, ja + 2)[1:-1]
    azg, elg = np.meshgrid(az, el, indexing="ij")
    return azg.ravel(), elg.ravel()


def _focus_steering(cfg: DoaConfig, spacing: float) -> np.ndarray:
    """(N, J) complex128 steering columns of the full array (focusing
    precedes spatial smoothing) at the focusing directions, at an
    effective spacing."""
    dirs = focusing_directions(cfg)
    N = cfg.geometry.num_elements
    if cfg.geometry.kind == "ula":
        theta = np.deg2rad(np.asarray(dirs))
        k = np.arange(N)
        A = np.exp(-2j * np.pi * spacing * np.cos(theta)[:, None] * k)
        return A.T
    az, el = (np.deg2rad(d) for d in dirs)
    ux = np.cos(el) * np.sin(az)
    uy = np.cos(el) * np.cos(az)
    nx, ny = cfg.geometry.shape
    ix = np.arange(nx)[:, None]
    iy = np.arange(ny)[None, :]
    phase = -2 * np.pi * spacing * (ux[:, None, None] * ix
                                    + uy[:, None, None] * iy)
    return np.exp(1j * phase).reshape(len(ux), nx * ny).T


def focusing_matrices(cfg: DoaConfig) -> np.ndarray:
    """Unitary focusing matrices T complex64[F, N, N], host numpy: per
    subband the unitary Procrustes solution min ‖B₀ − T B_f‖ over unitary
    T, B_f the (N, J) steering at the focusing directions — T_f = U Vᴴ
    from the SVD B₀ B_fᴴ = U Σ Vᴴ."""
    B0 = _focus_steering(cfg, cfg.geometry.norm_spacing)
    mats = []
    for d in subband_spacings(cfg):
        Bf = _focus_steering(cfg, float(d))
        U, _, Vh = np.linalg.svd(B0 @ Bf.conj().T)
        mats.append(U @ Vh)
    return np.stack(mats, axis=0).astype(np.complex64)


def device_ula_phase(theta_deg: torch.Tensor, num_elements: int,
                     spacings: torch.Tensor) -> torch.Tensor:
    """The phases of the ULA steering at runtime angles: theta_deg f32[J]
    × spacings f32[S] → f32[S, J, N], −2π·d_s·cos θ_j·n."""
    cs = torch.cos(torch.deg2rad(theta_deg))
    n = torch.arange(num_elements, dtype=torch.float32,
                     device=theta_deg.device)
    return (-2.0 * math.pi) * (spacings[:, None, None] * cs[None, :, None]
                               * n[None, None, :])


def device_ura_phase(az_deg: torch.Tensor, el_deg: torch.Tensor, shape,
                     spacings: torch.Tensor) -> torch.Tensor:
    """The phases of the URA steering at runtime (az, el) pairs: f32[J]
    each × spacings f32[S] → f32[S, J, N] (x-major flattening, as
    ura_grid)."""
    az = torch.deg2rad(az_deg)
    el = torch.deg2rad(el_deg)
    ux = torch.cos(el) * torch.sin(az)
    uy = torch.cos(el) * torch.cos(az)
    nx, ny = shape
    ix = torch.arange(nx, dtype=torch.float32, device=az.device)[:, None]
    iy = torch.arange(ny, dtype=torch.float32, device=az.device)[None, :]
    grid = ux[:, None, None] * ix + uy[:, None, None] * iy   # (J, nx, ny)
    return (-2.0 * math.pi) * (spacings[:, None, None]
                               * grid.reshape(grid.shape[0], -1)[None])


def device_ula_steering(theta_deg: torch.Tensor, num_elements: int,
                        spacings: torch.Tensor) -> torch.Tensor:
    """ULA steering at runtime angles: theta_deg f32[J] × spacings f32[S]
    → complex64[S, J, N], a[s, j, n] = exp(−j2π·d_s·cos θ_j·n)."""
    ph = device_ula_phase(theta_deg, num_elements, spacings)
    return torch.complex(torch.cos(ph), torch.sin(ph))


def device_ura_steering(az_deg: torch.Tensor, el_deg: torch.Tensor, shape,
                        spacings: torch.Tensor) -> torch.Tensor:
    """URA steering at runtime (az, el) pairs: f32[J] each × spacings
    f32[S] → complex64[S, J, N] (x-major flattening, as ura_grid)."""
    ph = device_ura_phase(az_deg, el_deg, shape, spacings)
    return torch.complex(torch.cos(ph), torch.sin(ph))


def polar_unitary(M: torch.Tensor, iters: int = 20,
                  eps: float = 1e-4) -> torch.Tensor:
    """Batched unitary polar factor T = M (MᴴM + ε·tr̄·I)^(−1/2) of
    complex64[..., N, N] by a coupled Newton–Schulz inverse square root,
    then two polish steps T ← ½T(3I − TᴴT), in true FP32 (the reference
    runs it at its TPU's fp32-class "tensorfloat32"). ε regularises
    rank-deficient direction sets."""
    N = M.shape[-1]
    eye = torch.eye(N, dtype=M.dtype, device=M.device)
    with fp32_matmuls():
        G = M.mH @ M                                     # MᴴM ⪰ 0
        trbar = torch.diagonal(G.real, dim1=-2, dim2=-1).sum(-1) / N
        G = G + (eps * trbar)[..., None, None] * eye
        # Frobenius scale ≥ λmax puts the spectrum in NS's (0, 1] basin
        c = (G.real * G.real + G.imag * G.imag).sum((-2, -1)).sqrt()
        c = c.clamp_min(1e-30)[..., None, None]
        Y = G / c
        Z = eye.expand(Y.shape).clone()
        for _ in range(iters):                           # Z → Y^(−1/2)
            Tns = 0.5 * (3.0 * eye - Z @ Y)
            Y = Y @ Tns
            Z = Tns @ Z
        T = M @ (Z / c.sqrt())                           # M (MᴴM)^(−1/2)
        for _ in range(2):
            T = T @ (0.5 * (3.0 * eye - T.mH @ T))
    return T


def runtime_focusing(P: torch.Tensor, cfg: DoaConfig, spacings,
                     sector_halfwidth_deg: float = 2.0,
                     sector_weight: float = 2.0) -> torch.Tensor:
    """Coarse fused spectrum P f32[1, G] → unitary focusing matrices
    complex64[len(spacings) − 1, N, N] for spacings[1:] (spacings[0] is
    the reference): peak P (1-D or 2-D, the plain peak rules), focus at
    the found sector (each peak ± the half-width, weighted
    sector_weight) plus the static direction set, steering at runtime
    angles, Newton–Schulz polar factor."""
    hw = sector_halfwidth_deg
    dev = P.device
    spac = torch.as_tensor(np.asarray(spacings, np.float32), device=dev)
    K = cfg.num_sources
    if cfg.geometry.kind == "ura":
        g2 = cfg.grid2d
        _, azp, elp = find_local_max_2d(
            P.reshape(1, g2.num_az, g2.num_el), K,
            (g2.az_lo_deg, g2.az_hi_deg), (g2.el_lo_deg, g2.el_hi_deg))
        offs = [(0.0, 0.0), (hw, 0.0), (-hw, 0.0), (0.0, hw), (0.0, -hw)]
        sec_az = torch.cat([azp[0] + da for da, _ in offs])
        sec_el = torch.cat([elp[0] + de for _, de in offs])
        uni_az, uni_el = (torch.from_numpy(d.astype(np.float32)).to(dev)
                          for d in focusing_directions(cfg))
        n_sec, n_uni = sec_az.numel(), uni_az.numel()
        A_all = device_ura_steering(torch.cat([sec_az, uni_az]),
                                    torch.cat([sec_el, uni_el]),
                                    cfg.geometry.shape, spac)
    else:
        _, th = find_local_max(P, K, cfg.grid.lo_deg, cfg.grid.hi_deg)
        offs = torch.tensor([-hw, 0.0, hw], dtype=torch.float32, device=dev)
        sector = (th[0][:, None] + offs[None, :]).reshape(-1)
        uni = torch.from_numpy(np.asarray(focusing_directions(cfg),
                                          np.float32)).to(dev)
        n_sec, n_uni = sector.numel(), uni.numel()
        A_all = device_ula_steering(torch.cat([sector, uni]),
                                    cfg.geometry.num_elements, spac)
    wts = torch.cat([torch.full((n_sec,), sector_weight, device=dev),
                     torch.ones(n_uni, device=dev)])
    B0w = A_all[0] * wts[:, None]                         # (J, N)
    with fp32_matmuls():
        M = B0w.transpose(0, 1) @ A_all[1:].conj()        # B₀ diag(w) B_fᴴ
    return polar_unitary(M)


def focused_sum(R_sub: torch.Tensor, T: torch.Tensor) -> torch.Tensor:
    """Subband covariances R_sub complex64[F, B, N, N] (Hermitian) and
    focusing matrices T complex64[F, N, N] → Σ_f T_f R_f T_fᴴ
    complex64[B, N, N] (a sharded rank's sum over its own subbands).

    As GEMMs with no batch broadcast: R_f's windows side by side are
    (R_f viewed (B·N, N))ᴴ, since each R_f[b] is Hermitian, so T_f R_f[b]
    for every b is one product (N, N)·(N, B·N); its rows, viewed
    (N·B, N), times T_fᴴ accumulate over f in one (N·B, N) sum."""
    F, B, N, _ = R_sub.shape
    acc = torch.zeros((N * B, N), dtype=R_sub.dtype, device=R_sub.device)
    with fp32_matmuls():
        TR = torch.matmul(T, R_sub.reshape(F, B * N, N).mH)  # (F, N, B·N)
        for f in range(F):
            acc.addmm_(TR[f].reshape(N * B, N), T[f].mH)
    return acc.reshape(N, B, N).permute(1, 0, 2).contiguous()


def cssm_covariance(R_sub: torch.Tensor, T: torch.Tensor) -> torch.Tensor:
    """Subband covariances R_sub complex64[F, B, N, N] (Hermitian) and
    focusing matrices T complex64[F, N, N] → the focused coherent
    covariance complex64[B, N, N] = mean_f T_f R_f T_fᴴ (focused_sum)."""
    return focused_sum(R_sub, T) / R_sub.shape[0]


def coarse_band_spectra(R_mean: torch.Tensor, At_emb: torch.Tensor,
                        cfg: DoaConfig, iterate=None) -> torch.Tensor:
    """The coarse pass of "cssm_auto" band by band: capture-mean subband
    covariances R_mean complex64[F, N, N] → each subband's max-normalised
    MUSIC spectrum f32[F, 1, G] on the per-subband embedded steering
    At_emb f32[F, G, 2N] (cold subspaces, max(power_iters, 16) rounds by
    `iterate`, as signal_subspace_from_E_T)."""
    V = signal_subspace_embedded(R_mean.real.contiguous(),
                                 R_mean.imag.contiguous(), cfg.num_sources,
                                 iters=max(cfg.power_iters, 16),
                                 iterate=iterate)
    return torch.stack([spectrum_from_den(music_denominator_subspace(
        V[f:f + 1], At_emb[f])) for f in range(V.shape[0])])


def coarse_fused_spectrum(R_mean: torch.Tensor, At_emb: torch.Tensor,
                          cfg: DoaConfig, iterate=None) -> torch.Tensor:
    """The coarse pass of "cssm_auto": the mean over subbands of
    coarse_band_spectra, f32[1, G]."""
    return coarse_band_spectra(R_mean, At_emb, cfg, iterate).mean(dim=0)


def auto_focused_covariance(R_sub: torch.Tensor, At_emb: torch.Tensor,
                            cfg: DoaConfig,
                            sector_halfwidth_deg: float = 2.0,
                            sector_weight: float = 2.0,
                            iterate=None) -> torch.Tensor:
    """Two-pass auto-focused CSSM (fusion="cssm_auto"): the coarse
    incoherent spectrum of the capture-mean subband covariances, its
    peaks as runtime focusing directions (runtime_focusing), then
    R_coh = mean_f T_f R_f T_fᴴ. R_sub complex64[F, B, N, N]; At_emb the
    per-subband embedded steering f32[F, G, 2N]; iterate: the coarse
    pass's MGS rounds (signal_subspace_from_E_T)."""
    P = coarse_fused_spectrum(R_sub.mean(dim=1), At_emb, cfg, iterate)
    spac = np.concatenate([[cfg.geometry.norm_spacing],
                           subband_spacings(cfg)]).astype(np.float32)
    T = runtime_focusing(P, cfg, spac, sector_halfwidth_deg, sector_weight)
    return cssm_covariance(R_sub, T)


# ---------------------------------------------------------------------
# Hierarchical (coarse → refine) incoherent wideband MUSIC
# ---------------------------------------------------------------------

def fused_metric(Vt: torch.Tensor, dmin: torch.Tensor, ang, cfg: DoaConfig,
                 refine_chunk: int = 128) -> torch.Tensor:
    """The refine metric of the hierarchical wideband scan: the mean over
    subbands of dmin_f / max(den_f(angle), tiny) ∈ (0, 1], den_f the exact
    MUSIC denominator at subband f's spacing. Vt f32[F, B, 2K, 2N], dmin
    f32[F, B] (each subband's coarse minimum, kernel 5's), angles θ
    f32[B, ...] (ULA) or (az, el) f32[B, ...] each (URA) → f32[B, ...].

    The window axis runs in chunks of refine_chunk (the reference's), so
    the steering of one chunk, f32[F, chunk, ..., 2N], is all that is
    live: 0.6 GB at c5's micro-grids."""
    F, B, _, n2 = Vt.shape
    spac = torch.from_numpy(subband_spacings(cfg)).to(Vt.device)
    tiny = torch.finfo(torch.float32).tiny
    ula = cfg.geometry.kind == "ula"
    lead = (ang if ula else ang[0]).shape[1:]
    out = []
    for b0 in range(0, B, refine_chunk):
        b1 = min(B, b0 + refine_chunk)
        if ula:
            ph = device_ula_phase(ang[b0:b1].reshape(-1), n2 // 2, spac)
        else:
            ph = device_ura_phase(ang[0][b0:b1].reshape(-1),
                                  ang[1][b0:b1].reshape(-1),
                                  cfg.geometry.shape, spac)
        # the embedded rows [cos; sin], written in place: no complex or
        # concatenated copy of the chunk's steering
        at = ph.new_empty(ph.shape[:-1] + (n2,))
        torch.cos(ph, out=at[..., :n2 // 2])
        torch.sin(ph, out=at[..., n2 // 2:])
        del ph
        at = at.reshape(F, b1 - b0, -1, n2)
        with fp32_matmuls():
            Y = torch.matmul(at, Vt[:, b0:b1].transpose(-1, -2))
        den = ((n2 // 2) - (Y * Y).sum(-1)).clamp_min(tiny)  # (F, CH, M)
        out.append((dmin[:, b0:b1, None] / den).mean(dim=0))
    return torch.cat(out).reshape(B, *lead)


def wideband_music_hierarchical(Vt: torch.Tensor, P: torch.Tensor,
                                dmin: torch.Tensor, cfg: DoaConfig,
                                num_peaks: int, x_rng=(0.0, 180.0),
                                peaks2d=None, half_width_deg: float = 1.5,
                                num_points: int = 17,
                                refine_chunk: int = 128):
    """Coarse → refine incoherent wideband MUSIC (the power path). From
    the coarse fused spectrum P f32[B, G] ((1/F) Σ_f dmin_f / den_f on the
    config's grid) and its per-subband minima dmin f32[F, B] — both from
    one launch of kernel 5 (wideband_fused_spectrum(return_dmin=True)) —
    and the subspaces Vt f32[F, B, 2K, 2N]: the unrefined peaks of P,
    then the fused metric (fused_metric) on a micro-grid around each:
    on a ULA its argmax on num_points angles and the parabolic vertex, on
    a URA (cfg.grid2d) its argmax on the num_points² grid, no parabola.
    peaks2d: the 2-D peak rule (the pipeline's kernel 6; None takes
    find_local_max_2d). → (values f32[B, k], angles f32[B, k] or az/el
    f32[B, k, 2])."""
    W = num_points
    if cfg.geometry.kind == "ura":
        g2 = cfg.grid2d
        peaks2d = find_local_max_2d if peaks2d is None else peaks2d
        vals, az_c, el_c = peaks2d(
            P.reshape(P.shape[0], g2.num_az, g2.num_el), num_peaks,
            (g2.az_lo_deg, g2.az_hi_deg), (g2.el_lo_deg, g2.el_hi_deg),
            refine=False)
        azg, elg = micro_grid_2d(az_c, el_c, half_width_deg, W)
        m = fused_metric(Vt, dmin, (azg, elg), cfg, refine_chunk)
        az, el, _ = argbest_2d(m, azg, elg, largest=True)
        return vals, torch.stack([az, el], dim=-1)
    vals, coarse = find_local_max(P, num_peaks, x_rng[0], x_rng[1],
                                  refine=False)
    theta = coarse[..., None] + torch.linspace(
        -half_width_deg, half_width_deg, W, dtype=torch.float32,
        device=coarse.device)                                # (B, k, W)
    m = fused_metric(Vt, dmin, theta, cfg, refine_chunk)
    i = torch.argmax(m, dim=-1)
    step = 2.0 * half_width_deg / (W - 1)
    t0 = torch.gather(theta, -1, i[..., None])[..., 0]
    return vals, t0 + parabolic_vertex(m, i) * step
