"""Real-valued (split re/im) DoA ops — port of doa_tpu/ops/cpx_ops.py.

* Signal-subspace iteration on embedded covariances (MGS, warm start,
  escalation detector). The reference runs this stage as XLA. Here the
  rounds of the iteration run in one CUDA kernel per call (K4,
  csrc/subspace.cu; `mgs_iterate`), whose plain version is the same
  schedule as batched torch ops; the detector and the rare escalation
  batch are torch ops. orth="ns" is the reference's Newton–Schulz chain
  as torch ops (ops/cuda/subspace_ns.py holds it and kernel 11).
* The subspace guard: invariance residual, capture gap and the eigh
  fallback for flagged windows (guarded_signal_subspace).
* The planes path: covariance windows from sample planes (kernel 8,
  ops/cuda/covariance.py), the correction folded into R, forward-backward
  averaging, spatial smoothing; the eigh noise projector; the dense MUSIC
  denominators; Capon and Bartlett. A covariance travels as a pair of
  planes (Rr, Ri) f32[B, N, N], where the reference carries a ``Cpx``.

Every product is true FP32 (cpx.fp32_matmuls).
"""

from __future__ import annotations

import ctypes

import torch

from doa_tpu_torch import _build
from doa_tpu_torch.cpx import embed_planes, fp32_matmuls, unembed_planes
from doa_tpu_torch.ops.cuda.covariance import cov_from_stream  # noqa: F401
from doa_tpu_torch.ops.cuda.subspace_ns import ns_subspace
from doa_tpu_torch.utils.profiling import span

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIG = {"doa_mgs_iterate": [_P, _P, _I, _P, _P, _P, _I, _I, _I, _I, _P]}
MGS_MAX_N2 = 128        # csrc/subspace.cu: four elements of a row per lane
MGS_MAX_K2 = 8          # csrc/subspace.cu: rows of W a lane keeps
MGS_GROUP_MAX_N2 = 64   # csrc/subspace.cu GROUP_MAX_N2: the group form's 2N
MGS_FORMS = ("group", "block")


def mgs_form(n2: int, k2: int) -> str | None:
    """The form of K4 that takes (2N, 2K), as csrc/subspace.cu dispatches
    (`block_form`): "group" (a window per group of 4, 8 or 16 lanes by
    2N, its rows in registers, E by bulk copy on a persistent grid;
    2N ≤ MGS_GROUP_MAX_N2), "block" (a block of 8 warps a window, E held
    in shared memory for every round, MGS_GROUP_MAX_N2 < 2N ≤ MGS_MAX_N2),
    or None for a shape K4 does not take (an odd 2N, 2N > MGS_MAX_N2 or
    2K > min(2N, MGS_MAX_K2))."""
    if not (n2 <= MGS_MAX_N2 and n2 % 2 == 0 and k2 <= min(n2, MGS_MAX_K2)):
        return None
    return "group" if n2 <= MGS_GROUP_MAX_N2 else "block"


def mgs_takes(n2: int, k2: int) -> bool:
    """The shapes K4 is built for: those mgs_form gives a form."""
    return mgs_form(n2, k2) is not None


def _mgs_rows(Vt: torch.Tensor, passes: int = 1) -> torch.Tensor:
    """Modified Gram-Schmidt over the K2 rows of Vt f32[B, K2, 2N]:
    exact sequential deflation, robust at any eigenvalue spread."""
    rows = []
    for i in range(Vt.shape[-2]):
        v = Vt[..., i, :]
        for _ in range(passes):
            for u in rows:
                v = v - (u * v).sum(-1, keepdim=True) * u
        v = v * torch.rsqrt((v * v).sum(-1, keepdim=True).clamp_min(1e-30))
        rows.append(v)
    return torch.stack(rows, dim=-2)


def _init_rows(init, B: int):
    """→ (m, init f32[m, 2K, 2N]) with window b starting from row
    b // (B // m): one init for every window (m = 1, or an init expanded
    over the windows), one per group of consecutive windows (m | B), or
    one per window (m = B)."""
    if init.shape[0] == B and B > 1 and init.stride(0) == 0:
        init = init[:1]
    m = init.shape[0]
    if B % m:
        raise ValueError(f"{m} inits do not divide {B} windows")
    return m, init


def mgs_iterate_plain(E, num_sources: int, rounds: int, init=None):
    """Plain PyTorch version of K4 → (Vt, W, Vt_prev), each
    f32[B, 2K, 2N]: start from `init` (rows orthonormal; f32[m, 2K, 2N]
    with m | B, window b taking row b // (B // m)) or, cold, from MGS of
    E's first 2K rows; then rounds − 1 times W = Vt E, Vt_prev = Vt,
    Vt = MGS(W) with two passes in the last round. W and Vt_prev are the
    last apply's (one extra apply when none ran) — the escalation
    detector's inputs."""
    K2 = 2 * num_sources
    if init is None:
        Vt = _mgs_rows(E[..., :K2, :])
    else:
        B, n2 = E.shape[0], E.shape[-1]
        m, init = _init_rows(init, B)
        Vt = init[:, None].expand(m, B // m, K2, n2).reshape(B, K2, n2)
    W = Vt_prev = None
    for r in range(rounds - 1):
        W = torch.matmul(Vt, E)
        Vt_prev = Vt
        Vt = _mgs_rows(W, passes=2 if r == rounds - 2 else 1)
    if W is None:
        Vt_prev = Vt
        W = torch.matmul(Vt, E)
    return Vt, W, Vt_prev


def mgs_iterate(E: torch.Tensor, num_sources: int, rounds: int,
                init: torch.Tensor | None = None):
    """K4: every round of the MGS subspace iteration of each window in one
    launch (csrc/subspace.cu) → (Vt, W, Vt_prev) as mgs_iterate_plain.
    E f32[B, 2N, 2N] (2N ≤ 128; the form mgs_form names); init
    f32[m, 2K, 2N] with m | B (window b starts from row b // (B // m): one
    init, one per subband of a subband-major stack, or one per window) or
    None (cold).

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel in the form mgs_form names and raises if that fails; each
    launch is counted in mgs_iterate.launches and, by form, in
    mgs_iterate.by_form."""
    K2 = 2 * num_sources
    if E.dim() != 3 or E.shape[1] != E.shape[2] or E.dtype != torch.float32:
        raise ValueError(f"need E f32[B, 2N, 2N], got {tuple(E.shape)} "
                         f"{E.dtype}")
    B, n2 = E.shape[0], E.shape[-1]
    if init is not None and init.shape[-2:] != (K2, n2):
        raise ValueError(f"init {tuple(init.shape)} does not fit "
                         f"({B}, {K2}, {n2})")
    if E.device.type == "cpu":
        return mgs_iterate_plain(E, num_sources, rounds, init)
    if not E.is_cuda:
        raise ValueError(f"unsupported device {E.device}")
    if not mgs_takes(n2, K2) or rounds < 1:
        raise ValueError(f"mgs_iterate kernel takes an even 2N ≤ "
                         f"{MGS_MAX_N2}, 2K ≤ min(2N, {MGS_MAX_K2}), "
                         f"rounds ≥ 1 (2N={n2}, 2K={K2}, rounds={rounds})")
    E = E.contiguous()
    if E.data_ptr() % 16:       # bulk copies of E
        E = E.clone()
    group = 0
    if init is not None:
        m, init = _init_rows(init, B)
        group = B // m
        init = init.to(torch.float32).contiguous()
    outs = [torch.empty((B, K2, n2), dtype=torch.float32, device=E.device)
            for _ in range(3)]
    lib = _build.load("subspace", _SIG)
    err = lib.doa_mgs_iterate(
        E.data_ptr(), None if init is None else init.data_ptr(), group,
        *(o.data_ptr() for o in outs),
        B, n2, K2, rounds, torch.cuda.current_stream(E.device).cuda_stream)
    _build.check(err, "doa_mgs_iterate")
    mgs_iterate.launches += 1
    mgs_iterate.by_form[mgs_form(n2, K2)] += 1
    return tuple(outs)


mgs_iterate.launches = 0
mgs_iterate.by_form = dict.fromkeys(MGS_FORMS, 0)


def escalation_detector(W, Vt_prev, n2: int, scale=None):
    """From the final apply product W = Vt_prev @ E (Vt_prev orthonormal
    rows; `scale` = tr(E)/n2 per window, or None if E is already
    trace-normalised) → (gamma, gamma_max, res) each f32[B]:

    * gamma: min captured Rayleigh / noise-floor mean (≈1 when the weakest
      captured direction has sunk into the noise bulk);
    * gamma_max: max captured Rayleigh / noise mean (≈1.3–1.7 on a
      source-free capture: nothing to converge to);
    * res: span-invariance residual, ‖W‖² − ‖Vᵀ E V‖² by Pythagoras."""
    k2 = Vt_prev.shape[-2]
    lam = (W * Vt_prev).sum(-1)                          # (B, 2K)
    if scale is not None:
        lam = lam / scale[:, None]
    noise_mean = ((n2 - lam.sum(-1)) / (n2 - k2)).clamp_min(1e-30)
    gamma = lam.min(-1).values / noise_mean
    gamma_max = lam.max(-1).values / noise_mean
    C = torch.matmul(W, Vt_prev.transpose(-1, -2))     # Vᵀ E V
    w2 = (W * W).sum((-2, -1))
    c2 = (C * C).sum((-2, -1))
    res = torch.sqrt((w2 - c2).clamp_min(0.0) / w2.clamp_min(1e-30))
    return gamma, gamma_max, res


def escalation_flags(gamma, gamma_max, res, gap: float, tol: float,
                     signal_floor: float):
    """→ (bad bool[B], score f32[B]): unconverged (res > tol) or weakest
    direction in the noise bulk (gamma < gap), provided the capture shows
    a dominant component (gamma_max ≥ signal_floor). score orders the
    flagged windows by severity."""
    bad = ((res > tol) | (gamma < gap)) & (gamma_max >= signal_floor)
    score = res / tol + (gap - gamma).clamp_min(0.0)
    return bad, score


def escalate_flagged(Ep, Vt, bad, score, extra: int, capacity: int):
    """Gather the worst min(B, capacity) flagged windows, run `extra` MGS
    rounds on that compact batch, scatter back. Flagged windows beyond the
    capacity stay unescalated (reported as overflow). Ties in score keep
    the lower window index first, as lax.top_k does."""
    B = Vt.shape[0]
    M = min(B, max(1, capacity))
    key = torch.where(bad, score, torch.full_like(score, -torch.inf))
    idx = torch.sort(key, descending=True, stable=True).indices[:M]
    Ep_c = Ep.index_select(0, idx)
    v = Vt_c = Vt.index_select(0, idx)
    for _ in range(extra):
        v = _mgs_rows(torch.matmul(v, Ep_c), passes=2)
    upd = torch.where(bad[idx][:, None, None], v, Vt_c)
    out = Vt.clone()
    out[idx] = upd
    return out


def _subspace_E_T_mgs(E, num_sources: int, iters: int, squarings: int,
                      init=None, escalate_extra: int = 0,
                      escalate_gap: float = 3.0, escalate_tol: float = 0.05,
                      escalate_signal_floor: float = 2.5,
                      escalate_capacity: int = 1024,
                      return_stats: bool = False, iterate=None):
    """MGS-orthonormalised subspace iteration (see the reference's
    docstring for the measured design). init: an orthonormal starting
    basis f32[m, 2K, 2N], m | B, shared by groups of B // m consecutive
    windows (warm start; `iters` then counts E-applies from it).
    escalate_extra > 0 (squarings == 0 only) arms the detector and the
    pay-per-window escalation. iterate: the rounds, mgs_iterate (K4) by
    default or its plain version.

    One host sync per call: whether any window was flagged decides
    whether the escalation batch runs at all (lax.cond in the reference).
    Its span, doa.sync.escalation, holds the host read alone: the flag's
    reduction is launched before it."""
    n2 = E.shape[-1]
    tr = torch.diagonal(E, dim1=-2, dim2=-1).sum(-1) / n2        # (B,)
    if squarings > 0:
        Ep = E / tr.clamp_min(1e-30)[:, None, None]
        for _ in range(squarings):
            Ep = torch.matmul(Ep, Ep)
        scale = None
    else:
        # MGS is scale-invariant: iterate on raw E, normalise only the
        # detector's Rayleighs
        Ep = E
        scale = tr.clamp_min(1e-30)
    if init is not None:
        rounds = iters // (1 << squarings) + 1
    else:
        rounds = max(1, iters // (1 << squarings))
    Vt, W, Vt_prev = (iterate or mgs_iterate)(Ep, num_sources, rounds,
                                              init)
    zero = torch.zeros((), dtype=torch.int32, device=E.device)
    if escalate_extra <= 0 or squarings > 0:
        return (Vt, (zero, zero)) if return_stats else Vt
    gamma, gamma_max, res = escalation_detector(W, Vt_prev, n2, scale=scale)
    bad, score = escalation_flags(gamma, gamma_max, res, escalate_gap,
                                  escalate_tol, escalate_signal_floor)
    flag = bad.any()
    with span("doa.sync.escalation"):
        flagged_any = bool(flag)
    if flagged_any:
        with span("doa.escalate"):
            Vt = escalate_flagged(Ep, Vt, bad, score, escalate_extra,
                                  escalate_capacity)
    if return_stats:
        flagged = bad.sum().to(torch.int32)
        cap = min(Vt.shape[0], max(1, escalate_capacity))
        overflow = (flagged - cap).clamp_min(0)
        return Vt, (flagged, overflow)
    return Vt


def signal_subspace_from_E_T(E, num_sources: int, iters: int = 8,
                             ns_iters: int = 12, ns_iters_mid: int = 8,
                             squarings: int = 0, pack: int = 4,
                             orth: str = "mgs", init=None,
                             escalate_extra: int = 0,
                             escalate_gap: float = 3.0,
                             escalate_tol: float = 0.05,
                             escalate_signal_floor: float = 2.5,
                             escalate_capacity: int = 1024,
                             return_stats: bool = False, iterate=None):
    """Embedded signal subspace in transposed layout: Vt f32[B, 2K, 2N]
    with Vt·Vtᵀ = I, from E f32[B, 2N, 2N].

    orth="mgs" (the reference default): the MGS iteration above, with warm
    start and escalation, its rounds by `iterate` (mgs_iterate, K4, by
    default; the pipelines pass its plain version where their kernel plan
    says so). orth="ns": the reference's packed Newton–Schulz
    chain (Jacobi-preconditioned, per-window Frobenius scale; ns_iters in
    the first and last rounds, ns_iters_mid between), cold only. `pack` is
    the reference's count of windows whose chains it stacks into one
    block-diagonal Gram on the TPU; the block mask makes each window's
    chain exact, so every pack ≥ 1 gives the same numbers and the chain
    here runs per window."""
    if orth == "mgs":
        with fp32_matmuls():
            return _subspace_E_T_mgs(
                E, num_sources, iters, squarings, init=init,
                escalate_extra=escalate_extra, escalate_gap=escalate_gap,
                escalate_tol=escalate_tol,
                escalate_signal_floor=escalate_signal_floor,
                escalate_capacity=escalate_capacity,
                return_stats=return_stats, iterate=iterate)
    if orth != "ns":
        raise ValueError(f"unknown orth {orth!r}; 'mgs' or 'ns'")
    if init is not None:
        raise ValueError("warm-start init requires orth='mgs'")
    if escalate_extra > 0:
        raise ValueError("escalation requires orth='mgs'")
    if return_stats:
        raise ValueError("escalation stats require orth='mgs'")
    if pack < 1:
        raise ValueError(f"pack must be ≥ 1, got {pack}")
    return ns_subspace(E, num_sources, iters, ns_iters, ns_iters_mid,
                       squarings, symmetrize=False)


def signal_subspace_from_E(E, num_sources: int, **kw):
    """As signal_subspace_from_E_T, in the reference's layout: V_emb
    f32[B, 2N, 2K] (or (V_emb, stats) with return_stats=True)."""
    out = signal_subspace_from_E_T(E, num_sources, **kw)
    if kw.get("return_stats"):
        return out[0].transpose(-1, -2), out[1]
    return out.transpose(-1, -2)


def signal_subspace_embedded(Rr, Ri, num_sources: int, **kw):
    """Orthonormal basis V_emb f32[B, 2N, 2K] of the embedded signal
    subspace of the covariance planes (Rr, Ri): the cold MGS iteration of
    signal_subspace_from_E on E(R) (kwargs as there)."""
    return signal_subspace_from_E(embed_planes(Rr, Ri), num_sources, **kw)


# ---------------------------------------------------------------------
# The subspace guard (subspace_check)
# ---------------------------------------------------------------------

def subspace_residual(E, V_emb):
    """Invariance residual r = ‖(I − V Vᵀ) E V‖_F / ‖E V‖_F ∈ [0, 1] per
    window of E f32[B, 2N, 2N], V_emb f32[B, 2N, 2K] → f32[B]: 0 for an
    invariant subspace, larger while the iteration has not converged."""
    with fp32_matmuls():
        EV = torch.matmul(E, V_emb)
        coef = torch.matmul(V_emb.transpose(-1, -2), EV)        # Vᵀ E V
        resid = EV - torch.matmul(V_emb, coef)
    num = torch.sqrt((resid * resid).sum(dim=(-2, -1)))
    den = torch.sqrt((EV * EV).sum(dim=(-2, -1)))
    return num / den.clamp_min(1e-30)


def eigh_signal_subspace_from_E(E, num_sources: int):
    """The exact embedded signal subspace (the guard's fallback): the top
    2K eigenvectors of E f32[B, 2N, 2N] → f32[B, 2N, 2K]."""
    _, vecs = torch.linalg.eigh(E)
    return vecs[..., :, -2 * num_sources:]


def capture_gap(E, V_emb, probe_iters: int = 8):
    """Wrong-subspace detector: a few power steps of the deflated matrix
    (I − V Vᵀ) E from u = E·1 estimate the largest eigenvalue V does not
    capture → (lam_missed, lam_min_captured) f32[B] each."""
    with fp32_matmuls():
        EV = torch.matmul(E, V_emb)
        lam = (V_emb * EV).sum(-2)                              # Rayleighs
        lam_min = lam.min(dim=-1).values
        Vt = V_emb.transpose(-1, -2)
        u = E.sum(dim=-1)                                       # E @ ones

        def deflate(u):
            c = torch.matmul(Vt, u[..., None])                  # (B, 2K, 1)
            return u - torch.matmul(V_emb, c)[..., 0]

        for _ in range(probe_iters):
            u = torch.matmul(E, deflate(u)[..., None])[..., 0]
            u = u / torch.sqrt((u * u).sum(-1, keepdim=True)).clamp_min(1e-30)
        u = deflate(u)
        nrm = (u * u).sum(-1)
        Eu = torch.matmul(E, u[..., None])[..., 0]
    lam_missed = (u * Eu).sum(-1) / nrm.clamp_min(1e-30)
    return lam_missed, lam_min


def guarded_signal_subspace(E, V_emb, num_sources: int, tol: float = 0.05,
                            gap_margin: float = 1.05):
    """The subspace guard: a window is flagged when (a) its invariance
    residual exceeds tol, (b) its orthonormality error ‖VᵀV − I‖∞ exceeds
    tol, or (c) the capture gap finds an uncaptured eigenvalue
    ≥ gap_margin × the smallest captured Rayleigh value. Flagged windows
    take the exact eigh subspace → (V_emb f32[B, 2N, 2K], max(residual,
    flag) f32[B]: ≥ 1 marks a replaced window).

    One host sync per call decides whether any window was flagged (lax.cond
    in the reference); eigh then runs on the flagged windows only, which
    gives the reference's where() over all of them."""
    res = subspace_residual(E, V_emb)
    k2 = V_emb.shape[-1]
    with fp32_matmuls():
        G = torch.matmul(V_emb.transpose(-1, -2), V_emb)
    eye = torch.eye(k2, dtype=G.dtype, device=G.device)
    orth_err = (G - eye).abs().amax(dim=(-2, -1))
    lam_missed, lam_min = capture_gap(E, V_emb)
    bad = (res > tol) | (orth_err > tol) | (lam_missed > gap_margin * lam_min)
    if bool(bad.any()):
        idx = bad.nonzero()[:, 0]
        V_emb = V_emb.clone()
        V_emb[idx] = eigh_signal_subspace_from_E(E[idx], num_sources)
    return V_emb, torch.maximum(res, bad.to(res.dtype))


# ---------------------------------------------------------------------
# The planes path: covariance windows from sample planes
# (cov_from_stream, imported above from ops/cuda/covariance.py), then the
# correction, FB and smoothing on the (Rr, Ri) planes
# ---------------------------------------------------------------------

def apply_correction_to_cov(Rr, Ri, cr, ci):
    """cov(diag(c)·x) = (c cᴴ) ∘ cov(x) for c = cr + j·ci f32[N]: the
    correction folded into R, before FB and smoothing."""
    Wr = cr[:, None] * cr[None, :] + ci[:, None] * ci[None, :]
    Wi = ci[:, None] * cr[None, :] - cr[:, None] * ci[None, :]
    return Rr * Wr - Ri * Wi, Rr * Wi + Ri * Wr


def forward_backward(Rr, Ri):
    """R_fb = ½(R + J conj(R) J): flip both axes, negate the imaginary."""
    return (0.5 * (Rr + Rr.flip(-2, -1)), 0.5 * (Ri - Ri.flip(-2, -1)))


def spatial_smooth(Rr, Ri, subarray_size: int):
    """Mean of the N − L + 1 diagonal L×L sub-blocks."""
    N = Rr.shape[-1]
    L = subarray_size
    M = N - L + 1
    rr, ri = Rr[..., 0:L, 0:L], Ri[..., 0:L, 0:L]
    for m in range(1, M):
        rr = rr + Rr[..., m:m + L, m:m + L]
        ri = ri + Ri[..., m:m + L, m:m + L]
    return rr / M, ri / M


# ---------------------------------------------------------------------
# Noise projector and the dense spectra
# ---------------------------------------------------------------------

def noise_projector(Rr, Ri, num_sources: int):
    """Noise projector M = E_n E_nᴴ as planes (Mr, Mi) f32[B, N, N]: eigh of
    the real 2N embedding, whose 2(N − K) smallest eigenvectors span the
    embedded noise subspace (it is closed under the complex structure)."""
    N = Rr.shape[-1]
    _, V = torch.linalg.eigh(embed_planes(Rr, Ri))
    Vn = V[..., :, :2 * (N - num_sources)]
    with fp32_matmuls():
        P = torch.matmul(Vn, Vn.transpose(-1, -2))
    return unembed_planes(P)


def noise_projector_from_signal(V_emb):
    """Embedded signal basis V_emb f32[B, 2N, 2K] → the complex noise
    projector M = I − E_s E_sᴴ as planes (Mr, Mi) f32[B, N, N] (for
    root-MUSIC on the power subspace)."""
    n2 = V_emb.shape[-2]
    with fp32_matmuls():
        P = torch.matmul(V_emb, V_emb.transpose(-1, -2))
    eye = torch.eye(n2, dtype=V_emb.dtype, device=V_emb.device)
    return unembed_planes(eye - P)


def _cast(t, compute_dtype):
    """The reference's `astype(compute_dtype)` of a matmul input, as f32
    values: bfloat16 rounds to nearest even, int8 truncates toward zero.
    Products of such values are exact in FP32 and the sums accumulate in
    FP32, as the reference's preferred_element_type=float32."""
    dt = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "int8": torch.int8}[compute_dtype]
    return t.to(dt).to(torch.float32)


def music_denominator_subspace(V_emb, At_emb, compute_dtype="float32"):
    """den[b, g] = ‖ã_g‖² − ‖V_embᵀ ã_g‖² for V_emb f32[B, 2N, 2K] and the
    embedded grid At_emb f32[G, 2N]. compute_dtype bfloat16 rounds both
    inputs; int8 quantizes both at scale 127 (clip to ±1), whose integer
    products summed in FP32 are exact here (|Σ| < 2^24)."""
    nrm = (At_emb * At_emb).sum(-1)
    if compute_dtype == "int8":
        q = lambda t: torch.round(t.clamp(-1, 1) * 127.0)  # noqa: E731
        with fp32_matmuls():
            Y = torch.einsum("gn,bnk->bgk", q(At_emb), q(V_emb))
        Y = Y / (127.0 * 127.0)
    else:
        with fp32_matmuls():
            Y = torch.einsum("gn,bnk->bgk", _cast(At_emb, compute_dtype),
                             _cast(V_emb, compute_dtype))
    return nrm[None, :] - (Y * Y).sum(-1)


def music_denominator_cpx(Mr, Mi, Ar, Ai, compute_dtype="float32"):
    """den[b, g] = Re(a_gᴴ M_b a_g) = arᵀMr ar + aiᵀMr ai + 2·aiᵀMi ar for
    the projector planes (Mr, Mi) f32[B, N, N] and steering planes
    (Ar, Ai) f32[G, N]; compute_dtype casts the matmul inputs as the
    reference does (int8 truncates)."""
    c = lambda t: _cast(t, compute_dtype)  # noqa: E731
    with fp32_matmuls():
        t1 = torch.einsum("gn,bnm->bgm", c(Ar), c(Mr))
        t2 = torch.einsum("gn,bnm->bgm", c(Ai), c(Mr))
        t3 = torch.einsum("gn,bnm->bgm", c(Ai), c(Mi))
    return ((t1 * Ar[None]).sum(-1) + (t2 * Ai[None]).sum(-1)
            + 2.0 * (t3 * Ar[None]).sum(-1))


def spectrum_from_den(den, normalize: bool = True):
    """P = 1 / max(den, tiny), each row divided by its maximum."""
    P = 1.0 / den.clamp_min(torch.finfo(torch.float32).tiny)
    if normalize:
        P = P / P.max(dim=-1, keepdim=True).values
    return P


def bartlett_spectrum(Rr, Ri, At_emb, normalize: bool = True):
    """Bartlett: P = ãᵀ E(R) ã = Re(aᴴ R a), one matmul of the flattened
    E (B, 4N²) against the grid's outer-product table (4N², G)."""
    E = embed_planes(Rr, Ri)
    At = At_emb.T                                     # (2N, G)
    Kt = (At[:, None, :] * At[None, :, :]).reshape(-1, At.shape[-1])
    with fp32_matmuls():
        P = torch.matmul(E.reshape(E.shape[0], -1), Kt)
    if normalize:
        P = P / P.max(dim=-1, keepdim=True).values
    return P


def capon_spectrum(Rr, Ri, At_emb, diag_load: float = 1e-4,
                   normalize: bool = True, method: str = "cholesky",
                   newton_iters: int = 24):
    """Capon-MVDR: den = ãᵀ E(R)⁻¹ ã on the 2N embedding, with diagonal
    loading diag_load·tr(R)/N. method "cholesky": L = chol(E) (cholesky_ex:
    no host sync), den = ‖L⁻¹ã‖²; "newton": the Newton–Schulz inverse
    X ← X(2I − EX) from X₀ = I/‖E‖∞."""
    N = Rr.shape[-1]
    if diag_load > 0:
        tr = torch.diagonal(Rr, dim1=-2, dim2=-1).sum(-1) / N
        eye = torch.eye(N, dtype=Rr.dtype, device=Rr.device)
        Rr = Rr + (diag_load * tr)[..., None, None] * eye
    E = embed_planes(Rr, Ri)                          # (B, 2N, 2N) SPD
    At = At_emb.T                                     # (2N, G)
    with fp32_matmuls():
        if method == "cholesky":
            L, _ = torch.linalg.cholesky_ex(E)
            X = torch.linalg.solve_triangular(
                L, At.expand(E.shape[:-2] + At.shape), upper=False)
            den = (X * X).sum(-2)
        elif method == "newton":
            Einv = _spd_inverse_newton(E, iters=newton_iters)
            den = (At * torch.matmul(Einv, At)).sum(-2)
        else:
            raise ValueError(f"unknown Capon method {method!r}")
    return spectrum_from_den(den, normalize)


def _spd_inverse_newton(E, iters: int = 24):
    """Batched SPD inverse by Newton–Schulz, X ← X(2I − EX), from
    X₀ = I/‖E‖∞ (max absolute row sum), so ‖I − EX₀‖ < 1."""
    n = E.shape[-1]
    eye = torch.eye(n, dtype=E.dtype, device=E.device)
    norm = E.abs().sum(-1).max(-1).values
    X = eye / norm[..., None, None]
    with fp32_matmuls():
        for _ in range(iters):
            X = torch.matmul(X, 2.0 * eye - torch.matmul(E, X))
    return X
