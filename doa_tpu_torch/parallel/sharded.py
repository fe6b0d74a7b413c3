"""The time-sharded narrowband DoA pipeline over torch.distributed ranks
(port of the narrowband half of doa_tpu/parallel/sharded.py).

Layout, one rank per mesh position (parallel/mesh.py):

    capture x[T, N] c64       → rows [s·T/n_snap, (s+1)·T/n_snap) on snap
                                index s (the reference's P("snap", None))
    steering A f32[G, N]      → rows [g·G/n_grid, …) on grid index g
    peaks (B_loc, k)          → the rank's windows, replicated over grid
    spectra (B_loc, G_loc)    → the rank's windows × its grid block

Per rank: the halo exchange appends the right neighbour's first
`overlap` samples (ops/cuda/ring.py: impl "xla" zero-fills the last rank,
"pallas" is kernel 13's ring), the covariance windows that START in the
block, the subspace, the scan of the local angle block and the O(k) peak
merge over the grid axis. Windows at the global tail whose halo ran past
the capture end are invalid: callers keep the first num_valid_windows(T,
cfg) rows of the concatenated blocks.

Fused path (the single-card fused route's rule, plan.fused_route),
per rank:
    x_blk[T_loc, 2N] → halo → K1 (cov_embedded) → E f32[B_loc, 2N, 2N]
      → the last rank's tail windows zeroed for the subspace stage
      → warm start from the psum'd global capture mean (K4) and the
        escalation counts psum'd (or cold when fewer than 32 windows)
      → unsharded grid, return_spectra=False: K2 scan + peaks;
        otherwise K3 → the O(k) merge; Capon, Bartlett on R = unembed(E)
General path (smoothing, subspace_method="eigh", a hop outside the rule):
    halo → the two stride-2 planes → kernel 8 windows (Rr, Ri) → the
    correction, FB, smoothing → the cold MGS subspace (K4) and the dense
    MUSIC denominator, or the eigh noise projector; Capon, Bartlett → the
    O(k) merge.

As in the reference, the sharded pipeline takes neither subspace_impl nor
subspace_check (the warm MGS subspace always runs) and reports escalation
counts on the fused path only. Outside the slice, and raising
NotImplementedError: the wideband, TOPS and CSSM sharded pipelines and
beamspace (queue A.6), and min-norm, root-MUSIC, ESPRIT, Unitary ESPRIT
and the Jacobi subspace (queue A.3).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from doa_tpu_torch.configs import AvgMethod, DoaConfig, Estimator, as_config
from doa_tpu_torch.cpx import fp32_matmuls, unembed_planes
from doa_tpu_torch.ops import cpx_ops
from doa_tpu_torch.ops.cpx_ops import signal_subspace_from_E_T
from doa_tpu_torch.ops.cuda.cov_embedded import cov_embedded
from doa_tpu_torch.ops.cuda.music_scan import peaks_tiles, scan_tiles
from doa_tpu_torch.ops.cuda import ring
from doa_tpu_torch.ops.peaks import (_refine_frac, _topk_lastaxis,
                                     find_local_max_2d)
from doa_tpu_torch.parallel.collectives import all_gather, ppermute, psum
from doa_tpu_torch.parallel.mesh import GRID_AXIS, SNAP_AXIS, Mesh
from doa_tpu_torch.pipeline import _steering_matrix
from doa_tpu_torch.pipeline_torch import _correction_planes
from doa_tpu_torch.plan import Plan, kernel_forms, sharded_kernel_routes

_ESTIMATORS = (Estimator.MUSIC, Estimator.CAPON, Estimator.BARTLETT)


def num_valid_windows(T: int, cfg: DoaConfig) -> int:
    """Global window count for a T-sample capture (windows fully inside)."""
    S, hop = cfg.snapshot_size, cfg.hop
    return 0 if T < S else (T - S) // hop + 1


def _f32(v) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32)


def _gather_best(mesh: Mesh, k: int, vals, locs, rmax_v, rmax_l):
    """The O(k) exchange of both merges: every grid rank's k candidates
    and its row maximum → the global top k (value, location…) with the
    reference's pad-with-best and global-argmax fallbacks, and gmax."""
    cat = lambda t: all_gather(t, mesh, GRID_AXIS, dim=1)  # noqa: E731
    all_v = cat(vals)
    all_l = [cat(t) for t in locs]
    all_rv = cat(rmax_v)
    all_rl = [cat(t) for t in rmax_l]
    mv, mpos = _topk_lastaxis(all_v, k)
    gpos = torch.argmax(all_rv, dim=-1, keepdim=True)
    gmax = torch.gather(all_rv, -1, gpos)                       # (B, 1)
    have_any = torch.isfinite(mv[:, 0:1])
    valid = torch.isfinite(mv)
    best_v = torch.where(have_any, mv[:, 0:1], gmax)
    out_l = []
    for al, arl in zip(all_l, all_rl):
        ml = torch.gather(al, -1, mpos)
        best = torch.where(have_any, ml[:, 0:1], torch.gather(arl, -1, gpos))
        out_l.append(torch.where(valid, ml, best))
    v = torch.where(valid, mv, best_v)
    return v / gmax, out_l, gmax


def _local_peaks_merge_1d(P_loc: torch.Tensor, num_max_vals: int, x_rng,
                          refine: bool, mesh: Mesh):
    """O(k) tensor-parallel peak extraction over the grid axis: one-column
    spectrum halos from the grid neighbours make every local bin's peak
    test exact, peaks and sub-bin refinement run on the local block with
    the global angle mapping, and only (value, angle) candidates, k per
    rank, plus each rank's row maximum cross the ranks. Matches dense
    find_local_max, pad-with-best-peak and global-argmax fallbacks
    included.

    P_loc f32[B, G_loc] → (values / global row max, angles, global row
    max (B, 1))."""
    k = num_max_vals
    n = mesh.axis_size(GRID_AXIS)
    me = mesh.axis_index(GRID_AXIS)
    B, G_loc = P_loc.shape
    G = G_loc * n
    dx = (x_rng[1] - x_rng[0]) / (G - 1)
    inf = torch.full((B, 1), torch.inf, dtype=P_loc.dtype,
                     device=P_loc.device)
    if n == 1:
        left = right = inf
    else:
        left = ppermute(P_loc[:, -1:], mesh, GRID_AXIS,
                        [(i, i + 1) for i in range(n - 1)])
        right = ppermute(P_loc[:, :1], mesh, GRID_AXIS,
                         [(i + 1, i) for i in range(n - 1)])
        left = inf if me == 0 else left         # global edge bins are
        right = inf if me == n - 1 else right   # never peaks
    P_ext = torch.cat([left, P_loc, right], dim=1)
    is_max = torch.zeros_like(P_ext, dtype=torch.bool)
    is_max[:, 1:-1] = ((P_ext[:, 1:-1] > P_ext[:, :-2])
                       & (P_ext[:, 1:-1] >= P_ext[:, 2:]))
    masked = torch.where(is_max, P_ext, torch.full_like(P_ext, -torch.inf))
    vals, idx = _topk_lastaxis(masked, k)                 # extended coords
    # the reference's float32 arithmetic of the block offset
    x0 = _f32(x_rng[0]).to(P_loc.device)
    dx32 = _f32(dx).to(P_loc.device)
    x_min_ext = x0 + _f32(me * G_loc - 1).to(P_loc.device) * dx32
    if refine:
        locs = x_min_ext + _refine_frac(P_ext, idx, G_loc + 2) * dx
    else:
        locs = x_min_ext + idx.to(P_ext.dtype) * dx
    rmax_i = torch.argmax(P_loc, dim=-1, keepdim=True)
    rmax_v = torch.gather(P_loc, -1, rmax_i)                   # (B, 1)
    rmax_l = x0 + (me * G_loc + rmax_i).to(P_loc.dtype) * dx
    v, (l,), gmax = _gather_best(mesh, k, vals, [locs], rmax_v, [rmax_l])
    return v, l, gmax


def _local_peaks_merge_2d(P_loc: torch.Tensor, num_max_vals: int, g2,
                          refine: bool, mesh: Mesh):
    """O(k) tensor-parallel 2-D peak extraction: the az-major flattened
    grid is sharded in whole-az-row blocks (n_grid | num_az), so peak
    neighbourhoods cross rank boundaries along az only and one az-row
    halo from each grid neighbour makes every local bin's 4-neighbour test
    exact; local top-k candidates and each rank's row maximum merge as in
    the 1-D version. Az refinement reads the halo rows, el refinement is
    local.

    P_loc f32[B, Ga_loc·Ge] → (values / gmax (B, k), angles (B, k, 2)
    az/el, gmax (B, 1))."""
    k = num_max_vals
    n = mesh.axis_size(GRID_AXIS)
    me = mesh.axis_index(GRID_AXIS)
    B, Gl = P_loc.shape
    Ge, Ga = g2.num_el, g2.num_az
    Ga_loc = Gl // Ge
    P3 = P_loc.reshape(B, Ga_loc, Ge)
    inf = torch.full((B, 1, Ge), torch.inf, dtype=P3.dtype,
                     device=P3.device)
    if n == 1:
        up = dn = inf
    else:
        up = ppermute(P3[:, -1:, :], mesh, GRID_AXIS,
                      [(i, i + 1) for i in range(n - 1)])
        dn = ppermute(P3[:, :1, :], mesh, GRID_AXIS,
                      [(i + 1, i) for i in range(n - 1)])
        up = inf if me == 0 else up             # global az edges are
        dn = inf if me == n - 1 else dn         # never peaks
    Pe = torch.cat([up, P3, dn], dim=1)
    mid = P3[:, :, 1:-1]
    core = ((mid > Pe[:, :-2, 1:-1]) & (mid >= Pe[:, 2:, 1:-1])
            & (mid > P3[:, :, :-2]) & (mid >= P3[:, :, 2:]))
    is_max = torch.zeros_like(P3, dtype=torch.bool)
    is_max[:, :, 1:-1] = core
    masked = torch.where(is_max, P3,
                         torch.full_like(P3, -torch.inf)).reshape(B, Gl)
    vals, idx = _topk_lastaxis(masked, k)                 # local flat
    ra = idx // Ge
    ce = idx - ra * Ge
    if refine:
        # separable reciprocal-space parabolas; the az profile's ±1 rows
        # come from the extended block (halo rows included)
        tiny = torch.finfo(P3.dtype).tiny
        q = lambda v: 1.0 / v.clamp_min(tiny)            # noqa: E731
        flat_e = Pe.reshape(B, (Ga_loc + 2) * Ge)
        pick_e = lambda r, c: torch.gather(flat_e, -1, r * Ge + c)  # noqa
        q0 = q(pick_e(ra + 1, ce))
        qm = q(pick_e(ra, ce))
        qp = q(pick_e(ra + 2, ce))
        dd = qm - 2.0 * q0 + qp
        da_ = torch.where(dd.abs() > 0, 0.5 * (qm - qp) / dd,
                          torch.zeros_like(dd))
        ga = me * Ga_loc + ra                             # global az row
        da_ = torch.where((ga > 0) & (ga < Ga - 1), da_.clamp(-0.5, 0.5),
                          torch.zeros_like(da_))
        pick_l = lambda r, c: torch.gather(P_loc, -1, r * Ge + c)  # noqa
        qm = q(pick_l(ra, (ce - 1).clamp_min(0)))
        qp = q(pick_l(ra, (ce + 1).clamp_max(Ge - 1)))
        dd = qm - 2.0 * q0 + qp
        de_ = torch.where(dd.abs() > 0, 0.5 * (qm - qp) / dd,
                          torch.zeros_like(dd))
        de_ = torch.where((ce > 0) & (ce < Ge - 1), de_.clamp(-0.5, 0.5),
                          torch.zeros_like(de_))
        fa = (me * Ga_loc + ra).to(P3.dtype) + da_
        fe = ce.to(P3.dtype) + de_
    else:
        fa = (me * Ga_loc + ra).to(P3.dtype)
        fe = ce.to(P3.dtype)
    daz = (g2.az_hi_deg - g2.az_lo_deg) / (Ga - 1)
    dele = (g2.el_hi_deg - g2.el_lo_deg) / (Ge - 1)
    az = g2.az_lo_deg + fa * daz
    el = g2.el_lo_deg + fe * dele
    # the rank's row maximum (value, unrefined location) for the global
    # normalisation and the no-peak fallback
    rmax_i = torch.argmax(P_loc, dim=-1, keepdim=True)
    rmax_v = torch.gather(P_loc, -1, rmax_i)                   # (B, 1)
    r_ra = rmax_i // Ge
    r_ce = rmax_i - r_ra * Ge
    rmax_az = g2.az_lo_deg + (me * Ga_loc + r_ra).to(P3.dtype) * daz
    rmax_el = g2.el_lo_deg + r_ce.to(P3.dtype) * dele
    v, (az_o, el_o), gmax = _gather_best(mesh, k, vals, [az, el], rmax_v,
                                         [rmax_az, rmax_el])
    return v, torch.stack([az_o, el_o], dim=-1), gmax


def _check_sharded_slice(cfg: DoaConfig) -> None:
    """Raise NotImplementedError for a config outside the ported sharded
    slice, naming the ROADMAP.md queue that will cover it."""
    todo = []
    if cfg.wideband.enabled:
        todo.append(f"the sharded wideband pipelines (fusion="
                    f"{cfg.wideband.fusion!r}: _build_sharded_wideband, "
                    "_build_sharded_tops, _build_sharded_cssm; queue A.6)")
    if cfg.beamspace.enabled:
        todo.append("sharded beamspace (the steering and each rank's R "
                    "projected onto the beams; queue A.6)")
    if cfg.subspace_method == "jacobi":
        todo.append("subspace_method='jacobi' (queue A.3)")
    other = [e.value for e in cfg.estimators if e not in _ESTIMATORS]
    if other:
        todo.append(f"estimators {other} (root-MUSIC, ESPRIT, Unitary "
                    "ESPRIT, min-norm: queue A.3)")
    if todo:
        raise NotImplementedError(
            "doa_tpu_torch's sharded pipeline ports the narrowband fused and "
            "general paths; not yet ported: " + "; ".join(todo)
            + " — see ROADMAP.md")


def _to_interleaved(x) -> np.ndarray:
    """A numpy complex (T, N) capture or a pair of f32[T, N] planes → the
    interleaved float32 (T, 2N) bytes of its complex64 form."""
    if isinstance(x, (tuple, list)):
        if len(x) != 2:
            raise ValueError("planes input is a pair (xr, xi)")
        x = np.asarray(x[0]) + 1j * np.asarray(x[1])
    x = np.asarray(x)
    if x.ndim != 2 or not np.iscomplexobj(x):
        raise ValueError(f"need a complex (T, N) capture, got {x.dtype} "
                         f"{x.shape}")
    x = np.ascontiguousarray(x, dtype=np.complex64)
    return x.view(np.float32)


def _block_rows(T: int, mesh: Mesh):
    """This rank's rows [lo, hi) of a T-row global array, as the
    reference's P("snap", None)."""
    n, s = mesh.axis_size(SNAP_AXIS), mesh.axis_index(SNAP_AXIS)
    T_loc = T // n
    return s * T_loc, (s + 1) * T_loc


def build_sharded_pipeline(cfg: DoaConfig, mesh: Mesh,
                           refine_peaks: bool = True,
                           return_spectra: bool = True):
    """→ callable(x, correction=None) → dict of this rank's outputs; every
    rank of the mesh calls together. x is the global capture, a numpy
    complex (T, N) array or a pair of f32[T, N] planes; each rank takes
    its own rows, and T must be divisible by n_snap · hop. ``call.local(
    x_blk, correction=None)`` takes this rank's block only: numpy complex
    (T_loc, N), or a tensor of the interleaved (T_loc, 2N) bytes (float32,
    bfloat16, or int8 under cov_dtype="int8").

    Outputs (the reference's keys): ``peak_values_<est>``,
    ``peak_angles_<est>`` (B_loc, k) or (B_loc, k, 2) az/el, and with
    return_spectra ``spectrum_<est>`` (B_loc, G_loc), this rank's windows
    and grid block, normalised by the global row maximum (a 2-D grid
    whose az rows do not split over the grid ranks returns the whole
    (B_loc, G) row); on the fused path ``escalation_flagged`` and
    ``escalation_overflow``, summed over the snap axis. Rows past
    num_valid_windows on the last snap rank are invalid.

    return_spectra=False on the fused path with an unsharded 1-D grid
    fuses normalise + peaks into the scan kernel (K2; k ≤ 4, G ≤ 8192),
    as the single-card pipeline does. ``call.plan`` is
    sharded_kernel_plan on a CUDA mesh (every stage "plain" on the CPU;
    plan.py): the pipeline takes each stage's route and callable from it,
    so a stage takes its plain torch version on the card only where it
    says so. cfg.halo_impl picks the halo
    exchange ("xla" ppermute, or "pallas": kernel 13). The pipeline runs
    on the mesh rank's device (make_mesh: the card unless the caller asks
    for the CPU).

    ``call.fast`` (the fused path), ``call.mesh``, ``call.config`` (the
    port's own) and ``call.steering_planes`` (this rank's grid block)."""
    cfg = as_config(cfg)
    _check_sharded_slice(cfg)
    dev = mesh.device
    n_snap, n_grid = mesh.axis_size(SNAP_AXIS), mesh.axis_size(GRID_AXIS)
    routes = sharded_kernel_routes(cfg, n_snap, n_grid, return_spectra)
    plan = Plan(routes, on_card=dev.type == "cuda",
                forms=kernel_forms(cfg, routes))
    route = plan.kernels
    A_host, x_rng = _steering_matrix(cfg)
    S, hop, overlap = cfg.snapshot_size, cfg.hop, cfg.overlap
    fb = cfg.avg_method == AvgMethod.FORWARD_BACKWARD
    G = A_host.shape[0]
    if G % n_grid:
        raise ValueError(f"grid size {G} not divisible by n_grid {n_grid}")
    N = cfg.geometry.num_elements
    K = cfg.num_sources
    k = cfg.num_max_vals
    use_power = cfg.subspace_method == "power"
    g2 = cfg.grid2d if cfg.geometry.kind == "ura" else None
    use_2d_merge = g2 is not None and (G // n_grid) % g2.num_el == 0
    fast = route["covariance"] == "chunk_gram"
    esc = cfg.escalate_kwargs
    G_loc = G // n_grid
    g = mesh.axis_index(GRID_AXIS)
    A_blk = A_host[g * G_loc:(g + 1) * G_loc]
    A_re = torch.from_numpy(np.ascontiguousarray(
        A_blk.real, dtype=np.float32)).to(dev)
    A_im = torch.from_numpy(np.ascontiguousarray(
        A_blk.imag, dtype=np.float32)).to(dev)
    At_emb = torch.cat([A_re, A_im], dim=-1).contiguous()   # (G_loc, 2N)
    nrm = (At_emb * At_emb).sum(dim=-1)
    scan = plan.op("scan") if "scan" in plan else None
    if plan.get("scan") == "music_scan":
        # K3's A' of the rank's grid block, made once
        scan = functools.partial(scan, tiles=scan_tiles(At_emb, 2 * K))
    elif plan.get("scan") == "music_scan_peaks":
        # K2's grid operand (A', or Aᵀ for its CUDA-core form), made once
        scan = functools.partial(scan, tiles=peaks_tiles(At_emb, 2 * K))
    need_R = (Estimator.CAPON in cfg.estimators
              or Estimator.BARTLETT in cfg.estimators)

    def _peaks(P_full):
        """Peaks of the gathered, normalised (B, G) row (2-D grids whose
        az rows do not split over the grid ranks)."""
        P2 = P_full.reshape(P_full.shape[0], g2.num_az, g2.num_el)
        v, az, el = find_local_max_2d(
            P2, k, (g2.az_lo_deg, g2.az_hi_deg),
            (g2.el_lo_deg, g2.el_hi_deg), refine=refine_peaks)
        return v, torch.stack([az, el], dim=-1)

    def _merge_peaks(out, est, P_loc):
        """1-D → the column-halo merge; 2-D → the az-row-halo merge when
        rank boundaries fall on az rows, the gathered row otherwise."""
        if g2 is not None and not use_2d_merge:
            P_full = all_gather(P_loc, mesh, GRID_AXIS, dim=1)
            P_full = P_full / P_full.max(dim=-1, keepdim=True).values
            v, l = _peaks(P_full)
            spec = P_full
        else:
            if g2 is not None:
                v, l, gmax = _local_peaks_merge_2d(P_loc, k, g2,
                                                   refine_peaks, mesh)
            else:
                v, l, gmax = _local_peaks_merge_1d(P_loc, k, x_rng,
                                                   refine_peaks, mesh)
            spec = P_loc / gmax
        if return_spectra:
            out[f"spectrum_{est.value}"] = spec
        out[f"peak_values_{est.value}"] = v
        out[f"peak_angles_{est.value}"] = l

    def _spectra(out, R, music):
        """Capon and Bartlett on R, MUSIC through music(); each into the
        merge."""
        for est in cfg.estimators:
            if est == Estimator.MUSIC:
                P_loc = music()
                if P_loc is None:             # K2 wrote the peaks
                    continue
            elif est == Estimator.CAPON:
                P_loc = cpx_ops.capon_spectrum(
                    *R, At_emb, diag_load=cfg.capon_diag_load,
                    normalize=False)
            else:
                P_loc = cpx_ops.bartlett_spectrum(*R, At_emb,
                                                  normalize=False)
            _merge_peaks(out, est, P_loc)

    def run_fast(x_ext, T, cr, ci):
        E_win = cov_embedded(x_ext, cr, ci, N=N, snapshot_size=S,
                             overlap=overlap, fb=fb,
                             compute_dtype=cfg.cov_dtype,
                             kernel=plan.op("covariance"))  # (B_loc, 2N, 2N)
        B_loc = E_win.shape[0]
        B_valid = num_valid_windows(T, cfg)
        n_invalid = B_loc * n_snap - B_valid
        E_sub = E_win
        if n_invalid and mesh.axis_index(SNAP_AXIS) == n_snap - 1:
            # the last rank's tail windows (their halo ran past the capture
            # end) are zeroed for the subspace stage: zero E is source-free
            # to the escalation detector and keeps the capture mean the
            # single-card pipeline's mean over the valid windows
            E_sub = torch.cat([E_win[:B_loc - n_invalid],
                               E_win.new_zeros((n_invalid,)
                                               + E_win.shape[1:])])
        it = plan.op("subspace")
        if cfg.subspace_warm_start and B_valid >= 32:
            Ebar = psum(E_sub.sum(dim=0), mesh, SNAP_AXIS) / B_valid
            Vt_bar = signal_subspace_from_E_T(
                Ebar[None], K, iters=max(cfg.power_iters, 8), iterate=it,
                **esc)
            Vt, stats = signal_subspace_from_E_T(
                E_sub, K, iters=cfg.power_iters_warm, init=Vt_bar,
                return_stats=True, iterate=it, **esc)
        else:
            Vt, stats = signal_subspace_from_E_T(
                E_sub, K, iters=cfg.power_iters,
                squarings=cfg.power_squarings, return_stats=True, iterate=it,
                **(esc if cfg.power_squarings == 0 else {}))
        out = {}

        def music():
            if route["scan"] == "music_scan_peaks":
                v, l = scan(Vt, At_emb, k, x_rng[0], x_rng[1],
                            refine=refine_peaks, nrm=nrm)
                out["peak_values_music"] = v
                out["peak_angles_music"] = l
                return None
            return scan(Vt, At_emb, nrm)

        _spectra(out, unembed_planes(E_win) if need_R else None, music)
        counts = psum(torch.stack(stats).reshape(2), mesh, SNAP_AXIS)
        out["escalation_flagged"] = counts[0]
        out["escalation_overflow"] = counts[1]
        return out

    def run_general(x_ext, cr, ci):
        xv = x_ext.reshape(-1, N, 2)
        R = cpx_ops.cov_from_stream(xv[..., 0], xv[..., 1], S, overlap,
                                    grams=plan.op("covariance"))
        R = cpx_ops.apply_correction_to_cov(*R, cr, ci)
        if fb:
            R = cpx_ops.forward_backward(*R)
        if cfg.smoothing.enabled:
            R = cpx_ops.spatial_smooth(*R, cfg.smoothing.subarray_size)
        out = {}

        def music():
            if use_power:
                V_emb = cpx_ops.signal_subspace_embedded(
                    *R, K, iters=cfg.power_iters,
                    squarings=cfg.power_squarings,
                    iterate=plan.op("subspace"),
                    **(esc if cfg.power_squarings == 0 else {}))
                den = cpx_ops.music_denominator_subspace(
                    V_emb, At_emb, cfg.compute_dtype)
            else:
                M = cpx_ops.noise_projector(*R, K)
                den = cpx_ops.music_denominator_cpx(
                    *M, A_re, A_im, cfg.compute_dtype)
            return 1.0 / den.clamp_min(torch.finfo(torch.float32).tiny)

        _spectra(out, R, music)
        return out

    def local(x_blk, correction=None) -> dict:
        if isinstance(x_blk, torch.Tensor):
            xt = x_blk.to(dev).reshape(-1, 2 * N)
        else:
            xt = torch.from_numpy(_to_interleaved(x_blk)).to(dev)
        if not fast and xt.dtype != torch.float32:
            raise ValueError(f"the general path takes float32 samples, got "
                             f"{xt.dtype}")
        T_loc = xt.shape[0]
        if T_loc % hop:
            raise ValueError(f"a rank's block of {T_loc} samples must be a "
                             f"multiple of hop ({hop}): T must be divisible "
                             f"by n_snap*hop={n_snap * hop}")
        cr, ci = _correction_planes(correction, N, dev)
        with fp32_matmuls():
            x_ext = ring._halo_exchange(
                xt, overlap, mesh,
                impl="pallas" if "halo" in route else "xla")
            if fast:
                return run_fast(x_ext, T_loc * n_snap, cr, ci)
            return run_general(x_ext, cr, ci)

    def call(x, correction=None) -> dict:
        xil = _to_interleaved(x)
        T = xil.shape[0]
        if T % (n_snap * hop):
            raise ValueError(f"T={T} must be divisible by n_snap*hop="
                             f"{n_snap * hop}")
        lo, hi = _block_rows(T, mesh)
        return local(torch.from_numpy(xil[lo:hi]), correction)

    call.local = local
    call.mesh = mesh
    call.fast = fast
    call.config = cfg
    call.steering_planes = (A_re, A_im)
    call.plan = plan
    return call


def distributed_covariance(mesh: Mesh):
    """→ callable(x) → (Rr, Ri) f32[N, N], ONE covariance over the whole
    time-sharded capture, on every rank: each rank's stacked Gram of
    [xr | xi] (one true-FP32 product), summed over the snap axis, so no
    rank gathers samples. x is the global numpy complex (T, N) capture (or
    a pair of planes); ``call.local(x_blk)`` takes this rank's block."""

    def local(x_blk):
        xil = _to_interleaved(x_blk)
        T_loc, n2 = xil.shape
        N = n2 // 2
        xv = torch.from_numpy(xil).to(mesh.device).view(T_loc, N, 2)
        Z = torch.cat([xv[..., 0], xv[..., 1]], dim=-1)      # (T_loc, 2N)
        with fp32_matmuls():
            Gm = Z.T @ Z
        Gm = psum(Gm, mesh, SNAP_AXIS) / (T_loc * mesh.axis_size(SNAP_AXIS))
        return (Gm[:N, :N] + Gm[N:, N:], Gm[N:, :N] - Gm[:N, N:])

    def call(x):
        xil = _to_interleaved(x)
        lo, hi = _block_rows(xil.shape[0], mesh)
        return local(xil[lo:hi].view(np.complex64))

    call.local = local
    return call
