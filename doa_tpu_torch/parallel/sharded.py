"""The sharded DoA pipeline over torch.distributed ranks (port of
doa_tpu/parallel/sharded.py).

Narrowband layout, one rank per mesh position (parallel/mesh.py):

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

Fast path (plan.sharded_fused_route: the single-card fused route's rule,
no beamspace), per rank:
    x_blk[T_loc, 2N] → halo → K1 (cov_embedded) → E f32[B_loc, 2N, 2N]
      → the last rank's tail windows zeroed for the subspace stage
      → warm start from the psum'd global capture mean (K4) and the
        escalation counts psum'd (or cold when fewer than 32 windows)
      → unsharded grid, return_spectra=False: K2 scan + peaks;
        otherwise K3 → the O(k) merge; min-norm on the subspace; Capon,
        Bartlett and the grid-free estimators on R = unembed(E)
General path (smoothing, beamspace, subspace_method "eigh" or "jacobi", a
hop outside the rule):
    halo → the two stride-2 planes → kernel 8 windows (Rr, Ri) → the
    correction, FB, smoothing → beamspace's projection BᴴRB (the beam
    matrix replicated, the projected steering grid sharded) → the cold
    MGS subspace (K4) and its dense MUSIC and min-norm denominators, or
    the eigh noise projector; Capon, Bartlett → the O(k) merge; the
    grid-free estimators on the rank's R.

Wideband, the expert-parallel (EP) layout: the snap axis shards time as
above (no halo: a window lies in one block, T divisible by n_snap·S), the
grid axis shards the F subbands, F_loc = F / n_grid a rank:
    x_blk → the rank's subband windows E f32[F_loc, B_loc, 2N, 2N]
      (kernel 4 on the block for all F subbands, the rank's slice kept:
      the single-card front end, wideband_cov_embedded(variant="auto"))
    incoherent: per-subband subspaces (K4, warm from the mean over every
      rank's windows) → the rank's spectrum sum over its subbands
      (kernel 5's mean × F_loc on the fast route where it applies, else
      the per-subband spectra) → one psum over the grid axis, / F → the
      peaks of the whole row (kernel 6 on a 2-D grid)
    TOPS: the reference band's subspaces replicated, Σ CᴴC and the guard
      sum over the rank's subbands → one psum → λ_min → peaks
    CSSM: Σ T_f R_f T_fᴴ over the rank's subbands → one psum, / F →
      R_coh, replicated; then the same axis shards the grid of its
      narrowband MUSIC scan (K4, K3 or K2) and the O(k) merge
      (cssm_auto: the capture-mean covariances psum'd over time and the
      coarse spectra over the rank's subbands psum'd, so every rank
      focuses at the same angles, each for its own subbands)

As in the reference, the sharded pipeline takes neither subspace_impl nor
subspace_check (the warm MGS subspace always runs), reports escalation
counts on the fast path only, runs MUSIC alone under CSSM, and takes the
eigh noise projector under subspace_method "jacobi".
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from doa_tpu_torch.configs import AvgMethod, DoaConfig, Estimator, as_config
from doa_tpu_torch.cpx import fp32_matmuls, unembed_planes
from doa_tpu_torch.ops import cpx_ops
from doa_tpu_torch.ops.beamspace import (beamspace_covariance,
                                         beamspace_steering, dft_beam_matrix)
from doa_tpu_torch.ops.cpx_ops import signal_subspace_from_E_T
from doa_tpu_torch.ops.cuda.cov_embedded import cov_embedded
from doa_tpu_torch.ops.cuda.music_scan import peaks_tiles, scan_tiles
from doa_tpu_torch.ops.cuda import ring
from doa_tpu_torch.ops.cuda.wideband_cov import wideband_cov_embedded
from doa_tpu_torch.ops.esprit import (esprit_cpx, signal_subspace_cpx,
                                      unitary_esprit_cpx)
from doa_tpu_torch.ops.min_norm import (min_norm_denominator_cpx,
                                        min_norm_denominator_subspace)
from doa_tpu_torch.ops.peaks import (_refine_frac, _topk_lastaxis,
                                     find_local_max)
from doa_tpu_torch.ops.root_music import root_music_cpx
from doa_tpu_torch.ops.tops import (tops_accumulate_cc, tops_finalize,
                                    tops_leakage_row)
from doa_tpu_torch.ops.wideband import (coarse_band_spectra, divide,
                                        focused_sum, focusing_matrices,
                                        fused_sum, power_spectra,
                                        projector_spectra, runtime_focusing,
                                        steering_planes,
                                        subband_noise_projectors,
                                        subband_spacings,
                                        subband_subspaces_from_E,
                                        wideband_steering_stack)
from doa_tpu_torch.parallel.collectives import all_gather, ppermute, psum
from doa_tpu_torch.parallel.mesh import GRID_AXIS, SNAP_AXIS, Mesh
from doa_tpu_torch.pipeline import _steering_fn, _steering_matrix
from doa_tpu_torch.pipeline_torch import _check_slice, _correction_planes
from doa_tpu_torch.plan import Plan, kernel_forms, sharded_kernel_routes

_TINY = torch.finfo(torch.float32).tiny


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


def _plan(cfg: DoaConfig, mesh: Mesh, return_spectra: bool) -> Plan:
    routes = sharded_kernel_routes(cfg, mesh.axis_size(SNAP_AXIS),
                                   mesh.axis_size(GRID_AXIS), return_spectra)
    return Plan(routes, on_card=mesh.device.type == "cuda",
                forms=kernel_forms(cfg, routes))


def _grid_block(A_host: np.ndarray, mesh: Mesh):
    """The rank's block of the steering grid → (A_re, A_im f32[G_loc, N],
    At_emb f32[G_loc, 2N], nrm f32[G_loc]) on its device."""
    G_loc = A_host.shape[0] // mesh.axis_size(GRID_AXIS)
    g = mesh.axis_index(GRID_AXIS)
    blk = A_host[g * G_loc:(g + 1) * G_loc]
    A_re, A_im = (torch.from_numpy(np.ascontiguousarray(
        p, dtype=np.float32)).to(mesh.device) for p in (blk.real, blk.imag))
    At_emb = torch.cat([A_re, A_im], dim=-1).contiguous()
    return A_re, A_im, At_emb, (At_emb * At_emb).sum(dim=-1)


def _scan_op(plan: Plan, At_emb: torch.Tensor, K: int):
    """The plan's MUSIC scan on the rank's grid block, a kernel with its
    grid operand made once (K3's A', K2's A' or Aᵀ); None where the route
    has no scan stage."""
    if plan.get("scan") == "music_scan":
        return functools.partial(plan.op("scan"),
                                 tiles=scan_tiles(At_emb, 2 * K))
    if plan.get("scan") == "music_scan_peaks":
        return functools.partial(plan.op("scan"),
                                 tiles=peaks_tiles(At_emb, 2 * K))
    return plan.op("scan") if "scan" in plan else None


def _row_peaks(cfg: DoaConfig, plan: Plan, x_rng, refine: bool):
    """→ peaks(P) of whole spectrum rows P f32[B, G]: find_local_max on a
    1-D grid, the plan's 2-D peaks (kernel 6) on an az/el grid →
    (values, angles (B, k) or az/el (B, k, 2))."""
    k = cfg.num_max_vals
    g2 = cfg.grid2d if cfg.geometry.kind == "ura" else None

    def peaks(P):
        if g2 is None:
            return find_local_max(P, k, x_rng[0], x_rng[1], refine=refine)
        v, az, el = plan.op("peaks")(
            P.reshape(P.shape[0], g2.num_az, g2.num_el), k,
            (g2.az_lo_deg, g2.az_hi_deg), (g2.el_lo_deg, g2.el_hi_deg),
            refine=refine)
        return v, torch.stack([az, el], dim=-1)
    return peaks


def _peak_merger(cfg: DoaConfig, mesh: Mesh, plan: Plan, x_rng,
                 refine: bool, return_spectra: bool):
    """→ merge(out, name, P_loc): the peaks of a grid-sharded scan's block
    P_loc f32[B, G_loc] into `out` under the reference's keys. 1-D → the
    column-halo merge; 2-D → the az-row-halo merge where the rank
    boundaries fall on az rows, else the gathered row's peaks (kernel 6).
    With return_spectra the spectrum: the block normalised by the global
    row maximum, or the whole gathered row."""
    k = cfg.num_max_vals
    g2 = cfg.grid2d if cfg.geometry.kind == "ura" else None
    gather = "peaks" in plan.kernels
    row_peaks = _row_peaks(cfg, plan, x_rng, refine)

    def merge(out, name, P_loc):
        if gather:
            P = all_gather(P_loc, mesh, GRID_AXIS, dim=1)
            spec = P / P.max(dim=-1, keepdim=True).values
            v, l = row_peaks(spec)
        else:
            if g2 is not None:
                v, l, gmax = _local_peaks_merge_2d(P_loc, k, g2, refine, mesh)
            else:
                v, l, gmax = _local_peaks_merge_1d(P_loc, k, x_rng, refine,
                                                   mesh)
            spec = P_loc / gmax
        if return_spectra:
            out[f"spectrum_{name}"] = spec
        out[f"peak_values_{name}"] = v
        out[f"peak_angles_{name}"] = l
    return merge


def _inverse(den: torch.Tensor) -> torch.Tensor:
    """P = 1 / max(den, tiny), the reference's unnormalised spectrum."""
    return 1.0 / den.clamp_min(_TINY)


def build_sharded_pipeline(cfg: DoaConfig, mesh: Mesh,
                           refine_peaks: bool = True,
                           return_spectra: bool = True):
    """→ callable(x, correction=None) → dict of this rank's outputs; every
    rank of the mesh calls together. x is the global capture, a numpy
    complex (T, N) array or a pair of f32[T, N] planes; each rank takes
    its own rows, and T must be divisible by n_snap · hop (a wideband
    config: n_snap · S). ``call.local(x_blk, correction=None)`` takes this
    rank's block only: numpy complex (T_loc, N), or a tensor of the
    interleaved (T_loc, 2N) bytes (float32; on the narrowband fast path
    also bfloat16, or int8 under cov_dtype="int8").

    Outputs (the reference's keys): ``peak_values_<est>``,
    ``peak_angles_<est>`` (B_loc, k) or (B_loc, k, 2) az/el, and with
    return_spectra ``spectrum_<est>`` (B_loc, G_loc), this rank's windows
    and grid block, normalised by the global row maximum (a 2-D grid
    whose az rows do not split over the grid ranks returns the whole
    (B_loc, G) row), for MUSIC, min-norm, Capon and Bartlett; on a ULA
    ``root_music_angles``, ``esprit_angles``, ``unitary_esprit_angles``
    (B_loc, K); on the fast path ``escalation_flagged`` and
    ``escalation_overflow``, summed over the snap axis. Rows past
    num_valid_windows on the last snap rank are invalid. Wideband configs
    take the EP layout (module docstring): incoherent fusion and CSSM
    return the "music" keys, TOPS the "tops" keys, each spectrum the
    whole (B_loc, G) row (CSSM's as the narrowband scan's).

    return_spectra=False on the fast path with an unsharded 1-D grid
    fuses normalise + peaks into the scan kernel (K2; k ≤ 4, G ≤ 8192),
    as the single-card pipeline does, and so does the CSSM scan of
    R_coh. ``call.plan`` is sharded_kernel_plan on a CUDA mesh (every
    stage "plain" on the CPU; plan.py): the pipeline takes each stage's
    route and callable from it, so a stage takes its plain torch version
    on the card only where it says so. cfg.halo_impl picks the narrowband
    halo exchange ("xla" ppermute, or "pallas": kernel 13). The pipeline
    runs on the mesh rank's device (make_mesh: the card unless the caller
    asks for the CPU).

    ``call.mesh``, ``call.config`` (the port's own), ``call.plan`` and,
    narrowband, ``call.fast`` (the fast path) and ``call.steering_planes``
    (this rank's grid block)."""
    cfg = as_config(cfg)
    if cfg.wideband.enabled:
        return _build_sharded_wideband(cfg, mesh, refine_peaks,
                                       return_spectra)
    dev = mesh.device
    n_snap, n_grid = mesh.axis_size(SNAP_AXIS), mesh.axis_size(GRID_AXIS)
    plan = _plan(cfg, mesh, return_spectra)
    route = plan.kernels
    A_host, x_rng = _steering_matrix(cfg)
    S, hop, overlap = cfg.snapshot_size, cfg.hop, cfg.overlap
    fb = cfg.avg_method == AvgMethod.FORWARD_BACKWARD
    N = cfg.geometry.num_elements
    K = cfg.num_sources
    k = cfg.num_max_vals
    d = cfg.geometry.norm_spacing
    bs = cfg.beamspace.enabled
    if bs:
        # the (N, Nb) beam matrix is replicated and the PROJECTED steering
        # grid sharded: the covariance stays element-space on each rank
        # (halo and psum layout unchanged) and each rank projects its
        # R → BᴴRB once; every later stage runs at Nb
        Bm_host = dft_beam_matrix(N, cfg.beamspace.num_beams,
                                  cfg.beamspace.center_deg, d)
        A_host = beamspace_steering(A_host, Bm_host)
        Bm = torch.from_numpy(Bm_host).to(dev)
    G = A_host.shape[0]
    if G % n_grid:
        raise ValueError(f"grid size {G} not divisible by n_grid {n_grid}")
    use_power = cfg.subspace_method == "power"
    fast = route["covariance"] == "chunk_gram"
    esc = cfg.escalate_kwargs
    A_re, A_im, At_emb, nrm = _grid_block(A_host, mesh)
    scan = _scan_op(plan, At_emb, K)
    ests = cfg.estimators
    ula = cfg.geometry.kind == "ula"
    need_R = any(e in ests for e in (
        Estimator.CAPON, Estimator.BARTLETT, Estimator.ROOT_MUSIC,
        Estimator.ESPRIT, Estimator.UNITARY_ESPRIT))
    merge = _peak_merger(cfg, mesh, plan, x_rng, refine_peaks,
                         return_spectra)

    def _spectra(out, R, music, min_norm):
        """Each scanned estimator's block into the merge: MUSIC through
        music() (None: K2 wrote the peaks), min-norm's den through
        min_norm() (w is per window, so the grid-sharded scan needs no
        collective), Capon and Bartlett on R."""
        for est in ests:
            if est == Estimator.MUSIC:
                P_loc = music()
                if P_loc is None:
                    continue
            elif est == Estimator.MIN_NORM:
                P_loc = _inverse(min_norm())
            elif est == Estimator.CAPON:
                P_loc = cpx_ops.capon_spectrum(
                    *R, At_emb, diag_load=cfg.capon_diag_load,
                    normalize=False)
            elif est == Estimator.BARTLETT:
                P_loc = cpx_ops.bartlett_spectrum(*R, At_emb,
                                                  normalize=False)
            else:               # grid-free: _grid_free
                continue
            merge(out, est.value, P_loc)

    def _grid_free(out, R, V_emb):
        """Root-MUSIC (on the power subspace's noise projector where there
        is one, else eigh's), ESPRIT and Unitary ESPRIT of the rank's own
        windows, on a ULA only, as the reference."""
        if not ula:
            return
        if Estimator.ROOT_MUSIC in ests:
            nproj = (None if V_emb is None
                     else cpx_ops.noise_projector_from_signal(V_emb))
            out["root_music_angles"] = root_music_cpx(*R, K, d,
                                                      noise_proj=nproj)
        if Estimator.ESPRIT in ests:
            out["esprit_angles"] = esprit_cpx(*R, K, d)
        if Estimator.UNITARY_ESPRIT in ests:
            out["unitary_esprit_angles"] = unitary_esprit_cpx(*R, K, d)

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
        V_emb = Vt.transpose(-1, -2)
        out = {}

        def music():
            if route["scan"] == "music_scan_peaks":
                v, l = scan(Vt, At_emb, k, x_rng[0], x_rng[1],
                            refine=refine_peaks, nrm=nrm)
                out["peak_values_music"] = v
                out["peak_angles_music"] = l
                return None
            return scan(Vt, At_emb, nrm)

        R = unembed_planes(E_win) if need_R else None
        _spectra(out, R, music, lambda: min_norm_denominator_subspace(
            V_emb, A_re, A_im, cfg.compute_dtype))
        _grid_free(out, R, V_emb)
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
        if bs:
            R = beamspace_covariance(*R, Bm)
        V_emb = M = None
        if "subspace" in route:
            V_emb = cpx_ops.signal_subspace_embedded(
                *R, K, iters=cfg.power_iters, squarings=cfg.power_squarings,
                iterate=plan.op("subspace"),
                **(esc if cfg.power_squarings == 0 else {}))
        elif Estimator.MUSIC in ests or Estimator.MIN_NORM in ests:
            # eigh's projector under "jacobi" too: the reference's sharded
            # general path reads the subspace method as "power" or not
            # (parallel/sharded.py:287) and takes noise_projector_cpx, as
            # its single-card wideband scan does (ops/wideband.py)
            M = cpx_ops.noise_projector(*R, K)
        out = {}

        def music():
            if use_power:
                den = cpx_ops.music_denominator_subspace(
                    V_emb, At_emb, cfg.compute_dtype)
            else:
                den = cpx_ops.music_denominator_cpx(
                    *M, A_re, A_im, cfg.compute_dtype)
            return _inverse(den)

        def min_norm():
            if use_power:
                return min_norm_denominator_subspace(V_emb, A_re, A_im,
                                                     cfg.compute_dtype)
            # at float32 whatever compute_dtype is, as the reference's
            return min_norm_denominator_cpx(*M, A_re, A_im)

        _spectra(out, R, music, min_norm)
        _grid_free(out, R, V_emb)
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


# ---------------------------------------------------------------------
# Wideband: the expert-parallel layout
# ---------------------------------------------------------------------

def _ep_layout(cfg: DoaConfig, mesh: Mesh):
    """The EP layout's checks, the reference's ValueErrors (and the
    single-card pipeline's for spatial smoothing on a wideband ULA) → (F,
    F_loc, lo): the rank's subbands are [lo, lo + F_loc)."""
    _check_slice(cfg)
    F = cfg.wideband.num_subbands
    n_ep = mesh.axis_size(GRID_AXIS)
    if F % n_ep:
        raise ValueError(f"subbands {F} not divisible by EP axis {n_ep}")
    F_loc = F // n_ep
    return F, F_loc, mesh.axis_index(GRID_AXIS) * F_loc


def _ep_front_end(cfg: DoaConfig, plan: Plan):
    """→ front(x, cr, ci) → the embedded covariance windows E f32[F,
    B_loc, 2N, 2N] of every subband of the rank's block x f32[T_loc, 2N]
    (interleaved), the correction (cr, ci) folded per subband: one launch
    of kernel 4 (the single-card front end, variant "auto": the FFT form
    for a power-of-two F, else the frames source) yields all F subbands,
    which the layout makes inherent; callers slice their own."""
    N, F = cfg.geometry.num_elements, cfg.wideband.num_subbands

    def front(x, cr, ci):
        return wideband_cov_embedded(
            x, cr, ci, N=N, F=F, snapshot_size=cfg.snapshot_size,
            overlap=cfg.overlap, kernel=plan.op("covariance"))
    return front


def _ep_pipeline(cfg: DoaConfig, mesh: Mesh, plan: Plan, run):
    """The entry points of an EP pipeline around run(x f32[T_loc, 2N], cr,
    ci) → dict (build_sharded_pipeline's call and call.local)."""
    dev = mesh.device
    N, S = cfg.geometry.num_elements, cfg.snapshot_size
    n_snap = mesh.axis_size(SNAP_AXIS)

    def local(x_blk, correction=None) -> dict:
        if isinstance(x_blk, torch.Tensor):
            xt = x_blk.to(device=dev, dtype=torch.float32).reshape(-1, 2 * N)
        else:
            xt = torch.from_numpy(_to_interleaved(x_blk)).to(dev)
        if xt.shape[0] % S:
            raise ValueError(f"a rank's block of {xt.shape[0]} samples must "
                             f"be a multiple of S ({S}): T must be divisible "
                             f"by n_snap*S={n_snap * S} on the wideband EP "
                             "path")
        cr, ci = _correction_planes(correction, N, dev)
        with fp32_matmuls():
            return run(xt, cr, ci)

    def call(x, correction=None) -> dict:
        xil = _to_interleaved(x)
        T = xil.shape[0]
        if T % (n_snap * S):
            raise ValueError(f"T={T} must be divisible by n_snap*S="
                             f"{n_snap * S} on the wideband EP path")
        lo, hi = _block_rows(T, mesh)
        return local(torch.from_numpy(xil[lo:hi]), correction)

    call.local = local
    call.mesh = mesh
    call.config = cfg
    call.plan = plan
    return call


def _subband_steering(cfg: DoaConfig, lo: int, hi: int, dev) -> torch.Tensor:
    """Subbands [lo, hi) of the per-subband steering stack, c64[hi − lo,
    G, N] on the device."""
    X = wideband_steering_stack(cfg, _steering_fn(cfg))[lo:hi]
    return torch.from_numpy(np.ascontiguousarray(X, np.complex64)).to(dev)


def _build_sharded_wideband(cfg: DoaConfig, mesh: Mesh,
                            refine_peaks: bool = True,
                            return_spectra: bool = True):
    """EP-sharded wideband (build_sharded_pipeline): "cssm" and
    "cssm_auto" go to _build_sharded_cssm, "tops" to _build_sharded_tops;
    incoherent fusion here. Each rank's subband windows (_ep_front_end),
    their subspaces (K4; the warm start from the mean over every rank's
    windows, the reference's pmean, gated on the global window count) and
    the sum of its subbands' max-normalised spectra: kernel 5's mean × F_loc
    where the plan has it (the reference's fast route), else each
    subband's spectrum (the power subspaces at compute_dtype, or eigh's
    noise projectors, under "jacobi" too) summed; then ONE psum over the
    grid axis, / F, and every rank peaks its windows on the whole grid."""
    if cfg.wideband.fusion in ("cssm", "cssm_auto"):
        return _build_sharded_cssm(cfg, mesh, refine_peaks, return_spectra)
    if cfg.wideband.fusion == "tops":
        return _build_sharded_tops(cfg, mesh, refine_peaks, return_spectra)
    F, F_loc, lo = _ep_layout(cfg, mesh)
    plan = _plan(cfg, mesh, return_spectra)
    route = plan.kernels
    _, x_rng = _steering_matrix(cfg)
    A_loc = _subband_steering(cfg, lo, lo + F_loc, mesh.device)
    Xr, Xi, As_emb, As_nrm = steering_planes(A_loc.real, A_loc.imag)
    del A_loc
    front = _ep_front_end(cfg, plan)
    peaks = _row_peaks(cfg, plan, x_rng, refine_peaks)
    n_snap = mesh.axis_size(SNAP_AXIS)
    K = cfg.num_sources

    def run(x, cr, ci):
        E = front(x, cr, ci)[lo:lo + F_loc]           # (F_loc, B_loc, 2N, 2N)
        if cfg.subspace_method == "power":
            Ebar = (divide(psum(E.mean(dim=1), mesh, SNAP_AXIS), n_snap)
                    if cfg.subspace_warm_start
                    and E.shape[1] * n_snap >= 32 else None)
            Vt = subband_subspaces_from_E(E, cfg, iterate=plan.op("subspace"),
                                          Ebar=Ebar)
            del E
            if "fusion" in route:
                # kernel 5's mean over the rank's subbands × F_loc: their
                # sum, as the reference's fast route
                P = plan.op("fusion")(Vt, As_emb, As_nrm) * F_loc
            else:
                P = fused_sum(power_spectra(Vt, As_emb, cfg.compute_dtype))
        else:
            M = subband_noise_projectors(E, K)
            del E
            P = fused_sum(projector_spectra(*M, Xr, Xi, cfg.compute_dtype))
        # the EP fusion: one psum of the ranks' subband sums, / F
        P = divide(psum(P, mesh, GRID_AXIS), F)
        v, l = peaks(P)
        out = {"peak_values_music": v, "peak_angles_music": l}
        if return_spectra:
            out["spectrum_music"] = P
        return out

    return _ep_pipeline(cfg, mesh, plan, run)


def _build_sharded_tops(cfg: DoaConfig, mesh: Mesh,
                        refine_peaks: bool = True,
                        return_spectra: bool = True):
    """EP-sharded TOPS (fusion="tops", ops/tops.py): the subband axis is
    the EP axis. Each rank takes the reference band's covariance and
    complex signal subspace itself (one band: no broadcast; the reference
    steering row rides in replicated), its own subbands' subspaces
    (max(power_iters, 16) iterations, as the reference), and Σ CᴴC with
    the guard's sum over its subbands (tops_accumulate_cc on its slice,
    the reference band weighted 0). The fusion is ONE psum of those sums
    over the grid axis, after which every rank finalises λ_min and peaks
    its windows on the whole grid."""
    F, F_loc, lo = _ep_layout(cfg, mesh)
    plan = _plan(cfg, mesh, return_spectra)
    _, x_rng = _steering_matrix(cfg)
    dev = mesh.device
    K, N = cfg.num_sources, cfg.geometry.num_elements
    ref = cfg.wideband.tops_ref_band
    sub_iters = max(cfg.power_iters, 16)
    A_loc = _subband_steering(cfg, lo, lo + F_loc, dev)
    A_ref = _subband_steering(cfg, ref, ref + 1, dev)[0]
    w = [0.0 if lo + f == ref else 1.0 for f in range(F_loc)]
    front = _ep_front_end(cfg, plan)
    peaks = _row_peaks(cfg, plan, x_rng, refine_peaks)

    def run(x, cr, ci):
        E = front(x, cr, ci)
        S_ref = signal_subspace_cpx(
            torch.complex(*unembed_planes(E[ref])), K, iters=sub_iters)
        R = torch.complex(*unembed_planes(E[lo:lo + F_loc]))
        del E
        B = R.shape[1]
        S_loc = signal_subspace_cpx(R.reshape(F_loc * B, N, N), K,
                                    iters=sub_iters).reshape(F_loc, B, N, K)
        del R
        v = tops_leakage_row(A_ref, S_ref)
        ccr, cci, mus = tops_accumulate_cc(S_loc, A_loc, A_ref, S_ref, v, w)
        # the fusion: ONE psum of the three sums in one buffer
        n = ccr.numel()
        buf = psum(torch.cat([ccr.reshape(-1), cci.reshape(-1),
                              mus.reshape(-1)]), mesh, GRID_AXIS)
        ccr, cci = buf[:n].view_as(ccr), buf[n:2 * n].view_as(cci)
        mus = buf[2 * n:].view_as(mus)
        P = tops_finalize(ccr, cci, v, F,
                          guard=mus if cfg.wideband.tops_guard else None)
        pv, pl = peaks(P)
        out = {"peak_values_tops": pv, "peak_angles_tops": pl}
        if return_spectra:
            out["spectrum_tops"] = P
        return out

    return _ep_pipeline(cfg, mesh, plan, run)


def _build_sharded_cssm(cfg: DoaConfig, mesh: Mesh,
                        refine_peaks: bool = True,
                        return_spectra: bool = True):
    """EP → TP coherent wideband: the grid axis is used twice. As the EP
    axis, each rank's Σ T_f R_f T_fᴴ over its subbands, ONE psum, / F →
    R_coh, replicated; then FB and smoothing, and as the TP axis the
    narrowband MUSIC scan of R_coh against the rank's grid block (K4, and
    K3 or K2 where the plan has them) into the O(k) merge.

    "cssm_auto" keeps its two passes EP-sharded: the capture-mean subband
    covariances over every rank's windows (the ranks' means psum'd over
    the snap axis, / n_snap, as the reference), each rank's coarse spectra
    against its subbands' steering, one psum over the grid axis, / F: the
    same coarse spectrum, and so the same focusing angles, on every rank;
    then runtime focusing for the rank's own subbands."""
    F, F_loc, lo = _ep_layout(cfg, mesh)
    dev = mesh.device
    A_host, x_rng = _steering_matrix(cfg)
    G, n_ep = A_host.shape[0], mesh.axis_size(GRID_AXIS)
    if G % n_ep:
        raise ValueError(f"grid size {G} not divisible by TP axis {n_ep}")
    plan = _plan(cfg, mesh, return_spectra)
    route = plan.kernels
    n_snap = mesh.axis_size(SNAP_AXIS)
    K, k = cfg.num_sources, cfg.num_max_vals
    fb = cfg.avg_method == AvgMethod.FORWARD_BACKWARD
    esc = cfg.escalate_kwargs
    A_re, A_im, At_emb, nrm = _grid_block(A_host, mesh)
    scan = _scan_op(plan, At_emb, K)
    merge = _peak_merger(cfg, mesh, plan, x_rng, refine_peaks,
                         return_spectra)
    auto = cfg.wideband.fusion == "cssm_auto"
    if auto:
        A_loc = _subband_steering(cfg, lo, lo + F_loc, dev)
        As_emb = steering_planes(A_loc.real, A_loc.imag)[2]
        del A_loc
        spac = np.concatenate([[cfg.geometry.norm_spacing],
                               subband_spacings(cfg)[lo:lo + F_loc]])
    else:
        T_foc = torch.from_numpy(focusing_matrices(cfg)[lo:lo + F_loc]).to(dev)
    front = _ep_front_end(cfg, plan)

    def run(x, cr, ci):
        R_sub = torch.complex(*unembed_planes(
            front(x, cr, ci)[lo:lo + F_loc]))
        if auto:
            Rbar = divide(psum(R_sub.mean(dim=1), mesh, SNAP_AXIS), n_snap)
            P1 = coarse_band_spectra(Rbar, As_emb, cfg,
                                     iterate=plan.op("coarse_subspace"))
            P1 = divide(psum(P1.sum(dim=0), mesh, GRID_AXIS), F)   # (1, G)
            Tf = runtime_focusing(P1, cfg, spac)
        else:
            Tf = T_foc
        # the EP fusion: ONE psum of the ranks' focused sums → R_coh
        R = divide(psum(focused_sum(R_sub, Tf), mesh, GRID_AXIS), F)
        del R_sub
        Rr, Ri = R.real.contiguous(), R.imag.contiguous()
        if fb:
            Rr, Ri = cpx_ops.forward_backward(Rr, Ri)
        if cfg.smoothing.enabled:
            Rr, Ri = cpx_ops.spatial_smooth(Rr, Ri,
                                            cfg.smoothing.subarray_size)
        # the TP scan on the same axis: R_coh replicated, the grid sharded
        out = {}
        if "subspace" in route:
            V = cpx_ops.signal_subspace_embedded(
                Rr, Ri, K, iters=cfg.power_iters,
                squarings=cfg.power_squarings, iterate=plan.op("subspace"),
                **(esc if cfg.power_squarings == 0 else {}))
            Vt = V.transpose(-1, -2)
            if route.get("scan") == "music_scan_peaks":
                v, l = scan(Vt, At_emb, k, x_rng[0], x_rng[1],
                            refine=refine_peaks, nrm=nrm)
                return {"peak_values_music": v, "peak_angles_music": l}
            P_loc = (scan(Vt, At_emb, nrm) if scan is not None
                     else _inverse(cpx_ops.music_denominator_subspace(
                         V, At_emb, cfg.compute_dtype)))
        else:
            M = cpx_ops.noise_projector(Rr, Ri, K)
            P_loc = _inverse(cpx_ops.music_denominator_cpx(
                *M, A_re, A_im, cfg.compute_dtype))
        merge(out, "music", P_loc)
        return out

    return _ep_pipeline(cfg, mesh, plan, run)


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
