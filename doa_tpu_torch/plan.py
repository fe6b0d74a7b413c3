"""The build-time kernel plan: which hand-written kernel each stage of a
pipeline launches on the card.

A kernel is built for some shapes only, and its wrapper's predicate
(`gram_takes`, `planes_takes`, `mgs_takes`, `kernel_takes`,
`fusion_takes`, `ns_takes`, `scan_takes`, `peaks_takes`, `track_takes`)
states which; given a CUDA tensor of another shape the wrapper raises.
The plan is worked out once, from the config alone (no card needed), when
a pipeline is built: {stage: the kernel's name}, or "plain" where the
predicate says no, and there the stage runs the kernel's plain torch
version on the card (the tracker's plan, `track_plan`, from its slots
and detections a window). The pipelines take each stage's route (`Plan.kernels`) and callable
(`Plan.op`) from it, so the plan they expose as ``call.plan`` is what
they run.

The route rules the plan reads are stated here once: the fused-path rule
(`fused_route`), the subspace rule (`runs_power_subspace`), the
fused-peaks rule (`fuses_peaks`), the scan rule (`scans_music_kernel`),
the hierarchical rule (`hierarchical_music`) and the width of the
subspace and scan stages (`subspace_n2`: the beams' under beamspace).
"""

from __future__ import annotations

import math

from doa_tpu_torch.configs import DoaConfig, Estimator, as_config
from doa_tpu_torch.ops.cpx_ops import (mgs_form, mgs_iterate,
                                       mgs_iterate_plain, mgs_takes)
from doa_tpu_torch.ops.cuda.cov_embedded import (chunk_grams_uhat,
                                                  chunk_grams_uhat_plain,
                                                  gram_epilogue, gram_takes,
                                                  interleave_factor)
from doa_tpu_torch.ops.cuda.covariance import (chunk_form, chunk_grams,
                                               chunk_grams_plain,
                                               planes_takes)
from doa_tpu_torch.ops.cuda.music_scan import (MAX_FUSED_G, MAX_FUSED_K,
                                               music_scan, music_scan_peaks,
                                               music_scan_peaks_plain,
                                               music_scan_plain, peaks_takes,
                                               scan_takes)
from doa_tpu_torch.ops.cuda.peaks2d import (MAX_PEAKS2D_K, peaks2d,
                                           peaks_form)
from doa_tpu_torch.ops.cuda.subspace_ns import (ns_form, ns_takes,
                                                subspace_ns,
                                                subspace_ns_plain)
from doa_tpu_torch.ops.cuda.track import track_scan, track_takes
from doa_tpu_torch.ops.cuda.wideband_cov import (kernel_takes,
                                                 resolve_variant,
                                                 subband_chunk_grams,
                                                 subband_chunk_grams_plain,
                                                 subband_embedded_frames,
                                                 subband_embedded_frames_plain)
from doa_tpu_torch.ops.cuda.wideband_scan import (
    fusion_takes, wideband_fused_spectrum, wideband_fused_spectrum_plain)
from doa_tpu_torch.ops.peaks import find_local_max_2d
from doa_tpu_torch.tracking import track_batch_plain
from doa_tpu_torch.ops.wideband import fusion_kernel_applies

# kernel name → (its wrapper, its plain version: the same signature)
KERNELS = {
    "chunk_gram": (chunk_grams_uhat, chunk_grams_uhat_plain),
    "planes_chunk_gram": (chunk_grams, chunk_grams_plain),
    "wideband_fft_gram": (subband_chunk_grams, subband_chunk_grams_plain),
    "subband_embedded_frames": (subband_embedded_frames,
                                subband_embedded_frames_plain),
    "mgs_iterate": (mgs_iterate, mgs_iterate_plain),
    "subspace_ns": (subspace_ns, subspace_ns_plain),
    "music_scan": (music_scan, music_scan_plain),
    "music_scan_peaks": (music_scan_peaks, music_scan_peaks_plain),
    "wideband_fusion": (wideband_fused_spectrum,
                        wideband_fused_spectrum_plain),
    "peaks2d": (peaks2d, find_local_max_2d),
    "track": (track_scan, track_batch_plain),
}


class Plan(dict):
    """{stage: the kernel's name, or "plain"} from routes {stage: (kernel,
    whether it takes the config's shapes)}; on_card=False (a pipeline on
    the CPU) makes every stage "plain". `kernels` keeps each stage's
    kernel, planned or not: the stage's route. `forms` names, for each
    planned stage whose kernel has named forms, the form a launch takes
    (kernel_forms)."""

    def __init__(self, routes: dict, on_card: bool = True,
                 forms: dict | None = None):
        super().__init__((stage, kernel if takes and on_card else "plain")
                         for stage, (kernel, takes) in routes.items())
        self.kernels = {stage: kernel for stage, (kernel, _) in
                        routes.items()}
        self.forms = {stage: f for stage, f in (forms or {}).items()
                      if self[stage] != "plain"}

    def op(self, stage: str):
        """The stage's callable: its kernel's wrapper where planned, else
        the kernel's plain version."""
        wrapper, plain = KERNELS[self.kernels[stage]]
        return plain if self[stage] == "plain" else wrapper


def fused_route(cfg: DoaConfig) -> bool:
    """The fused-path rule, the reference's (pipeline_tpu.py:164-166):
    narrowband, power subspace, no smoothing, and TPACK | gcd(S, hop) with
    TPACK = interleave_factor(N). The last condition comes from the TPU's
    128-lane layout, but it is kept as a route choice, not as a layout
    rule: the route sets the numbers (the fused route warm-starts from the
    capture mean, the planes route runs a cold subspace), so a config
    outside it takes the planes route here as there."""
    S = cfg.snapshot_size
    return (not cfg.wideband.enabled and cfg.subspace_method == "power"
            and not cfg.smoothing.enabled
            and math.gcd(S, cfg.hop)
            % interleave_factor(cfg.geometry.num_elements) == 0)


def _grid_size(cfg: DoaConfig) -> int:
    if cfg.geometry.kind == "ura":
        return cfg.grid2d.num_az * cfg.grid2d.num_el
    return cfg.grid.num_points


def fuses_peaks(cfg: DoaConfig, return_spectra: bool) -> bool:
    """The fused-peaks rule: K2 writes the peaks (no spectrum) when the
    spectra are not returned, the grid is 1-D, k ≤ MAX_FUSED_K and
    3 ≤ G ≤ MAX_FUSED_G. A single-card pipeline asks with
    return_spectra=False under the hierarchical rule, whose MUSIC returns
    no spectrum whatever return_spectra is (kernel_routes)."""
    G = _grid_size(cfg)
    return (not return_spectra and cfg.geometry.kind != "ura"
            and cfg.num_max_vals <= MAX_FUSED_K and 3 <= G <= MAX_FUSED_G)


def runs_power_subspace(cfg: DoaConfig) -> bool:
    """The rule of the reference (pipeline_tpu.py:289-292): the power
    subspace runs where subspace_method is "power" and an estimator reads
    it: MUSIC, root-MUSIC on a ULA (its noise projector) or min-norm (its
    weight)."""
    ests = cfg.estimators
    return (cfg.subspace_method == "power"
            and (Estimator.MUSIC in ests or Estimator.MIN_NORM in ests
                 or (Estimator.ROOT_MUSIC in ests
                     and cfg.geometry.kind == "ula")))


def hierarchical_music(cfg: DoaConfig) -> bool:
    """The reference's hierarchical rule for MUSIC (pipeline_tpu.py:317):
    scan_mode "hierarchical" on the power subspace. There MUSIC returns
    the coarse scan's peaks refined on micro-grids and no spectrum; under
    eigh or Jacobi it stays a dense scan of the projector (Capon's
    hierarchical branch does not read the subspace method)."""
    return (cfg.scan_mode == "hierarchical"
            and cfg.subspace_method == "power"
            and Estimator.MUSIC in cfg.estimators)


def subspace_n2(cfg: DoaConfig) -> int:
    """The width 2N of the subspace and scan stages: 2·Nb under beamspace
    (the covariance stays at the array's 2N and is projected after it),
    else 2·effective_num_elements."""
    if cfg.beamspace.enabled:
        return 2 * cfg.beamspace.num_beams
    return 2 * cfg.effective_num_elements


def scans_music_kernel(cfg: DoaConfig) -> bool:
    """MUSIC on the power subspace runs the scan kernels (K3 or K2) under
    scan_mode "pallas" ("auto" picks it on the fused path) or
    compute_dtype float32; else the dense quantized scan (torch ops)."""
    scan_mode = cfg.scan_mode
    if scan_mode == "auto":
        scan_mode = "pallas" if fused_route(cfg) else "dense"
    return (cfg.subspace_method == "power"
            and Estimator.MUSIC in cfg.estimators
            and (scan_mode == "pallas" or cfg.compute_dtype == "float32"))


def _wideband_covariance_route(cfg: DoaConfig):
    """Kernel 4's front end, wideband_cov_embedded(variant="auto")'s
    dispatch: "wideband_fft_gram" for a power-of-two subband count, else
    the ring kernel's frames source "subband_embedded_frames"."""
    fft = resolve_variant(cfg.wideband.num_subbands, "auto") == "fft"
    return ("wideband_fft_gram" if fft else "subband_embedded_frames",
            kernel_takes(cfg.geometry.num_elements))


def mgs_n2(cfg: DoaConfig, stage: str) -> int:
    """The 2N at which K4 runs `stage`: the array's for cssm_auto's coarse
    pass ("coarse_subspace") and for the power subspaces of incoherent
    wideband, else subspace_n2."""
    wb = cfg.wideband
    if stage == "coarse_subspace" or (wb.enabled
                                      and wb.fusion == "incoherent"):
        return 2 * cfg.geometry.num_elements
    return subspace_n2(cfg)


def _k4_route(cfg: DoaConfig, stage: str) -> tuple:
    """K4's route of `stage`: ("mgs_iterate", whether it takes the
    stage's shapes)."""
    return ("mgs_iterate", mgs_takes(mgs_n2(cfg, stage), 2 * cfg.num_sources))


def kernel_routes(cfg, *, return_spectra: bool = True) -> dict:
    """{stage: (kernel, whether it takes the config's shapes)} of a
    single-card pipeline of `cfg`, each stage only where the config's
    route runs it:

    * "covariance": K1 "chunk_gram" (fused route), kernel 8
      "planes_chunk_gram" (planes route), kernel 4 "wideband_fft_gram"
      (power-of-two subbands) or "subband_embedded_frames" (any other
      subband count: the ring kernel on the frames, whose plain version
      is the reference's channelizer + kernel 7);
    * "covariance_planes": kernel 8 for planes input on the fused route
      (the interleaved entry does not run it);
    * "coarse_subspace": K4 "mgs_iterate" in cssm_auto's coarse pass;
    * "subspace": K4, or kernel 11 "subspace_ns" (fused route,
      subspace_impl="pallas"), for the power subspace's estimators
      (runs_power_subspace: MUSIC, root-MUSIC on a ULA, min-norm); K4 for
      incoherent wideband on the power subspaces;
    * "scan": K2 "music_scan_peaks" (the fused-peaks rule; under the
      hierarchical rule the coarse scan, which keeps no spectrum) or K3
      "music_scan", where MUSIC runs the scan kernels;
    * "fusion": kernel 5 "wideband_fusion" (incoherent wideband where
      ops/wideband.fusion_kernel_applies, the reference's rule: the power
      subspaces at compute_dtype "float32"; its other incoherent scans
      are XLA, and so torch ops here);
    * "peaks": kernel 6 "peaks2d" on a 2-D grid (k ≤ MAX_PEAKS2D_K).

    TOPS ("tops") plans "covariance" and, on a 2-D grid, "peaks" only: its
    subspaces, products and λ_min are torch ops, as they are XLA in the
    reference. Incoherent fusion and TOPS run no narrowband estimator
    (the reference returns the fused key alone whatever cfg.estimators
    says)."""
    cfg = as_config(cfg)
    N, K = cfg.geometry.num_elements, cfg.num_sources
    n2, k2 = subspace_n2(cfg), 2 * K
    routes = {}
    wb = cfg.wideband
    incoherent = wb.enabled and wb.fusion == "incoherent"
    fused_key = wb.enabled and wb.fusion in ("incoherent", "tops")
    if wb.enabled:
        routes["covariance"] = _wideband_covariance_route(cfg)
        if incoherent and cfg.subspace_method == "power":
            routes["subspace"] = _k4_route(cfg, "subspace")
            if fusion_kernel_applies(cfg):
                routes["fusion"] = ("wideband_fusion",
                                    fusion_takes(k2, 2 * N))
        elif wb.fusion == "cssm_auto":
            routes["coarse_subspace"] = _k4_route(cfg, "coarse_subspace")
    elif fused_route(cfg):
        routes["covariance"] = ("chunk_gram", gram_takes(2 * N))
        routes["covariance_planes"] = ("planes_chunk_gram", planes_takes(N))
    else:
        routes["covariance"] = ("planes_chunk_gram", planes_takes(N))
    if not fused_key and runs_power_subspace(cfg):
        if fused_route(cfg) and cfg.subspace_impl == "pallas":
            routes["subspace"] = ("subspace_ns", ns_takes(n2, k2))
        else:
            routes["subspace"] = _k4_route(cfg, "subspace")
        if scans_music_kernel(cfg):
            routes["scan"] = (
                ("music_scan_peaks", peaks_takes(k2, n2, _grid_size(cfg)))
                if fuses_peaks(cfg, return_spectra
                               and not hierarchical_music(cfg))
                else ("music_scan", scan_takes(k2, n2)))
    if cfg.geometry.kind == "ura":
        routes["peaks"] = ("peaks2d", cfg.num_max_vals <= MAX_PEAKS2D_K)
    return routes


def sharded_fused_route(cfg: DoaConfig) -> bool:
    """The sharded narrowband fast path's rule, the reference's
    (parallel/sharded.py:306-308): the fused route's, and no beamspace."""
    return fused_route(cfg) and not cfg.beamspace.enabled


def gathers_spectrum_row(cfg: DoaConfig, n_grid: int) -> bool:
    """Whether a grid-sharded 2-D scan gathers the whole spectrum row for
    its peaks (the reference's rule, parallel/sharded.py:290-291): a URA
    whose az rows do not fall whole on the n_grid ranks; else the O(k)
    merge runs."""
    return (cfg.geometry.kind == "ura"
            and (_grid_size(cfg) // n_grid) % cfg.grid2d.num_el != 0)


def _music_scan_route(cfg, n_grid: int, return_spectra: bool, k2: int,
                      n2: int):
    return (("music_scan_peaks", peaks_takes(k2, n2, _grid_size(cfg)))
            if n_grid == 1 and fuses_peaks(cfg, return_spectra)
            else ("music_scan", scan_takes(k2, n2)))


def sharded_kernel_routes(cfg, n_snap: int, n_grid: int,
                          return_spectra: bool = True) -> dict:
    """kernel_routes of a sharded pipeline of `cfg` on an (n_snap, n_grid)
    mesh, per rank.

    Narrowband: "halo" (kernel 13 "halo_ring" under halo_impl="pallas"
    with a halo to exchange), "covariance" (K1 on the fast path,
    sharded_fused_route; kernel 8 on the general path), "subspace" (K4:
    on the fast path, and on the general path where the power subspace
    runs, runs_power_subspace), "scan" for MUSIC on the fast path (K2
    under the fused-peaks rule on an unsharded grid, else K3).

    Wideband (the EP layout): "covariance" as on one card (kernel 4 on
    each rank's block, "wideband_fft_gram" for a power-of-two F, else the
    ring kernel's frames source "subband_embedded_frames"); incoherent
    fusion on the power subspaces: "subspace" (K4) and, where
    fusion_kernel_applies, "fusion" (kernel 5 on the rank's subbands);
    "cssm" / "cssm_auto": "coarse_subspace" (K4, cssm_auto's coarse
    pass), and on the power subspace of R_coh "subspace" (K4) and "scan"
    (K3, or K2 as above, where scans_music_kernel); TOPS: the front end
    alone.

    "peaks": kernel 6 on a 2-D grid wherever a rank peaks a whole
    spectrum row: incoherent fusion and TOPS (P is whole on every rank),
    and the gathered row of a grid-sharded scan (gathers_spectrum_row)."""
    cfg = as_config(cfg)
    N, K = cfg.geometry.num_elements, cfg.num_sources
    n2, k2 = subspace_n2(cfg), 2 * K
    power = cfg.subspace_method == "power"
    wb = cfg.wideband
    whole_row = gathers_spectrum_row(cfg, n_grid)
    routes = {}
    if wb.enabled:
        routes["covariance"] = _wideband_covariance_route(cfg)
        if wb.fusion == "incoherent" and power:
            routes["subspace"] = _k4_route(cfg, "subspace")
            if fusion_kernel_applies(cfg):
                routes["fusion"] = ("wideband_fusion",
                                    fusion_takes(k2, 2 * N))
        elif wb.fusion in ("cssm", "cssm_auto"):
            if wb.fusion == "cssm_auto":
                routes["coarse_subspace"] = _k4_route(cfg, "coarse_subspace")
            if power:
                routes["subspace"] = _k4_route(cfg, "subspace")
                if scans_music_kernel(cfg):
                    routes["scan"] = _music_scan_route(
                        cfg, n_grid, return_spectra, k2, n2)
        whole_row = whole_row or wb.fusion in ("incoherent", "tops")
    else:
        fast = sharded_fused_route(cfg)
        if cfg.halo_impl == "pallas" and cfg.overlap > 0 and n_snap > 1:
            routes["halo"] = ("halo_ring", True)
        routes["covariance"] = (("chunk_gram", gram_takes(2 * N)) if fast
                                else ("planes_chunk_gram", planes_takes(N)))
        if fast or runs_power_subspace(cfg):
            # the fast path runs its subspace (and escalation counts) always
            routes["subspace"] = _k4_route(cfg, "subspace")
        if Estimator.MUSIC in cfg.estimators and fast:
            routes["scan"] = _music_scan_route(cfg, n_grid, return_spectra,
                                               k2, n2)
    if cfg.geometry.kind == "ura" and whole_row:
        routes["peaks"] = ("peaks2d", cfg.num_max_vals <= MAX_PEAKS2D_K)
    return routes


def kernel_forms(cfg, routes: dict) -> dict:
    """{stage: form} for the stages of `routes` whose kernel has named
    forms:

    * K1 ("chunk_gram"), the epilogue its wrapper launches
      (chunk_grams_uhat.by_epilogue) when cov_embedded asks it for the
      windows' E, as cov_embedded.gram_epilogue says of cov_dtype, 2N and
      the windows' chunks: "embedded" where a window is one chunk
      (overlap 0), "windows" where windows overlap and kernel 9's window
      entry takes the shapes, else "gram";
    * kernel 8 ("planes_chunk_gram"), in the form it takes on the two
      views of an interleaved complex64 capture (covariance.chunk_form of
      the "interleaved" layout): the planes a pipeline makes of its
      complex capture, and planes input passed as such views. Planes of
      another layout take that layout's form; chunk_grams.by_form counts
      the form of each launch;
    * kernel 11 ("subspace_ns"): subspace_ns.ns_form of the config's
      (2N, 2K), the form its wrapper launches (subspace_ns.by_form);
    * kernel 6 ("peaks2d"): peaks2d.peaks_form of the config's az/el
      grid, the form its wrapper launches (peaks2d.by_form);
    * K4 ("mgs_iterate"): cpx_ops.mgs_form of the stage's (2N, 2K)
      (mgs_n2), the form its wrapper launches (mgs_iterate.by_form)."""
    cfg = as_config(cfg)
    k2 = 2 * cfg.num_sources
    N = cfg.geometry.num_elements
    g = math.gcd(cfg.snapshot_size, cfg.hop)
    forms = {"chunk_gram": gram_epilogue(cfg.cov_dtype, 2 * N,
                                         cfg.snapshot_size // g,
                                         cfg.hop // g),
             "planes_chunk_gram": chunk_form(N, "interleaved"),
             "subspace_ns": ns_form(subspace_n2(cfg), k2)}
    if cfg.geometry.kind == "ura":
        forms["peaks2d"] = peaks_form(cfg.grid2d.num_az, cfg.grid2d.num_el)
    return {stage: (mgs_form(mgs_n2(cfg, stage), k2)
                    if kernel == "mgs_iterate" else forms[kernel])
            for stage, (kernel, _) in routes.items()
            if kernel in forms or kernel == "mgs_iterate"}


def kernel_plan(cfg, *, return_spectra: bool = True) -> dict:
    """The kernels a single-card pipeline of `cfg` launches on the card:
    {stage: the kernel's name, or "plain"} (kernel_routes' stages). A
    pure function of the config. Every preset plans a kernel for every
    stage; the plain versions take what the kernels do not: a ULA of
    N > 32 (K1), K ≥ 5 (K4), a wideband array of N > 64 (the ring
    kernel; 2N > 128 for K4)."""
    return dict(Plan(kernel_routes(cfg, return_spectra=return_spectra)))


def sharded_kernel_plan(cfg, n_snap: int, n_grid: int,
                        return_spectra: bool = True) -> dict:
    """kernel_plan of a sharded pipeline (sharded_kernel_routes)."""
    return dict(Plan(sharded_kernel_routes(cfg, n_snap, n_grid,
                                           return_spectra)))


def track_plan(max_tracks: int, K: int, on_card: bool = True) -> Plan:
    """The tracker's plan (tracking.track_batch): {"track": "track"}, the
    scan kernel, where track_takes(max_tracks, K) (a slot and a detection
    a lane of one warp) and the detections are on the card; else
    {"track": "plain"}, tracking.track_batch_plain."""
    return Plan({"track": ("track", track_takes(max_tracks, K))},
                on_card=on_card)
