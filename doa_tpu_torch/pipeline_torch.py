"""The DoA pipelines on torch tensors (port of the narrowband fused and
planes branches and the wideband incoherent, coherent and TOPS branches
of doa_tpu/pipeline_tpu.py::build_pipeline_tpu).

Narrowband, fused path (no smoothing, subspace_method="power",
TPACK | gcd(S, hop): plan.fused_route, the reference's route rule):
    capture x[T, 2N] (the bytes of a complex64 (T, N) buffer)
      → K1 chunk Grams → windows E(R) f32[B, 2N, 2N]   ops/cuda/cov_embedded
        (overlap 0: each window's E from kernel 9's epilogue, no windows)
      → warm-start MGS subspace (K4) Vt f32[B, 2K, 2N] ops/cpx_ops
        or, under subspace_impl="pallas", the cold Newton–Schulz
        subspace (kernel 11)                           ops/cuda/subspace_ns
      → under subspace_check, the guard (residual, capture gap, eigh for
        flagged windows)                               ops/cpx_ops
      → K2 scan + peaks (return_spectra=False, 1-D)     ops/cuda/music_scan
        or K3 scan → normalise → find_local_max          ops/peaks
           (2-D grids: the 2-D peaks kernel)            ops/cuda/peaks2d
      Capon / Bartlett, and the grid-free estimators (root-MUSIC on the
      power subspace's noise projector, ESPRIT, Unitary ESPRIT), on
      R = unembed(E); min-norm on the power subspace   ops/{root_music,
                                                   esprit,min_norm}

Narrowband, planes path (smoothing, subspace_method="eigh", a hop outside
the route rule, or planes input on either path):
    planes xr, xi f32[T, N] (separate, or strided views of a complex64
    capture: call.interleaved reads its x[T, 2N] so, in place)
      → kernel 8 chunk Grams → windows (Rr, Ri) f32[B, N, N]   (doa.gram)
                                                   ops/cuda/covariance
      → correction (c cᴴ) ∘ R → FB → spatial smoothing  ops/cpx_ops
                                                        (doa.smoothing)
      → cold MGS subspace of E(R) (K4; the guard under subspace_check)
        → K3 / K2 scan, or the eigh (or Jacobi: ops/jacobi) noise
        projector and its dense MUSIC and min-norm denominators; Capon,
        Bartlett; root-MUSIC, ESPRIT, Unitary ESPRIT
      (on a fused config, planes input embeds E(R) and joins the fused
      path downstream)

Wideband (c5; planes input is stacked once into the interleaved layout):
    capture x[T, 2N]
      → front end → E_sub f32[F, B, 2N, 2N]         ops/cuda/wideband_cov
        (the ring kernel's in-kernel DFT and subband Grams, kernel 4, at
        any F on the card; the CPU, at F not a power of two, the
        reference's dense channelizer matmul + kernel 7's plain version)
    incoherent fusion:
      → per-subband warm-start MGS subspaces (K4) Vt f32[F, B, 2K, 2N]
                                                   ops/wideband
      → fused subband scan + fusion → P f32[B, G]  ops/cuda/wideband_scan
        (ops/wideband.wideband_music_cpx chooses: compute_dtype bfloat16 /
        int8, the reference's quantized subband scan as torch ops;
        subspace_method eigh / jacobi, the eigh noise projectors and their
        scan, no K4; no kernel 5 in either)        ops/wideband
      → 2-D peaks (az/el grids) or find_local_max  ops/cuda/peaks2d
    TOPS ("tops"):
      → unembed → R_sub c64[F, B, N, N] → complex signal subspaces
        (signal_subspace_cpx) → leakage row, Σ_f CᴴC and the guard,
        λ_min → P f32[B, G]                        ops/tops
      → 2-D peaks (az/el grids) or find_local_max  ops/cuda/peaks2d
    coherent fusion ("cssm": static focusing; "cssm_auto": focusing at the
    peaks of a coarse incoherent spectrum of the capture-mean subband
    covariances, cold K4 on F matrices):
      → R_coh = mean_f T_f R_f T_fᴴ c64[B, N, N]    ops/wideband
      → FB → smoothing → the narrowband estimators (cold K4 + K3/K2,
        eigh, Jacobi, Capon, Bartlett, min-norm, the grid-free ones; 2-D
        ESPRIT on a URA) as on the planes path

Beamspace (cfg.beamspace, a ULA): after the covariance stage (K1 or
kernel 8 at the array's 2N) E and, where an estimator needs it, R are
projected onto Nb DFT beams (ops/beamspace); the steering is the
unit-norm beamspace steering, and the subspace and scans run at 2·Nb.

Hierarchical (scan_mode="hierarchical"): MUSIC on the power subspace and
Capon take the coarse → refine scans of ops/hierarchical (the coarse
scan on the plan's route: K2 with the refine off on a 1-D grid, else K3
and the peak rule or kernel 6), incoherent wideband MUSIC the fused-
metric refine of ops/wideband on kernel 5's coarse spectrum and dmin;
none returns a spectrum.

call.scan_capture runs a capture staged as M blocks through the fused or
wideband path, block by block with the continuous-framing carry.

Every product carrying a value runs in true FP32 (cpx.fp32_matmuls). On a
CUDA device every kernel launch either runs or raises; nothing falls back
to the CPU or to a plain version.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from doa_tpu_torch.configs import AvgMethod, DoaConfig, Estimator, as_config
from doa_tpu_torch.cpx import (checked_device, embed_planes, fp32_matmuls,
                               unembed_planes)
from doa_tpu_torch.io.native import quantize_interleaved_int8
from doa_tpu_torch.ops import cpx_ops
from doa_tpu_torch.ops.cpx_ops import signal_subspace_from_E_T
from doa_tpu_torch.ops.cuda.cov_embedded import cov_embedded
from doa_tpu_torch.ops.cuda.music_scan import peaks_tiles, scan_tiles
from doa_tpu_torch.ops.cuda.wideband_cov import wideband_cov_embedded
from doa_tpu_torch.ops.beamspace import (beamspace_covariance,
                                         beamspace_embedded,
                                         beamspace_steering, dft_beam_matrix)
from doa_tpu_torch.ops.esprit import (esprit_2d_cpx, esprit_cpx,
                                      unitary_esprit_cpx)
from doa_tpu_torch.ops.hierarchical import (capon_hierarchical_ula,
                                            capon_hierarchical_ura,
                                            music_hierarchical_ula,
                                            music_hierarchical_ura)
from doa_tpu_torch.ops.jacobi import subspace_projector_jacobi
from doa_tpu_torch.ops.min_norm import (min_norm_denominator_cpx,
                                        min_norm_denominator_subspace)
from doa_tpu_torch.ops.peaks import find_local_max
from doa_tpu_torch.ops.root_music import root_music_cpx
from doa_tpu_torch.ops.tops import wideband_tops_cpx
from doa_tpu_torch.ops.wideband import (auto_focused_covariance,
                                        cssm_covariance, focusing_matrices,
                                        steering_planes, wideband_music_cpx,
                                        wideband_music_hierarchical,
                                        wideband_steering_stack)
from doa_tpu_torch.plan import (Plan, fused_route, kernel_forms,  # noqa: F401
                                hierarchical_music, kernel_plan,
                                kernel_routes)
from doa_tpu_torch.pipeline import DoaResult, _steering_fn, _steering_matrix
from doa_tpu_torch.utils.profiling import span


def _check_slice(cfg: DoaConfig) -> None:
    """Raise for a config the single-card builder does not run: ValueError
    where the reference's own call fails, NotImplementedError, naming the
    ROADMAP.md entry, for what is not ported."""
    wb = cfg.wideband
    if wb.enabled:
        if cfg.snapshot_size % wb.num_subbands:
            raise ValueError(f"snapshot_size ({cfg.snapshot_size}) must be "
                             f"divisible by num_subbands ({wb.num_subbands})")
        if (wb.fusion != "cssm" and cfg.smoothing.enabled
                and cfg.geometry.kind == "ula"):
            # the reference builds the steering of the L-element subarray
            # and scans it against the N-element subband covariances,
            # which fails in its einsum (a ValueError on the call); only
            # "cssm" smooths R_coh, after the focusing, before its scan
            raise ValueError(
                f"fusion={wb.fusion!r} with spatial smoothing on a ULA: "
                f"the steering is the {cfg.smoothing.subarray_size}-element "
                f"subarray's, the subband covariances are "
                f"{cfg.geometry.num_elements}-element (only 'cssm' smooths, "
                "after focusing)")
    elif cfg.cov_dtype == "int8" and not fused_route(cfg):
        raise NotImplementedError(
            "doa_tpu_torch runs every single-card path of the reference "
            "but cov_dtype='int8' on the planes path (the reference "
            "truncates unscaled planes there; ROADMAP.md §C.3) — see "
            "ROADMAP.md")


# what scan_capture keeps of each block's DoaResult, as the reference's
# (pipeline_tpu.py:652-655): the peaks and the grid-free angles
_CAPTURE_KEYS = ("peak_values", "peak_angles", "root_music_angles",
                 "esprit_angles", "unitary_esprit_angles")


def _correction_planes(correction, N, device: torch.device):
    """→ (cr, ci) f32[N] on the device; N None takes the correction's own
    length."""
    if correction is None:
        c = np.ones((N,), np.complex64)
    else:
        c = np.asarray(correction).astype(np.complex64).reshape(
            -1 if N is None else N)
    return (torch.from_numpy(np.ascontiguousarray(c.real)).to(device),
            torch.from_numpy(np.ascontiguousarray(c.imag)).to(device))


def load_state(A_re, A_im, correction=None, *, device="cuda",
               subband_planes=None, focusing=None, beams=None) -> dict:
    """The pipeline's state — steering planes A_re, A_im f32[G, N_eff]
    (under beamspace the unit-norm beamspace steering f32[G, Nb]), the
    calibration correction c64[N] (None = no correction), under beamspace
    the beam matrix beams = complex64 (N, Nb) (doa_tpu's
    ``dft_beam_matrix``; None = build it from the config) and, for a
    wideband config, the per-subband steering planes
    subband_planes = (re, im) f32[F, G, N] (doa_tpu's
    ``call.wb_ilv_args[1:]``; incoherent, cssm_auto and tops) or the focusing
    matrices focusing = (re, im) f32[F, N, N] (doa_tpu's
    ``focusing_matrices(cfg)``; cssm), None = build them from the config,
    all numpy — as device tensors, for build_pipeline_torch(state=...)."""
    dev = checked_device(device)
    A_re = np.array(A_re, dtype=np.float32)
    A_im = np.array(A_im, dtype=np.float32)
    if A_re.ndim != 2 or A_re.shape != A_im.shape:
        raise ValueError(f"need A_re, A_im f32[G, N] of one shape, got "
                         f"{A_re.shape} and {A_im.shape}")
    state = {"A_re": torch.from_numpy(A_re).to(dev),
             "A_im": torch.from_numpy(A_im).to(dev)}
    if correction is not None:
        # the array's size: the steering's under smoothing is the subarray's
        state["cr"], state["ci"] = _correction_planes(correction, None,
                                                      dev)
    if subband_planes is not None:
        Xr, Xi = (np.array(p, dtype=np.float32) for p in subband_planes)
        if Xr.ndim != 3 or Xr.shape != Xi.shape or Xr.shape[1:] != A_re.shape:
            raise ValueError(f"need subband planes f32[F, G, N] of one shape "
                             f"with (G, N) = {A_re.shape}, got {Xr.shape} and "
                             f"{Xi.shape}")
        state["As_re"] = torch.from_numpy(Xr).to(dev)
        state["As_im"] = torch.from_numpy(Xi).to(dev)
    if focusing is not None:
        Tr, Ti = (np.array(p, dtype=np.float32) for p in focusing)
        if (Tr.ndim != 3 or Tr.shape != Ti.shape
                or Tr.shape[1] != Tr.shape[2]):
            raise ValueError(f"need focusing planes f32[F, N, N] of one "
                             f"shape, got {Tr.shape} and {Ti.shape}")
        state["T"] = torch.complex(torch.from_numpy(Tr),
                                   torch.from_numpy(Ti)).to(dev)
    if beams is not None:
        Bm = np.array(beams, dtype=np.complex64)
        if Bm.ndim != 2 or Bm.shape[1] != A_re.shape[1]:
            raise ValueError(f"need a beam matrix complex64 (N, Nb) with "
                             f"Nb = {A_re.shape[1]}, got {Bm.shape}")
        state["Bm"] = torch.from_numpy(Bm).to(dev)
    return state


def compute_covariances(xr: torch.Tensor, xi: torch.Tensor, cfg: DoaConfig,
                        correction=None, compute_dtype=None,
                        grams=None):
    """Covariance planes (Rr, Ri) of the sample planes xr, xi f32[T, N]
    (doa_tpu's compute_covariances_cpx): kernel 8 chunk Grams and strided
    prefix-sum windows, then, in this fixed order, the correction
    (cr, ci) folded as (c cᴴ) ∘ R, forward-backward averaging and spatial
    smoothing. compute_dtype: the Gram's input precision (default
    cfg.cov_dtype); grams: kernel 8's stage (cov_from_stream). The Grams
    and windows run under the span doa.gram, the correction, FB and
    smoothing under doa.smoothing."""
    with span("doa.gram"):
        Rr, Ri = cpx_ops.cov_from_stream(
            xr, xi, cfg.snapshot_size, cfg.overlap,
            compute_dtype=cfg.cov_dtype if compute_dtype is None
            else compute_dtype, grams=grams)
    with span("doa.smoothing"):
        if correction is not None:
            Rr, Ri = cpx_ops.apply_correction_to_cov(Rr, Ri, *correction)
        if cfg.avg_method == AvgMethod.FORWARD_BACKWARD:
            Rr, Ri = cpx_ops.forward_backward(Rr, Ri)
        if cfg.smoothing.enabled:
            Rr, Ri = cpx_ops.spatial_smooth(Rr, Ri,
                                            cfg.smoothing.subarray_size)
    return Rr, Ri


def build_pipeline_torch(cfg: DoaConfig, *, device="cuda",
                         refine_peaks: bool = True,
                         return_spectra: bool = True,
                         return_covariance: bool = False,
                         donate_inputs: bool = False,
                         state: dict | None = None):
    """→ callable(x, correction=None) → DoaResult. x is one of

    * a numpy complex (T, N) capture: complex64 enters as a zero-copy view
      (the fused path reads it interleaved through K1; the planes path
      reads its two strided planes through kernel 8), another complex
      dtype is cast to complex64 once and takes the planes route;
    * a pair (xr, xi) of f32[T, N] planes, tensors or arrays (doa_tpu's
      ``Cpx``): device tensors, strided views included, go to kernel 8 as
      they are. On a fused config the planes embed E(R) (f32 Grams, as the
      reference's XLA route) and join the fused path downstream.

    The callable also has

    * ``call.interleaved(xil, correction=None)`` (every path): the
      capture as float x[T, 2N] or doa_tpu's (T/TPACK, 2N·TPACK) (same
      bytes), numpy or torch; under cov_dtype="int8" a float buffer is
      quantized on the device (narrowband), an int8 buffer passes as it
      is. On the planes path (smoothing, eigh, Jacobi, ...) the float32
      capture on the device is read as its two stride-2 planes
      x.view(-1, N, 2)[..., 0] and [..., 1], with no copy, as call(x)
      reads a complex64 numpy capture, and the answers are call(x)'s.
      ``call.interleaved.route`` names the route, fixed when the
      pipeline is built: "fused", "wideband" or "planes";
    * ``call.scan_capture(blocks, correction=None)`` (fused and wideband
      paths): a capture staged as M blocks, (M, T_blk, 2N) or doa_tpu's
      (M, T_blk/TPACK, 2N·TPACK), numpy or torch, hop | T_blk (wideband:
      also F | overlap; under cov_dtype="int8" the blocks must be int8,
      as the reference's) → {"peak_values": {est: (M, B_blk, k)},
      "peak_angles": {est: (M, B_blk, k[, 2])}} and, where the config
      asks for them, the grid-free angles stacked as (M, B_blk, K[, 2])
      under "root_music_angles", "esprit_angles" and
      "unitary_esprit_angles", as the reference's. Block m is computed
      with the carry of the hop·ceil(overlap/hop) samples before it, so
      windows are framed as in one continuous stream; block 0's carry is
      zeros, and its first ``call.scan_capture.prefix_windows`` windows,
      which reach into that zero prefix, are the ones callers drop. Blocks
      in one contiguous device tensor are read in place (block 0 aside);
      the blocks run one by one (each call syncs with the host on the
      escalation check and the guard);
    * ``call.steering_planes`` (A_re, A_im), ``call.subband_planes``
      (wideband: (re, im) f32[F, G, N]; else None), ``call.fast_path``
      (True on the fused path), ``call.config``;
    * ``call.plan``: {stage: kernel name or "plain"}, kernel_plan(cfg) on
      a CUDA device, every stage "plain" on the CPU (plan.py). The
      pipeline takes each stage's route and callable from it: a stage
      runs its plain torch version on the card only where the plan says
      so, and a kernel wrapper given a shape its kernel does not take
      still raises. ``call.plan.forms`` names the form each kernel
      with named forms launches where the plan runs it (plan.kernel_forms:
      K1's epilogue, kernel 8's on the views of a complex64 capture, K4's,
      kernel 11's, K2's, kernel 6's on a 2-D grid).

    `state` (load_state) replaces the steering built from cfg and gives
    the default correction. donate_inputs=True is the caller's promise
    that the capture tensor may be consumed (doa_tpu lets XLA reuse the
    capture's buffer under it); the port reuses no input buffer, so the
    results are those with False. Peak angles are (B, k) on a 1-D grid and
    (B, k, 2) az/el on a 2-D one.

    Narrowband MUSIC: with the power subspace, K3 scans the spectrum
    (scan_mode "pallas", which "auto" picks on the fused path, or
    compute_dtype float32); return_spectra=False fuses normalise + peaks
    into the scan kernel (K2) when the grid is 1-D, k ≤ 4 and G ≤ 8192,
    an explicit size rule; a dense scan in bfloat16/int8 runs the
    reference's quantized forms as torch ops. subspace_method="eigh" or
    "jacobi" scans that noise projector (the reference's; one a call,
    shared by MUSIC and min-norm). Capon (Cholesky) and Bartlett scan R.
    Min-norm scans the power subspace's weight (or the projector's).
    Under beamspace the state's steering is the unit-norm beamspace
    steering f32[G, Nb] (its ‖a‖² ≈ 1, the nrm K2 and K3 take), E (fused)
    and R (where Capon, Bartlett or return_covariance reads it; the
    returned covariance is R_b) are projected after the covariance, and
    the subspace and scans run at 2·Nb. The reference resolves
    scan_mode "auto" to a dense scan under beamspace; the port keeps K2 /
    K3 there, whose peaks are held bit-equal to normalise +
    find_local_max, so the angles are the dense scan's.
    scan_mode="hierarchical" (as the reference, pipeline_tpu.py:317, 409):
    MUSIC on the power subspace (under eigh or Jacobi it stays dense) and
    Capon (whatever the subspace method) return the coarse scan's
    max-normalised peak values and angles refined on micro-grids
    (ops/hierarchical), and no spectrum whatever return_spectra says;
    refine_peaks does not apply to them. The coarse MUSIC scan is K2 with
    the refine off on a 1-D grid (the plan picks it with spectra too),
    else K3 and the peak rule (kernel 6 on a 2-D grid).
    The grid-free estimators fill DoaResult.root_music_angles (a ULA; on
    the power subspace's noise projector, else eigh's, as the
    reference), esprit_angles (f32[B, K] on a ULA, az/el pairs
    f32[B, K, 2] on a URA) and unitary_esprit_angles (a ULA), each
    window's angles sorted; they run on R, which the fused path then
    unembeds from E.
    subspace_impl="pallas" replaces the fused path's warm MGS by kernel
    11's cold Newton–Schulz subspace (power_iters, power_squarings; the
    escalation counts are then zeros); the planes route keeps its cold
    MGS. subspace_check=True guards the subspace on either route (E, or
    E(R) of the planes) and returns the residual in
    DoaResult.subspace_residual.

    Wideband (cfg.wideband.enabled; S divisible by num_subbands): the
    front end (on the card one launch of the ring kernel on the frames,
    its DFT in the kernel, at any num_subbands; the plain route, at
    num_subbands not a power of two, the reference's dense channelizer +
    kernel 7's plain version), then one of the four fusion modes.
    Incoherent fusion ("incoherent") and TOPS ("tops") return their fused
    key alone, "music" or "tops", whatever cfg.estimators lists, and no
    escalation counts, as the reference; forward-backward averaging does
    not apply there.
    * "incoherent": the per-subband subspaces, the fused subband scan and
      the peaks; the fused spectrum is returned whatever return_spectra
      says, as in the reference (but under scan_mode="hierarchical" on
      the power subspaces: the coarse spectrum and each subband's
      minimum, and ops/wideband.wideband_music_hierarchical refines the
      coarse peaks on the fused metric; no spectrum). At compute_dtype
      "float32" on the power subspaces kernel 5 scans (with dmin in the
      same launch under hierarchical); at "bfloat16" or "int8" the
      reference's quantized scan as torch ops (hierarchical: its coarse
      spectrum, each minimum from the FP32 den); under subspace_method
      "eigh" or "jacobi" the eigh noise projector of each window
      (Jacobi's route takes eigh's, as the reference) and its scan at
      compute_dtype, with no K4. ops/wideband.wideband_music_cpx makes
      the choice.
    * "tops": ops/tops.wideband_tops_cpx on E_sub (the complex signal
      subspaces of the unembedded subband covariances, then the TOPS
      spectrum on the config's reference band and guard);
      return_spectra=False drops its spectrum.
    * "cssm" / "cssm_auto": R_coh, then FB, smoothing and the narrowband
      estimators on the planes path's route, escalation counts included
      (a quantized compute_dtype takes the dense quantized MUSIC scan;
      cssm_auto's coarse pass stays FP32, as the reference's).
    Spatial smoothing on a ULA raises ValueError under every mode but
    "cssm": the reference scans the subarray's steering against the full
    array's subband covariances there and fails. cov_dtype does not apply
    to the wideband path, as in the reference. The reference's
    wb_fusion_impl and peaks_impl switches choose between its TPU kernels
    and XLA; here every stage the plan gives a kernel runs it, and the
    stages the reference runs as XLA (TOPS, the quantized and projector
    scans) run as torch ops, not kernel 5.

    `cfg` may be a doa_tpu_torch or a doa_tpu DoaConfig; call.config is
    the port's own (as_config(cfg))."""
    dev = checked_device(device)
    cfg = as_config(cfg)
    _check_slice(cfg)
    routes = kernel_routes(cfg, return_spectra=return_spectra)
    plan = Plan(routes, on_card=dev.type == "cuda",
                forms=kernel_forms(cfg, routes))
    route = plan.kernels
    N = cfg.geometry.num_elements
    K = cfg.num_sources
    k = cfg.num_max_vals
    wb = cfg.wideband.enabled
    fused = route["covariance"] == "chunk_gram"
    g2 = cfg.grid2d if cfg.geometry.kind == "ura" else None
    A_host, x_rng = _steering_matrix(cfg)
    bs = cfg.beamspace.enabled
    Bm_host = None
    if bs:
        Bm_host = dft_beam_matrix(N, cfg.beamspace.num_beams,
                                  cfg.beamspace.center_deg,
                                  cfg.geometry.norm_spacing)
        A_host = beamspace_steering(A_host, Bm_host)           # (G, Nb)
    if state is None:
        state = load_state(A_host.real, A_host.imag, device=dev,
                           beams=Bm_host)
    elif tuple(state["A_re"].shape) != A_host.shape:
        raise ValueError(f"state steering {tuple(state['A_re'].shape)} does "
                         f"not match the config's grid {A_host.shape}")
    if bs:
        Bm = state["Bm"] if "Bm" in state else torch.from_numpy(Bm_host)
        if tuple(Bm.shape) != Bm_host.shape:
            raise ValueError(f"state beam matrix {tuple(Bm.shape)} does not "
                             f"match {Bm_host.shape}")
        Bm = Bm.to(dev)
        Bt = embed_planes(Bm.real, Bm.imag).contiguous()      # (2N, 2Nb)
    no_correction = _correction_planes(None, N, dev)
    A_re = state["A_re"].to(dev)
    A_im = state["A_im"].to(dev)
    At_emb = torch.cat([A_re, A_im], dim=-1).contiguous()      # (G, 2N)
    nrm = (At_emb * At_emb).sum(dim=-1)
    scan = plan.op("scan") if "scan" in plan else None
    if plan.get("scan") == "music_scan":
        # K3's A' of the grid, made once (scan_tc's layout)
        scan = functools.partial(scan, tiles=scan_tiles(At_emb, 2 * K))
    elif plan.get("scan") == "music_scan_peaks":
        # K2's grid operand (A', or Aᵀ for its CUDA-core form), made once
        scan = functools.partial(scan, tiles=peaks_tiles(At_emb, 2 * K))
    ests = cfg.estimators
    ula = cfg.geometry.kind == "ula"
    want_root = Estimator.ROOT_MUSIC in ests and ula
    want_unitary = Estimator.UNITARY_ESPRIT in ests and ula
    need_R = (Estimator.CAPON in ests or Estimator.BARTLETT in ests
              or Estimator.ESPRIT in ests or want_root or want_unitary
              or return_covariance)
    fb = cfg.avg_method == AvgMethod.FORWARD_BACKWARD
    esc = cfg.escalate_kwargs
    # scan_mode="hierarchical": Capon's coarse → refine scan whatever the
    # subspace method, MUSIC's on the power subspace only (plan.py)
    hier = cfg.scan_mode == "hierarchical"
    hier_music = hierarchical_music(cfg)
    subband_planes = None
    if wb:
        F = cfg.wideband.num_subbands
        fusion = cfg.wideband.fusion
        variant = {"wideband_fft_gram": "fft",
                   "subband_embedded_frames": "embedded"}[route["covariance"]]
    if wb and fusion == "cssm":
        T_foc = state.get("T")
        if T_foc is None:
            T_foc = torch.from_numpy(focusing_matrices(cfg)).to(dev)
        elif tuple(T_foc.shape) != (F, N, N):
            raise ValueError(f"state focusing {tuple(T_foc.shape)} does not "
                             f"match ({F}, {N}, {N})")
        T_foc = T_foc.to(dev)
    elif wb:
        if "As_re" in state:
            Xr, Xi = state["As_re"].to(dev), state["As_im"].to(dev)
            if tuple(Xr.shape) != (F,) + A_host.shape:
                raise ValueError(f"state subband steering {tuple(Xr.shape)} "
                                 f"does not match ({F},) + {A_host.shape}")
        else:
            X = wideband_steering_stack(cfg, _steering_fn(cfg))
            Xr, Xi = (torch.from_numpy(np.ascontiguousarray(
                p.astype(np.float32))).to(dev) for p in (X.real, X.imag))
        subband_planes = (Xr, Xi)
        wb_planes = steering_planes(Xr, Xi)
        As_emb = wb_planes[2]                                  # (F, G, 2N)
        if fusion == "tops":
            A_stack = torch.complex(Xr, Xi)                    # (F, G, N)
    # incoherent fusion's coarse → refine scan (on the power subspaces
    # only, as the reference; under eigh or Jacobi it stays dense)
    wb_hier = wb and hier and cfg.subspace_method == "power"

    def _peaks(P, refine=refine_peaks):
        """(values, angles): 1-D → angles (B, k); 2-D → (B, k, 2) az/el
        through the 2-D peaks kernel (k ≤ 4; the plain rule beyond)."""
        with span("doa.peaks"):
            if g2 is None:
                return find_local_max(P, k, x_rng[0], x_rng[1],
                                      refine=refine)
            P2 = P.reshape(P.shape[0], g2.num_az, g2.num_el)
            az_rng = (g2.az_lo_deg, g2.az_hi_deg)
            el_rng = (g2.el_lo_deg, g2.el_hi_deg)
            v, az, el = plan.op("peaks")(P2, k, az_rng, el_rng,
                                         refine=refine)
            return v, torch.stack([az, el], dim=-1)

    def _subspace(E):
        """Fused path → (Vt, (flagged, overflow)): kernel 11 cold under
        subspace_impl="pallas" (no warm start and zero counts, as the
        reference); else warm start from the capture-mean subspace when
        the batch has ≥ 32 windows (as the reference)."""
        if route["subspace"] == "subspace_ns":
            zero = torch.zeros((), dtype=torch.int32, device=dev)
            return plan.op("subspace")(
                E, K, iters=cfg.power_iters,
                squarings=cfg.power_squarings), (zero, zero)
        it = plan.op("subspace")
        if cfg.subspace_warm_start and E.shape[0] >= 32:
            Vt_bar = signal_subspace_from_E_T(
                E.mean(dim=0, keepdim=True), K,
                iters=max(cfg.power_iters, 8), iterate=it, **esc)
            return signal_subspace_from_E_T(
                E, K, iters=cfg.power_iters_warm, init=Vt_bar,
                return_stats=True, iterate=it, **esc)
        return signal_subspace_from_E_T(
            E, K, iters=cfg.power_iters, squarings=cfg.power_squarings,
            return_stats=True, iterate=it,
            **(esc if cfg.power_squarings == 0 else {}))

    def _noise_projector(R):
        """The complex noise projector's planes of the eigh and Jacobi
        routes (the reference's _noise_M): Jacobi's projector onto the
        2(N − K) smallest eigenvectors of E(R), or eigh's."""
        if cfg.subspace_method == "jacobi":
            n_noise = 2 * (R[0].shape[-1] - K)
            return unembed_planes(subspace_projector_jacobi(
                embed_planes(*R), n_noise))
        return cpx_ops.noise_projector(*R, K)

    def _music(Vt, M, refine=refine_peaks):
        """→ (P or None, (values, angles) or None); M the noise projector
        of the eigh and Jacobi routes."""
        if route.get("scan") == "music_scan_peaks":
            return None, scan(Vt, At_emb, k, x_rng[0], x_rng[1],
                              refine=refine, nrm=nrm)
        if scan is not None:
            P = scan(Vt, At_emb, nrm)
            return P / P.max(dim=-1, keepdim=True).values, None
        if "subspace" in route:
            den = cpx_ops.music_denominator_subspace(
                Vt.transpose(-1, -2), At_emb, cfg.compute_dtype)
        else:
            den = cpx_ops.music_denominator_cpx(*M, A_re, A_im,
                                                cfg.compute_dtype)
        return cpx_ops.spectrum_from_den(den), None

    def _coarse_music(Vt):
        """The hierarchical MUSIC's coarse scan on the plan's scan route
        (K2, or K3 / the dense scan with the peak rule, kernel 6 on a 2-D
        grid): its unrefined peaks, (values, angles) on a 1-D grid,
        (values, az, el) on a 2-D one."""
        P, peaks = _music(Vt, None, refine=False)
        v, l = _peaks(P, refine=False) if peaks is None else peaks
        return (v, l) if g2 is None else (v, l[..., 0], l[..., 1])

    def _hierarchical(est, R, Vt):
        """MUSIC (on the power subspace Vt) or Capon (on R) by the
        coarse → refine scan → (values, angles); no spectrum."""
        d = cfg.geometry.norm_spacing
        if est == Estimator.MUSIC and g2 is None:
            return music_hierarchical_ula(
                Vt, At_emb, k, d, coarse_rng=x_rng,
                compute_dtype=cfg.compute_dtype, coarse=_coarse_music)
        if est == Estimator.MUSIC:
            v, az, el = music_hierarchical_ura(
                Vt, At_emb, k, cfg.geometry.shape, d, g2,
                compute_dtype=cfg.compute_dtype, coarse=_coarse_music)
        elif g2 is None:
            return capon_hierarchical_ula(*R, At_emb, k, d,
                                          diag_load=cfg.capon_diag_load,
                                          coarse_rng=x_rng)
        else:
            v, az, el = capon_hierarchical_ura(
                *R, At_emb, k, cfg.geometry.shape, d, g2,
                diag_load=cfg.capon_diag_load, peaks2d=plan.op("peaks"))
        return v, torch.stack([az, el], dim=-1)

    def _grid_free(R, Vt):
        """The grid-free angles (root-MUSIC, ESPRIT, Unitary ESPRIT) of the
        covariance planes R, each None where the config does not ask for
        it: root-MUSIC (ULA) on the power subspace's noise projector, else
        eigh's, as the reference; ESPRIT f32[B, K] on a ULA, the az/el
        pairs f32[B, K, 2] on a URA; Unitary ESPRIT on a ULA."""
        d = cfg.geometry.norm_spacing
        root = esp = uni = None
        if want_root:
            nproj = (cpx_ops.noise_projector_from_signal(
                Vt.transpose(-1, -2)) if "subspace" in route else None)
            root = root_music_cpx(*R, K, d, noise_proj=nproj)
        if Estimator.ESPRIT in ests and ula:
            esp = esprit_cpx(*R, K, d)
        elif Estimator.ESPRIT in ests:
            esp = torch.stack(esprit_2d_cpx(*R, K, d, cfg.geometry.shape),
                              dim=-1)
        if want_unitary:
            uni = unitary_esprit_cpx(*R, K, d)
        return root, esp, uni

    def _estimate(R, E):
        """Everything downstream of the covariance: R planes (Rr, Ri) or
        None, E(R) windows (fused path) or None. Under beamspace both are
        projected onto the beams first (each where it is given), and
        every later stage runs at 2·Nb."""
        if bs:
            E = None if E is None else beamspace_embedded(E, Bt)
            R = None if R is None else beamspace_covariance(*R, Bm)
        zero = torch.zeros((), dtype=torch.int32, device=dev)
        stats = (zero, zero)
        Vt = sub_res = None
        if "subspace" in route:
            with span("doa.subspace"):
                if E is not None:
                    Vt, stats = _subspace(E)
                else:
                    V, stats = cpx_ops.signal_subspace_embedded(
                        *R, K, iters=cfg.power_iters,
                        squarings=cfg.power_squarings, return_stats=True,
                        iterate=plan.op("subspace"),
                        **(esc if cfg.power_squarings == 0 else {}))
                    Vt = V.transpose(-1, -2)
            if cfg.subspace_check:
                V, sub_res = cpx_ops.guarded_signal_subspace(
                    E if E is not None else embed_planes(*R),
                    Vt.transpose(-1, -2), K, tol=cfg.subspace_tol)
                Vt = V.transpose(-1, -2)
        spectra, pvals, pangs = {}, {}, {}
        # the eigh or Jacobi projector, once a call for MUSIC and min-norm
        M = (_noise_projector(R) if "subspace" not in route and (
            Estimator.MUSIC in ests or Estimator.MIN_NORM in ests) else None)
        for est in ests:
            peaks = None
            if (est == Estimator.MUSIC and hier_music) or (
                    est == Estimator.CAPON and hier):
                pvals[est.value], pangs[est.value] = _hierarchical(est, R,
                                                                   Vt)
                continue
            if est == Estimator.MUSIC:
                with span("doa.scan"):
                    P, peaks = _music(Vt, M)
            elif est == Estimator.MIN_NORM:
                if "subspace" in route:
                    den = min_norm_denominator_subspace(
                        Vt.transpose(-1, -2), A_re, A_im, cfg.compute_dtype)
                else:
                    den = min_norm_denominator_cpx(*M, A_re, A_im,
                                                   cfg.compute_dtype)
                P = cpx_ops.spectrum_from_den(den)
            elif est == Estimator.CAPON:
                P = cpx_ops.capon_spectrum(*R, At_emb,
                                           diag_load=cfg.capon_diag_load)
            elif est == Estimator.BARTLETT:
                P = cpx_ops.bartlett_spectrum(*R, At_emb)
            else:       # grid-free: after the scans
                continue
            if peaks is None:
                peaks = _peaks(P)
                if return_spectra:
                    spectra[est.value] = P
            pvals[est.value], pangs[est.value] = peaks
        root, esp, uni = _grid_free(R, Vt)
        return DoaResult(
            spectra=spectra, peak_values=pvals, peak_angles=pangs,
            root_music_angles=root, esprit_angles=esp,
            unitary_esprit_angles=uni,
            covariance=torch.complex(*R) if return_covariance else None,
            subspace_residual=sub_res, escalation_flagged=stats[0],
            escalation_overflow=stats[1])

    def _coherent(E_sub):
        """E_sub → the focused covariance planes after FB and smoothing."""
        R_sub = torch.complex(*unembed_planes(E_sub))
        if "coarse_subspace" in route:
            R = auto_focused_covariance(R_sub, As_emb, cfg,
                                        iterate=plan.op("coarse_subspace"))
        else:
            R = cssm_covariance(R_sub, T_foc)
        del R_sub
        Rr, Ri = R.real.contiguous(), R.imag.contiguous()
        if fb:
            Rr, Ri = cpx_ops.forward_backward(Rr, Ri)
        if cfg.smoothing.enabled:
            Rr, Ri = cpx_ops.spatial_smooth(Rr, Ri,
                                            cfg.smoothing.subarray_size)
        return Rr, Ri

    def _incoherent(E_sub):
        """E_sub → (P f32[B, G] or None, values, angles) of incoherent
        fusion (ops/wideband.wideband_music_cpx: kernel 5 where the plan
        has it, else the reference's XLA scan as torch ops); under the
        hierarchical rule the refined peaks and no spectrum."""
        ops = {s: plan.op(s) for s in ("subspace", "fusion") if s in route}
        with span("doa.wb_fusion"):
            out = wideband_music_cpx(None, None, None, cfg, E_sub=E_sub,
                                     planes=wb_planes,
                                     iterate=ops.get("subspace"),
                                     fusion=ops.get("fusion"),
                                     return_dmin=wb_hier)
        if not wb_hier:
            return (out, *_peaks(out))
        P, Vt, dmin = out
        return (None, *wideband_music_hierarchical(
            Vt, P, dmin, cfg, k, x_rng,
            peaks2d=plan.op("peaks") if g2 else None))

    def run_interleaved(x: torch.Tensor, cr: torch.Tensor, ci: torch.Tensor):
        with fp32_matmuls():
            if wb:
                with span("doa.wb_front"):
                    E_sub = wideband_cov_embedded(
                        x, cr, ci, N=N, F=F, snapshot_size=cfg.snapshot_size,
                        overlap=cfg.overlap, variant=variant,
                        kernel=plan.op("covariance"))
                if fusion in ("cssm", "cssm_auto"):
                    return _estimate(_coherent(E_sub), None)
                # the fused key alone, whatever cfg.estimators lists, and
                # no escalation counts, as the reference
                if fusion == "tops":
                    P = wideband_tops_cpx(None, A_stack, None, cfg,
                                          E_sub=E_sub)
                    del E_sub
                    v, l = _peaks(P)
                    key = "tops"
                    # the reference's wideband branch keeps P whatever
                    # return_spectra says; TOPS drops it as the flag asks
                    spectra = {key: P} if return_spectra else {}
                else:
                    P, v, l = _incoherent(E_sub)
                    key = "music"
                    spectra = {} if P is None else {key: P}
                return DoaResult(spectra=spectra, peak_values={key: v},
                                 peak_angles={key: l})
            with span("doa.covariance"):
                E = cov_embedded(x, cr, ci, N=N,
                                 snapshot_size=cfg.snapshot_size,
                                 overlap=cfg.overlap, fb=fb,
                                 compute_dtype=cfg.cov_dtype,
                                 kernel=plan.op("covariance"))
            return _estimate(unembed_planes(E) if need_R else None, E)

    def run_planes(xr: torch.Tensor, xi: torch.Tensor, cr: torch.Tensor,
                   ci: torch.Tensor):
        if wb:
            # the front end reads the interleaved layout: stack once
            return run_interleaved(torch.stack([xr, xi], dim=-1).reshape(
                -1, 2 * N), cr, ci)
        with fp32_matmuls():
            # the fused path's planes route: f32 Grams whatever cov_dtype,
            # as the reference's XLA stacked Gram
            with span("doa.covariance"):
                R = compute_covariances(
                    xr, xi, cfg, (cr, ci), "float32" if fused else None,
                    grams=plan.op("covariance_planes" if fused
                                  else "covariance"))
            if fused:
                return _estimate(R if need_R else None, embed_planes(*R))
            return _estimate(R, None)

    def _planes(correction):
        if correction is not None:
            return _correction_planes(correction, N, dev)
        if "cr" in state:
            return state["cr"].to(dev), state["ci"].to(dev)
        return no_correction

    def _ingest(x: torch.Tensor) -> torch.Tensor:
        x = x.to(dev).reshape(-1, 2 * N)
        if not wb and cfg.cov_dtype == "int8" and x.is_floating_point():
            x = quantize_interleaved_int8(x)[0]
        return x

    def _plane(p) -> torch.Tensor:
        if isinstance(p, np.ndarray):
            p = torch.from_numpy(np.asarray(p, dtype=np.float32))
        elif not isinstance(p, torch.Tensor):
            raise TypeError(f"planes must be tensors or arrays, got "
                            f"{type(p).__name__}")
        p = p.to(device=dev, dtype=torch.float32)
        if p.dim() != 2 or p.shape[1] != N:
            raise ValueError(f"need planes f32[T, {N}], got "
                             f"{tuple(p.shape)}")
        return p

    def _call_input(x):
        """call's x on the device → the planes (xr, xi), a tuple, or the
        interleaved capture x[T, 2N]."""
        if isinstance(x, (tuple, list)):
            if len(x) != 2:
                raise ValueError("planes input is a pair (xr, xi)")
            return _plane(x[0]), _plane(x[1])
        if not isinstance(x, np.ndarray):
            raise TypeError("call(x) takes a numpy complex (T, N) capture "
                            "or a pair of f32[T, N] planes; use "
                            "call.interleaved for interleaved tensors")
        if x.ndim != 2 or x.shape[1] != N or not np.iscomplexobj(x):
            raise ValueError(f"need a complex (T, {N}) capture, got "
                             f"{x.dtype} {x.shape}")
        c64 = x.dtype == np.complex64
        # zero-copy view: C-ordered c64 (T, N) is float32 (T, 2N); another
        # complex dtype is cast once
        xt = torch.from_numpy(np.ascontiguousarray(
            x, dtype=np.complex64).view(np.float32))
        if wb or (fused and c64):
            return _ingest(xt)
        xt = xt.to(dev).view(-1, N, 2)
        return xt[..., 0], xt[..., 1]

    def call(x, correction=None) -> DoaResult:
        with span("doa.call"):
            with span("doa.ingest"):
                cr, ci = _planes(correction)
                x = _call_input(x)
            if isinstance(x, tuple):
                return run_planes(*x, cr, ci)
            return run_interleaved(x, cr, ci)

    interleaved_route = "wideband" if wb else "fused" if fused else "planes"

    def call_interleaved(xil, correction=None) -> DoaResult:
        with span("doa.call"):
            with span("doa.ingest"):
                if isinstance(xil, np.ndarray):
                    xil = torch.from_numpy(np.ascontiguousarray(xil))
                cr, ci = _planes(correction)
                if interleaved_route == "planes":
                    # the capture's two stride-2 planes, read in place
                    x = xil.to(device=dev, dtype=torch.float32).reshape(
                        -1, N, 2)
                    x = x[..., 0], x[..., 1]
                else:
                    x = _ingest(xil)
            if isinstance(x, tuple):
                return run_planes(*x, cr, ci)
            return run_interleaved(x, cr, ci)

    call_interleaved.route = interleaved_route

    # windows start at global multiples of hop, so the earliest window
    # spanning a block boundary starts hop·ceil(overlap/hop) samples
    # before it: the carry (overlap itself only when hop | overlap)
    carry = cfg.hop * -(-cfg.overlap // cfg.hop)

    def scan_capture(blocks, correction=None) -> dict:
        if not (fused or wb):
            raise ValueError("scan_capture requires the fused path (power "
                             "subspace, no smoothing, TPACK | gcd(S, hop)) "
                             "or the wideband path")
        if wb and cfg.overlap % cfg.wideband.num_subbands:
            raise ValueError("wideband scan_capture needs subbands | "
                             "overlap (else the effective subband hop "
                             "misaligns with the input-domain carry)")
        xt = torch.from_numpy(np.ascontiguousarray(blocks)) if isinstance(
            blocks, np.ndarray) else blocks
        if not wb and cfg.cov_dtype == "int8" and xt.is_floating_point():
            # as the reference: one scale for the whole capture would make
            # block m differ from a per-block call, so blocks come quantized
            raise ValueError("cov_dtype='int8' scan_capture takes int8 "
                             "blocks (io.native.quantize_interleaved_int8 "
                             "per block), not a float buffer")
        M = xt.shape[0]
        with span("doa.call"):
            with span("doa.ingest"):
                x = _ingest(xt)                        # (M·T_blk, 2N)
                T_blk = x.shape[0] // M
                if T_blk % cfg.hop:
                    raise ValueError(f"scan_capture needs hop ({cfg.hop}) "
                                     f"| block samples ({T_blk})")
                cr, ci = _planes(correction)
            outs = []
            for m in range(M):
                # block m and its carry: the stream behind a zero prefix of
                # `carry` samples, a contiguous slice once m·T_blk ≥ carry
                lo = m * T_blk - carry
                xb = x[max(lo, 0):(m + 1) * T_blk]
                if lo < 0:
                    xb = torch.cat([xb.new_zeros((-lo, xb.shape[1])), xb])
                r = run_interleaved(xb, cr, ci)
                outs.append({key: getattr(r, key) for key in _CAPTURE_KEYS
                             if getattr(r, key) is not None})
            return {key: ({est: torch.stack([o[key][est] for o in outs])
                           for est in first}
                          if isinstance(first, dict)
                          else torch.stack([o[key] for o in outs]))
                    for key, first in outs[0].items()}

    # windows of block 0 that reach into the zero prefix (drop them)
    scan_capture.prefix_windows = carry // cfg.hop

    call.interleaved = call_interleaved
    call.scan_capture = scan_capture
    call.steering_planes = (A_re, A_im)
    call.subband_planes = subband_planes
    call.fast_path = fused
    call.config = cfg
    call.plan = plan
    return call
