"""Configuration system of doa_tpu_torch: a copy of doa_tpu/configs.py
(the same classes, fields, validation and PRESETS), kept here so the port
imports nothing of the JAX package.

A single tree of frozen (hashable) dataclasses: one pipeline per config.
Field comments keep the reference's wording, TPU measurements included;
they describe the reference's choices, not the port's numbers.

``as_config`` turns a config of the same shape built elsewhere (e.g. a
``doa_tpu.configs.DoaConfig``) into this module's own. The five named
presets mirror BASELINE.json `configs[0..4]`.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional, Tuple


class AvgMethod(enum.IntEnum):
    """Covariance averaging method (reference `autocorrelate` arg `avg_method`)."""

    NONE = 0
    FORWARD_BACKWARD = 1


class Estimator(str, enum.Enum):
    MUSIC = "music"
    CAPON = "capon"          # Capon-MVDR — required by BASELINE north-star.
    BARTLETT = "bartlett"    # conventional (delay-and-sum) beamformer —
    #                          the non-adaptive baseline scan; works in
    #                          beamspace and at any snapshot count
    ROOT_MUSIC = "root_music"
    ESPRIT = "esprit"        # grid-free shift-invariance (beyond reference)
    MIN_NORM = "min_norm"    # Kumaresan–Tufts (beyond reference): the
    #                          noise subspace collapsed to ONE vector —
    #                          O(B·G·N) scan + a well-separated root form
    UNITARY_ESPRIT = "unitary_esprit"  # Haardt–Nossek real-valued
    #                          ESPRIT: all-real after one transform,
    #                          implicit FB (one coherent pair free)


@dataclasses.dataclass(frozen=True)
class ArrayGeometry:
    """Antenna array geometry.

    `kind="ula"`: uniform linear array of `num_elements` elements spaced
    `norm_spacing` wavelengths apart; broadside is 90°, angles measured from
    the array axis (endfire), theta ∈ [0°, 180°] — the reference's
    `MUSIC_lin_array` convention (SURVEY.md §2.1 C2).

    `kind="ura"`: uniform rectangular (planar) array with `shape=(nx, ny)`
    elements, same normalized spacing on both axes; scanned in azimuth /
    elevation (BASELINE config 5).
    """

    kind: str = "ula"
    num_elements: int = 4
    norm_spacing: float = 0.5  # element spacing / wavelength (d/λ)
    shape: Optional[Tuple[int, int]] = None  # only for kind="ura"

    def __post_init__(self):
        if self.kind not in ("ula", "ura"):
            raise ValueError(f"unknown array kind {self.kind!r}")
        if self.kind == "ura":
            if self.shape is None:
                raise ValueError("ura geometry requires shape=(nx, ny)")
            nx, ny = self.shape
            if nx * ny != self.num_elements:
                raise ValueError(
                    f"shape {self.shape} inconsistent with num_elements "
                    f"{self.num_elements}"
                )


@dataclasses.dataclass(frozen=True)
class GridSpec1D:
    """Steering-scan grid over theta ∈ [lo, hi] degrees, `num_points` bins.

    Mirrors the reference's `pspectrum_len` over [0°, 180°].
    """

    num_points: int = 180
    lo_deg: float = 0.0
    hi_deg: float = 180.0


@dataclasses.dataclass(frozen=True)
class GridSpec2D:
    """Az/el scan grid for planar arrays (BASELINE config 5)."""

    num_az: int = 180
    num_el: int = 90
    az_lo_deg: float = -90.0
    az_hi_deg: float = 90.0
    el_lo_deg: float = 0.0
    el_hi_deg: float = 90.0


@dataclasses.dataclass(frozen=True)
class SmoothingSpec:
    """Forward(-backward) spatial smoothing for correlated sources
    (BASELINE config 3). `subarray_size` L: average the (N-L+1) leading
    principal L×L submatrices of R. Disabled when subarray_size == 0.
    """

    subarray_size: int = 0

    @property
    def enabled(self) -> bool:
        return self.subarray_size > 0


@dataclasses.dataclass(frozen=True)
class WidebandSpec:
    """Per-subband FFT channelizer + spectrum/covariance fusion
    (BASELINE config 5). Disabled when num_subbands <= 1.

    `fusion` selects how subbands combine:
      * "incoherent": per-subband MUSIC spectra, mean of max-normalized
        spectra (robust, spectrum-level — MUSIC only).
      * "cssm": Coherent Signal-subspace Method — unitary RSS focusing
        matrices T_f (Hung & Kaveh) rotate each subband covariance onto
        the reference-frequency array manifold, R_coh = mean_f T_f R_f
        T_fᴴ, then the FULL narrowband estimator suite runs on R_coh
        (Capon, root-MUSIC, ESPRIT — grid-free wideband — plus FB
        averaging/smoothing, which the spectrum-level fusion cannot
        compose with). Gains over incoherent fusion at low SNR (noise
        averages coherently across the band) and for correlated
        broadband sources.
      * "cssm_auto": two-pass CSSM — a coarse incoherent pass picks
        runtime focusing directions (on-device Newton-Schulz polar),
        then the coherent fusion above. No prior angle knowledge.
      * "tops": Test of Orthogonality of Projected Subspaces
        (ops/tops.py) — focusing-free coherent use of the band: the
        reference subband's signal subspace is carried to every band
        by the diagonal manifold transform and tested against each
        band's noise subspace; spectrum = 1/σ_min of the stacked
        projections. Needs no focusing angles OR preliminary
        estimates; meaningful when fractional_bw > 0 (at 0 every
        band shares one manifold and the transform is the identity).
        `tops_guard` (default on) suppresses the estimator's canonical
        broadside false peak — docs/ACCURACY.md "Wideband fusion
        modes" has the measured comparison table.
    """

    num_subbands: int = 1
    center_norm_freq: float = 0.0  # normalized center frequency of the band
    # samp_rate / carrier_freq: how much the electrical array spacing
    # stretches across the band (0 → all subbands share one steering grid).
    fractional_bw: float = 0.0
    fusion: str = "incoherent"
    # Focusing directions for fusion="cssm": J angles uniform over the
    # scan grid (config-static; 0 → auto = 2 per array element — full-
    # rank, estimate-free focusing; see ops.wideband.focusing_directions
    # for the measured J sweep).
    num_focus_angles: int = 0
    # Reference subband for fusion="tops" (whose signal subspace is
    # transported across the band). MUST hold signal energy — a
    # noise-only bin transports a noise subspace and the test
    # degenerates (classic choice: the highest-SNR bin). Config-static
    # so the subband scan stays loop-free; default 0 = DC, in-band for
    # baseband-centered scenes.
    tops_ref_band: int = 0
    # Suppress TOPS's canonical transform-degeneracy false peak
    # (broadside on a ULA, where Φ_f = I for every band) by gating the
    # spectrum with the incoherent signal-subspace MUSIC spectrum
    # accumulated in the same subband scan (near-free; measured at
    # fbw 0.4 / 10 dB the ungated 90° ridge outranks a true peak in
    # ~25% of windows — docs/ACCURACY.md "Wideband fusion modes").
    # Off = the textbook estimator (golden.tops_spectrum).
    tops_guard: bool = True

    @property
    def enabled(self) -> bool:
        return self.num_subbands > 1


@dataclasses.dataclass(frozen=True)
class BeamspaceSpec:
    """DFT beamspace preprocessing (ops/beamspace.py): project the
    covariance and steering onto `num_beams` orthonormal DFT beams
    around `center_deg` before the subspace scan — the classic sector
    thinning (subspace + scan dimensions shrink N → Nb). Disabled when
    num_beams == 0. ULA + MUSIC/Capon dense scans only (root/ESPRIT/
    Min-Norm keep element-space semantics; validated)."""

    num_beams: int = 0
    center_deg: float = 90.0

    @property
    def enabled(self) -> bool:
        return self.num_beams > 0


@dataclasses.dataclass(frozen=True)
class DoaConfig:
    """Full pipeline configuration: geometry + windowing + estimator."""

    geometry: ArrayGeometry = ArrayGeometry()
    snapshot_size: int = 256          # samples per covariance window (S)
    overlap: int = 0                  # overlapped samples between windows (O)
    num_sources: int = 1              # K — assumed signal-subspace dimension
    estimators: Tuple[Estimator, ...] = (Estimator.MUSIC,)
    grid: GridSpec1D = GridSpec1D()
    grid2d: Optional[GridSpec2D] = None
    avg_method: AvgMethod = AvgMethod.NONE
    smoothing: SmoothingSpec = SmoothingSpec()
    wideband: WidebandSpec = WidebandSpec()
    beamspace: BeamspaceSpec = BeamspaceSpec()
    num_max_vals: int = 1             # peaks to report (reference find_local_max)
    capon_diag_load: float = 1e-4     # diagonal loading for Capon R⁻¹ (× tr(R)/N)
    compute_dtype: str = "float32"    # "float32" | "bfloat16" scan precision
    # Signal-subspace extraction: "power" = batched subspace iteration
    # (MXU-native, the fast path); "eigh" = full eigendecomposition
    # (exact; LAPACK-style, slower on TPU for large batches).
    subspace_method: str = "power"
    power_iters: int = 8              # EFFECTIVE iteration count for "power"
    # Power-iteration schedule: how many repeated-squaring passes build
    # the per-round apply matrix E^(2^s). Under the MGS orthonormalizer
    # (r2 s4, exp_mgs.py) "e1" is BOTH the fastest and the most robust
    # schedule — exact on planted spectra through eigenvalue spread 10⁴
    # (~40 dB source power imbalance), 5.8 ms vs NS-e1's 20.7 at the
    # headline shape — so the old speed-vs-robustness dial is gone.
    # squarings > 0 remain a documented CORRECTNESS hazard with no speed
    # reward (conditioning grows spread^(2^s) between orths; "e4" loses
    # a −20 dB source) — kept for the config surface and regression
    # tests. Beyond any envelope enable subspace_check (per-window eigh
    # repair) or subspace_method="eigh".
    # Measured: docs/ACCURACY.md; regression: tests/test_power_subspace.py.
    power_schedule: str = "e1"
    # Power-iteration hardening: compute the per-window invariance
    # residual of the iterated subspace and fall back to exact eigh for
    # windows above subspace_tol (lax.cond — the converged common case
    # pays 3 extra batched matmuls, not an eigh). The residual appears
    # in DoaResult.subspace_residual for observability.
    subspace_check: bool = False
    subspace_tol: float = 0.05
    # AUTOMATIC subspace escalation (default ON; power path, e1
    # schedule ONLY — e2/e4 squarings disarm it with a config-time
    # warning: the detector's noise-floor estimate assumes the
    # unsquared spectrum): the final iteration's apply product gives
    # each window's invariance residual and eigengap ratios γ / γ_max
    # (min / max captured Rayleigh over the noise-floor mean) for
    # free. A window with residual > subspace_tol or
    # γ < subspace_escalate_gap — the slow-convergence regime of
    # extreme source imbalance (≥ ~20 dB) or threshold SNR, where the
    # default 8 iterations converge to a wrong-but-invariant subspace
    # that the residual alone cannot see — runs
    # subspace_escalate_extra more MGS rounds, PER WINDOW: flagged
    # windows are gathered into a compact batch of at most
    # subspace_escalate_capacity (worst-first), iterated there, and
    # scattered back under lax.cond (cpx_ops.escalate_flagged) — one
    # threshold window taxes ~capacity/B of the batch, not all of it.
    # SOURCE-FREE contract: a capture whose dominant component sits in
    # the noise bulk (γ_max < subspace_escalate_signal_floor — e.g.
    # spectrum monitoring before any signal appears, where EVERY
    # window has γ ≈ 1) never escalates: there is no subspace to
    # converge to, and the old whole-batch trigger cost the r3 bench
    # 3× on exactly that input (docs/PERF.md r3 post-mortem). Healthy
    # captures pay only tiny detector matmuls, never an extra pass
    # over E. Measured: the 25 dB imbalance row matches the eigh
    # column at default power_iters (docs/ACCURACY.md); benign-regime
    # γ ≥ 16 (no spurious escalation down to 0 dB SNR); noise-only
    # captures have γ_max ≈ 1.3–1.7 at S≈1024.
    subspace_escalate: bool = True
    subspace_escalate_gap: float = 3.0
    subspace_escalate_extra: int = 40
    subspace_escalate_signal_floor: float = 2.5
    subspace_escalate_capacity: int = 1024
    # WARM-START subspace iteration (the DEFAULT on the fused
    # narrowband path and the wideband incoherent paths, for window
    # batches ≥ 32): initialize every window's iteration from the
    # CAPTURE-MEAN covariance's subspace (computed at full power_iters
    # on the tiny mean — 1 or F matrices, not B or F·B) and refine per
    # window with power_iters_warm E-applies. The E reads are the
    # stage cost (8 passes over the (F·B, 2N, 2N) stack at c5), so a
    # good init cuts the stage near-proportionally: c5 77.3 → 59.1 ms,
    # headline measured in docs/PERF.md. The refinement still converges
    # to each window's OWN subspace — init affects speed, not the
    # fixed point. Measured equivalent to cold (order-invariant angle
    # diff ≤ 0.013°) at 0 dB SNR, 20 dB source imbalance, 2° near-
    # Rayleigh separation, and 30°-sweep moving emitters
    # (tests/test_power_subspace.py, tests/test_wideband_fast.py).
    # Requires subspace_method="power"; cold iteration via False.
    # power_iters_warm: E-applies per window from the mean init. The
    # r5 default is 2 (was 3): measured equal to cold through every
    # probed edge — 0/20 dB imbalance (bit-equal angles), abrupt
    # mid-capture scene change (6e-4°), 0 dB SNR (2e-4°) — because
    # each apply contracts the init error by λ_{K+1}/λ_K (large after
    # S-sample averaging), and the armed escalation detector catches
    # any window where 2 applies were NOT enough (res > tol ⇒
    # per-window extra rounds). One fewer pass over the E stack:
    # c5 54.3 → 50.3 ms, headline ~0.5 ms (docs/PERF.md r5).
    subspace_warm_start: bool = True
    power_iters_warm: int = 2
    # MUSIC scan strategy: "dense" scans the full grid; "hierarchical"
    # (ULA + power path only) runs a coarse grid scan then refines each
    # peak on an on-device micro-grid — resolution beyond the grid at a
    # fraction of the flops (ops.hierarchical); "pallas" (power path
    # only) runs the fused lane-packed Pallas scan kernel
    # (ops.pallas.music_scan) — no (B, G, 2K) intermediate in HBM.
    # "auto" (default) resolves to "pallas" whenever the fused fast
    # path is active (TPU + power subspace + no smoothing) and "dense"
    # otherwise — the measured-fastest composition on each backend.
    scan_mode: str = "auto"
    # Covariance chunk-Gram implementation: "auto" picks the Pallas
    # kernel on TPU backends and XLA elsewhere; "xla" | "pallas" force.
    cov_impl: str = "auto"
    # Subspace-iteration implementation on the fused (embedded-E) path:
    # "auto" (default) = the batched-einsum XLA iteration in transposed
    # layout (cpx_ops.signal_subspace_from_E_T — measured fastest; the
    # warm path skips the Ep materialization so E crosses HBM once per
    # apply); "xla" forces the einsum path everywhere; "pallas" = the
    # cold in-VMEM consolidated kernel (ops/pallas/subspace.py).
    # (An r3 "fused" warm-refine Pallas kernel was REMOVED in r4:
    # 6× slower at 2N=32 — per-window micro-dot latency — and its
    # design shape 2N=128 fails to compile on this Mosaic toolchain,
    # while the einsum warm path runs at 1.2× its E-read floor.
    # Post-mortem: docs/PERF.md "warm-refine fusion experiments".)
    subspace_impl: str = "auto"
    # Gram input precision: "bfloat16" quarters the MXU pass count of the
    # covariance stage (f32 accumulation; ~3 decimal digits on R entries
    # — fine above threshold SNR, see docs/ACCURACY.md). "int8" is the
    # INGEST-QUANTIZED mode (fused Pallas path only): feed a
    # pre-quantized int8 interleaved buffer
    # (io.native.quantize_interleaved_int8 → pipe.interleaved(xq)) —
    # ¼ the input read (the f32 pipeline's bandwidth floor), exact
    # int32 Gram accumulation, R carries the quantization scale²
    # (every consumer is scale-invariant). The modern analog of the
    # reference fork's 16-bit fixed-point Connex ingest (SURVEY §2.2).
    cov_dtype: str = "float32"
    # Wideband incoherent subband-scan + fusion implementation (power
    # path, compute_dtype float32 only): "xla" = the lax.scan-over-
    # subbands form (materializes one den/spectrum per subband per
    # step); "pallas" = the fused two-pass kernel
    # (ops/pallas/wideband_scan.py — den never leaves VMEM; tf32-class
    # hi/lo dots); "auto" picks the measured winner per backend
    # (docs/PERF.md). The kernel is toolchain-sensitive — keep the XLA
    # fallback reachable (bench try/except pattern).
    wb_fusion_impl: str = "auto"
    # 2-D peak extraction implementation (ULA 1-D peaks fuse into the
    # scan kernel and ignore this): "auto" = the fused Pallas 2-D peaks
    # kernel whenever the Pallas covariance path is active, XLA
    # otherwise (the measured default); "xla" keeps the Pallas
    # covariance/scan kernels but opts out of peaks2d alone (the kernel
    # is shape-sensitive on some Mosaic toolchains — block_b=64 fails
    # to compile — and a compile failure inside the one jitted program
    # cannot be caught piecemeal); "pallas" forces the kernel.
    peaks_impl: str = "auto"
    # Overlap-halo exchange in the SHARDED pipeline (SURVEY §2.5 ring
    # row): "xla" = lax.ppermute collective (default; zero-fills the
    # last shard), "pallas" = fused ICI async-remote-copy kernel
    # (ops/pallas/ring.py — pod hardware; ring-wraps into the last
    # shard, whose tail windows are invalid either way, so valid-window
    # outputs are identical). Single-chip pipelines ignore it.
    halo_impl: str = "xla"

    def __post_init__(self):
        if not (0 <= self.overlap < self.snapshot_size):
            raise ValueError("need 0 <= overlap < snapshot_size")
        if self.num_sources >= self.effective_num_elements:
            raise ValueError("num_sources must be < effective array size")
        if self.subspace_method not in ("power", "eigh", "jacobi"):
            raise ValueError(
                f"subspace_method {self.subspace_method!r} not one of "
                "'power' | 'eigh' | 'jacobi'")
        if self.scan_mode not in ("auto", "dense", "hierarchical",
                                  "pallas"):
            raise ValueError(
                f"scan_mode {self.scan_mode!r} not one of "
                "'auto' | 'dense' | 'hierarchical' | 'pallas'")
        if self.scan_mode == "pallas" and self.subspace_method != "power":
            raise ValueError(
                "scan_mode='pallas' scans the signal subspace directly "
                "and requires subspace_method='power'")
        if self.compute_dtype not in ("float32", "bfloat16", "int8"):
            raise ValueError(
                f"compute_dtype {self.compute_dtype!r} not one of "
                "'float32' | 'bfloat16' | 'int8'")
        if self.cov_impl not in ("auto", "xla", "pallas"):
            raise ValueError(
                f"cov_impl {self.cov_impl!r} not 'auto' | 'xla' | 'pallas'")
        if self.subspace_impl not in ("auto", "xla", "pallas"):
            raise ValueError(
                f"subspace_impl {self.subspace_impl!r} not "
                "'auto' | 'xla' | 'pallas'")
        if self.cov_dtype not in ("float32", "bfloat16", "int8"):
            raise ValueError(
                f"cov_dtype {self.cov_dtype!r} not "
                "'float32' | 'bfloat16' | 'int8'")
        if self.halo_impl not in ("xla", "pallas"):
            raise ValueError(
                f"halo_impl {self.halo_impl!r} not 'xla' | 'pallas'")
        if self.peaks_impl not in ("auto", "xla", "pallas"):
            raise ValueError(
                f"peaks_impl {self.peaks_impl!r} not "
                "'auto' | 'xla' | 'pallas'")
        if self.wb_fusion_impl not in ("auto", "xla", "pallas"):
            raise ValueError(
                f"wb_fusion_impl {self.wb_fusion_impl!r} not "
                "'auto' | 'xla' | 'pallas'")
        if self.power_schedule not in ("e1", "e2", "e4"):
            raise ValueError(
                f"power_schedule {self.power_schedule!r} not one of "
                "'e1' | 'e2' | 'e4'")
        if self.subspace_escalate and self.power_schedule != "e1":
            import warnings
            warnings.warn(
                f"power_schedule={self.power_schedule!r} DISARMS "
                "subspace_escalate (the eigengap detector assumes the "
                "unsquared e1 spectrum): the 25-dB-imbalance safety "
                "net is off on this config. Squared schedules are a "
                "documented correctness hazard with no speed reward "
                "(docs/PERF.md) — prefer e1, or set "
                "subspace_escalate=False to silence this.",
                stacklevel=2)
        if self.subspace_escalate_capacity < 1:
            raise ValueError("subspace_escalate_capacity must be >= 1")
        if self.wideband.fusion not in ("incoherent", "cssm",
                                        "cssm_auto", "tops"):
            raise ValueError(
                f"wideband.fusion {self.wideband.fusion!r} not "
                "'incoherent' | 'cssm' | 'cssm_auto' | 'tops'")
        if self.wideband.fusion == "tops":
            if not (0 <= self.wideband.tops_ref_band
                    < max(self.wideband.num_subbands, 1)):
                raise ValueError(
                    "wideband.tops_ref_band must index a subband "
                    f"(got {self.wideband.tops_ref_band} with "
                    f"{self.wideband.num_subbands} subbands)")
            if self.scan_mode == "hierarchical":
                raise ValueError(
                    "fusion='tops' has no hierarchical scan (the "
                    "orthogonality metric is grid-pointwise); use "
                    "scan_mode 'auto'/'dense'")
        if (self.wideband.fusion == "cssm_auto"
                and self.geometry.kind == "ura" and self.grid2d is None):
            raise ValueError(
                "fusion='cssm_auto' on a planar array needs grid2d "
                "(the coarse pass scans the 2-D az/el grid)")
        if self.wideband.num_focus_angles < 0:
            raise ValueError("wideband.num_focus_angles must be >= 0")
        if self.beamspace.enabled:
            if self.geometry.kind != "ula":
                raise ValueError("beamspace requires a ULA geometry")
            if not (self.num_sources < self.beamspace.num_beams
                    < self.effective_num_elements):
                raise ValueError(
                    "need num_sources < beamspace.num_beams < array size")
            bad = {Estimator.ROOT_MUSIC, Estimator.ESPRIT,
                   Estimator.UNITARY_ESPRIT,
                   Estimator.MIN_NORM} & set(self.estimators)
            if bad:
                raise ValueError(
                    f"{sorted(e.value for e in bad)} keep element-space "
                    "semantics and cannot run under beamspace")
            if self.wideband.enabled or self.smoothing.enabled:
                raise ValueError(
                    "beamspace does not compose with wideband/smoothing")
            if self.scan_mode in ("hierarchical", "pallas"):
                raise ValueError(
                    "beamspace scans are dense (scan_mode 'auto'/'dense')")
        # NOTE: irregular overlap (hop not dividing snapshot_size) is
        # legal on every path: the TPU paths frame it with
        # gcd(S, hop)-granularity chunk Grams + strided prefix sums
        # (exact; less MXU-efficient for tiny gcds), the complex/CPU
        # path frames it explicitly.

    @property
    def power_squarings(self) -> int:
        """Squaring passes for the power schedule (e1→0, e2→1, e4→2)."""
        return {"e1": 0, "e2": 1, "e4": 2}[self.power_schedule]

    def escalate_kwargs_for(self, snapshots: int,
                            n2: Optional[int] = None) -> dict:
        """kwargs for the cpx_ops signal-subspace escalation detector
        at an operating point of `snapshots` samples per covariance
        window over an n2-dimensional embedding (default
        2·effective_num_elements); extra=0 disables.

        The source-free gate compares γ_max against a SIGNAL FLOOR that
        must sit above the Wishart noise-bulk edge ≈ (1 + √(n2/S))² —
        at the headline point (n2=32, S=1024) the edge is 1.37 and the
        static 2.5 default clears it, but short windows push the bulk
        up toward and past 2.5 (S=64, n2=32 → 2.91; a wideband subband
        at S_sub=64, n2=128 → 5.83), where a fixed floor would let
        PURE-NOISE captures qualify as signal-bearing and spuriously
        escalate (exactly the r3 3× regression class). The effective
        floor is therefore max(subspace_escalate_signal_floor,
        1.5 × edge): unchanged at the measured operating points,
        noise-proof at short-snapshot ones. Pinned by
        tests/test_power_subspace.py::test_small_snapshot_noise_never_escalates."""
        import math
        if n2 is None:
            n2 = 2 * self.effective_num_elements
        edge = (1.0 + math.sqrt(n2 / max(snapshots, 1))) ** 2
        floor = max(self.subspace_escalate_signal_floor, 1.5 * edge)
        return dict(
            escalate_extra=(self.subspace_escalate_extra
                            if self.subspace_escalate else 0),
            escalate_gap=self.subspace_escalate_gap,
            escalate_tol=self.subspace_tol,
            escalate_signal_floor=floor,
            escalate_capacity=self.subspace_escalate_capacity)

    @property
    def escalate_kwargs(self) -> dict:
        """escalate_kwargs_for at the narrowband operating point
        (snapshot_size samples per window)."""
        return self.escalate_kwargs_for(self.snapshot_size)

    @property
    def hop(self) -> int:
        """Snapshot hop = snapshot_size − overlap (reference decimation)."""
        return self.snapshot_size - self.overlap

    @property
    def effective_num_elements(self) -> int:
        """Array size seen by the estimator (subarray size when smoothing)."""
        if self.smoothing.enabled:
            return self.smoothing.subarray_size
        return self.geometry.num_elements


# ---------------------------------------------------------------------------
# The five named presets from BASELINE.json `configs`.
# ---------------------------------------------------------------------------

PRESETS = {
    # "4-element ULA, single complex-tone source, MUSIC on 256-snapshot
    #  covariance, CPU-runnable recorded IQ"
    "c1_ula4_tone": DoaConfig(
        geometry=ArrayGeometry(kind="ula", num_elements=4, norm_spacing=0.5),
        snapshot_size=256,
        num_sources=1,
        estimators=(Estimator.MUSIC,),
        grid=GridSpec1D(num_points=1024),
    ),
    # "8-element ULA, 2 uncorrelated sources, MUSIC + Capon-MVDR, 1° steering
    #  grid, 2048 snapshots"
    "c2_ula8_2src": DoaConfig(
        geometry=ArrayGeometry(kind="ula", num_elements=8, norm_spacing=0.5),
        snapshot_size=2048,
        num_sources=2,
        estimators=(Estimator.MUSIC, Estimator.CAPON),
        grid=GridSpec1D(num_points=181),  # 1° over [0, 180]
        num_max_vals=2,
    ),
    # "16-element ULA with phase/gain calibration stage, 3 sources incl.
    #  correlated pair (spatial smoothing)"
    "c3_ula16_calib_smooth": DoaConfig(
        geometry=ArrayGeometry(kind="ula", num_elements=16, norm_spacing=0.5),
        snapshot_size=1024,
        num_sources=3,
        estimators=(Estimator.MUSIC,),
        grid=GridSpec1D(num_points=1024),
        avg_method=AvgMethod.FORWARD_BACKWARD,
        smoothing=SmoothingSpec(subarray_size=12),
        num_max_vals=3,
    ),
    # "16-element array, streaming overlap-save covariance updates at
    #  10 Msps/channel, sliding-window tracking of moving emitters"
    "c4_ula16_streaming": DoaConfig(
        geometry=ArrayGeometry(kind="ula", num_elements=16, norm_spacing=0.5),
        snapshot_size=1024,
        overlap=512,
        num_sources=2,
        estimators=(Estimator.MUSIC,),
        grid=GridSpec1D(num_points=1024),
        num_max_vals=2,
    ),
    # FAST MODE (r5, beyond the five BASELINE presets): the headline
    # 16-element config with bf16 covariance Grams, intended for a
    # BFLOAT16 resident ingest buffer (pipe.interleaved(
    # xil.astype(jnp.bfloat16)) — the input read is the f32 pipeline's
    # bandwidth floor, and an 8-bit-mantissa capture exceeds any real
    # ADC's dynamic range). Measured 2,492,885 snapshots/s (255× real
    # time) at angle error IDENTICAL to f32 on the bench's planted
    # scene (0.030° max over 16384 windows) — docs/PERF.md r5.
    "fast_bf16": DoaConfig(
        geometry=ArrayGeometry(kind="ula", num_elements=16,
                               norm_spacing=0.5),
        snapshot_size=1024,
        num_sources=2,
        estimators=(Estimator.MUSIC,),
        grid=GridSpec1D(num_points=1024),
        num_max_vals=2,
        cov_dtype="bfloat16",
    ),
    # int8 INGEST fast mode (r5): pre-quantize the capture with
    # io.native.quantize_interleaved_int8 and feed the int8 buffer to
    # pipe.interleaved — ¼ the input read, EXACT int32 Grams, R is
    # scale-invariant downstream. Measured 2,704,138 snapshots/s
    # (277×) at 0.0303° max planted-scene error == the f32 pipeline's
    # (docs/PERF.md r5) — the modern analog of the reference fork's
    # 16-bit fixed-point Connex ingest, two bits further.
    "fast_int8": DoaConfig(
        geometry=ArrayGeometry(kind="ula", num_elements=16,
                               norm_spacing=0.5),
        snapshot_size=1024,
        num_sources=2,
        estimators=(Estimator.MUSIC,),
        grid=GridSpec1D(num_points=1024),
        num_max_vals=2,
        cov_dtype="int8",
    ),
    # "64-element planar array, 2-D az/el MUSIC scan, wideband sources via
    #  per-subband FFT channelizer + incoherent spectrum fusion"
    "c5_ura64_wideband": DoaConfig(
        geometry=ArrayGeometry(
            kind="ura", num_elements=64, norm_spacing=0.5, shape=(8, 8)
        ),
        snapshot_size=1024,
        num_sources=2,
        estimators=(Estimator.MUSIC,),
        grid2d=GridSpec2D(num_az=181, num_el=91),
        wideband=WidebandSpec(num_subbands=16, fractional_bw=0.1),
        num_max_vals=2,
    ),
}


def _rebuild(value):
    """A field value with every dataclass and enum of a same-shaped config
    tree replaced by this module's class of the same name."""
    if isinstance(value, enum.Enum):
        return globals()[type(value).__name__](value.value)
    if dataclasses.is_dataclass(value) and not isinstance(value, type):
        cls = globals()[type(value).__name__]
        return cls(**{f.name: _rebuild(getattr(value, f.name))
                      for f in dataclasses.fields(cls)})
    if isinstance(value, tuple):
        return tuple(_rebuild(v) for v in value)
    return value


def as_config(cfg) -> DoaConfig:
    """→ this module's DoaConfig equal to `cfg`, any object with the same
    dataclass fields (e.g. a doa_tpu.configs.DoaConfig): nested specs are
    rebuilt field by field and enums mapped by value, so the result is
    validated as if built here. A DoaConfig of this module is returned
    as it is."""
    if isinstance(cfg, DoaConfig):
        return cfg
    if not dataclasses.is_dataclass(cfg) or type(cfg).__name__ != "DoaConfig":
        raise TypeError(f"need a DoaConfig, got {type(cfg).__name__}")
    return _rebuild(cfg)
