#!/usr/bin/env python3
"""Drive the doa_tpu_torch port once on one NVIDIA GPU and check it.

    python3 chip_smoke.py          # from the root of the repository

Phases (each prints its own lines; any failure ends the run non-zero):

1. environment: card name and power limit (nvidia-smi), torch and CUDA
   versions; TF32 off.
2. build: the CUDA kernels from doa_tpu_torch/csrc with nvcc.
3. kernel parity on the card, each kernel against its plain PyTorch
   version: exact on integer-valued inputs (every sum exact in FP32, so
   any difference is a bug), and at the main path's shapes on the planted
   scene within the stated tolerances. Each kernel's time beside the
   plain version's. K1 (`gram_parity`) is exact at every 2N it takes,
   chunks of 1, 3, 4, 7, 512 and 1024 rows and f32, bf16 and int8, also
   on views at row 1 and at element 1 (off the 16-byte alignment of its
   bulk copies); timed at f32, bf16 and int8 (g = 1024) and f32 at
   g = 512 and g = 8 (where each row class takes whole chunks), each in
   turns with its plain version and one f32 torch.bmm;
   then the prefix-sum windows (`window_sums`) alone at c4's shape. K3
   (3xTF32 on the tensor cores, csrc/scan_tc.cuh's mainloop) exact at
   (2K, 2N) = (4, 32), (6, 24) and (4, 128), ragged B and odd G, and on
   the headline's subspaces within 1e-5·max‖a‖² of its plain version's
   den, timed in turns with the plain version and one FP32
   torch.matmul(Vt, At.T) (the product alone; no torch call computes
   den); their plain den (`music_den_plain`, y rounded once from a
   float64 sum) on the card bit-equal to the CPU's on the exact inputs
   and within 2^-23·max‖a‖² on 4096 of the headline's windows. K2
   (`k2_exact`): both forms (tensor-core, on K3's mainloop with
   den held in shared memory; CUDA-core) bit-equal to the plain version on
   exact inputs at (2K, 2N, G) = (4, 32, 1024), (6, 24, 1024),
   (4, 16, 181), (2, 8, 250), k = 1 to 4, refine off and on, and on the
   made-to-order den rows of `peak_rows` (ties, plateaus, fallbacks,
   subnormal quotients); the wrapper at 2K = 10 and at G = 2048 past the
   den tile, where it must take the CUDA-core form; on the headline's
   subspaces (`k2_scene`) within 0.01° of the plain version's sorted
   angles and 0.5° of the planted scene, timed in turns with its plain
   version, its CUDA-core form and the unfused route (K3, normalise,
   find_local_max). K4 (its group form at 2N = 32) on the headline's
   windows, warm 3 rounds and cold 8, and on their capture mean (B = 1,
   cold 8) within 1e-5 (projectors, W over max|W|; `k4_scene`), timed at
   both (`k4_times`).
4. main path: the headline configuration (ULA-16, S=1024, K=2, G=1024,
   MUSIC, e1 power schedule, warm start + escalation) at T=2^24 samples
   (16384 windows) through build_pipeline_torch(...).interleaved, with
   return_spectra False (fused scan + peaks, K2) and True (K3); launch
   counts reset before and read after (K2's all of its tensor-core form,
   K4's all of the form call.plan.forms["subspace"] names: `k4_forms`,
   as in phases 7 and 9); every window within 0.5° of the
   planted 70°/110°; the median call time from CUDA events. Each path's
   call.plan is logged (here and below), and every preset's kernel_plan,
   with the c5 variants driven here, must name a kernel for every stage.
5. the same scene check on the c4_ula16_streaming, fast_bf16 and
   fast_int8 presets at T=2^20, and the card's pipeline against the same
   pipeline on the CPU on a small capture.
6. wideband kernel parity at c5's shapes (8x8 URA, 16 subbands,
   181x91 az/el grid) on a wideband planar scene made on the card: the
   FFT-channelizer Gram, the fused subband-scan fusion and the 2-D peaks
   kernels (kernel 6 in each of its forms, its ring form and its block
   form, bit-equal), and the subspace kernel K4 at 2N = 128 with one init per
   subband (its block form: 8 warps a window, E held on chip for every
   round); exact on integer-valued inputs (K4: signed-permutation windows
   at (2K, 2N) = (2, 66), (4, 128), (8, 128), (6, 96) and, in its group
   form, (2, 8), (4, 16), (4, 32), (6, 24), (8, 32), (2, 34), (6, 48),
   (8, 64), B = 1001, cold and from each init grouping), within the
   stated tolerances on the scene;
   each kernel's time beside its plain version's (K4 also on the
   per-subband means and, in phase 11, on c5 cssm's R_coh windows). The
   fusion kernel (3xTF32 on the tensor cores) also in window groups
   (bit-equal), its workspace's bytes, and the kernel's and the plain
   version's errors against float64 on 64 windows (logged).
7. the c5 path: PRESETS["c5_ura64_wideband"] at B = 2048 windows
   (T = 2^21 samples) through build_pipeline_torch(...).interleaved;
   launch counts reset before and read after (kernel 6's launches all of
   the form `call.plan.forms["peaks"]` names, as on every path below that
   runs it: `peaks_forms`); the median pair-sorted
   az/el within 0.5 deg of the planted (-20, 30), (35, 60); the median
   call time, per-layer times and a profile window; then the card's
   pipeline against the same pipeline on the CPU on 32 windows.
8. planes-path kernel parity: kernel 8 (chunk Grams of sample planes, f32
   and bf16) in each of its forms (`form_of` reads the form of each
   launch from the wrapper's by_form counts): the ring form on the
   stride-2 views of a complex64 capture (also 8 bytes off a 16-byte
   boundary) and on separate planes (4 | N), the staged form on rows
   padded by one element, every third value and separate planes at odd
   N; exact on integer-valued inputs at 2N = 16, 30, 32, 64, chunks of
   128 and 7 rows, 63 chunks + a tail; at c3's shape within 1e-5 of
   max|R| on the c3 scene, each form timed in turns with the plain
   versions (f32 and bf16). Kernel 12 in each of its forms (K12_EXACT:
   the chunk-sum form at N = 16, 8, 4 with hops of 24, 56, 200, 6 and 1,
   on the stride-2 views, separate planes and every third value; the
   per-window form at hop 4 and at N = 15; at N = 16 also the per-window
   form through its C entry) exact on integer-valued inputs, and at S =
   96 the card's plain version equal to the CPU's on them; both forms
   within 1e-5 of max|R| on the c3 scene at N=16, S=1024, overlap 1000
   (43649 windows of 2^20 samples) and timed in turns with the plain
   version. K4 exact at (2N, 2K) = (24, 6) and (16, 4) on
   signed-permutation windows and within 1e-5 on the c3 scene's smoothed
   windows; each kernel's time beside its plain version's.
9. the planes path: the two-stage calibration on the card (common tone,
   pilot at 68 deg, artifact round trip); PRESETS["c3_ula16_calib_smooth"]
   at T=2^24 on validate_tpu.py's c3 scene (40/70 deg coherent, 100 deg),
   impaired by chain phases and element gains/phases, through
   call((xr, xi), correction) on strided card views: every window within
   0.5 deg, launch counts, median call time, layer times, a profile
   window (K2's launches all of its tensor-core form, kernel 8's all of
   its ring form on the interleaved views, as the plan names); K3 and K2
   on c3's own subspaces (`scan_parity`: den, sorted angles within 0.01°
   of plain and 0.5° of the scene, K2 timed as in phase 3); c3 with eigh at
   overlap 512 (1024 windows); the card against
   the CPU on 64 c3 windows; PRESETS["c2_ula8_2src"] (MUSIC + Capon) at
   T=2^24 on validate_tpu.py's c2 scene: every window within 0.5 deg of
   60/110 (K2 in its tensor-core form; `scan_parity` on c2's subspaces;
   K4 on c2's windows warm from their mean within 1e-5, and timed),
   the card against the CPU on 64 windows; the cov_windows entry
   driven at gcd 8 (kernel 12, all of its chunk-sum form).
10. the wideband front end at any F: kernel 7 (the ring kernel of
   csrc/wideband_cov.cu on the channelized stream) and kernel 10
   (interleaved subband Grams) exact on integer-valued streams at every
   tile form (kernel 7 also on views one complex element in); kernel 7
   at c5_f12's full shape (12 subbands, 2048 chunks of 64) and at N=16,
   F=10, 13 chunks, kernel 10 at c5's (F=16; sb_group 2 equal to 1),
   each within 1e-5 of max|E| of its plain version; the "embedded"
   variant's stage on the card (the ring kernel on the frames, its split
   DFT at F = 12 = 4 x 3) within 1e-5 of max|E| of the reference
   composition (channelizer + kernel 7's plain version) at c5_f12, and
   the card's "embedded" route at F = 12, 10, 6 within 2e-5; the three
   front-end routes (fft, embedded, uhat) on one c5 capture within 2e-5
   of max|E|; times in turns: kernel 7 beside its plain version and the
   library call (one batched torch.matmul of the subband Grams; kernel 10
   likewise), the frames launch beside the composition, its plain version
   and the channelizer matmul alone.
11. the paths at full width, each driven once with counts from zero, then
   20 timed calls and a profile window: c5_f12 (c5 at S=768, 12 subbands:
   the ring kernel once on the frames, no channelizer call, kernel 7's
   stream entry not launched; incoherent fusion; 2048 windows, median
   within 0.5 deg; its peak memory and layers, the reference
   composition's front end beside the card's), its planes input (equal
   angles); the kernel 7 entry on a channelized stream; c5 with
   fusion="cssm" and "cssm_auto" (kernel 4, R_coh, cold K4, K3, 2-D
   peaks; 2048 windows, medians within 2.0 deg) and the cssm layer times,
   K3 on c5 cssm's own subspaces (den within 1e-5·max‖a‖², its time
   beside the plain version's and the FP32 product's);
   the uhat entry (kernel 10); ULA-16 cssm with FB, smoothing to L=12,
   MUSIC + Capon on a 65/115 deg wideband scene (1024 windows, medians
   within 2.0 deg); the card against the CPU on 32 windows of each path.
12. the fused path's opt-in kernels: kernel 11 (the cold Newton-Schulz
   subspace) in each form that takes the shape (the warp form up to
   (2N, 2K) = (64, 8), the block form at every shape) against its plain
   version on the headline's E at squarings 0, on a 60/110 deg scene of
   its shape at squarings 2, at (24, 6) and (16, 4) on 4096 windows and
   at (128, 4) on 2048 windows of c5's first subband: projectors and
   orthonormality within the stated tolerances; both forms timed on the
   headline's E in turns with the plain version; kernel 9
   (`embedded_parity`: chunk Grams with the embedding, correction, FB
   and 1/S in the epilogue; also the covariance stage's epilogue where a
   window is one chunk) exact on integer-valued inputs at every tile
   form, at g = 256, 7 and 1, FB on and off, also on views at row 1 and
   element 1, within 1e-5 of max|E| at the headline shape (f32, bf16;
   overlaps 0 and 512), and its route within 2e-5 of max|E| of the
   stacked route; timed in turns with its plain version and one
   torch.bmm; kernel 9's window entry (`window_route`: the covariance
   stage at overlap 512, 2^24 samples, g = 512, f32 and bf16, FB off and
   on) launched once, bit-equal to kernel 9's per-chunk E summed in
   order and within 1e-5 of max|E| of its plain version, the stacked
   route within 1e-5 of max|E| of a float64 sum, timed in turns with its
   plain version, one torch.bmm and the route it replaces.
13. the paths: the headline with subspace_impl="pallas" in both
   return_spectra modes (every window within 0.5 deg, escalation counts
   0, kernel 11 launched in its warp form alone, as call.plan.forms
   names, and K4 not; 20 timed calls, a profile window);
   the headline with subspace_check under both subspace_impl values; the
   guard's hard scene (30:1 at 60/110 deg, 20 dB, power_iters=4) within
   0.2 deg of the eigh run; scan_capture on the headline (8 blocks of
   2^21, overlaps 0 and 512) and on c5 (4 blocks of 2^19, overlap 512),
   each block equal to a per-block call with its carry; the
   cov_embedded(variant="chunk") entry at T=2^24; the card against the
   CPU on 64 windows of the two opt-in stages.
14. the time-sharded pipeline: PRESETS["c4_ula16_streaming"] (overlap
   512, so the halo is not empty) at T=2^24 on R = 2 and 4 ranks, each
   a process on cuda:0 started by parallel.launch.spawn_ranks (gloo,
   whose collectives the port stages through the host; kernel 13 writes
   each halo through a CUDA IPC peer pointer): kernel 13 bit-equal to
   its plain version on every rank, its public result unchanged by the
   next exchange, its time alone, the exchange's, the default halo's; the sharded fused path under halo_impl "pallas" and
   "xla", equal bit for bit on the valid windows, within 5e-3 deg of the
   single-card path on the same capture, every window within 0.5 deg,
   equal escalation counts, launch counts of kernel 13, K4, K2 and the
   covariance stage (kernel 9's window entry once and K1 never where the
   plan names the "windows" epilogue, on the single card and on every
   rank: `window_epilogue`); the ms of a call with the R ranks
   time-sliced on one card.
15. fault C.5: ULA-48 (2N = 96, beyond K1 and kernel 8) and ULA-16 at
   K = 5 (2K = 10, beyond K4; K3 takes it in its CUDA-core form), the
   latter also under subspace_impl="pallas" (kernel 11), through
   build_pipeline_torch on the card in both return_spectra modes: the
   plan names "plain" for those stages, their kernels launch no time and
   the planned ones launch (K3 wherever spectra are returned; K2 in its
   CUDA-core form, never its tensor-core form); the angles equal the CPU
   pipeline's within 1e-3 deg; kernel 11 launched in the form the plan
   names (the block form at 2K = 10); and each kernel wrapper (K1, 8,
   K4, K3, K2, 5, 4, 7, the frames launch, kernel 11 and its warp form)
   still raises on a CUDA tensor of a shape it does not take.
16. the grid-free and projector estimators, each configuration driven
   once with counts from zero (its plan's kernels launched, no other),
   its peak allocation, the median of 10 calls, a profile window, each
   estimator's own time and the card against the CPU on 64 windows
   (sorted angles within 1e-3 deg narrowband, 5e-3 deg wideband): the
   headline with MUSIC, root-MUSIC, ESPRIT, Unitary ESPRIT and min-norm
   at T=2^24 in both return_spectra modes (K1, warm K4, K2 or K3; R
   unembedded for the grid-free ones), every window of every estimate
   within 0.5 deg of 70/110, root-MUSIC's every angle within 0.5 deg of
   a source, the windows where the reference's root rule takes one
   source twice counted (ROADMAP §C.3); PRESETS["c3_ula16_calib_smooth"]
   with subspace_method="jacobi" at T=2^24 through strided planes views
   (kernel 8 alone, Jacobi's noise projector), every window within 0.5
   deg of 40/70/100; c5 with fusion="cssm" and "cssm_auto" and ESPRIT
   (kernel 4, R_coh, cold K4, K3, kernel 6; 2-D ESPRIT on R_coh; 2048
   windows), MUSIC's and ESPRIT's median az/el within 2.0 deg.
17. beamspace, the hierarchical scans and model order, each
   configuration driven once with counts from zero (its plan's kernels
   launched, no other), its peak allocation, the median of 10 calls, a
   profile window and the card against the CPU on 64 windows (as phase
   16): the headline with 8 DFT beams at 90 deg (E projected after K1;
   K4 and K2 or K3 at 2Nb = 16), MUSIC + Capon, both return_spectra
   modes, every MUSIC window within 0.5 deg of 70/110 (Capon's error
   logged: over the full grid the reference's beamspace Capon peaks out
   of the sector too); the headline with scan_mode="hierarchical" in
   both modes (K2's coarse peaks, then the refine; no spectrum), every
   window within 0.5 deg and its largest error within the dense
   headline's on the same capture + 0.05 deg; estimate_num_sources on
   the headline's R windows (MDL K = 2 in every window, AIC ≥ MDL, the
   counts equal to the CPU's); PRESETS["c2_ula8_2src"] hierarchical,
   MUSIC + Capon, at T=2^24 through strided planes views (kernel 8),
   every window within 0.5 deg of 60/110; c5 and c5 cssm hierarchical
   (2048 windows; kernel 5's coarse spectrum and dmin from one launch,
   dmin within 1e-5·max‖a‖² of its plain version's and P bit-equal to
   the launch without it; kernel 6 with refine off), medians within 0.5
   and 2.0 deg.
18. the complex-typed public entry (doa_tpu_torch.estimate_doa,
   pipeline.build_pipeline: PyTorch library calls on complex64, no
   kernel of the port launched, `no_kernel`), each path also on the CPU
   for the first 64 windows of its capture (`cpx_card_vs_cpu`: the
   covariance within 2e-5 of max|R|, every estimate within 1e-3 deg,
   root-MUSIC's windows that the card and the CPU split differently
   counted where one takes a source twice): the headline capture
   (16384 windows) with all seven estimators, every window of MUSIC,
   Capon, min-norm, ESPRIT and Unitary ESPRIT within 0.5 deg of 70/110,
   root-MUSIC's angles within 0.5 deg of a source, Bartlett's error
   logged, then timed beside the MUSIC-only complex call and the fast
   path's headline on the same capture; beamspace with 8 beams at 90
   deg (MUSIC, every window); MVDR extraction toward 70 deg on 4096
   windows (the CPU within 2e-5 of max|y|); PRESETS c2 (MUSIC + Capon),
   c3 (FB, smoothing L = 12, M = 5, with the calibration correction on
   an impaired capture) and c4 (overlap 512) at T=2^24, every window
   within 0.5 deg; S = 96 with overlap 40 (the explicit frames) with
   return_covariance, the median window within 0.5 deg; the 8x8 URA
   narrowband on c5's 181x91 grid with MUSIC + 2-D ESPRIT at 512
   windows (reduced depth: the (B, G, N) complex64 products are 4.3 GB
   there), every window within 0.5 deg. The median of 10 calls and a
   profile window for the headline, c2, c3, c4 and the URA.
19. the rest of single-card wideband (torch ops around the ported
   kernels; no new kernel), each configuration driven once with counts
   from zero (its plan's kernels launched, no other), its peak
   allocation, the median of 10 calls and a profile window (as phase
   16): c5 with fusion="tops" at 2048 windows in both return_spectra
   modes (kernel 4 and kernel 6 once a call, no K4, no kernel 5; the
   median pair-sorted az/el within 2.0 deg, tests/test_tops.py's bound;
   the layers: front end, unembed, complex subspaces, accumulate,
   finalize, peaks), ULA-16 TOPS (S = 1024, F = 16, fractional bandwidth
   0.4, 1024 windows) at K = 2 on 65/115 deg and at K = 3 on 45/80/120
   deg (the Jacobi λ_min), medians within 2.0 deg; c5 incoherent at
   compute_dtype bfloat16 and int8 and hierarchical + bfloat16 (K4, the
   quantized scan as torch ops, no kernel 5), medians within 0.5 deg;
   c5 with subspace_method="eigh" at 8 windows (reduced depth: cuSOLVER's
   batched Jacobi eigh of F·B = 128 matrices of 128x128 takes ~0.25 s a
   call), median within 0.5 deg; the TOPS cells and c5 eigh against the
   CPU (32, 16 and 8 windows, within 5e-3 deg).
20. the rest of the sharded pipeline on ranks of this card (spawn_ranks,
   gloo, as phase 14), one launch a mesh shape: on MeshSpec(2, 1) c4 at
   T = 2^21 with MUSIC, min-norm, root-MUSIC, ESPRIT and Unitary ESPRIT
   under halo_impl="pallas" (kernel 9's window entry, K4, K2, kernel
   13), c4 with 8 beams and c4 under "jacobi" (the general path: kernel
   8, K4 / eigh), and c5 cssm
   (kernel 4, K4, K3; c5's 16471-point grid does not split in two); c5
   incoherent on MeshSpec(1, 2) and (2, 2) (each rank kernel 4 on its
   block, K4, kernel 5 on its 8 or 16 subbands, one psum, kernel 6) and
   c5 TOPS on (1, 2) (kernel 4, the psum of Σ CᴴC, kernel 6), and on
   (1, 2) phase 11c's ULA-16 scene under cssm and cssm_auto (the psum of
   the focused sums, then K3 on each rank's half of the 180-point grid
   into the O(k) merge; cssm_auto's psums of the capture means and the
   coarse spectra); c5 at T = 2^20 (1024 windows). Each case driven
   once with every count from zero on every rank (its plan all kernels,
   each launched, no other; kernel 6 in its planned form), then 3 calls
   timed (the slowest rank of each, every rank at once); its angles
   within 5e-3 deg of the single-card port on the same capture (the
   jacobi case against eigh, the beamspace case against a cold subspace:
   the sharded general path takes both, as the reference's), every c4
   window within 0.5 deg of the scene, the c5 median within 0.5 deg and
   the ULA-16 median within 2 deg (phase 11c's limit), root-MUSIC's
   windows that take one source twice counted (C.3) and held out of the
   comparison.
   The EP psum of c5 incoherent and TOPS is timed inside the call, in 3
   more calls with a span around it (the grid ranks met first).
21. the host side (`host_phase`), in a temporary directory: the commands
   of `python -m doa_tpu_torch` run in this process (cli.main) on the
   card, each command's wall time logged: simulate → estimate on c2
   (32768 samples; the medians within 0.5 deg of 60/110 and within 1e-3
   deg of `estimate --device cpu` on the same file) and on c4 (2^21
   samples, 4095 windows, within 0.5 deg); tests/test_cli.py's
   calibration workflow (calibrate-phase, calibrate-elements, a
   calibrated c2 estimate within 1.5 deg); `track` on a moving-emitter
   c4 capture of 2^21 samples (the tracker kernel's main path, its
   launches counted from zero: one); a 2-SNR, 2-trial `evaluate` on c2.
   The tracker kernel (csrc/track.cu) bit-equal to its plain version on
   the card over the first 512 windows of that capture's peaks and to the
   CPU's plain run over all 4095 (NaN masks and final states too), and
   on three made scenes against both (`track_scenes`: NaN angles and
   values; tied values, signed zeros and equal costs; 32 slots and 32
   detections); the
   tracks within 1.5 deg of both trajectories over the second half; the
   kernel's ms at 4095 windows (median of 10) against the plain
   version's on the card (one call: 5.4 s), and both at 512 (median of
   10).
   The track state at window 2048 through save_stream_state and
   load_stream_state back onto the card resumes bit-equal to the
   uninterrupted run. The streaming driver (run_iter and its thread) on
   the card's c4 pipeline at 2^20 samples in 8 blocks: within 0.01 deg of
   the offline call, counts and escalations summed. NativeUdpSource
   (the C++ framer's drain, built with g++) → driver → pipeline over
   loopback: 4 blocks of 2^14 samples, no datagram lost, every window
   within 1 deg; one loopback_rate_bench line (a host figure). Timer.fence
   on a card result and trace_to writing a trace file.

Each kernel record gives its bound (the larger of its bytes over
3.35 TB/s and the FP32 operations the function needs over 67 TFLOP/s,
int8 products over 1979 TOP/s, the three TF32 products of the fusion
kernel and K3 over 495 TFLOP/s with the FP32 figure beside as
bound_fp32_ms, the published H100 peaks; a symmetric or Hermitian Gram
counts the half its output determines) and the time of one PyTorch call
computing the same function (library_ms; null where there is none; K3's
record gives the FP32 product alone as product_ms, and its figures at c5
cssm's shapes as the keys ending in _c5_cssm; K2's record gives its
tensor-core form's count as tc_launches, both forms' times as by_form
(kernel 11's and kernel 6's records their forms' launches and times),
the unfused route's as unfused_ms and its c3 and c2 figures in
by_shape). The last two lines: one
JSON object with the kernels, then {"ok": true, "device": {...}}.
"""

import dataclasses
import functools
import importlib
import json
import math
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
THETA = (70.0, 110.0)      # planted truth (bench.py's scene)
CYCLES = (5, 9)            # tone frequencies, cycles per PERIOD samples
PERIOD = 1024
SNR_DB = 10.0
T_MAIN = 1 << 24
T_PRESET = 1 << 20
ANGLE_TOL = 0.5            # degrees, every window (bench.py tripwire)
C5_TRUTH = ((-20.0, 30.0), (35.0, 60.0))   # planted (az, el), validate_tpu
C5_BW = 0.5                # each source's band, centred on 0 (exp_r5.py)
T_C5 = 1 << 21             # 2048 windows of 1024 samples
T_C5_SMALL = 32 * 1024     # the card against the CPU
C5_ANGLE_TOL = 0.5         # degrees, the median window
B_DEN_CPU = 4096           # windows of K2/K3's plain den, card against CPU
KERNEL_KEYS = ("name", "route", "source", "replaces", "launches",
               "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
               "library_ms")
SOURCES = ("cov_gram", "music_scan", "subspace", "wideband_cov",
           "wideband_scan", "peaks2d", "covariance", "subspace_ns", "ring",
           "track")
# the published H100 SXM peaks (NVIDIA's data sheet): HBM3 bytes/s, FP32
# FLOP/s outside the tensor cores, int8 OP/s (the card's exact integer
# rate, on its tensor cores: the bound of a product of int8 inputs even
# where a kernel multiplies them on the CUDA cores), and dense TF32 FLOP/s
# on the tensor cores
H100_BYTES_PER_S = 3.35e12
H100_FP32_PER_S = 67e12
H100_INT8_PER_S = 1979e12
H100_TF32_PER_S = 495e12


def log(msg):
    print(msg, flush=True)


def fail(msg):
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    stop_resource_tracker()
    sys.exit(1)


def stop_resource_tracker():
    """End multiprocessing's resource tracker, if this process started
    one. Phase 14's ranks are spawned processes, and spawning starts the
    tracker, a process that would otherwise outlive this one: it exits
    only once it reads the end of its pipe. Waits for it to exit. Call it
    when no queue or lock of multiprocessing is alive any more (the
    collection first frees those still in reference cycles: each
    unregisters from the tracker as it goes, and one freed after the
    tracker ended would start another)."""
    rt_mod = sys.modules.get("multiprocessing.resource_tracker")
    if rt_mod is None:
        return
    import gc
    gc.collect()
    rt = rt_mod._resource_tracker
    if getattr(rt, "_pid", None) is None:
        return
    if hasattr(rt, "_stop"):
        rt._stop()
    else:                   # an older 3.12: what _stop does
        os.close(rt._fd)
        rt._fd = None
        os.waitpid(rt._pid, 0)
        rt._pid = None


def live_children():
    """→ ["pid: command line"] of this process's children still running
    (a zombie, ended but not yet reaped, is not running)."""
    me, out = os.getpid(), []
    for p in os.listdir("/proc"):
        if not p.isdigit():
            continue
        try:
            with open(f"/proc/{p}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
            if int(fields[1]) != me or fields[0] == "Z":
                continue
            with open(f"/proc/{p}/cmdline", "rb") as f:
                cmd = f.read().replace(b"\0", b" ").decode(errors="replace")
            out.append(f"{p}: {cmd.strip()}")
        except (OSError, IndexError, ValueError):
            pass                            # ended while we looked
    return out


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0]


def make_scene(torch, T, N, device, seed=0):
    """The planted scene as the interleaved capture x f32[T, 2N]: two
    equal-power tones at THETA, 10 dB SNR per element, unit-normal noise on
    re and im, made on the device from an explicit generator. Phases use
    t mod PERIOD, exact in f32."""
    from doa_tpu_torch.ops.steering import _ula_steering_np

    a = _ula_steering_np(THETA, N, 0.5)                  # (2, N) c64
    amp = math.sqrt(2.0 * 10 ** (SNR_DB / 10.0))
    mix = torch.zeros((4, N, 2), dtype=torch.float32)
    for k in range(2):
        ar = torch.from_numpy(a[k].real.astype("float32")) * amp
        ai = torch.from_numpy(a[k].imag.astype("float32")) * amp
        # e^{jωt}·a = (cos + j sin)(ar + j ai)
        mix[2 * k, :, 0], mix[2 * k, :, 1] = ar, ai
        mix[2 * k + 1, :, 0], mix[2 * k + 1, :, 1] = -ai, ar
    mix = mix.reshape(4, 2 * N).to(device)
    t = (torch.arange(T, device=device) % PERIOD).to(torch.float32)
    w = torch.tensor([2 * math.pi * c / PERIOD for c in CYCLES],
                     device=device)
    ph = t[:, None] * w[None, :]                         # (T, 2)
    F = torch.stack([ph[:, 0].cos(), ph[:, 0].sin(),
                     ph[:, 1].cos(), ph[:, 1].sin()], dim=-1)
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((T, 2 * N), generator=gen, device=device)
    x += F @ mix
    return x


def angle_err(torch, angles):
    a = torch.sort(angles, dim=-1).values
    truth = torch.tensor(THETA, device=a.device)
    if not bool(torch.isfinite(a).all()):
        fail("non-finite angles")
    return float((a - truth).abs().max())


def time_ms(torch, fn, reps=10, warm=2):
    """Median ms of fn() over reps calls, CUDA events around each."""
    ts = call_times(torch, fn, reps, warm)
    return ts[len(ts) // 2]


def call_times(torch, fn, reps, warm):
    """Sorted ms of reps calls of fn() after warm calls (CUDA events)."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        ts.append(e0.elapsed_time(e1))
    return sorted(ts)


def turns_ms(torch, *fns):
    """ms of each fn measured in turns: f0 … fn, fn … f0; each figure
    is the mean of its two medians."""
    first = [time_ms(torch, f) for f in fns]
    last = [time_ms(torch, f) for f in reversed(fns)][::-1]
    return [0.5 * (a + b) for a, b in zip(first, last)]


def pair_ms(torch, kernel, plain):
    """(kernel ms, plain ms) measured in turns: plain, kernel, kernel,
    plain."""
    p, k = turns_ms(torch, plain, kernel)
    return k, p


def check(cond, msg):
    if not cond:
        fail(msg)


def bound(nbytes, flops, peak=H100_FP32_PER_S):
    """The least time the card could take: the larger of `nbytes` (each
    input read once, each output written once) over the memory rate and
    `flops` (the least arithmetic the function needs: a symmetric or
    Hermitian Gram counts only the half its output determines) over
    `peak`, the card's rate for the inputs' type (FP32 unless given)
    → {"bound_ms", "bound_by"}."""
    tb = nbytes / H100_BYTES_PER_S * 1e3
    tf = flops / peak * 1e3
    return {"bound_ms": max(tb, tf),
            "bound_by": "bytes" if tb >= tf else "operations"}


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def fft_gram_bound(M, F, N, g):
    """Kernel 4's bound for M frames of F subbands of N elements, chunks
    of g: the frames read and E f32[F, M // g, 2N, 2N] written once,
    against an F-point FFT (5·F·log2 F) per frame and element and the
    Hermitian Grams (4·g·N² a chunk and subband: the half)."""
    n = M // g
    return bound(M * F * 2 * N * 4 + F * n * 4 * N * N * 4,
                 5 * F * math.log2(F) * M * N + 4 * g * N * N * F * n)


def scan_flops(B, G, k2, n2):
    """den = ‖a‖² − ‖Vᵀã‖² for B windows × G bins: the (k2 × n2)
    products, the squares and sums, the subtraction and reciprocal."""
    return 2 * B * G * k2 * (n2 + 1) + 2 * B * G


# kernel 4 exact: (F, N, g, chunks, offset in floats of the view into
# its buffer): every register-tile form; g = 100 runs two stages at
# N = 64; g = 1 and 3, where a stage holds many chunks and a block walks
# many units; a chunk count that is no multiple of the resident blocks;
# views one complex element in, which break a bulk copy's 16 bytes
FFT_GRAM_EXACT = ((1, 64, 100, 5, 0), (2, 16, 16, 5, 0), (4, 64, 100, 5, 0),
                  (4, 6, 16, 5, 0), (4, 5, 16, 5, 0), (4, 64, 1, 2000, 0),
                  (4, 64, 3, 700, 0), (4, 16, 64, 1009, 0), (2, 6, 7, 60, 2),
                  (1, 5, 5, 70, 2))
GRAM_GS = (1, 3, 4, 7, 512, 1024)   # K1 exact: chunk lengths
# K3 exact beyond the headline's (4, 32): (2K, 2N, B, G); the last two
# are beyond the tensor-core form's shapes and run the CUDA-core form
K3_EXACT = ((6, 24, 1000, 1001), (4, 128, 2048, 16471),
            (10, 32, 1000, 1001), (4, 240, 100, 1001))
GRAM_WIDTHS = (6, 16, 30, 32, 64)   # every register-tile form
T_WSUM = 1 << 24                    # window_sums alone at c4's shape


def gram_views(x, n2, g, n):
    """K1's inputs from x[rows, n2]: n chunks of g rows at row 0, at row 1
    (int8 or bf16 rows then break the 16-byte alignment of a bulk copy)
    and at element 1 of the flat buffer (the kernel's element-load
    route: its rows are not aligned to a register tile's vector)."""
    flat = x.reshape(-1)
    return (("row 0", x[:n * g]), ("row 1", x[1:1 + n * g]),
            ("element 1", flat[1:1 + n * g * n2].view(n * g, n2)))


def gram_parity(torch, dev, x, card):
    """Phase 3's K1 part → its kernel record (launches filled in after the
    main path). x: the headline capture f32[T_MAIN, 32] on the card."""
    from doa_tpu_torch.cpx import fp32_matmuls
    from doa_tpu_torch.io.native import quantize_interleaved_int8
    from doa_tpu_torch.ops.cuda import cov_embedded as ce

    gen = torch.Generator(device=dev).manual_seed(1)
    # exact: integer-valued samples, every partial sum an integer below
    # 2^24, so FP32 sums are exact in any order. Every 2N the kernel takes
    # (its 4x4 and 2x2 register-tile forms), chunks from 1 row to 1024,
    # and views that start off the 16-byte alignment
    for n2 in GRAM_WIDTHS:
        for g in GRAM_GS:
            n = min(64 * 1024 // g, 4096)
            xi = torch.randint(-20, 21, (n * g + 1, n2), generator=gen,
                               device=dev)
            for dt in (torch.float32, torch.bfloat16, torch.int8):
                views = gram_views(xi.to(dt), n2, g, n)
                for where, xk in views if g in (7, 1024) else views[:1]:
                    d = (ce.chunk_grams_uhat(xk, g)
                         - ce.chunk_grams_uhat_plain(xk, g)
                         ).abs().max().item()
                    log(f"K1 exact-input 2N={n2} g={g} {dt} at {where}: "
                        f"max|kernel-plain| = {d!r} (must be 0)")
                    check(d == 0.0, f"K1 2N={n2} g={g} {dt} at {where} "
                                    f"differs on exact inputs")
    # at the main path's shape on the planted scene
    g = 1024
    Uk = ce.chunk_grams_uhat(x, g)
    Up = ce.chunk_grams_uhat_plain(x, g)
    err = (Uk - Up).abs().max().item()
    scale = Up.abs().max().item()
    log(f"K1 f32 scene T={x.shape[0]}: max|kernel-plain| = {err!r}, "
        f"max|U| = {scale!r}, tol 1e-5*max|U|")
    check(err <= 1e-5 * scale, "K1 f32 disagrees with plain")
    del Up
    xb = x.to(torch.bfloat16)
    eb = (ce.chunk_grams_uhat(xb, g)
          - ce.chunk_grams_uhat_plain(xb, g)).abs().max().item()
    log(f"K1 bf16 scene: max|kernel-plain| = {eb!r}, tol 1e-5*max|U|")
    check(eb <= 1e-5 * scale, "K1 bf16 disagrees with plain")
    xq = quantize_interleaved_int8(x)[0]
    eq = (ce.chunk_grams_uhat(xq, g)
          - ce.chunk_grams_uhat_plain(xq, g)).abs().max().item()
    log(f"K1 int8 scene: max|kernel-plain| = {eq!r} (must be 0)")
    check(eq == 0.0, "K1 int8 is not bit-exact")

    # times: kernel, plain version and one torch.bmm of the f32 chunks in
    # turns; the bound counts the input read, U written and the
    # symmetric Gram's half (n2·(n2+1)/2 entries, 2 operations a sample
    # each) at the card's rate for the input type
    T, n2 = x.shape
    times = {}
    for tag, xk, gk in (("f32", x, 1024), ("bf16", xb, 1024),
                        ("int8", xq, 1024), ("f32 g=512", x, 512),
                        ("f32 g=8", x, 8)):
        xv = x.view(-1, gk, n2)
        with fp32_matmuls():
            k_ms, p_ms, lib_ms = turns_ms(
                torch, lambda: ce.chunk_grams_uhat(xk, gk),
                lambda: ce.chunk_grams_uhat_plain(xk, gk),
                lambda: torch.bmm(xv.transpose(1, 2), xv))
        b = bound(nbytes(xk) + (T // gk) * n2 * n2 * 4, T * n2 * (n2 + 1),
                  H100_INT8_PER_S if tag == "int8" else H100_FP32_PER_S)
        times[tag] = dict(ms=k_ms, plain_ms=p_ms, library_ms=lib_ms, **b)
        log(f"K1 time {tag} [{T}, {n2}] g={gk}: kernel {k_ms:.4f} ms, plain "
            f"{p_ms:.4f} ms, library (one f32 torch.bmm of the chunks) "
            f"{lib_ms:.4f} ms, bound {b['bound_ms']:.4f} ms "
            f"({b['bound_by']})  [{card}]")
    del xb, xq
    # the prefix-sum windows alone at c4's shape (S = 1024, overlap 512:
    # 32768 chunks of 512, windows of 2 chunks at stride 1); a measurement
    # only, for ROADMAP's overlap > 0 item
    Uc = torch.randn((T_WSUM // 512, n2, n2), generator=gen, device=dev)
    B = (T_WSUM - 1024) // 512 + 1
    ws_ms = time_ms(torch, lambda: ce.window_sums(Uc, B, 2, 1))
    wb = bound(nbytes(Uc) + B * n2 * n2 * 4, 0)
    log(f"window_sums alone (c4: {Uc.shape[0]} chunks, {B} windows, n_win "
        f"2, stride 1): {ws_ms:.4f} ms, bytes bound {wb['bound_ms']:.4f} ms "
        f" [{card}]")
    del Uc
    return dict(
        name="chunk_gram", route="cuda",
        source="doa_tpu_torch/csrc/cov_gram.cu",
        replaces="doa_tpu/ops/pallas/cov_embedded.py:191",
        max_abs_err=err, **times["f32"],
        by_input={k: v for k, v in times.items() if k != "f32"},
        window_sums_c4_ms=ws_ms)


def kernel_parity(torch, dev, x, Vt, At, nrm, card):
    """Phase 3 → the kernel records for the JSON line (launches filled in
    after the main path)."""
    from doa_tpu_torch.cpx import fp32_matmuls
    from doa_tpu_torch.ops.cuda import cov_embedded as ce
    from doa_tpu_torch.ops.cuda import music_scan as ms

    recs = {"chunk_gram": gram_parity(torch, dev, x, card)}
    gen = torch.Generator(device=dev).manual_seed(1)

    # K3 / K2 exact: Vt in quarter steps, A integer, den = nrm − Σ y² all
    # multiples of 1/16 far below 2^24 — exact in FP32 in any order, so
    # den, P, Pn = dmin/den, the peak picks and the refine agree bit for
    # bit (ties and plateaus included)
    Bx, Gx = 4096, 1024
    Vq = torch.randint(-2, 3, (Bx, 4, 32), generator=gen,
                       device=dev).float() / 4
    Aq = torch.randint(-3, 4, (Gx, 32), generator=gen, device=dev).float()
    nq = 2304.0 + torch.randint(0, 64, (Gx,), generator=gen,
                                device=dev).float()
    d3 = (ms.music_scan(Vq, Aq, nq) - ms.music_scan_plain(Vq, Aq, nq)
          ).abs().max().item()
    log(f"K3 exact-input (2K, 2N) = (4, 32): max|kernel-plain| = {d3!r} "
        f"(must be 0)")
    check(d3 == 0.0, "K3 differs on exact inputs")
    # K3's tensor-core form at c3's (2K, 2N) = (6, 24) (2N padded to 32,
    # 32 bins a warpgroup; a ragged B and an odd G) and c5's 2N = 128
    for k2, n2, Bq, Gq in K3_EXACT:
        Vs = torch.randint(-2, 3, (Bq, k2, n2), generator=gen,
                           device=dev).float() / 4
        As = torch.randint(-3, 4, (Gq, n2), generator=gen,
                           device=dev).float()
        ns = 300000.0 + torch.randint(0, 64, (Gq,), generator=gen,
                                      device=dev).float()
        d = (ms.music_scan(Vs, As, ns) - ms.music_scan_plain(Vs, As, ns)
             ).abs().max().item()
        log(f"K3 exact-input (2K, 2N) = ({k2}, {n2}), B={Bq}, G={Gq}: "
            f"max|kernel-plain| = {d!r} (must be 0)")
        check(d == 0.0, f"K3 differs on exact inputs at ({k2}, {n2})")
    for k in (1, 2, 4):
        for refine in (False, True):
            vk, lk = ms.music_scan_peaks(Vq, Aq, k, 0.0, 180.0, refine, nq)
            vp, lp = ms.music_scan_peaks_plain(Vq, Aq, k, 0.0, 180.0,
                                               refine, nq)
            dv = (vk - vp).abs().max().item()
            dl = (lk - lp).abs().max().item()
            log(f"K2 exact-input k={k} refine={refine}: max|dval| = {dv!r}, "
                f"max|dloc| = {dl!r} (must be 0)")
            check(dv == 0.0 and dl == 0.0, "K2 differs on exact inputs")
    k2_exact(torch, dev, gen)

    # K3 / K2 at the main path's shapes on the scene's subspaces
    e3, k3 = k3_scene(torch, "headline", Vt, At, nrm, card)
    plain_den_card_vs_cpu(torch, (Vq, Aq, nq), (Vt[:B_DEN_CPU], At, nrm))
    # K3's CUDA-core form (2K of 10 to 16) at the headline's B, 2N and G,
    # on random orthonormal subspaces at 2K = 10 (its bound: the FP32
    # figure)
    Q = torch.linalg.qr(torch.randn((Vt.shape[0], Vt.shape[2], 10),
                                    generator=gen, device=dev)).Q
    k3_scene(torch, "headline at 2K = 10 (CUDA-core form)",
             Q.transpose(1, 2).contiguous(), At, nrm, card)
    del Q
    recs["music_scan"] = dict(
        name="music_scan", route="cuda",
        source="doa_tpu_torch/csrc/music_scan.cu",
        replaces="doa_tpu/ops/pallas/music_scan.py:56",
        max_abs_err=e3, library_ms=None, **k3)
    e2, k2_rec = k2_scene(torch, "headline", Vt, At, nrm, 2, THETA, card)
    recs["music_scan_peaks"] = dict(
        name="music_scan_peaks", route="cuda",
        source="doa_tpu_torch/csrc/music_scan.cu",
        replaces="doa_tpu/ops/pallas/music_scan.py:138",
        max_abs_err=e2, library_ms=None, **k2_rec)

    # K4 on the scene's windows: the pipeline's warm refine (3 rounds from
    # the capture-mean subspace) and a cold 8-round start; rsqrt and the
    # sums' order differ, so projectors VᵀV are held to 1e-5
    from doa_tpu_torch.ops import cpx_ops
    with fp32_matmuls():
        E = ce.cov_embedded(x, torch.ones(16, device=dev),
                            torch.zeros(16, device=dev), N=16,
                            snapshot_size=1024)
        Em = E.mean(0, keepdim=True)
        init = cpx_ops.mgs_iterate_plain(Em, 2, 8)[0]
        init = init.expand(E.shape[0], -1, -1)
        e4 = max(k4_scene(torch, "headline", E, 2, 3, init),
                 k4_scene(torch, "headline", E, 2, 8, None),
                 k4_scene(torch, "headline mean", Em, 2, 8, None))
        t4 = k4_times(torch, "headline", E, 2, 3, init, card)
        t4m = k4_times(torch, "headline mean", Em, 2, 8, None, card)
    recs["mgs_iterate"] = dict(
        name="mgs_iterate", route="cuda",
        source="doa_tpu_torch/csrc/subspace.cu",
        replaces="doa_tpu/ops/cpx_ops.py:347", max_abs_err=e4,
        **{k: t4[k] for k in ("ms", "plain_ms", "product_ms", "bound_ms",
                              "bound_by")},
        library_ms=None, by_shape={"headline": t4, "headline mean": t4m})
    return recs


def plain_den_card_vs_cpu(torch, exact, scene):
    """The plain den of K3 and K2 (music_den_plain, the yardstick both
    kernels are held to) on the card against the same function on the
    CPU (ROADMAP C.4): bit-equal on the exact inputs; on the first
    B_DEN_CPU windows of the headline's subspaces within one FP32 unit of
    max‖a‖² (y is rounded once from a float64 sum on either device, so
    the two differ only where a sum sits within float64 noise of an FP32
    rounding boundary), with the number of bins that differ at all."""
    from doa_tpu_torch.ops.cuda import music_scan as ms

    for tag, (V, A, n) in (("exact", exact), ("headline", scene)):
        d = (ms.music_den_plain(V, A, n).cpu()
             - ms.music_den_plain(V.cpu(), A.cpu(), n.cpu())).abs()
        tol = 0.0 if tag == "exact" else 2.0 ** -23 * n.max().item()
        log(f"plain den card vs CPU, {tag} ({V.shape[0]} windows, G="
            f"{A.shape[0]}): max|card - CPU| = {d.max().item()!r} (tol "
            f"{tol!r}), {int((d > 0).sum())} of {d.numel()} bins differ")
        check(d.max().item() <= tol,
              f"the card's plain den disagrees with the CPU's ({tag})")


def k3_scene(torch, tag, Vt, At, nrm, card):
    """K3 on a path's own subspaces: den within 1e-5·max‖a‖² of the plain
    version's, then timed in turns with its plain version and one FP32
    product Vt·Ãᵀ (the product alone: no single torch call computes den)
    → (the error, {ms, plain_ms, product_ms, bound_ms, bound_by,
    bound_fp32_ms}). The kernel is called as the pipelines call it, with
    the grid's A' made once; its bound is the three TF32 products at the
    TF32 rate (or the bytes), its FP32 figure beside."""
    from doa_tpu_torch.cpx import fp32_matmuls
    from doa_tpu_torch.ops.cuda import music_scan as ms

    (B, k2, n2), G = Vt.shape, At.shape[0]
    tiles = ms.scan_tiles(At, k2)
    Pk = ms.music_scan(Vt, At, nrm, tiles)
    e3 = (1.0 / Pk - 1.0 / ms.music_scan_plain(Vt, At, nrm)).abs().max()
    e3, tol3 = e3.item(), 1e-5 * nrm.max().item()
    log(f"K3 {tag} (2N, 2K) = ({n2}, {k2}), G={G}, {B} windows: "
        f"max|den kernel - den plain| = {e3!r}, tol 1e-5*max‖a‖² = "
        f"{tol3!r}")
    check(e3 <= tol3, f"K3 disagrees with plain at {tag}'s shapes")

    def product():
        with fp32_matmuls():
            return torch.matmul(Vt, At.T)
    p_ms, k_ms, prod_ms = turns_ms(
        torch, lambda: ms.music_scan_plain(Vt, At, nrm),
        lambda: ms.music_scan(Vt, At, nrm, tiles), product)
    moved = nbytes(Vt, At, nrm, Pk)
    rec = dict(ms=k_ms, plain_ms=p_ms, product_ms=prod_ms,
               **bound(moved, 3 * 2 * B * k2 * n2 * G, H100_TF32_PER_S),
               bound_fp32_ms=bound(moved, scan_flops(B, G, k2, n2))[
                   "bound_ms"])
    log(f"K3 time at {tag}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, "
        f"one FP32 torch.matmul(Vt, At.T) (product only, not the same "
        f"function) {prod_ms:.4f} ms; bound {rec['bound_ms']:.4f} ms (3 "
        f"TF32 products), {rec['bound_fp32_ms']:.4f} ms at the FP32 rate  "
        f"[{card}]")
    return e3, rec


# K2 exact, both forms: the (2K, 2N, G) of its CPU model (the headline's,
# c3's, c2's, a ULA-4 at K = 1); and through the wrapper the shapes it
# gives the CUDA-core form: 2K = 10, and a G past the den tile
K2_EXACT = ((4, 32, 1024), (6, 24, 1024), (4, 16, 181), (2, 8, 250))
K2_FMA_EXACT = ((10, 32, 1024), (4, 32, 2048))


def peak_rows(torch, dev, gen, G=181):
    """Den rows f32[9, G] for K2's peak rule: small integers, a plateau at
    the minimum, four equal isolated minima, a monotone row (no interior
    peak: the fallback), a flat row (value 1 at bin 0), a peak every
    other bin, the minimum at both edges; then bins 1e-5 of themselves
    above their right neighbour (1001, 1000.01, 1000 repeated), once at a
    normal dmin and once at FLT_MIN (an exact null, clamped), where those
    quotients are subnormal and round equal: peaks that a test in den
    alone would miss."""
    rows = torch.randint(2, 7, (9, G), generator=gen, device=dev).float()
    rows[1, 40:44] = 1.0
    rows[2, [5, 60, 120, 170]] = 1.0
    rows[3] = torch.arange(G, 0, -1, device=dev).float()
    rows[4] = 3.0
    rows[5, ::2] = 1.0
    rows[6, [0, G - 1]] = 0.5
    rows[7:] = 1000.0
    rows[7:, 1::3] = 1000.01
    rows[7:, 0::3] = 1001.0
    rows[7, 90] = 1.0
    rows[8, 90] = torch.finfo(torch.float32).tiny
    return rows


def k2_exact(torch, dev, gen):
    """K2 bit-equal to its plain version on exact inputs (quarter-step V,
    integer A, a constant nrm above every Σy², so den has plateaus and
    equal peaks; window 0 zero: a flat row, the fallback) at B = 1000 (a
    ragged last tile): both forms at K2_EXACT, k = 1 to 4, refine off and
    on, and on the den rows of peak_rows; the wrapper at K2_FMA_EXACT,
    where it must take the CUDA-core form."""
    from doa_tpu_torch.ops.cuda import music_scan as ms

    def inputs(k2, n2, G):
        Vq = torch.randint(-2, 3, (1000, k2, n2), generator=gen,
                           device=dev).float() / 4
        Vq[0] = 0.0
        Aq = torch.randint(-3, 4, (G, n2), generator=gen, device=dev).float()
        return Vq, Aq, torch.full((G,), 300000.0, device=dev)

    def diff(a, b):
        return max((x - y).abs().max().item() for x, y in zip(a, b))

    for k2, n2, G in K2_EXACT:
        Vq, Aq, nq = inputs(k2, n2, G)
        forms = {"tensor-core": (ms._peaks_tc, ms.scan_tiles(Aq, k2)),
                 "CUDA-core": (ms._peaks_fma, Aq.T.contiguous())}
        worst = {form: 0.0 for form in forms}
        for k in (1, 2, 3, 4):
            for refine in (False, True):
                plain = ms.music_scan_peaks_plain(Vq, Aq, k, 0.0, 180.0,
                                                  refine, nq)
                for form, (fn, op) in forms.items():
                    d = diff(fn(Vq, op, nq, k, 0.0, 180.0 / (G - 1), refine),
                             plain)
                    worst[form] = max(worst[form], d)
                    check(d == 0.0, f"K2's {form} form differs on exact "
                          f"inputs at (2K, 2N, G) = ({k2}, {n2}, {G}), k={k}, "
                          f"refine={refine}")
        log(f"K2 exact-input (2K, 2N, G) = ({k2}, {n2}, {G}), B=1000, k=1-4, "
            f"refine off and on: max|kernel - plain| (vals, locs) "
            + ", ".join(f"{f} form {w!r}" for f, w in worst.items())
            + " (must be 0)")
    # den rows made to order: with Vt = 0, den = max(nrm, tiny), so each
    # row of peak_rows, given as nrm, is every window's den
    rows = peak_rows(torch, dev, gen)
    Vz = torch.zeros((64, 4, 32), device=dev)
    Az = torch.ones((rows.shape[1], 32), device=dev)
    worst = 0.0
    for r, nr in enumerate(rows):
        for k in (1, 2, 3, 4):
            for refine in (False, True):
                plain = ms.music_scan_peaks_plain(Vz, Az, k, 0.0, 180.0,
                                                  refine, nr)
                for form, fn, op in (
                        ("tensor-core", ms._peaks_tc, ms.scan_tiles(Az, 4)),
                        ("CUDA-core", ms._peaks_fma, Az.T.contiguous())):
                    d = diff(fn(Vz, op, nr, k, 0.0, 180.0 / (rows.shape[1]
                                                            - 1), refine),
                             plain)
                    worst = max(worst, d)
                    check(d == 0.0, f"K2's {form} form differs on den row "
                          f"{r} of peak_rows, k={k}, refine={refine}")
    log(f"K2 on the {rows.shape[0]} den rows of peak_rows (ties, plateaus, "
        f"fallbacks, quotients one rounding apart, subnormal quotients), "
        f"k=1-4, refine off and on, both forms: max|kernel - plain| "
        f"{worst!r} (must be 0)")
    for k2, n2, G in K2_FMA_EXACT:
        Vq, Aq, nq = inputs(k2, n2, G)
        tc0, all0 = (ms.music_scan_peaks.tc_launches,
                     ms.music_scan_peaks.launches)
        worst = 0.0
        for k in (1, 2, 3, 4):
            for refine in (False, True):
                d = diff(ms.music_scan_peaks(Vq, Aq, k, 0.0, 180.0, refine,
                                             nq),
                         ms.music_scan_peaks_plain(Vq, Aq, k, 0.0, 180.0,
                                                   refine, nq))
                worst = max(worst, d)
                check(d == 0.0, f"K2 differs on exact inputs at (2K, 2N, G) "
                      f"= ({k2}, {n2}, {G}), k={k}, refine={refine}")
        log(f"K2 exact-input (2K, 2N, G) = ({k2}, {n2}, {G}) through the "
            f"wrapper: max|kernel - plain| {worst!r} (must be 0); launches "
            f"{ms.music_scan_peaks.launches - all0}, of the tensor-core "
            f"form {ms.music_scan_peaks.tc_launches - tc0} (must be 0)")
        check(ms.music_scan_peaks.tc_launches == tc0
              and ms.music_scan_peaks.launches == all0 + 8,
              f"K2 did not take its CUDA-core form at ({k2}, {n2}, {G})")


def k2_scene(torch, tag, Vt, At, nrm, k, truth, card):
    """K2 on a path's own subspaces, called as the pipelines call it (its
    grid operand made once): each window's sorted peak angles within
    0.01° of its plain version's and within ANGLE_TOL of the planted
    truth; then timed in turns with its plain version, its CUDA-core form
    on the same inputs and the unfused route (K3, normalise,
    find_local_max) → (the error, {ms, plain_ms, bound_ms, bound_by,
    bound_fp32_ms, by_form, unfused_ms}). Its bound is the three TF32
    products at the TF32 rate (or the bytes), the FP32 figure beside."""
    from doa_tpu_torch.ops.cuda import music_scan as ms
    from doa_tpu_torch.ops.peaks import find_local_max

    (B, k2, n2), G = Vt.shape, At.shape[0]
    tiles = ms.peaks_tiles(At, k2)
    vk, lk = ms.music_scan_peaks(Vt, At, k, 0.0, 180.0, True, nrm, tiles)
    _, lp = ms.music_scan_peaks_plain(Vt, At, k, 0.0, 180.0, True, nrm)
    # equal-power sources: which peak ranks first may flip on rounding,
    # so each window's sorted angles are compared
    e2 = (lk.sort(-1).values - lp.sort(-1).values).abs().max().item()
    et = sorted_err(torch, lk, truth)
    log(f"K2 {tag} (2K, 2N, G) = ({k2}, {n2}, {G}), k={k}, {B} windows: "
        f"max|sorted loc kernel - plain| = {e2!r} deg (tol 0.01); max "
        f"sorted angle error vs the planted {truth} {et!r} deg (limit "
        f"{ANGLE_TOL})")
    check(e2 <= 0.01, f"K2 disagrees with plain at {tag}'s shapes")
    check(et <= ANGLE_TOL, f"K2 misses the planted scene at {tag}")
    At_T = At.T.contiguous()
    nrm = nrm.contiguous()
    dx = 180.0 / (G - 1)
    k3_tiles = ms.scan_tiles(At, k2)

    def unfused():
        P = ms.music_scan(Vt, At, nrm, k3_tiles)
        return find_local_max(P / P.max(-1, keepdim=True).values, k, 0.0,
                              180.0, refine=True)
    p_ms, tc_ms, fma_ms, un_ms = turns_ms(
        torch, lambda: ms.music_scan_peaks_plain(Vt, At, k, 0.0, 180.0,
                                                 True, nrm),
        lambda: ms.music_scan_peaks(Vt, At, k, 0.0, 180.0, True, nrm,
                                    tiles),
        lambda: ms._peaks_fma(Vt, At_T, nrm, k, 0.0, dx, True), unfused)
    moved = nbytes(Vt, At, nrm, vk, lk)
    rec = dict(ms=tc_ms, plain_ms=p_ms,
               **bound(moved, 3 * 2 * B * k2 * n2 * G, H100_TF32_PER_S),
               bound_fp32_ms=bound(moved, scan_flops(B, G, k2, n2))[
                   "bound_ms"],
               by_form={"tensor-core": tc_ms, "CUDA-core": fma_ms},
               unfused_ms=un_ms)
    log(f"K2 time at {tag}: tensor-core form {tc_ms:.4f} ms, CUDA-core form "
        f"{fma_ms:.4f} ms, plain {p_ms:.4f} ms, unfused route (K3, "
        f"normalise, find_local_max) {un_ms:.4f} ms; bound "
        f"{rec['bound_ms']:.4f} ms (3 TF32 products), "
        f"{rec['bound_fp32_ms']:.4f} ms at the FP32 rate  [{card}]")
    return e2, rec


def show_plan(name, pipe, all_kernel=True):
    """Log a pipeline's call.plan; a preset's path must plan a kernel for
    every stage."""
    log(f"plan of {name}: {json.dumps(pipe.plan)}")
    if all_kernel:
        check("plain" not in pipe.plan.values(),
              f"{name} plans a plain stage on the card")


def mgs_bound(E, k2, rounds, *, cold):
    """K4's bound on E f32[B, n2, n2]: what the kernel runs a window,
    max(1, rounds − 1) applies W = Vt·E (2·n2²·k2 each) and its MGS passes
    (~4·k2²·n2 each: one over E's rows when cold, one after each apply but
    the last, two after the last, none when rounds = 1); E read once, Vt,
    W, Vt_prev written."""
    B, n2, _ = E.shape
    applies = max(1, rounds - 1)
    passes = int(cold) + (rounds if rounds > 1 else 0)
    return bound(nbytes(E) + 3 * B * k2 * n2 * 4,
                 B * (applies * 2 * n2 * n2 * k2 + passes * 4 * k2 * k2 * n2))


def k4_scene(torch, tag, E, K, rounds, init):
    """K4 against its plain version on a scene's windows: rsqrt and the
    sums' order differ, so projectors VᵀV are held to 1e-5 and W to 1e-5
    of max|W| → the projectors' max difference."""
    from doa_tpu_torch.ops import cpx_ops

    outk = cpx_ops.mgs_iterate(E, K, rounds, init)
    outp = cpx_ops.mgs_iterate_plain(E, K, rounds, init)
    dp = 0.0
    for lo in range(0, E.shape[0], 4096):
        a, b = outk[0][lo:lo + 4096], outp[0][lo:lo + 4096]
        dp = max(dp, (a.transpose(1, 2) @ a - b.transpose(1, 2) @ b
                      ).abs().max().item())
    dw = ((outk[1] - outp[1]).abs().max() / outp[1].abs().max()).item()
    log(f"K4 scene {tag} ({E.shape[0]} windows, (2N, 2K) = ({E.shape[-1]}, "
        f"{2 * K}), {'warm' if init is not None else 'cold'} {rounds} "
        f"rounds, {cpx_ops.mgs_form(E.shape[-1], 2 * K)} form): "
        f"max|projector kernel - plain| = {dp!r} (tol 1e-5), "
        f"max|W kernel - plain|/max|W| = {dw!r} (tol 1e-5)")
    check(dp <= 1e-5 and dw <= 1e-5, f"K4 disagrees with plain at {tag}")
    return dp


def k4_times(torch, tag, E, K, rounds, init, card):
    """K4 at `tag`'s shape (E f32[B, n2, n2], 2K = 2·K, `rounds`, warm from
    `init` or cold) timed in turns with its plain version and one FP32
    torch.matmul(Vt, E) (the apply's product alone, not the same
    function) → {ms, plain_ms, product_ms, form, bound_ms, bound_by}, an
    entry of K4's record's by_shape."""
    from doa_tpu_torch.cpx import fp32_matmuls
    from doa_tpu_torch.ops import cpx_ops

    Vt = cpx_ops.mgs_iterate(E, K, rounds, init)[0]

    def product():
        with fp32_matmuls():
            return torch.matmul(Vt, E)
    p_ms, k_ms, prod_ms = turns_ms(
        torch, lambda: cpx_ops.mgs_iterate_plain(E, K, rounds, init),
        lambda: cpx_ops.mgs_iterate(E, K, rounds, init), product)
    rec = dict(ms=k_ms, plain_ms=p_ms, product_ms=prod_ms,
               form=cpx_ops.mgs_form(E.shape[-1], 2 * K),
               **mgs_bound(E, 2 * K, rounds, cold=init is None))
    log(f"K4 time ({tag}: {'warm' if init is not None else 'cold'}, "
        f"{rounds} rounds, {E.shape[0]} windows of 2N={E.shape[-1]}, 2K="
        f"{2 * K}, {rec['form']} form): kernel {k_ms:.4f} ms, plain "
        f"{p_ms:.4f} ms, one FP32 torch.matmul(Vt, E) (product only, not "
        f"the same function) {prod_ms:.4f} ms, bound {rec['bound_ms']:.4f} "
        f"ms ({rec['bound_by']})  [{card}]")
    return rec


# K4 exact: (2K, 2N) of the block form (2N > 64) and of the group form,
# every group width L (4, 8, 16) and K2
K4_EXACT = ((2, 66), (4, 128), (8, 128), (6, 96), (2, 8), (4, 16), (4, 32),
            (6, 24), (8, 32), (2, 34), (6, 48), (8, 64))
B_K4_EXACT = 1001                   # 7 · 11 · 13 windows: ragged


def signed_permutations(torch, B, n2, gen, dev):
    """B windows f32[B, n2, n2], each a signed permutation: K4's exact
    inputs (every MGS dot product 0, every norm 1, every sum exact)."""
    perm = torch.argsort(torch.rand((B, n2), generator=gen, device=dev),
                         dim=-1)
    sign = torch.randint(0, 2, (B, n2), generator=gen,
                         device=dev).float() * 2 - 1
    Eq = torch.zeros((B, n2, n2), device=dev)
    Eq.scatter_(2, perm[..., None], sign[..., None])
    return Eq


def k4_exact(torch, dev, gen):
    """K4 bit-equal to mgs_iterate_plain on exact inputs (signed
    permutations) at each K4_EXACT shape, cold (1 and 8 rounds) and warm
    (3 rounds) from inits that are rows of E: one for all, one per group
    of 143 windows, one per window, and one expanded over the windows
    (stride 0)."""
    from doa_tpu_torch.ops import cpx_ops

    B = B_K4_EXACT
    for k2, n2 in K4_EXACT:
        Eq = signed_permutations(torch, B, n2, gen, dev)
        rows = Eq[:, :k2, :]
        cases = [("cold", 1, None), ("cold", 8, None),
                 ("one init", 3, rows[:1].clone()),
                 ("per group", 3, rows[::143].clone()),
                 ("per window", 3, rows.clone()),
                 ("expanded", 3, rows[:1].expand(B, -1, -1))]
        for start, rounds, ini in cases:
            outk = cpx_ops.mgs_iterate(Eq, k2 // 2, rounds, ini)
            outp = cpx_ops.mgs_iterate_plain(Eq, k2 // 2, rounds, ini)
            d = max((a - b).abs().max().item() for a, b in zip(outk, outp))
            log(f"K4 exact-input (2K, 2N) = ({k2}, {n2}), B={B}, {start}, "
                f"{rounds} rounds, {cpx_ops.mgs_form(n2, k2)} form: "
                f"max|kernel-plain| over Vt, W, Vt_prev = {d!r} (must be 0)")
            check(d == 0.0, f"K4 ({k2}, {n2}) {start} differs on exact "
                  f"inputs")


def headline_config():
    from doa_tpu_torch import (ArrayGeometry, DoaConfig, Estimator,
                               GridSpec1D)
    return DoaConfig(
        geometry=ArrayGeometry(kind="ula", num_elements=16,
                               norm_spacing=0.5),
        snapshot_size=1024, overlap=0, num_sources=2,
        estimators=(Estimator.MUSIC,), grid=GridSpec1D(num_points=1024),
        num_max_vals=2, power_schedule="e1", power_iters=8)


def stage_times(torch, pipe, cfg, x, card):
    """Per-layer device times of one main-path call (CUDA events)."""
    from doa_tpu_torch.cpx import fp32_matmuls
    from doa_tpu_torch.ops.cpx_ops import signal_subspace_from_E_T
    from doa_tpu_torch.ops.cuda.cov_embedded import cov_embedded
    from doa_tpu_torch.ops.cuda.music_scan import (music_scan_peaks,
                                                   peaks_tiles)

    Ar, Ai = pipe.steering_planes
    At = torch.cat([Ar, Ai], -1).contiguous()
    nrm = (At * At).sum(-1)
    cr = torch.ones(16, device=x.device)
    ci = torch.zeros(16, device=x.device)
    esc = cfg.escalate_kwargs
    out = {}
    with fp32_matmuls():
        E = cov_embedded(x, cr, ci, N=16, snapshot_size=1024)
        out["cov (K1 + windows + embed)"] = time_ms(
            torch, lambda: cov_embedded(x, cr, ci, N=16, snapshot_size=1024))

        def sub():
            vb = signal_subspace_from_E_T(E.mean(0, keepdim=True), 2,
                                          iters=8, **esc)
            return signal_subspace_from_E_T(
                E, 2, iters=2, init=vb.expand(E.shape[0], -1, -1),
                return_stats=True, **esc)
        Vt = sub()[0]
        out["subspace (warm MGS + detector)"] = time_ms(torch, sub)
        tiles = peaks_tiles(At, 4)
        out["scan + peaks (K2)"] = time_ms(
            torch, lambda: music_scan_peaks(Vt, At, 2, 0.0, 180.0, True,
                                            nrm, tiles))
    log("layer times, ms: " + ", ".join(f"{k} {v:.4f}"
                                        for k, v in out.items())
        + f"  [{card}]")
    profile_window(torch, lambda: pipe.interleaved(x), card)


def profile_window(torch, fn, card, calls=3):
    """Device busy share of whole calls and the top device ops, from a
    short torch.profiler window. Only the device's own events count
    (kernels, copies, fills; not CUPTI's buffer requests), and busy time
    is the union of their intervals on the timeline: the host op that
    launches a kernel carries the same device time as the kernel's own
    row, so summing every row's device time counts a torch op twice."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    def on_device(ev):
        return (ev.device_type == DeviceType.CUDA
                and ev.key != "Activity Buffer Request")

    spans = sorted((ev.time_range.start, ev.time_range.end)
                   for ev in prof.events() if on_device(ev))
    busy_us, end = 0.0, float("-inf")
    for a, b in spans:                   # the union of the intervals
        if b > end:
            busy_us += b - max(a, end)
            end = b
    busy_ms = busy_us / 1e3
    check(busy_ms > 0, "the profile window saw no device work")
    rows = sorted(((ev.self_device_time_total, ev.count, ev.key)
                   for ev in prof.key_averages() if on_device(ev)),
                  reverse=True)
    log(f"profile of {calls} calls: wall {wall_ms:.3f} ms, device busy "
        f"{busy_ms:.3f} ms, idle share {1 - busy_ms / wall_ms:.3f}; "
        f"{len(spans)} device ops  [{card}]")
    for dev_us, count, key in rows[:10]:
        log(f"  {dev_us / 1e3 / calls:9.4f} ms/call  x{count // calls:<4d} "
            f"{key[:90]}")


def make_c5_scene(torch, T, device, seed=0):
    """The c5 wideband planar scene as the interleaved capture
    x f32[T, 128], made on the device from an explicit generator by the
    model of doa_tpu.io.synthetic.synth_wideband_ura_iq: complex white
    noise on every length-T FFT bin in each source's band (centred on 0,
    width C5_BW), each bin steered at its own spacing
    0.5·(1 + f·0.1) on both axes of the 8x8 array; unit source power,
    complex white noise at 10 dB below it per element."""
    nx = ny = 8
    gen = torch.Generator(device=device).manual_seed(seed)
    freqs = torch.fft.fftfreq(T, device=device, dtype=torch.float64)
    ix = torch.arange(nx, device=device,
                      dtype=torch.float64).repeat_interleave(ny)
    iy = torch.arange(ny, device=device, dtype=torch.float64).repeat(nx)
    spec = torch.zeros((T, nx * ny), dtype=torch.complex128, device=device)
    for az_deg, el_deg in C5_TRUTH:
        band = ((freqs >= -C5_BW / 2) & (freqs < C5_BW / 2)).nonzero()[:, 0]
        nb = band.numel()
        az, el = math.radians(az_deg), math.radians(el_deg)
        u = math.cos(el) * math.sin(az) * ix + math.cos(el) * math.cos(az) * iy
        w = torch.complex(
            torch.randn(nb, generator=gen, device=device, dtype=torch.float64),
            torch.randn(nb, generator=gen, device=device, dtype=torch.float64))
        w = w * math.sqrt(T / (2.0 * nb))
        d_eff = 0.5 * (1.0 + freqs[band] * 0.1)
        phase = -2.0 * math.pi * d_eff[:, None] * u[None, :]
        spec[band] += w[:, None] * torch.polar(torch.ones_like(phase), phase)
    x = torch.fft.ifft(spec, dim=0) * math.sqrt(T)
    del spec
    npow = 10.0 ** (-SNR_DB / 10.0)
    x += torch.complex(
        torch.randn((T, nx * ny), generator=gen, device=device,
                    dtype=torch.float64),
        torch.randn((T, nx * ny), generator=gen, device=device,
                    dtype=torch.float64)) * math.sqrt(npow / 2.0)
    return torch.view_as_real(x.to(torch.complex64)).reshape(T, 2 * nx * ny)


def pair_sorted(torch, ang):
    """(B, k, 2) az/el → each window's peaks in order of az."""
    order = torch.argsort(ang[..., 0], dim=-1)
    return torch.gather(ang, 1, order[..., None].expand(ang.shape))


def c5_errors(torch, ang, truth=C5_TRUTH):
    """→ (max, median) over windows of the largest |angle − truth| of a
    window, and the median pair-sorted (az, el) f32[2, 2]."""
    a = pair_sorted(torch, ang)
    truth = torch.tensor(truth, device=a.device)
    if not bool(torch.isfinite(a).all()):
        fail("non-finite c5 angles")
    per = (a - truth).abs().amax(dim=(1, 2))
    return float(per.max()), float(per.median()), a.median(dim=0).values


def wideband_parity(torch, dev, x, cfg, pipe, card, k4_shapes=None):
    """Phase 6 → the records of the three wideband kernels, and the
    per-subband inputs of the c5 path (E_sub, Vt, P) for later phases;
    K4's times at c5 go into `k4_shapes` (K4's by_shape) if given."""
    from doa_tpu_torch.cpx import fp32_matmuls
    from doa_tpu_torch.ops import cpx_ops
    from doa_tpu_torch.ops import wideband as wb
    from doa_tpu_torch.ops.cuda import peaks2d as pk
    from doa_tpu_torch.ops.cuda import wideband_cov as wc
    from doa_tpu_torch.ops.cuda import wideband_scan as wsc
    from doa_tpu_torch.ops.peaks import find_local_max_2d

    recs = {}
    gen = torch.Generator(device=dev).manual_seed(3)
    F, N = cfg.wideband.num_subbands, cfg.geometry.num_elements
    g2 = cfg.grid2d
    az_rng, el_rng = (g2.az_lo_deg, g2.az_hi_deg), (g2.el_lo_deg, g2.el_hi_deg)

    def ri(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=gen, device=dev).float()

    # front end, exact: F ≤ 4 (twiddles ±1, ±j), integer samples and
    # correction, every sum an integer below 2^24; the plain version in
    # float64, rounded once (FFT_GRAM_EXACT's cases)
    for Fx, Nx, gx, nx, off in FFT_GRAM_EXACT:
        size = nx * gx * Fx * 2 * Nx
        xf = ri(-4, 5, (size + 2,))[off:off + size].view(nx * gx,
                                                          Fx * 2 * Nx)
        cr, ci = ri(-1, 3, (Nx,)), ri(-1, 2, (Nx,))
        kw = dict(F=Fx, N=Nx, g=gx, scale=1.0 / 16)
        d = (wc.subband_chunk_grams(xf, cr, ci, **kw)
             - wc.subband_chunk_grams_plain(xf.double(), cr, ci, **kw)
             ).abs().max().item()
        log(f"wideband_fft_gram exact-input F={Fx} N={Nx} g={gx} "
            f"chunks={nx} offset={off * 4} bytes: max|kernel-plain| = "
            f"{d!r} (must be 0)")
        check(d == 0.0, f"wideband_fft_gram F={Fx} N={Nx} g={gx} differs "
                        f"on exact inputs")
        del xf

    # front end on the c5 scene (no correction, as the main path)
    S_sub, hop_sub, g = wc.subband_framing(F, cfg.snapshot_size, cfg.overlap)
    M = x.shape[0] // F
    xf = x[:M * F].reshape(M, F * 2 * N)
    cr1 = torch.ones(N, device=dev)
    ci0 = torch.zeros(N, device=dev)
    kw = dict(F=F, N=N, g=g, scale=1.0 / S_sub)
    E_sub = wc.subband_chunk_grams(xf, cr1, ci0, **kw)
    Ep = wc.subband_chunk_grams_plain(xf, cr1, ci0, **kw)
    e1 = (E_sub - Ep).abs().max().item()
    s1 = Ep.abs().max().item()
    log(f"wideband_fft_gram c5 scene {tuple(E_sub.shape)}: max|kernel-plain| "
        f"= {e1!r}, max|E| = {s1!r}, tol 1e-5*max|E|")
    check(e1 <= 1e-5 * s1, "wideband_fft_gram disagrees with plain")
    del Ep
    k_ms, p_ms = pair_ms(torch, lambda: wc.subband_chunk_grams(xf, cr1, ci0,
                                                               **kw),
                         lambda: wc.subband_chunk_grams_plain(xf, cr1, ci0,
                                                              **kw))
    log(f"wideband_fft_gram time [{M}, {F * 2 * N}] g={g}: kernel "
        f"{k_ms:.4f} ms, plain (torch.fft + cuBLAS) {p_ms:.4f} ms  [{card}]")
    # the ULA-16 cssm front end's shape (N = 16, F = 16, g = 64): another
    # register-tile form and subband grouping than c5's
    xu = torch.randn((T_ULA // 16, 16 * 32), generator=gen, device=dev)
    ku = dict(F=16, N=16, g=64, scale=1.0 / 64)
    cu1, cu0 = torch.ones(16, device=dev), torch.zeros(16, device=dev)
    Eu = wc.subband_chunk_grams(xu, cu1, cu0, **ku)
    Eup = wc.subband_chunk_grams_plain(xu, cu1, cu0, **ku)
    eu, su = (Eu - Eup).abs().max().item(), Eup.abs().max().item()
    del Eu, Eup
    log(f"wideband_fft_gram ULA-16 cssm shape {tuple(xu.shape)} g=64: "
        f"max|kernel-plain| = {eu!r}, max|E| = {su!r}, tol 1e-5*max|E|")
    check(eu <= 1e-5 * su, "wideband_fft_gram disagrees with plain at the "
                           "ULA-16 cssm shape")
    ku_ms, pu_ms = pair_ms(
        torch, lambda: wc.subband_chunk_grams(xu, cu1, cu0, **ku),
        lambda: wc.subband_chunk_grams_plain(xu, cu1, cu0, **ku))
    bu = fft_gram_bound(xu.shape[0], 16, 16, 64)
    log(f"wideband_fft_gram time ULA-16 cssm shape: kernel {ku_ms:.4f} ms, "
        f"plain {pu_ms:.4f} ms, bound {bu['bound_ms']:.4f} ms "
        f"({bu['bound_by']})  [{card}]")
    del xu
    recs["wideband_fft_gram"] = dict(
        name="wideband_fft_gram", route="cuda",
        source="doa_tpu_torch/csrc/wideband_cov.cu",
        replaces="doa_tpu/ops/pallas/wideband_cov.py:162",
        max_abs_err=e1, ms=k_ms, plain_ms=p_ms,
        **fft_gram_bound(M, F, N, g), library_ms=None,
        by_shape={"ULA-16 cssm": dict(ms=ku_ms, plain_ms=pu_ms,
                                      max_abs_err=eu, **bu)})

    # K4 at 2N = 128 on the c5 windows: warm from one init per subband
    # (3 rounds, as the pipeline) and cold (8 rounds); projectors to 1e-5
    E = E_sub.reshape(-1, 2 * N, 2 * N)
    with fp32_matmuls():
        init = cpx_ops.mgs_iterate_plain(E_sub.mean(dim=1), 2, 8)[0]
        for rounds, ini in ((3, init), (8, None)):
            outk = cpx_ops.mgs_iterate(E, 2, rounds, ini)
            outp = cpx_ops.mgs_iterate_plain(E, 2, rounds, ini)
            dp = 0.0
            for lo in range(0, E.shape[0], 4096):      # projectors in slices
                pk_, pp_ = (o[0][lo:lo + 4096] for o in (outk, outp))
                dp = max(dp, (pk_.transpose(1, 2) @ pk_
                              - pp_.transpose(1, 2) @ pp_).abs().max().item())
            dw = ((outk[1] - outp[1]).abs().max()
                  / outp[1].abs().max()).item()
            start = "warm, one init per subband" if ini is not None else "cold"
            log(f"K4 c5 2N=128 rounds={rounds} {start}: max|projector kernel "
                f"- plain| = {dp!r} (tol 1e-5), max|W kernel - plain|/max|W| "
                f"= {dw!r} (tol 1e-5)")
            check(dp <= 1e-5 and dw <= 1e-5, "K4 at 2N=128 disagrees")
        del outk, outp
        t_c5 = k4_times(torch, "c5", E, 2, 3, init, card)
        # the per-subband capture means (the warm start's init): F windows
        Em = E_sub.mean(dim=1)
        t_means = k4_times(torch, "c5 subband means", Em, 2, 8, None, card)
        del Em
    if k4_shapes is not None:
        k4_shapes.update({"c5": t_c5, "c5 subband means": t_means})
    k4_exact(torch, dev, gen)

    # fusion, exact: Vt in quarter steps, A integer, nrm above every
    # Σ y²: den = nrm − Σ y² are multiples of 1/16 below 2^24, exact in any
    # order, so dmin, every dmin/den and their sums agree bit for bit
    # (every 2K the kernel is built for; ragged n2, B and G)
    for K2, n2 in ((2, 128), (4, 20), (6, 128), (8, 128)):
        Vq = ri(-2, 3, (4, 100, K2, n2)) / 4
        Aq = ri(-3, 4, (4, 1000, n2))
        nq = 300000.0 + ri(0, 64, (4, 1000))
        d = (wsc.wideband_fused_spectrum(Vq, Aq, nq)
             - wsc.wideband_fused_spectrum_plain(Vq, Aq, nq)
             ).abs().max().item()
        log(f"wideband_fusion exact-input 2K={K2} 2N={n2}: max|kernel-plain| "
            f"= {d!r} (must be 0)")
        check(d == 0.0, f"wideband_fusion 2K={K2} differs on exact inputs")

    # fusion on the c5 scene's subspaces and steering
    with fp32_matmuls():
        Vt = wb.subband_subspaces_from_E(E_sub, cfg)
    Xr, Xi = pipe.subband_planes
    At = torch.cat([Xr, Xi], dim=-1).contiguous()
    nrm = (At * At).sum(dim=-1)
    P = wsc.wideband_fused_spectrum(Vt, At, nrm)
    Pp = wsc.wideband_fused_spectrum_plain(Vt, At, nrm)
    B5, G5 = P.shape
    e5 = (P - Pp).abs().max().item()
    r5 = ((P - Pp).abs() / Pp).max().item()
    log(f"wideband_fusion c5 scene B={B5} G={G5}: "
        f"max|P kernel - P plain| = {e5!r}, max relative {r5!r}; tol "
        f"2e-4 + 2e-4*|P|")
    check(bool(((P - Pp).abs() <= 2e-4 + 2e-4 * Pp.abs()).all()),
          "wideband_fusion disagrees with plain")
    # the evidence for 3xTF32 (logged, no tolerance): 64 windows of the
    # kernel and of the FP32 plain version against float64
    P64 = fusion_f64(torch, Vt[:, :64], At, nrm)
    log(f"wideband_fusion precision, 64 c5 windows against float64: max "
        f"relative error kernel (3xTF32) "
        f"{((P[:64] - P64).abs() / P64).max().item()!r}, plain (FP32) "
        f"{((Pp[:64] - P64).abs() / P64).max().item()!r}")
    del P64
    # windows in groups (the workspace cap): exact, dmin being per window
    cap = wsc.workspace_bytes(F, B5, G5) // 5
    Pg = wsc._fused_cuda(Vt, At, nrm, cap=cap)
    log(f"wideband_fusion workspace: {wsc.workspace_bytes(F, B5, G5)} bytes "
        f"at c5 (cap {wsc.WORKSPACE_CAP}); in groups of "
        f"{wsc._group_windows(F, B5, G5, cap)} "
        f"windows bit-equal: {bool(torch.equal(Pg, P))}")
    check(torch.equal(Pg, P), "wideband_fusion differs in window groups")
    del Pg
    k_ms, p_ms = pair_ms(torch, lambda: wsc.wideband_fused_spectrum(Vt, At,
                                                                   nrm),
                         lambda: wsc.wideband_fused_spectrum_plain(Vt, At,
                                                                   nrm))
    log(f"wideband_fusion time (F={F}, B={B5}, 2K=4, 2N=128, G={G5}): "
        f"kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms  [{card}]")
    # the products the function needs (2K x 2N a den), three times over
    # on the tensor cores at the TF32 rate; beside it one FP32 pass of the
    # plain version's arithmetic (den, then dmin/den and the sum)
    prod = 2 * F * B5 * G5 * Vt.shape[2] * Vt.shape[3]
    io = nbytes(Vt, At, nrm, P)
    recs["wideband_fusion"] = dict(
        name="wideband_fusion", route="cuda",
        source="doa_tpu_torch/csrc/wideband_scan.cu",
        replaces="doa_tpu/ops/pallas/wideband_scan.py:51",
        max_abs_err=e5, ms=k_ms, plain_ms=p_ms,
        **bound(io, 3 * prod, peak=H100_TF32_PER_S),
        bound_fp32_ms=bound(io, F * (scan_flops(B5, G5, Vt.shape[2],
                                                Vt.shape[3])
                                     + 2 * P.numel()))["bound_ms"],
        library_ms=None)

    # 2-D peaks, exact: integer spectra full of ties and plateaus, a
    # strictly rising window (no interior peak) and a flat one
    Pq = ri(1, 6, (512, g2.num_az, g2.num_el))
    Pq[0] = torch.arange(Pq[0].numel(), device=dev,
                         dtype=torch.float32).reshape(Pq[0].shape)
    Pq[1] = 2.0
    forms = {f: (lambda P, k, refine, f=f: pk._launch(P, k, az_rng, el_rng,
                                                      refine, f))
             for f in pk.PEAKS_FORMS}
    check(pk.peaks_form(g2.num_az, g2.num_el) == "ring",
          "c5's grid does not take kernel 6's ring form")
    for form, fn in forms.items():
        for k in (1, 2, 3, 4):
            for refine in (False, True):
                got = fn(Pq, k, refine)
                ref = find_local_max_2d(Pq, k, az_rng, el_rng, refine)
                d = max((a - b).abs().max().item() for a, b in zip(got, ref))
                log(f"peaks2d {form} form, exact-input k={k} refine="
                    f"{refine}: max|kernel - plain| over values, az, el = "
                    f"{d!r} (must be 0)")
                check(d == 0.0, f"peaks2d's {form} form differs on exact "
                      f"inputs")
    # on the c5 scene's spectrum: bit for bit, each form
    P2 = Pp.reshape(-1, g2.num_az, g2.num_el)
    ref = find_local_max_2d(P2, 2, az_rng, el_rng, True)
    e6 = 0.0
    for form, fn in forms.items():
        got = fn(P2, 2, True)
        d = max((a - b).abs().max().item() for a, b in zip(got, ref))
        log(f"peaks2d {form} form, c5 scene: max|kernel - plain| over "
            f"values, az, el = {d!r} (must be 0)")
        check(d == 0.0, f"peaks2d's {form} form differs from plain on the "
              f"scene")
        e6 = max(e6, d)
    p_ms, r_ms, b_ms = turns_ms(
        torch, lambda: find_local_max_2d(P2, 2, az_rng, el_rng, True),
        lambda: forms["ring"](P2, 2, True),
        lambda: forms["block"](P2, 2, True))
    log(f"peaks2d time (B={P2.shape[0]}, {g2.num_az}x{g2.num_el}, k=2): "
        f"ring form {r_ms:.4f} ms, block form {b_ms:.4f} ms, plain "
        f"{p_ms:.4f} ms  [{card}]")
    recs["peaks2d"] = dict(
        name="peaks2d", route="cuda", source="doa_tpu_torch/csrc/peaks2d.cu",
        replaces="doa_tpu/ops/pallas/peaks2d.py:42",
        max_abs_err=e6, ms=r_ms, plain_ms=p_ms,
        # four neighbour comparisons a bin; the top-k and refine are per
        # window
        **bound(nbytes(P2, *ref), 4 * P2.numel()), library_ms=None,
        by_form={"ring": {"ms": r_ms}, "block": {"ms": b_ms}})
    return recs, (E_sub, Vt, At, nrm, P2)


def fusion_f64(torch, Vt, At, nrm):
    """The fused spectrum of the plain version's arithmetic in float64 on
    the card (its products in full float64) → P f64[B, G]."""
    acc = 0.0
    for f in range(Vt.shape[0]):
        y = torch.matmul(Vt[f].double(), At[f].double().T)    # (B, 2K, G)
        den = (nrm[f].double() - (y * y).sum(dim=-2)).clamp_min(
            torch.finfo(torch.float32).tiny)
        acc = acc + den.min(dim=-1, keepdim=True).values / den
    return acc / Vt.shape[0]


PEAKS_TALLY = {}                   # kernel 6's path launches by form
K4_TALLY = {}                      # K4's launches by form, the paths below


def k4_forms_zero():
    from doa_tpu_torch.ops import cpx_ops
    cpx_ops.mgs_iterate.by_form.update(dict.fromkeys(cpx_ops.MGS_FORMS, 0))


def k4_forms(tag, pipes, n):
    """K4's n launches in a path since k4_forms_zero: all of the form each
    pipeline's plan names for its "subspace" stage (mgs_iterate.by_form),
    added to K4_TALLY."""
    from doa_tpu_torch.ops import cpx_ops

    by = dict(cpx_ops.mgs_iterate.by_form)
    planned = {p.plan.forms.get("subspace") for p in pipes}
    log(f"{tag}: K4 launches by form {json.dumps(by)}, planned "
        f"{sorted(map(str, planned))}")
    check(len(planned) == 1 and by.get(next(iter(planned))) == n > 0,
          f"{tag}: K4 did not launch the form its plan names alone")
    for f, v in by.items():
        K4_TALLY[f] = K4_TALLY.get(f, 0) + v


def peaks_forms(name, pipe, n):
    """Check that a path's n launches of kernel 6 (counted from zero, with
    its by_form counts) all took the form pipe.plan.forms["peaks"] names,
    and add them to PEAKS_TALLY."""
    from doa_tpu_torch.ops.cuda import peaks2d as pk
    by = dict(pk.peaks2d.by_form)
    want = pipe.plan.forms.get("peaks")
    log(f"{name}: kernel 6 by form {json.dumps(by)}, planned {want}")
    check(n > 0 and want is not None and by[want] == n
          and sum(by.values()) == n,
          f"{name} did not launch kernel 6's planned form {want} alone")
    for f, v in by.items():
        PEAKS_TALLY[f] = PEAKS_TALLY.get(f, 0) + v


def c5_phases(torch, dev, card, counters, k4_shapes=None):
    """Phases 6 and 7 → (the wideband kernels' records, the subspace
    kernel's launches in the c5 path). `counters`: the narrowband
    kernels' wrappers, which must not launch in the c5 path; K4's times
    at c5 go into `k4_shapes` if given."""
    from doa_tpu_torch import PRESETS
    from doa_tpu_torch.cpx import fp32_matmuls
    from doa_tpu_torch.ops import cpx_ops
    from doa_tpu_torch.ops import wideband as wb
    from doa_tpu_torch.ops.cuda import peaks2d as pk
    from doa_tpu_torch.ops.cuda import wideband_cov as wc
    from doa_tpu_torch.ops.cuda import wideband_scan as wsc
    from doa_tpu_torch.pipeline_torch import build_pipeline_torch

    cfg = PRESETS["c5_ura64_wideband"]
    pipe = build_pipeline_torch(cfg, device=dev)
    show_plan("c5", pipe)
    x = make_c5_scene(torch, T_C5, dev)
    torch.cuda.synchronize()
    recs, (E_sub, Vt, At, nrm, P2) = wideband_parity(torch, dev, x, cfg,
                                                     pipe, card, k4_shapes)

    # 7. the c5 path, counts from zero just before it
    wb_counters = {"wideband_fft_gram": wc.subband_chunk_grams,
                   "wideband_fusion": wsc.wideband_fused_spectrum,
                   "peaks2d": pk.peaks2d, "mgs_iterate": cpx_ops.mgs_iterate}
    for f in list(counters.values()) + list(wb_counters.values()):
        f.launches = 0
    pk.peaks2d.by_form.update(dict.fromkeys(pk.PEAKS_FORMS, 0))
    k4_forms_zero()
    res = pipe.interleaved(x)
    torch.cuda.synchronize()
    launches = {n: f.launches for n, f in wb_counters.items()}
    log("launches in the c5 path: " + json.dumps(launches))
    k4_forms("c5 path", (pipe,), launches["mgs_iterate"])
    peaks_forms("c5 path", pipe, launches["peaks2d"])
    for name, n in launches.items():
        check(n > 0, f"kernel {name} never ran in the c5 path")
        if name in recs:
            recs[name]["launches"] = n
    for name in ("chunk_gram", "chunk_embedded", "music_scan",
                 "music_scan_peaks"):
        check(counters[name].launches == 0,
              f"narrowband kernel {name} ran in the c5 path")
    B = T_C5 // cfg.snapshot_size
    ang = res.peak_angles["music"]
    check(tuple(ang.shape) == (B, 2, 2), f"c5 angles shape {tuple(ang.shape)}")
    P = res.spectra["music"]
    check(tuple(P.shape) == (B, 181 * 91) and bool(torch.isfinite(P).all()),
          "c5 spectrum not finite or of the wrong shape")
    e_max, e_med, med = c5_errors(torch, ang)
    dmed = (med - torch.tensor(C5_TRUTH, device=med.device)).abs().max()
    log(f"c5 path: {B} windows, per-window max |az/el - truth|: max "
        f"{e_max!r} deg, median {e_med!r} deg; median pair-sorted (az, el) "
        f"{med.tolist()} vs truth {list(C5_TRUTH)} (limit {C5_ANGLE_TOL} "
        f"deg); escalation counts {res.escalation_flagged}")
    check(float(dmed) <= C5_ANGLE_TOL, f"c5 median angle off by {dmed}")
    ts = call_times(torch, lambda: pipe.interleaved(x), reps=20, warm=3)
    med_ms = 0.5 * (ts[9] + ts[10])
    log(f"c5 path: median {med_ms:.4f} ms per call of {B} windows (20 "
        f"calls, min {ts[0]:.4f}, max {ts[-1]:.4f}) = "
        f"{B / (med_ms / 1e3):.1f} snapshots/s  [{card}]")

    g2 = cfg.grid2d
    az_rng, el_rng = (g2.az_lo_deg, g2.az_hi_deg), (g2.el_lo_deg, g2.el_hi_deg)
    cr1 = torch.ones(64, device=dev)
    ci0 = torch.zeros(64, device=dev)
    with fp32_matmuls():
        layers = {
            "front end (FFT-channelizer Gram)": lambda: wc.wideband_cov_embedded(
                x, cr1, ci0, N=64, F=16, snapshot_size=1024),
            "subspace (per-subband warm MGS + detector)":
                lambda: wb.subband_subspaces_from_E(E_sub, cfg),
            "fusion (den once on the tensor cores, then P)":
                lambda: wsc.wideband_fused_spectrum(Vt, At, nrm),
            "peaks (2-D)": lambda: pk.peaks2d(P2, 2, az_rng, el_rng, True),
        }
        out = {k: time_ms(torch, f) for k, f in layers.items()}
    log("c5 layer times, ms: " + ", ".join(f"{k} {v:.4f}"
                                           for k, v in out.items())
        + f"  [{card}]")
    profile_window(torch, lambda: pipe.interleaved(x), card)
    del x, res, P, E_sub, Vt, P2

    # the card against the CPU on a short capture
    xs = make_c5_scene(torch, T_C5_SMALL, dev, seed=2)
    xc64 = xs.cpu().numpy().view("complex64")
    a_gpu = pair_sorted(torch, pipe(xc64).peak_angles["music"]).cpu()
    t0 = time.perf_counter()
    a_cpu = pair_sorted(torch, build_pipeline_torch(cfg, device="cpu")(
        xc64).peak_angles["music"])
    d = (a_gpu - a_cpu).abs().max().item()
    log(f"c5 card vs CPU pipeline on {a_cpu.shape[0]} windows: max pair-sorted "
        f"angle difference {d!r} deg (tol 1e-2; CPU run "
        f"{time.perf_counter() - t0:.1f} s)")
    check(d <= 1e-2, "c5 card and CPU pipelines disagree")
    return recs, launches["mgs_iterate"]


# ---------------------------------------------------------------------
# 8-9: the planes path (c3, c2, eigh) and the calibration stage
# ---------------------------------------------------------------------

C3_TRUTH = (40.0, 70.0, 100.0)     # validate_tpu.py's c3 scene
C2_TRUTH = (60.0, 110.0)           # validate_tpu.py's c2 scene
T_C3 = 1 << 24                     # 16384 windows of 1024: 2 GiB
T_C2 = 1 << 24                     # 8192 windows of 2048: 1 GiB
T_K12 = 1 << 20                    # kernel 12: S = 1024, overlap 1000
# kernel 12 exact: (N, S, overlap, T, the form windows_form names)
K12_EXACT = ((16, 1024, 1000, T_K12, "chunk_sums"),
             (16, 256, 200, 1 << 16, "chunk_sums"),
             (16, 256, 56, 1 << 16, "chunk_sums"),     # hop 200 > S/2
             (8, 256, 250, 1 << 16, "chunk_sums"),
             (4, 96, 95, 1 << 14, "chunk_sums"),       # hop 1, g 1
             (16, 1024, 1020, 1 << 15, "per_window"),  # 256 open windows
             (15, 1024, 1000, 1 << 16, "per_window"))  # N odd
B_EIGH = 1024                      # c3 with eigh at overlap 512
B_CPU = 64                         # the card against the CPU
T_CAL = 1 << 20                    # each calibration capture
PILOT_DEG = 68.0


def make_ula_capture(torch, T, N, sources, snr_db, device, seed):
    """A ULA capture by the model of doa_tpu.io.synth_ula_iq as the
    interleaved buffer x f32[T, N, 2] (complex64 bytes), made on the
    device: each source (theta_deg, num, den[, amplitude]) a tone of
    amplitude 1 (or the one given) and frequency num/den cycles a sample
    with a random start phase (t·num mod den in integers, so the phase is
    exact at any T), steered by
    a_k = exp(−jπ·cos θ·k); complex white noise of power 10^(−snr/10) per
    element."""
    import numpy as np

    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=device).manual_seed(seed)
    npow = 10.0 ** (-snr_db / 10.0)
    x = torch.randn((T, N, 2), generator=gen, device=device)
    x *= math.sqrt(npow / 2.0)
    xc = torch.view_as_complex(x)
    t = torch.arange(T, device=device, dtype=torch.int64)
    k = torch.arange(N, device=device, dtype=torch.float64)
    for theta, num, den, *amp in sources:
        ph = (2.0 * math.pi / den) * ((t * num) % den).to(torch.float64)
        ph += rng.uniform(0.0, 2.0 * math.pi)
        s = torch.polar(torch.full_like(ph, amp[0] if amp else 1.0),
                        ph).to(torch.complex64)
        a = torch.polar(torch.ones_like(k), -math.pi * math.cos(
            math.radians(theta)) * k).to(torch.complex64)
        xc += s[:, None] * a[None, :]
        del ph, s
    return x


def c3_sources():
    return ((40.0, 12, 100), (70.0, 12, 100), (100.0, 3, 10))


def impairments(N, seed=3):
    """Receiver-chain phases (chain 0 the reference) and element gains and
    phases, as tests/test_calibration.py injects them → the per-channel
    complex factor the capture is multiplied by (numpy complex128[N])."""
    import numpy as np
    rng = np.random.default_rng(seed)
    chain = rng.uniform(-1.5, 1.5, N)
    chain[0] = 0.0
    gains = 1.0 + 0.25 * rng.standard_normal(N)
    phases = rng.uniform(-0.4, 0.4, N)
    return np.exp(1j * chain) * gains * np.exp(1j * phases)


def impair(torch, x, factor):
    xc = torch.view_as_complex(x)
    xc *= torch.from_numpy(factor.astype("complex64")).to(x.device)[None, :]
    return x


def sorted_err(torch, ang, truth):
    """Max over windows of the largest |sorted angle − truth|."""
    if not bool(torch.isfinite(ang).all()):
        fail("non-finite angles")
    a = torch.sort(ang, dim=-1).values
    return float((a - torch.tensor(truth, device=a.device)).abs().max())


def scan_parity(torch, tag, Vt, At, nrm, k, truth, card, k2_shapes=None):
    """K3 and K2 against their plain versions on a path's own subspaces
    (its 2N, 2K, G and k): den within 1e-5·max‖a‖², each window's sorted
    peak angles within 0.01° and within ANGLE_TOL of the planted truth
    (k2_scene, which also times K2; its record goes into k2_shapes[tag]
    if given)."""
    from doa_tpu_torch.ops.cuda import music_scan as ms

    e3 = (1.0 / ms.music_scan(Vt, At, nrm, ms.scan_tiles(At, Vt.shape[1]))
          - 1.0 / ms.music_scan_plain(Vt, At, nrm)).abs().max().item()
    tol3 = 1e-5 * nrm.max().item()
    log(f"K3 {tag} (2N, 2K) = ({Vt.shape[2]}, {Vt.shape[1]}), "
        f"G={At.shape[0]}, {Vt.shape[0]} windows: max|den kernel - "
        f"den plain| = {e3!r} (tol 1e-5*max‖a‖² = {tol3!r})")
    check(e3 <= tol3, f"K3 disagrees with plain at {tag}'s shapes")
    _, rec = k2_scene(torch, tag, Vt, At, nrm, k, truth, card)
    if k2_shapes is not None:
        k2_shapes[tag] = rec


def form_counts(counter):
    """A wrapper's launches by the form its plan names: `by_form`, or
    K1's `by_epilogue` (chunk_grams_uhat: the covariance stage's calls by
    epilogue); None if it has neither."""
    return getattr(counter, "by_form", getattr(counter, "by_epilogue", None))


def counter_of(kernel, form):
    """The counter a stage's launches land on, from its kernel and the
    form its plan names: the kernel's, but kernel 9's ("chunk_embedded")
    where the covariance stage ("chunk_gram") takes the embedded or the
    window epilogue, which launch kernel 9's entries in K1's place."""
    if kernel == "chunk_gram" and form in ("embedded", "windows"):
        return "chunk_embedded"
    return kernel


def stage_counter(plan, stage):
    """counter_of a planned stage (plan.kernels, plan.forms)."""
    return counter_of(plan.kernels[stage], plan.forms.get(stage))


def form_of(fn, counter):
    """fn() → (its result, the form of its one launch of the wrapper
    `counter`, from the wrapper's `by_form` counts)."""
    before = dict(counter.by_form)
    out = fn()
    moved = {f: n - before[f] for f, n in counter.by_form.items()
             if n != before[f]}
    check(len(moved) == 1 and list(moved.values()) == [1],
          f"not one launch of one form: {moved}")
    return out, next(iter(moved), None)


def k12_per_window(torch, xr, xi, S, ov):
    """Kernel 12's per-window form at any shape, through its C entry (the
    wrapper takes it only where windows_form names it)."""
    from doa_tpu_torch import _build
    from doa_tpu_torch.ops.cuda import covariance as cv

    lib = _build.load("covariance", cv._SIG)
    N = xr.shape[1]
    hop, _, B = cv._framing(xr.shape[0], S, ov)
    xr, xi, rs, es, load, _ = cv._kernel_args(xr, xi, N)
    rr = torch.empty((B, N, N), device=xr.device)
    ri = torch.empty_like(rr)
    _build.check(lib.doa_planes_cov_windows(
        xr.data_ptr(), xi.data_ptr(), rs, es, load, rr.data_ptr(),
        ri.data_ptr(), B, S, hop, N,
        torch.cuda.current_stream(xr.device).cuda_stream),
        "doa_planes_cov_windows")
    return rr, ri


def planes_parity(torch, dev, x3, card, k4_shapes=None):
    """Phase 8 → the records of kernels 8 and 12 (launches filled in
    later). x3: the c3 capture f32[T, 16, 2] on the card. K4's time at c3
    goes into `k4_shapes` (K4's by_shape) if given."""
    from doa_tpu_torch.cpx import embed_planes, fp32_matmuls
    from doa_tpu_torch.ops import cpx_ops
    from doa_tpu_torch.ops.cuda import covariance as cv

    recs = {}
    gen = torch.Generator(device=dev).manual_seed(5)

    def dmax(a, b):
        return max((p - q).abs().max().item() for p, q in zip(a, b))

    # kernel 8 exact: integer samples |x| ≤ 20 (exact in bf16 too), every
    # sum an integer below 2^24; both register-tile forms (2N = 16, 32, 64;
    # 2N = 30), chunks of 128 and 7 rows, 63 chunks + a tail, and every
    # layout with the form it takes: the stride-2 views of an interleaved
    # buffer (the ring's rows; also 8 bytes off a 16-byte boundary, whose
    # stages take plain loads for their heads and tails), separate planes
    # (the ring's planes where 4 | N, else staged), the stride-2 views of
    # rows padded by one element and every third value (staged)
    for N in (8, 15, 16, 32):
        for g in (128, 7):
            T8 = 63 * g + 17
            buf = torch.randint(-20, 21, (T8 * 3 * N + 2,), generator=gen,
                                device=dev).float()
            xq = buf[:T8 * 2 * N].view(T8, N, 2)
            xo = buf[2:2 + T8 * 2 * N].view(T8, N, 2)
            x3v = buf[:T8 * 3 * N].view(T8, N, 3)
            xpad = buf[:T8 * 2 * (N + 1)].view(T8, N + 1, 2)[:, :N]
            layouts = (
                ("planar", (xq[..., 0].contiguous(), xq[..., 1].contiguous()),
                 "ring_planar" if N % 4 == 0 else "staged"),
                ("stride2", (xq[..., 0], xq[..., 1]), "ring_interleaved"),
                ("stride2 8-byte offset", (xo[..., 0], xo[..., 1]),
                 "ring_interleaved"),
                ("stride2 padded rows", (xpad[..., 0], xpad[..., 1]),
                 "staged"),
                ("stride3", (x3v[..., 0], x3v[..., 2]), "staged"))
            for dt in ("float32", "bfloat16"):
                for name, (xr, xi), want in layouts:
                    got, form = form_of(
                        lambda: cv.chunk_grams(xr, xi, g, dt), cv.chunk_grams)
                    d = dmax(got, cv.chunk_grams_plain(xr, xi, g, dt))
                    log(f"kernel 8 exact-input N={N} g={g} {dt} {name} "
                        f"({form}): max|kernel-plain| = {d!r} (must be 0)")
                    check(form == want, f"kernel 8 {name} took {form}, "
                                        f"not {want}")
                    check(d == 0.0, f"kernel 8 N={N} g={g} {dt} {name} "
                                    f"differs on exact inputs")
    # kernel 8 at c3's shape on the c3 scene (g = S = 1024), each form:
    # the stride-2 views (c3's own planes, the ring's rows), separate
    # planes (the ring's planes), rows padded by one element (staged)
    xr, xi = x3[..., 0], x3[..., 1]
    T3, N3 = xr.shape
    xp = (xr.contiguous(), xi.contiguous())
    xpad = torch.empty((T3, N3 + 1, 2), device=dev)
    xpad[:, :N3] = x3
    xs = (xpad[:, :N3, 0], xpad[:, :N3, 1])
    ref = cv.chunk_grams_plain(xr, xi, 1024)
    scale = ref[0].abs().max().item()
    k8 = {}
    for form, planes, dt in (("ring_interleaved", (xr, xi), "float32"),
                             ("ring_planar", xp, "float32"),
                             ("staged", xs, "float32"),
                             ("ring_interleaved", (xr, xi), "bfloat16")):
        got, took = form_of(lambda: cv.chunk_grams(*planes, 1024, dt),
                            cv.chunk_grams)
        want = ref if dt == "float32" else cv.chunk_grams_plain(
            xr, xi, 1024, dt)
        e = dmax(got, want)
        tag = form + (" bf16" if dt == "bfloat16" else "")
        k8[tag] = {"max_abs_err": e}
        log(f"kernel 8 {tag} c3 scene T={T3} N={N3}: max|kernel-plain| = "
            f"{e!r}, max|Rr| = {scale!r}, tol 1e-5*max|Rr|")
        check(took == form, f"kernel 8 at c3 took {took}, not {form}")
        check(e <= 1e-5 * scale, f"kernel 8 {tag} disagrees with plain")
        del got, want
    del ref
    fns = {"plain": lambda: cv.chunk_grams_plain(xr, xi, 1024),
           "ring_interleaved": lambda: cv.chunk_grams(xr, xi, 1024),
           "ring_planar": lambda: cv.chunk_grams(*xp, 1024),
           "staged": lambda: cv.chunk_grams(*xs, 1024),
           "ring_interleaved bf16": lambda: cv.chunk_grams(
               xr, xi, 1024, "bfloat16"),
           "plain bf16": lambda: cv.chunk_grams_plain(xr, xi, 1024,
                                                      "bfloat16")}
    t8 = dict(zip(fns, turns_ms(torch, *fns.values())))
    for tag in k8:
        k8[tag]["ms"] = t8[tag]
    del xp, xs, xpad
    # the library's form: one complex batched product of the chunks,
    # R = Σ x xᴴ, whose (re, im) are kernel 8's (Rr, Ri)
    xc = torch.view_as_complex(x3).view(-1, 1024, N3)
    with fp32_matmuls():
        lib8_ms = time_ms(torch, lambda: torch.matmul(xc.mT, xc.conj()))
    del xc
    log(f"kernel 8 time [{T3}, 16] x2 g=1024 (in turns): "
        + ", ".join(f"{k} {v:.4f} ms" for k, v in t8.items())
        + f"; library (one complex torch.matmul) {lib8_ms:.4f} ms  [{card}]")
    recs["planes_chunk_gram"] = dict(
        name="planes_chunk_gram", route="cuda",
        source="doa_tpu_torch/csrc/covariance.cu",
        replaces="doa_tpu/ops/pallas/covariance.py:34",
        max_abs_err=k8["ring_interleaved"]["max_abs_err"],
        ms=t8["ring_interleaved"], plain_ms=t8["plain"],
        # the planes read once; (Rr, Ri) a chunk; R = Σ x xᴴ Hermitian,
        # 4·N² FLOP a sample for its half
        **bound(2 * T3 * N3 * 4 + 2 * (T3 // 1024) * N3 * N3 * 4,
                4 * T3 * N3 * N3),
        library_ms=lib8_ms, by_form=k8, plain_bf16_ms=t8["plain bf16"])

    # kernel 12 exact, each form on integer samples: (N, S, overlap, T,
    # the form windows_form names); the chunk-sum form also on separate
    # planes and on every third value (its planar and one-value loads)
    def per_window(xr, xi, S, ov):
        return k12_per_window(torch, xr, xi, S, ov)

    for N, S, ov, T12, want in K12_EXACT:
        xq = torch.randint(-20, 21, (T12 * 3 * N,), generator=gen,
                           device=dev).float()
        x2v = xq[:T12 * 2 * N].view(T12, N, 2)
        x3v = xq.view(T12, N, 3)
        layouts = [("stride2", (x2v[..., 0], x2v[..., 1]))]
        if (N, S) == (16, 256):
            layouts += [("planar", (x2v[..., 0].contiguous(),
                                    x2v[..., 1].contiguous())),
                        ("stride3", (x3v[..., 0], x3v[..., 2]))]
        for name, (xr, xi) in layouts:
            got, form = form_of(lambda: cv.cov_windows(xr, xi, S, ov),
                                cv.cov_windows)
            d = dmax(got, cv.cov_windows_plain(xr, xi, S, ov))
            B12 = got[0].shape[0]
            log(f"kernel 12 exact-input N={N} S={S} overlap={ov} {name} "
                f"({B12} windows, {form}): max|kernel-plain| = {d!r} "
                f"(must be 0)")
            check(form == want, f"kernel 12 took {form}, not {want}")
            check(d == 0.0, f"kernel 12 {form} differs on exact inputs")
        if want == "chunk_sums" and N == 16:      # the other form, too
            xr, xi = x2v[..., 0], x2v[..., 1]
            d = dmax(per_window(xr, xi, S, ov),
                     cv.cov_windows_plain(xr, xi, S, ov))
            log(f"kernel 12 exact-input N={N} S={S} overlap={ov} stride2 "
                f"(per_window, its C entry): max|kernel-plain| = {d!r} "
                f"(must be 0)")
            check(d == 0.0, "kernel 12 per_window differs on exact inputs")
        if S == 96:     # the yardstick: the card's plain version, the CPU's
            xr, xi = x2v[..., 0], x2v[..., 1]
            d = dmax(cv.cov_windows_plain(xr, xi, S, ov),
                     [t.to(dev) for t in cv.cov_windows_plain(
                         xr.cpu(), xi.cpu(), S, ov)])
            log(f"cov_windows_plain N={N} S={S} overlap={ov}, card against "
                f"CPU: max|card-cpu| = {d!r} (must be 0)")
            check(d == 0.0, "cov_windows_plain differs from the CPU's")
        del xq, x2v, x3v
    # on the c3 scene: N = 16, S = 1024, overlap 1000 (hop 24, gcd 8)
    S, ov = 1024, 1000
    xr, xi = x3[:T_K12, :, 0], x3[:T_K12, :, 1]
    B12 = (T_K12 - S) // (S - ov) + 1
    ref = cv.cov_windows_plain(xr, xi, S, ov)
    s12 = ref[0].abs().max().item()
    got, form = form_of(lambda: cv.cov_windows(xr, xi, S, ov),
                        cv.cov_windows)
    k12 = {"chunk_sums": {"max_abs_err": dmax(got, ref)},
           "per_window": {"max_abs_err": dmax(per_window(xr, xi, S, ov),
                                              ref)}}
    del got, ref
    for f, r in k12.items():
        log(f"kernel 12 {f} c3 scene ({B12} windows): max|kernel-plain| = "
            f"{r['max_abs_err']!r}, max|Rr| = {s12!r}, tol 1e-5*max|Rr|")
        check(r["max_abs_err"] <= 1e-5 * s12, f"kernel 12 {f} disagrees "
                                              f"with plain")
    check(form == "chunk_sums", f"kernel 12 at c3's shape took {form}")
    fns = {"plain": lambda: cv.cov_windows_plain(xr, xi, S, ov),
           "chunk_sums": lambda: cv.cov_windows(xr, xi, S, ov),
           "per_window": lambda: per_window(xr, xi, S, ov)}
    t12 = dict(zip(fns, turns_ms(torch, *fns.values())))
    for f in k12:
        k12[f]["ms"] = t12[f]
    # the library's form: one complex batched product over the windows of
    # the capture's unfold view, R = Σ x xᴴ a window (the 1/S the kernel
    # folds in is left out: one multiply an output value)
    xw = torch.view_as_complex(x3[:T_K12]).unfold(0, S, S - ov)
    with fp32_matmuls():
        lib12_ms = time_ms(torch, lambda: torch.matmul(xw, xw.mT.conj()))
    del xw
    log(f"kernel 12 time ({B12} windows of {S}x16, hop {S - ov}, in turns): "
        + ", ".join(f"{k} {v:.4f} ms" for k, v in t12.items())
        + f"; library (one complex torch.matmul on the unfold view) "
        f"{lib12_ms:.4f} ms  [{card}]")
    n12 = T_K12 // math.gcd(S, S - ov)
    recs["planes_cov_windows"] = dict(
        name="planes_cov_windows", route="cuda",
        source="doa_tpu_torch/csrc/covariance.cu",
        replaces="doa_tpu/ops/pallas/covariance.py:94",
        max_abs_err=k12["chunk_sums"]["max_abs_err"],
        ms=t12["chunk_sums"], plain_ms=t12["plain"],
        # the capture read once, (Rr, Ri) a window; the least arithmetic
        # is the Hermitian chunk Grams at the windows' gcd (4·N² FLOP a
        # sample), a running sum over chunks and one difference a window
        # (N² distinct reals each)
        **bound(T_K12 * 32 * 4 + B12 * 2 * 256 * 4,
                4 * T_K12 * 256 + (n12 + B12) * 256),
        library_ms=lib12_ms, by_form=k12)

    # K4 at the planes path's new shapes, exact: E a signed permutation per
    # window (every MGS dot product 0, every norm 1, every sum exact)
    for n2, K in ((24, 3), (16, 2)):
        Eq = signed_permutations(torch, 4096, n2, gen, dev)
        starts = [("cold", None)]
        if K == 2:
            starts.append(("warm", Eq[:1, :2 * K, :].clone()))
        for start, ini in starts:
            outk = cpx_ops.mgs_iterate(Eq, K, 8, ini)
            outp = cpx_ops.mgs_iterate_plain(Eq, K, 8, ini)
            d = max((a - b).abs().max().item() for a, b in zip(outk, outp))
            log(f"K4 exact-input (2N, 2K) = ({n2}, {2 * K}) {start} 8 rounds:"
                f" max|kernel-plain| over Vt, W, Vt_prev = {d!r} (must be 0)")
            check(d == 0.0, f"K4 ({n2}, {2 * K}) differs on exact inputs")
    # K4 on the c3 scene's smoothed windows (the planes path's cold start)
    cr1 = torch.ones(16, device=dev)
    ci0 = torch.zeros(16, device=dev)
    from doa_tpu_torch import PRESETS
    from doa_tpu_torch.pipeline_torch import compute_covariances
    with fp32_matmuls():
        R = compute_covariances(x3[..., 0], x3[..., 1],
                                PRESETS["c3_ula16_calib_smooth"], (cr1, ci0))
        E = embed_planes(*R)
        k4_scene(torch, "c3", E, 3, 8, None)
        t4 = k4_times(torch, "c3", E, 3, 8, None, card)
    if k4_shapes is not None:
        k4_shapes["c3"] = t4
    return recs


def calibrate(torch, dev, factor, card):
    """Phase 9a: the two-stage calibration on the card → the correction
    loaded back from its artifact (numpy complex64[16])."""
    import numpy as np
    from doa_tpu_torch import calib
    from doa_tpu_torch.ops.cpx_ops import (apply_correction_to_cov,
                                           cov_from_stream)

    N = 16
    t0 = time.perf_counter()
    # stage 1: one common tone into every chain (broadside: a = 1)
    x = impair(torch, make_ula_capture(torch, T_CAL, N, ((90.0, 1, 10),),
                                       25.0, dev, seed=4), factor)
    phi = calib.phase_offset_est(torch.view_as_complex(x))
    c1 = calib.phase_correction(phi)
    # stage 2: a pilot at a known angle, after the stage-1 correction
    x = impair(torch, make_ula_capture(torch, T_CAL, N, (
        (PILOT_DEG, 1, 10),), 25.0, dev, seed=5), factor)
    Rr, Ri = cov_from_stream(x[..., 0], x[..., 1], 2048, 0)
    Rr, Ri = apply_correction_to_cov(Rr, Ri, c1.real.contiguous(),
                                     c1.imag.contiguous())
    c2 = calib.average_corrections(calib.element_calibration(
        torch.complex(Rr, Ri), PILOT_DEG, 0.5))
    del x
    art = calib.CalibrationArtifact(
        phase_offsets=phi.cpu().numpy(), element_corrections=c2.cpu().numpy(),
        num_elements=N, norm_spacing=0.5, pilot_theta_deg=PILOT_DEG)
    with tempfile.TemporaryDirectory() as out_dir:
        path = os.path.join(out_dir, "c3_calibration.npz")
        calib.save_calibration(path, art)
        corr = calib.load_calibration(path).correction_vector()
    # the corrected chain: c · factor ∝ 1 up to one common complex gain
    resid = corr * factor
    resid = resid / resid[0]
    err = float(np.abs(resid - 1).max())
    log(f"calibration on the card (stage 1 common tone, stage 2 pilot at "
        f"{PILOT_DEG} deg, {T_CAL} samples each, artifact round trip): "
        f"max|c·impairment/(c·impairment)_0 - 1| = {err!r} (tol 2e-2); "
        f"{time.perf_counter() - t0:.2f} s")
    check(err <= 2e-2, "calibration did not undo the impairments")
    return corr


def planes_phases(torch, dev, card, k4_shapes=None, k2_shapes=None):
    """Phases 8 and 9 → (kernel records, the launches of K4 in the c3 and
    c2 paths); K4's time at c3 goes into `k4_shapes` and K2's records at
    c3 and c2 into `k2_shapes` if given."""
    import numpy as np
    from doa_tpu_torch import PRESETS
    from doa_tpu_torch.cpx import embed_planes, fp32_matmuls
    from doa_tpu_torch.ops import cpx_ops
    from doa_tpu_torch.ops.cuda import cov_embedded as ce
    from doa_tpu_torch.ops.cuda import covariance as cv
    from doa_tpu_torch.ops.cuda import music_scan as ms
    from doa_tpu_torch.ops.peaks import find_local_max
    from doa_tpu_torch.pipeline_torch import (build_pipeline_torch,
                                              compute_covariances)

    factor = impairments(16)
    x3 = make_ula_capture(torch, T_C3, 16, c3_sources(), SNR_DB, dev, seed=3)
    torch.cuda.synchronize()
    recs = planes_parity(torch, dev, x3, card, k4_shapes)

    # 9. the slice's paths
    corr = calibrate(torch, dev, factor, card)
    impair(torch, x3, factor)
    xr, xi = x3[..., 0], x3[..., 1]                  # strided card views
    cfg3 = PRESETS["c3_ula16_calib_smooth"]
    pipes = {rs: build_pipeline_torch(cfg3, device=dev, return_spectra=rs)
             for rs in (False, True)}
    for rs, p in pipes.items():
        show_plan(f"c3 return_spectra={rs}", p)
    counters = {"planes_chunk_gram": cv.chunk_grams,
                "planes_cov_windows": cv.cov_windows,
                "mgs_iterate": cpx_ops.mgs_iterate,
                "music_scan": ms.music_scan,
                "music_scan_peaks": ms.music_scan_peaks,
                "chunk_gram": ce.chunk_grams_uhat,
                "chunk_embedded": ce.chunk_embedded}
    for f in counters.values():
        f.launches = 0
    ms.music_scan_peaks.tc_launches = 0
    for by_form in (cv.chunk_grams.by_form, cv.cov_windows.by_form):
        by_form.update(dict.fromkeys(by_form, 0))
    k4_forms_zero()
    res = {rs: p((xr, xi), corr) for rs, p in pipes.items()}
    torch.cuda.synchronize()
    n3 = {k: f.launches for k, f in counters.items()}
    k4_forms("c3 path", pipes.values(), n3["mgs_iterate"])
    n3["music_scan_peaks (tensor-core form)"] = (
        ms.music_scan_peaks.tc_launches)
    k8_forms = dict(cv.chunk_grams.by_form)
    log("launches in the c3 path (both return_spectra modes): "
        + json.dumps(n3) + "; kernel 8 by form " + json.dumps(k8_forms)
        + "; the plan's kernel 8 forms "
        + json.dumps(pipes[False].plan.forms))
    check(k8_forms["ring_interleaved"] == n3["planes_chunk_gram"],
          "kernel 8 left its ring form on c3's strided views")
    check(pipes[False].plan.forms.get("covariance") == "ring_interleaved",
          "c3's plan does not name the ring form")
    check(n3["music_scan_peaks (tensor-core form)"]
          == n3["music_scan_peaks"], "K2 left its tensor-core form at c3")
    check(n3["planes_chunk_gram"] > 0 and n3["mgs_iterate"] > 0
          and n3["music_scan"] > 0 and n3["music_scan_peaks"] > 0,
          "a kernel of the c3 path never ran")
    check(n3["planes_cov_windows"] == 0 and n3["chunk_gram"] == 0
          and n3["chunk_embedded"] == 0,
          "kernel 12, K1 or kernel 9 ran in the c3 path")
    recs["planes_chunk_gram"]["launches"] = n3["planes_chunk_gram"]
    recs["planes_chunk_gram"]["launches_by_form"] = k8_forms
    B3 = T_C3 // 1024
    for rs, r in res.items():
        ang = r.peak_angles["music"]
        check(tuple(ang.shape) == (B3, 3), f"c3 angles {tuple(ang.shape)}")
        e = sorted_err(torch, ang, C3_TRUTH)
        log(f"c3 path return_spectra={rs}: {B3} windows, max angle error "
            f"{e!r} deg (limit {ANGLE_TOL}), escalation flagged "
            f"{int(r.escalation_flagged)}, overflow "
            f"{int(r.escalation_overflow)}")
        check(e <= ANGLE_TOL, f"c3 angle error {e}")
    P = res[True].spectra["music"]
    check(tuple(P.shape) == (B3, 1024) and bool(torch.isfinite(P).all()),
          "c3 spectra not finite or of the wrong shape")
    del res, P
    for rs, p in pipes.items():
        ts = call_times(torch, lambda: p((xr, xi), corr), reps=20, warm=3)
        med = 0.5 * (ts[9] + ts[10])
        log(f"c3 path return_spectra={rs}: median {med:.4f} ms per call of "
            f"{B3} windows (20 calls, min {ts[0]:.4f}, max {ts[-1]:.4f}) = "
            f"{B3 / (med / 1e3):.1f} snapshots/s  [{card}]")
    cr = torch.from_numpy(np.ascontiguousarray(corr.real)).to(dev)
    ci = torch.from_numpy(np.ascontiguousarray(corr.imag)).to(dev)
    pipe = pipes[True]
    At = torch.cat(pipe.steering_planes, -1).contiguous()
    nrm = (At * At).sum(-1)
    esc = cfg3.escalate_kwargs
    with fp32_matmuls():
        R = compute_covariances(xr, xi, cfg3, (cr, ci))
        E = embed_planes(*R)
        Vt = cpx_ops.signal_subspace_from_E_T(E, 3, iters=8)
        scan_parity(torch, "c3", Vt, At, nrm, 3, C3_TRUTH, card,
                    k2_shapes)
        P = ms.music_scan(Vt, At, nrm)
        Pn = P / P.max(-1, keepdim=True).values
        k2_tiles = ms.peaks_tiles(At, 6)
        layers = {
            "covariance (kernel 8 + windows + correction, FB, smoothing)":
                lambda: compute_covariances(xr, xi, cfg3, (cr, ci)),
            "subspace (cold MGS K4 + detector)":
                lambda: cpx_ops.signal_subspace_from_E_T(
                    embed_planes(*R), 3, iters=8, return_stats=True, **esc),
            "scan (K3 + normalise)": lambda: (lambda q: q / q.max(
                -1, keepdim=True).values)(ms.music_scan(Vt, At, nrm)),
            "peaks (find_local_max)": lambda: find_local_max(
                Pn, 3, 0.0, 180.0, refine=True),
            "scan + peaks (K2)": lambda: ms.music_scan_peaks(
                Vt, At, 3, 0.0, 180.0, True, nrm, k2_tiles),
        }
        out = {k: time_ms(torch, f) for k, f in layers.items()}
    log("c3 layer times, ms: " + ", ".join(f"{k} {v:.4f}"
                                          for k, v in out.items())
        + f"  [{card}]")
    del R, E, Vt, P, Pn
    profile_window(torch, lambda: pipes[False]((xr, xi), corr), card)

    # c3 with eigh at overlap 512 on B_EIGH windows
    cfg_e = dataclasses.replace(cfg3, overlap=512, subspace_method="eigh")
    Te = (B_EIGH - 1) * 512 + 1024
    r = build_pipeline_torch(cfg_e, device=dev)((xr[:Te], xi[:Te]), corr)
    e = sorted_err(torch, r.peak_angles["music"], C3_TRUTH)
    log(f"c3 eigh overlap 512: {r.peak_angles['music'].shape[0]} windows, "
        f"max angle error {e!r} deg (limit {ANGLE_TOL})")
    check(r.peak_angles["music"].shape[0] == B_EIGH and e <= ANGLE_TOL,
          f"c3 eigh angle error {e}")

    # the card against the CPU on B_CPU c3 windows
    xs = x3[:B_CPU * 1024].cpu()
    a_gpu = pipes[False]((xr[:B_CPU * 1024], xi[:B_CPU * 1024]), corr)
    a_cpu = build_pipeline_torch(cfg3, device="cpu", return_spectra=False)(
        (xs[..., 0], xs[..., 1]), corr)
    d3 = (a_gpu.peak_angles["music"].cpu().sort(-1).values
          - a_cpu.peak_angles["music"].sort(-1).values).abs().max().item()
    log(f"c3 card vs CPU pipeline on {B_CPU} windows: max sorted angle "
        f"difference {d3!r} deg (tol 1e-3)")
    check(d3 <= 1e-3, "c3 card and CPU pipelines disagree")
    del x3, xr, xi, xs, pipes, pipe

    # c2 (fused path, MUSIC + Capon) at T_C2
    cfg2 = PRESETS["c2_ula8_2src"]
    x2 = make_ula_capture(torch, T_C2, 8, ((60.0, 1, 10), (110.0, 31, 100)),
                          SNR_DB, dev, seed=2)
    pipe2 = build_pipeline_torch(cfg2, device=dev, return_spectra=False)
    show_plan("c2", pipe2)
    for f in counters.values():
        f.launches = 0
    ms.music_scan_peaks.tc_launches = 0
    k4_forms_zero()
    r2 = pipe2.interleaved(x2)
    torch.cuda.synchronize()
    n2 = {k: f.launches for k, f in counters.items()}
    k4_forms("c2 path", (pipe2,), n2["mgs_iterate"])
    n2["music_scan_peaks (tensor-core form)"] = (
        ms.music_scan_peaks.tc_launches)
    log("launches in the c2 path: " + json.dumps(n2))
    check(n2["music_scan_peaks (tensor-core form)"]
          == n2["music_scan_peaks"], "K2 left its tensor-core form at c2")
    # overlap 0: the covariance stage launches kernel 9's entry, not K1
    check(n2["chunk_embedded"] > 0 and n2["chunk_gram"] == 0
          and n2["mgs_iterate"] > 0 and n2["music_scan_peaks"] > 0,
          "a kernel of the c2 path never ran, or K1 ran")
    B2 = T_C2 // 2048
    for key in ("music", "capon"):
        ang = r2.peak_angles[key]
        check(tuple(ang.shape) == (B2, 2), f"c2 {key} {tuple(ang.shape)}")
        e = sorted_err(torch, ang, C2_TRUTH)
        log(f"c2 path {key}: {B2} windows, max angle error {e!r} deg (limit "
            f"{ANGLE_TOL})")
        check(e <= ANGLE_TOL, f"c2 {key} angle error {e}")
    At2 = torch.cat(pipe2.steering_planes, -1).contiguous()
    with fp32_matmuls():
        E2 = ce.cov_embedded(x2, torch.ones(8, device=dev),
                             torch.zeros(8, device=dev), N=8,
                             snapshot_size=2048)
        Vt2 = cpx_ops.signal_subspace_from_E_T(E2, 2, iters=8)
        scan_parity(torch, "c2", Vt2, At2, (At2 * At2).sum(-1), 2,
                    C2_TRUTH, card, k2_shapes)
        # K4 at c2's warm refine: 3 rounds from the capture-mean subspace
        init2 = cpx_ops.mgs_iterate_plain(E2.mean(0, keepdim=True), 2,
                                          8)[0].expand(E2.shape[0], -1, -1)
        k4_scene(torch, "c2", E2, 2, 3, init2)
        t4 = k4_times(torch, "c2", E2, 2, 3, init2, card)
        if k4_shapes is not None:
            k4_shapes["c2"] = t4
    del E2, Vt2, init2
    ts = call_times(torch, lambda: pipe2.interleaved(x2), reps=20, warm=3)
    med = 0.5 * (ts[9] + ts[10])
    log(f"c2 path (MUSIC + Capon, peaks only): median {med:.4f} ms per call "
        f"of {B2} windows (20 calls, min {ts[0]:.4f}, max {ts[-1]:.4f}) = "
        f"{B2 / (med / 1e3):.1f} snapshots/s  [{card}]")
    profile_window(torch, lambda: pipe2.interleaved(x2), card)
    xc64 = x2[:B_CPU * 2048].cpu().numpy().view("complex64")[..., 0]
    g = pipe2(xc64)
    c = build_pipeline_torch(cfg2, device="cpu", return_spectra=False)(xc64)
    d2 = max((g.peak_angles[k].cpu().sort(-1).values
              - c.peak_angles[k].sort(-1).values).abs().max().item()
             for k in ("music", "capon"))
    log(f"c2 card vs CPU pipeline on {B_CPU} windows: max sorted angle "
        f"difference (MUSIC, Capon) {d2!r} deg (tol 1e-3)")
    check(d2 <= 1e-3, "c2 card and CPU pipelines disagree")
    del x2, r2

    # the cov_windows entry (kernel 12's route, gcd < 64), driven as a
    # user calls it, counts from zero
    xq = make_ula_capture(torch, T_K12, 16, c3_sources(), SNR_DB, dev,
                          seed=6)
    for f in counters.values():
        f.launches = 0
    for by_form in (cv.chunk_grams.by_form, cv.cov_windows.by_form):
        by_form.update(dict.fromkeys(by_form, 0))
    Rw = cv.cov_windows(xq[..., 0], xq[..., 1], 1024, 1000)
    torch.cuda.synchronize()
    B12 = (T_K12 - 1024) // 24 + 1
    check(tuple(Rw[0].shape) == (B12, 16, 16)
          and bool(torch.isfinite(Rw[0]).all()), "cov_windows output")
    log(f"cov_windows entry (S=1024, overlap 1000, {B12} windows): launches "
        f"kernel 12 {cv.cov_windows.launches} (by form "
        f"{json.dumps(cv.cov_windows.by_form)}), kernel 8 "
        f"{cv.chunk_grams.launches}")
    check(cv.cov_windows.launches > 0 and cv.chunk_grams.launches == 0,
          "the cov_windows entry did not take kernel 12")
    check(cv.cov_windows.by_form["chunk_sums"] == cv.cov_windows.launches,
          "the cov_windows entry left kernel 12's chunk-sum form")
    recs["planes_cov_windows"]["launches"] = cv.cov_windows.launches
    recs["planes_cov_windows"]["launches_by_form"] = dict(
        cv.cov_windows.by_form)
    return recs, n3["mgs_iterate"] + n2["mgs_iterate"]


# ---------------------------------------------------------------------
# 10-11: the wideband front end at any F (kernels 7, 10) and the coherent
# fusions (cssm, cssm_auto)
# ---------------------------------------------------------------------

T_F12 = 2048 * 768                 # c5_f12: 2048 windows of 768 samples
B_CSSM_CPU = 32                    # the card against the CPU, each path
ULA_TRUTH = (65.0, 115.0)          # tests/test_cssm.py's ULA-16 scene
T_ULA = 1 << 20                    # 1024 windows of 1024
CSSM_ANGLE_TOL = 2.0               # degrees, the median (test_cssm.py)


def c5_variant(**over):
    """PRESETS["c5_ura64_wideband"] with fields of its WidebandSpec (and
    snapshot_size) replaced."""
    from doa_tpu_torch import PRESETS
    c5 = PRESETS["c5_ura64_wideband"]
    S = over.pop("snapshot_size", c5.snapshot_size)
    return dataclasses.replace(
        c5, snapshot_size=S,
        wideband=dataclasses.replace(c5.wideband, **over))


def make_wideband_ula_capture(torch, T, N, thetas, bw, fbw, snr_db, device,
                              seed, tones=12):
    """A wideband ULA capture by the model of
    doa_tpu.io.synthetic.synth_wideband_ula_iq as the interleaved buffer
    x f32[T, 2N], made on the device: each source's band (centred on 0,
    width bw) as `tones` unit-power tones with random start phases, tone f
    steered at the effective spacing 0.5·(1 + f·fbw); complex white noise
    of power 10^(−snr/10) per element."""
    import numpy as np
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((T, N, 2), generator=gen, device=device)
    x *= math.sqrt(10.0 ** (-snr_db / 10.0) / 2.0)
    xc = torch.view_as_complex(x)
    t = torch.arange(T, device=device, dtype=torch.float64)
    k = torch.arange(N, device=device, dtype=torch.float64)
    for theta in thetas:
        for f in bw * np.linspace(-0.5, 0.5, tones):
            ph = 2.0 * math.pi * torch.frac(t * f) + rng.uniform(0, 2 * math.pi)
            s = torch.polar(torch.full_like(ph, 1.0 / math.sqrt(tones)), ph)
            d_eff = 0.5 * (1.0 + f * fbw)
            a = torch.polar(torch.ones_like(k), -2.0 * math.pi * d_eff
                            * math.cos(math.radians(theta)) * k)
            xc += (s[:, None] * a[None, :]).to(torch.complex64)
    return x.reshape(T, 2 * N)


def ula16_wideband(fusion, estimators):
    """Phase 11c's ULA-16 wideband config: S = 1024, F = 16, fractional
    bandwidth 0.4, FB, the default 180-point grid, and under "cssm"
    smoothing to L = 12 (cssm_auto's steering is the whole array's)."""
    from doa_tpu_torch import (ArrayGeometry, AvgMethod, DoaConfig,
                               SmoothingSpec, WidebandSpec)
    return DoaConfig(
        geometry=ArrayGeometry(kind="ula", num_elements=16, norm_spacing=0.5),
        snapshot_size=1024, num_sources=2, num_max_vals=2,
        estimators=estimators,
        wideband=WidebandSpec(num_subbands=16, fractional_bw=0.4,
                              fusion=fusion),
        avg_method=AvgMethod.FORWARD_BACKWARD,
        smoothing=SmoothingSpec(
            subarray_size=12 if fusion == "cssm" else 0))


# kernel 7 exact: (F, N, g, chunks, offset in floats of the view into its
# buffer): every tile form of the ring kernel (N = 64, 36, 16 at RT = 4;
# 6, 32 at 2; 5, 1 at 1), several stages a chunk (g = 300), and views one
# complex element in, which break a bulk copy's 16 bytes; kernel 10 takes
# the same streams at offset 0
SUBBAND_EXACT = ((12, 64, 64, 7, 0), (16, 64, 64, 3, 0), (10, 16, 24, 13, 0),
                 (4, 36, 16, 5, 0), (4, 6, 100, 5, 0), (2, 32, 300, 3, 0),
                 (3, 5, 40, 9, 0), (6, 1, 8, 3, 0), (12, 64, 64, 7, 2),
                 (5, 6, 7, 60, 2), (10, 16, 3, 40, 2), (3, 5, 40, 9, 2))


def subband_parity(torch, dev, x12, x16, card):
    """Phase 10 → the records of kernel 7 (the ring kernel's stream
    source), the "embedded" variant's frames launch and kernel 10
    (launches filled in later). x12, x16: the c5 scene at T_F12 and T_C5
    samples."""
    from doa_tpu_torch.cpx import fp32_matmuls
    from doa_tpu_torch.ops.cuda import wideband_cov as wc

    recs = {}
    gen = torch.Generator(device=dev).manual_seed(7)

    def ri(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=gen, device=dev).float()

    # exact: integer stream and correction, scale 1/16, every sum an
    # integer below 2^24; the plain versions in float64, rounded once
    for F, N, g, n, off in SUBBAND_EXACT:
        buf = ri(-4, 5, (n * g * F * 2 * N + 2,))
        y = buf[off:off + n * g * F * 2 * N].view(n * g, F * 2 * N)
        cr, ci = ri(-1, 3, (N,)), ri(-1, 2, (N,))
        d7 = (wc.subband_embedded(y, cr, ci, F=F, N=N, g=g, scale=1.0 / 16)
              - wc.subband_embedded_plain(y.double(), cr, ci, F=F, N=N, g=g,
                                          scale=1.0 / 16)).abs().max().item()
        d10 = (wc.subband_grams(y, F=F, N=N, g=g)
               - wc.subband_grams_plain(y.double(), F=F, N=N, g=g)
               ).abs().max().item()
        log(f"kernels 7/10 exact-input F={F} N={N} g={g} n={n} offset {off}: "
            f"max|kernel-plain| = {d7!r} / {d10!r} (must be 0)")
        check(d7 == 0.0 and d10 == 0.0,
              f"kernel 7 or 10 differs on exact inputs at F={F} N={N} "
              f"offset {off}")

    # kernel 7 at c5_f12's full shape, on the c5 scene channelized
    cr1, ci0 = torch.ones(64, device=dev), torch.zeros(64, device=dev)
    S_sub, _, g = wc.subband_framing(12, 768, 0)
    K12 = wc.channelizer_on(12, 64, dev)
    xf12 = x12.reshape(-1, 12 * 128)
    Y12 = wc.channelize_frames(xf12, K12)
    kw7 = dict(F=12, N=64, g=g, scale=1.0 / S_sub)
    E7 = wc.subband_embedded(Y12, cr1, ci0, **kw7)
    Ep = wc.subband_embedded_plain(Y12, cr1, ci0, **kw7)
    e7 = (E7 - Ep).abs().max().item()
    s7 = Ep.abs().max().item()
    del Ep
    log(f"kernel 7 c5_f12 scene {tuple(E7.shape)}: max|kernel-plain| = "
        f"{e7!r}, max|E| = {s7!r}, tol 1e-5*max|E|")
    check(e7 <= 1e-5 * s7, "kernel 7 disagrees with plain at c5_f12")
    # and at an odd small shape: N = 16, F = 10, 13 chunks, g = 24
    y = torch.randn((13 * 24, 10 * 32), generator=gen, device=dev)
    cr, ci = torch.randn(16, generator=gen, device=dev), torch.randn(
        16, generator=gen, device=dev)
    Eo = wc.subband_embedded(y, cr, ci, F=10, N=16, g=24, scale=1 / 24)
    Eop = wc.subband_embedded_plain(y, cr, ci, F=10, N=16, g=24, scale=1 / 24)
    eo = (Eo - Eop).abs().max().item()
    log(f"kernel 7 N=16 F=10 13 chunks: max|kernel-plain| = {eo!r}, max|E| "
        f"= {Eop.abs().max().item()!r}, tol 1e-5*max|E|")
    check(eo <= 1e-5 * Eop.abs().max().item(), "kernel 7 odd shape")
    # kernel 7, its plain version and the library in turns
    yv12 = Y12.view(-1, g, 12, 128).permute(2, 0, 1, 3)

    def lib7():
        # one batched torch.matmul of the 12 subbands' chunk Grams
        # (interleaved basis; kernel 7 adds the planar fold, correction and
        # scale in its epilogue), as kernel 10's below
        with fp32_matmuls():
            return torch.matmul(yv12.transpose(-1, -2), yv12)
    p7_ms, k7_ms, lib7_ms = turns_ms(
        torch, lambda: wc.subband_embedded_plain(Y12, cr1, ci0, **kw7),
        lambda: wc.subband_embedded(Y12, cr1, ci0, **kw7), lib7)
    # the "embedded" variant's stage on the card: the ring kernel on the
    # frames, against the reference's composition (the channelizer matmul,
    # then kernel 7 on Y) and the composition's plain version, in turns
    Ef = wc.subband_embedded_frames(xf12, cr1, ci0, **kw7)
    Efp = wc.subband_embedded_frames_plain(xf12, cr1, ci0, **kw7)
    ef = (Ef - Efp).abs().max().item()
    sf = Efp.abs().max().item()
    del Efp
    log(f"the ring kernel on the c5_f12 frames (F = 12: four subbands a "
        f"group, G = 3, the split DFT): max|kernel - (channelizer + kernel "
        f"7's plain version)| = {ef!r}, max|E| = {sf!r}, tol 1e-5*max|E|")
    check(ef <= 1e-5 * sf, "the frames launch disagrees with the "
          "reference composition at c5_f12")
    ch12_ms, fr_ms, comp_ms, frp_ms = turns_ms(
        torch, lambda: wc.channelize_frames(xf12, K12),
        lambda: wc.subband_embedded_frames(xf12, cr1, ci0, **kw7),
        lambda: wc.subband_embedded(wc.channelize_frames(xf12, K12), cr1,
                                    ci0, **kw7),
        lambda: wc.subband_embedded_frames_plain(xf12, cr1, ci0, **kw7))
    log(f"kernel 7 time (c5_f12: [{Y12.shape[0]}, {Y12.shape[1]}], g={g}): "
        f"kernel {k7_ms:.4f} ms, plain {p7_ms:.4f} ms, library (one batched "
        f"torch.matmul) {lib7_ms:.4f} ms  [{card}]")
    log(f"c5_f12 front-end stage: the ring kernel on the frames {fr_ms:.4f} "
        f"ms; the composition (the channelizer matmul [{xf12.shape[0]}, "
        f"1536] x [1536, 1536] {ch12_ms:.4f} ms, then kernel 7) "
        f"{comp_ms:.4f} ms; its plain version {frp_ms:.4f} ms  [{card}]")
    n7 = E7.shape[1]
    recs["subband_embedded"] = dict(
        name="subband_embedded", route="cuda",
        source="doa_tpu_torch/csrc/wideband_cov.cu",
        replaces="doa_tpu/ops/pallas/wideband_cov.py:92",
        max_abs_err=e7, ms=k7_ms, plain_ms=p7_ms,
        # the Hermitian Gram's half (4·g·N²) and the correction and scale
        # (8 FLOP a distinct complex entry) a chunk and subband
        **bound(nbytes(Y12, E7), 4 * (g + 1) * 64 * 64 * 12 * n7),
        library_ms=lib7_ms, channelizer_ms=ch12_ms)
    recs["subband_embedded_frames"] = dict(
        name="subband_embedded_frames", route="cuda",
        source="doa_tpu_torch/csrc/wideband_cov.cu",
        replaces="doa_tpu/ops/pallas/wideband_cov.py:92",
        max_abs_err=ef, ms=fr_ms, plain_ms=frp_ms,
        **fft_gram_bound(xf12.shape[0], 12, 64, g),
        library_ms=None, composition_ms=comp_ms, channelizer_ms=ch12_ms)
    del E7, Ef, Y12, yv12, xf12, K12

    # the card's "embedded" route (wideband_cov_embedded) at F = 12, 10, 6
    # against the reference composition's plain version
    for F, x, S in ((12, x12, 768), (10, x16, 640), (6, x16, 384)):
        kw = dict(N=64, F=F, snapshot_size=S, variant="embedded")
        Ee = wc.wideband_cov_embedded(x, cr1, ci0, **kw)
        Er = wc.wideband_cov_embedded(
            x, cr1, ci0, kernel=wc.subband_embedded_frames_plain, **kw)
        d = (Ee - Er).abs().max().item()
        se = Er.abs().max().item()
        log(f"front end \"embedded\" F={F} {tuple(Ee.shape)}: max|card - "
            f"reference composition| = {d!r}, max|E| = {se!r}, tol "
            f"2e-5*max|E|")
        check(d <= 2e-5 * se, f"the embedded route disagrees at F={F}")
        del Ee, Er

    # kernel 10 at c5 (F = 16); the wrapper accepts sb_group and ignores it
    S_sub, _, g = wc.subband_framing(16, 1024, 0)
    K16 = wc.channelizer_on(16, 64, dev)
    xf16 = x16.reshape(-1, 16 * 128)
    Y16 = wc.channelize_frames(xf16, K16)
    U1 = wc.subband_grams(Y16, F=16, N=64, g=g)
    d_sbg = (wc.subband_grams(Y16, F=16, N=64, g=g, sb_group=2)
             - U1).abs().max().item()
    Up = wc.subband_grams_plain(Y16, F=16, N=64, g=g)
    e10 = (U1 - Up).abs().max().item()
    s10 = Up.abs().max().item()
    del Up
    log(f"kernel 10 c5 scene {tuple(U1.shape)}: max|kernel-plain| = {e10!r}, "
        f"max|U| = {s10!r}, tol 1e-5*max|U|; sb_group 2 vs 1: {d_sbg!r} "
        f"(must be 0)")
    check(e10 <= 1e-5 * s10 and d_sbg == 0.0, "kernel 10 disagrees")
    k10_ms, p10_ms = pair_ms(
        torch, lambda: wc.subband_grams(Y16, F=16, N=64, g=g),
        lambda: wc.subband_grams_plain(Y16, F=16, N=64, g=g))
    yv = Y16.view(-1, g, 16, 128).permute(2, 0, 1, 3)
    with fp32_matmuls():
        lib10_ms = time_ms(torch, lambda: torch.matmul(yv.transpose(-1, -2),
                                                       yv))
    ch16_ms = time_ms(torch, lambda: wc.channelize_frames(xf16, K16))
    log(f"kernel 10 time (c5: [{Y16.shape[0]}, 2048], g={g}): kernel "
        f"{k10_ms:.4f} ms, plain {p10_ms:.4f} ms,"
        f" library (one batched torch.matmul) {lib10_ms:.4f} ms; the "
        f"channelizer matmul [{xf16.shape[0]}, 2048] x [2048, 2048] "
        f"{ch16_ms:.4f} ms  [{card}]")
    recs["subband_gram"] = dict(
        name="subband_gram", route="cuda",
        source="doa_tpu_torch/csrc/wideband_cov.cu",
        replaces="doa_tpu/ops/pallas/wideband_cov.py:255",
        max_abs_err=e10, ms=k10_ms, plain_ms=p10_ms,
        # the symmetric Gram's half: g·2N·(2N+1) a chunk and subband
        **bound(nbytes(Y16, U1), g * 128 * 129 * U1.shape[0]
                * U1.shape[1]),
        library_ms=lib10_ms, channelizer_ms=ch16_ms)
    del U1, Y16, yv, xf16

    # the three front-end routes on one c5 capture, F = 16: kernel 4;
    # channelizer + kernel 7; channelizer + kernel 10 + embedding
    kw = dict(N=64, F=16, snapshot_size=1024, K=K16)
    Ef = wc.wideband_cov_embedded(x16, cr1, ci0, variant="fft", **kw)
    sf = Ef.abs().max().item()
    for variant in ("embedded", "uhat"):
        d = (wc.wideband_cov_embedded(x16, cr1, ci0, variant=variant, **kw)
             - Ef).abs().max().item()
        log(f"front end c5 F=16: max|{variant} - fft| = {d!r}, max|E| = "
            f"{sf!r}, tol 2e-5*max|E|")
        check(d <= 2e-5 * sf, f"front-end routes fft and {variant} disagree")
    return recs


def path_run(torch, name, pipe, x, counters, card, truth, tol, call=None):
    """Drive one path once with every count from zero → (result, the
    launches); check the median pair-sorted angles within `tol` of
    `truth`; then 20 timed calls and a profile window."""
    call = call or (lambda: pipe.interleaved(x))
    for f in counters.values():
        f.launches = 0
        by = form_counts(f)
        if by is not None:
            by.update(dict.fromkeys(by, 0))
    res = call()
    torch.cuda.synchronize()
    launches = {n: f.launches for n, f in counters.items()}
    log(f"launches in the {name} path: " + json.dumps(launches))
    if "peaks" in pipe.plan:
        peaks_forms(name, pipe, launches["peaks2d"])
    ang = res.peak_angles["music"]
    B = ang.shape[0]
    if ang.dim() == 3:
        e_max, e_med, med = c5_errors(torch, ang, truth)
    else:
        a = torch.sort(ang, dim=-1).values
        check(bool(torch.isfinite(a).all()), f"{name}: non-finite angles")
        per = (a - torch.tensor(truth, device=a.device)).abs().amax(-1)
        e_max, e_med, med = (float(per.max()), float(per.median()),
                             a.median(dim=0).values)
    dmed = float((med - torch.tensor(truth, device=med.device)).abs().max())
    log(f"{name}: {B} windows, per-window max |angle - truth|: max {e_max!r}"
        f" deg, median {e_med!r} deg; median {med.tolist()} vs truth "
        f"{list(truth)} (limit {tol} deg); escalation counts "
        f"{res.escalation_flagged}, {res.escalation_overflow}")
    check(dmed <= tol, f"{name} median angle off by {dmed}")
    ts = call_times(torch, call, reps=20, warm=3)
    med_ms = 0.5 * (ts[9] + ts[10])
    log(f"{name}: median {med_ms:.4f} ms per call of {B} windows (20 calls, "
        f"min {ts[0]:.4f}, max {ts[-1]:.4f}) = {B / (med_ms / 1e3):.1f} "
        f"snapshots/s  [{card}]")
    profile_window(torch, call, card)
    return res, launches


def card_vs_cpu(torch, name, cfg, x, B):
    """The card's pipeline against the same pipeline on the CPU on the
    first B windows of x: pair-sorted (or sorted) angles within 0.01°."""
    from doa_tpu_torch.pipeline_torch import build_pipeline_torch
    xs = x[:B * cfg.snapshot_size]
    a_gpu = build_pipeline_torch(cfg, device=x.device).interleaved(
        xs).peak_angles["music"].cpu()
    t0 = time.perf_counter()
    a_cpu = build_pipeline_torch(cfg, device="cpu").interleaved(
        xs.cpu()).peak_angles["music"]
    if a_cpu.dim() == 3:
        a_gpu, a_cpu = pair_sorted(torch, a_gpu), pair_sorted(torch, a_cpu)
    else:
        a_gpu, a_cpu = a_gpu.sort(-1).values, a_cpu.sort(-1).values
    d = (a_gpu - a_cpu).abs().max().item()
    log(f"{name} card vs CPU pipeline on {a_cpu.shape[0]} windows: max angle "
        f"difference {d!r} deg (tol 1e-2; CPU run "
        f"{time.perf_counter() - t0:.1f} s)")
    check(a_cpu.shape[0] == B and d <= 1e-2,
          f"{name}: card and CPU pipelines disagree")


def coherent_phases(torch, dev, card, k4_shapes=None):
    """Phases 10 and 11 → (the records of kernels 7 and 10, the launches
    of the earlier kernels in these paths, K3's figures at c5 cssm's
    shapes); K4's time on c5 cssm's R_coh windows goes into `k4_shapes`
    (K4's by_shape) if given."""
    from doa_tpu_torch import AvgMethod, Estimator, SmoothingSpec
    from doa_tpu_torch.cpx import embed_planes, fp32_matmuls, unembed_planes
    from doa_tpu_torch.ops import cpx_ops
    from doa_tpu_torch.ops import wideband as wb
    from doa_tpu_torch.ops.cuda import music_scan as ms
    from doa_tpu_torch.ops.cuda import peaks2d as pk
    from doa_tpu_torch.ops.cuda import wideband_cov as wc
    from doa_tpu_torch.ops.cuda import wideband_scan as wsc
    from doa_tpu_torch.pipeline_torch import build_pipeline_torch

    x12 = make_c5_scene(torch, T_F12, dev, seed=4)
    x16 = make_c5_scene(torch, T_C5, dev, seed=5)
    torch.cuda.synchronize()
    recs = subband_parity(torch, dev, x12, x16, card)

    counters = {"subband_embedded": wc.subband_embedded,
                "subband_embedded_frames": wc.subband_embedded_frames,
                "subband_gram": wc.subband_grams,
                "wideband_fft_gram": wc.subband_chunk_grams,
                "wideband_fusion": wsc.wideband_fused_spectrum,
                "mgs_iterate": cpx_ops.mgs_iterate,
                "music_scan": ms.music_scan,
                "music_scan_peaks": ms.music_scan_peaks,
                "peaks2d": pk.peaks2d}
    total = {n: 0 for n in counters}

    def add(launches):
        for n, v in launches.items():
            total[n] += v

    cr1, ci0 = torch.ones(64, device=dev), torch.zeros(64, device=dev)
    # 11a. c5_f12: 12 subbands, incoherent; the front end is one launch of
    # the ring kernel on the frames: no channelizer matmul, no Y
    cfg12 = c5_variant(snapshot_size=768, num_subbands=12)
    pipe12 = build_pipeline_torch(cfg12, device=dev)
    show_plan("c5_f12", pipe12)
    check(pipe12.plan["covariance"] == "subband_embedded_frames",
          "c5_f12 does not plan the frames launch")
    channelized = []
    channelize = wc.channelize_frames

    def counted(*a, **k):
        channelized.append(1)
        return channelize(*a, **k)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    wc.channelize_frames = counted
    try:
        res12, n12 = path_run(torch, "c5_f12", pipe12, x12, counters, card,
                              C5_TRUTH, C5_ANGLE_TOL)
    finally:
        wc.channelize_frames = channelize
    log(f"c5_f12: channelizer calls {len(channelized)}; peak memory above "
        f"the capture and state {torch.cuda.max_memory_allocated() - base} "
        f"bytes (a Y would be {x12.numel() * 4})")
    check(n12["subband_embedded_frames"] == 1 and n12["subband_embedded"] == 0
          and n12["wideband_fft_gram"] == 0 and not channelized
          and n12["wideband_fusion"] > 0 and n12["mgs_iterate"] > 0
          and n12["peaks2d"] > 0, "c5_f12 launch counts")
    add(n12)
    # its layers, and the reference composition's front end beside the
    # card's
    As12 = torch.cat(pipe12.subband_planes, -1).contiguous()   # (F, G, 2N)
    nrm12 = (As12 * As12).sum(-1)

    def composition(xf, cr, ci, K=None, **kw):
        return wc.subband_embedded(wc.channelize_frames(
            xf, wc.channelizer_on(12, 64, dev)), cr, ci, **kw)
    with fp32_matmuls():
        E12 = wc.wideband_cov_embedded(x12, cr1, ci0, N=64, F=12,
                                       snapshot_size=768)
        Vt12 = wb.subband_subspaces_from_E(E12, cfg12)
        P12 = wsc.wideband_fused_spectrum(Vt12, As12, nrm12)
        P12 = P12.reshape(-1, 181, 91)
        layers = {
            "front end (the ring kernel on the frames)":
                lambda: wc.wideband_cov_embedded(x12, cr1, ci0, N=64, F=12,
                                                 snapshot_size=768),
            "front end, the reference composition (channelizer + kernel 7)":
                lambda: wc.wideband_cov_embedded(
                    x12, cr1, ci0, N=64, F=12, snapshot_size=768,
                    kernel=composition),
            "subspace (per-subband warm MGS + detector)":
                lambda: wb.subband_subspaces_from_E(E12, cfg12),
            "fusion (kernel 5)":
                lambda: wsc.wideband_fused_spectrum(Vt12, As12, nrm12),
            "peaks (2-D)": lambda: pk.peaks2d(P12, 2, (-90.0, 90.0),
                                              (0.0, 90.0), True),
        }
        out = {k: time_ms(torch, f) for k, f in layers.items()}
    log("c5_f12 layer times, ms: " + ", ".join(f"{k} {v:.4f}"
                                              for k, v in out.items())
        + f"  [{card}]")
    del E12, Vt12, P12, As12, nrm12
    # planes input: the stride-2 views of the same capture
    v = x12.view(-1, 64, 2)
    a_pl = pipe12((v[..., 0], v[..., 1])).peak_angles["music"]
    d = (a_pl - res12.peak_angles["music"]).abs().max().item()
    log(f"c5_f12 planes input (stride-2 card views): max|angles - "
        f"interleaved angles| = {d!r} (must be 0)")
    check(d == 0.0, "c5_f12 planes input differs from the interleaved input")
    del res12, a_pl, v

    # 11b. c5 with cssm and cssm_auto: kernel 4, R_coh, cold K4, K3, peaks
    for fusion in ("cssm", "cssm_auto"):
        cfg = c5_variant(fusion=fusion)
        pipe = build_pipeline_torch(cfg, device=dev)
        show_plan(f"c5 {fusion}", pipe)
        res, n = path_run(torch, f"c5 {fusion}", pipe, x16, counters, card,
                          C5_TRUTH, CSSM_ANGLE_TOL)
        check(n["wideband_fft_gram"] == 1 and n["mgs_iterate"] > 0
              and n["music_scan"] > 0 and n["peaks2d"] > 0
              and n["wideband_fusion"] == 0 and n["subband_embedded"] == 0,
              f"c5 {fusion} launch counts")
        add(n)
        P = res.spectra["music"]
        check(tuple(P.shape) == (T_C5 // 1024, 181 * 91)
              and bool(torch.isfinite(P).all()), f"c5 {fusion} spectrum")
        del res, P
    # layer times of the c5 cssm call
    cfg = c5_variant(fusion="cssm")
    T_foc = torch.from_numpy(wb.focusing_matrices(cfg)).to(dev)
    At = torch.cat(build_pipeline_torch(cfg, device=dev).steering_planes,
                   -1).contiguous()
    nrm = (At * At).sum(-1)
    with fp32_matmuls():
        E_sub = wc.wideband_cov_embedded(x16, cr1, ci0, N=64, F=16,
                                         snapshot_size=1024)
        R_sub = torch.complex(*unembed_planes(E_sub))
        R = wb.cssm_covariance(R_sub, T_foc)
        Rr, Ri = R.real.contiguous(), R.imag.contiguous()
        V = cpx_ops.signal_subspace_embedded(Rr, Ri, 2, iters=8)
        Vt = V.transpose(-1, -2).contiguous()
        # K4 on the R_coh windows, as the subspace layer launches it
        t4 = k4_times(torch, "c5 cssm R_coh", embed_planes(Rr, Ri), 2, 8,
                      None, card)
        if k4_shapes is not None:
            k4_shapes["c5 cssm R_coh"] = t4
        # K3 on c5 cssm's own subspaces: den, and its time
        e_c5, k3_c5 = k3_scene(torch, "c5 cssm", Vt, At, nrm, card)
        tiles = ms.scan_tiles(At, 4)
        P = ms.music_scan(Vt, At, nrm, tiles)
        P2 = (P / P.max(-1, keepdim=True).values).reshape(-1, 181, 91)
        layers = {
            "front end (kernel 4)": lambda: wc.wideband_cov_embedded(
                x16, cr1, ci0, N=64, F=16, snapshot_size=1024),
            "unembed": lambda: torch.complex(*unembed_planes(E_sub)),
            "R_coh (complex GEMMs)": lambda: wb.cssm_covariance(R_sub, T_foc),
            "subspace (cold K4 + detector)":
                lambda: cpx_ops.signal_subspace_embedded(
                    Rr, Ri, 2, iters=8, return_stats=True,
                    **cfg.escalate_kwargs),
            "scan (K3)": lambda: ms.music_scan(Vt, At, nrm, tiles),
            "peaks (2-D)": lambda: pk.peaks2d(P2, 2, (-90.0, 90.0),
                                              (0.0, 90.0), True),
        }
        out = {k: time_ms(torch, f) for k, f in layers.items()}
    log("c5 cssm layer times, ms: " + ", ".join(f"{k} {v:.4f}"
                                               for k, v in out.items())
        + f"  [{card}]")
    del E_sub, R_sub, R, Rr, Ri, V, Vt, P, P2, tiles

    # the uhat entry (kernel 10's route), driven as a user calls it
    for f in counters.values():
        f.launches = 0
    Eu = wc.wideband_cov_embedded(x16, cr1, ci0, N=64, F=16,
                                  snapshot_size=1024, variant="uhat")
    torch.cuda.synchronize()
    log(f"wideband_cov_embedded(variant='uhat') entry: launches kernel 10 "
        f"{wc.subband_grams.launches}, kernel 7 "
        f"{wc.subband_embedded.launches}, kernel 4 "
        f"{wc.subband_chunk_grams.launches}")
    check(tuple(Eu.shape) == (16, T_C5 // 1024, 128, 128)
          and wc.subband_grams.launches == 1
          and wc.subband_chunk_grams.launches == 0, "the uhat entry")
    add({"subband_gram": wc.subband_grams.launches})
    del Eu
    # kernel 7's entry: a caller that holds a channelized stream Y
    Y12 = wc.channelize_frames(x12.reshape(-1, 12 * 128),
                               wc.channelizer_on(12, 64, dev))
    for f in counters.values():
        f.launches = 0
    E7 = wc.subband_embedded(Y12, cr1, ci0, F=12, N=64, g=64, scale=1 / 64)
    torch.cuda.synchronize()
    log(f"subband_embedded entry (a channelized stream {tuple(Y12.shape)}): "
        f"launches kernel 7 {wc.subband_embedded.launches}, the frames "
        f"launch {wc.subband_embedded_frames.launches}")
    check(tuple(E7.shape) == (12, T_F12 // 768, 128, 128)
          and wc.subband_embedded.launches == 1
          and wc.subband_embedded_frames.launches == 0,
          "the kernel 7 entry")
    add({"subband_embedded": wc.subband_embedded.launches})
    del E7, Y12

    # 11c. ULA-16 CSSM with FB, smoothing to L = 12, MUSIC + Capon
    cfg_u = ula16_wideband("cssm", (Estimator.MUSIC, Estimator.CAPON))
    xu = make_wideband_ula_capture(torch, T_ULA, 16, ULA_TRUTH, 0.5, 0.4,
                                   SNR_DB, dev, seed=1)
    pipe_u = build_pipeline_torch(cfg_u, device=dev)
    show_plan("ULA-16 cssm", pipe_u)
    res_u, n_u = path_run(torch, "ULA-16 cssm FB + smoothing", pipe_u, xu,
                          counters, card, ULA_TRUTH, CSSM_ANGLE_TOL)
    check(n_u["wideband_fft_gram"] == 1 and n_u["mgs_iterate"] > 0
          and n_u["music_scan"] > 0, "ULA-16 cssm launch counts")
    add(n_u)
    a = torch.sort(res_u.peak_angles["capon"], -1).values
    dcap = float((a.median(0).values
                  - torch.tensor(ULA_TRUTH, device=dev)).abs().max())
    log(f"ULA-16 cssm Capon: median sorted angles {a.median(0).values.tolist()}"
        f" (limit {CSSM_ANGLE_TOL} deg)")
    check(dcap <= CSSM_ANGLE_TOL, f"ULA-16 cssm Capon median off by {dcap}")
    del res_u

    # the card against the CPU, 32 windows of each path
    card_vs_cpu(torch, "c5_f12", cfg12, x12, B_CSSM_CPU)
    card_vs_cpu(torch, "c5 cssm", c5_variant(fusion="cssm"), x16, B_CSSM_CPU)
    card_vs_cpu(torch, "c5 cssm_auto", c5_variant(fusion="cssm_auto"), x16,
                B_CSSM_CPU)
    card_vs_cpu(torch, "ULA-16 cssm", cfg_u, xu, B_CSSM_CPU)
    for name in ("subband_embedded", "subband_embedded_frames",
                 "subband_gram"):
        recs[name]["launches"] = total.pop(name)
    k3_c5 = {f"{key}_c5_cssm": v for key, v in k3_c5.items()}
    k3_c5["max_abs_err_c5_cssm"] = e_c5
    return recs, total, k3_c5


# ---------------------------------------------------------------------
# 12-13: the fused path's opt-in stages (kernel 11 under
# subspace_impl="pallas", the subspace guard), scan_capture and kernel 9
# ---------------------------------------------------------------------

T_BLK = 1 << 21                    # scan_capture: 8 blocks of the capture
T_HARD = 1 << 20                   # the guard's hard scene: 512 windows
T_WB_BLK = 1 << 19                 # wideband scan_capture: 4 blocks
B_SUB_SMALL = 4096                 # kernel 11 at (24, 6) and (16, 4)
B_SUB_C5 = 2048                    # kernel 11 at (128, 4)
NS_PROJ_TOL = 2e-5                 # kernel 11 vs plain: projectors
NS_ORTH_TOL = 2e-4                 # ‖Vt Vtᵀ − I‖∞ of the kernel's rows (E⁴
                                   # at 2N = 128 leaves ~7e-5 on the card)
HARD_TOL = 0.2                     # guarded vs eigh angles, degrees


def ns_flops(B, n2, k2, iters, squarings, ns_iters=12, ns_iters_mid=8):
    """FP32 operations kernel 11's chain needs for B windows: the trace
    scale, each squaring (the upper triangle of the symmetric E², n2²(n2+1)),
    each apply (2·k2·n2²), each round's Gram (its upper triangle,
    k2(k2+1)·n2) and output product (2·k2²·n2), and each Newton–Schulz
    step (Z·Y, Y·T and T·Z are symmetric, being polynomials in the
    preconditioned Gram: the upper triangle of each, 3·k2²(k2+1))."""
    rounds = max(1, iters // (1 << squarings))
    steps = (ns_iters * min(rounds, 2)
             + ns_iters_mid * max(rounds - 2, 0))
    per = (n2 * n2 + squarings * n2 * n2 * (n2 + 1)
           + (rounds - 1) * 2 * k2 * n2 * n2
           + rounds * (k2 * (k2 + 1) * n2 + 2 * k2 * k2 * n2)
           + steps * 3 * k2 * k2 * (k2 + 1))
    return B * per


def ns_parity(torch, tag, E, K, squarings, iters, form):
    """Kernel 11 in `form` against subspace_ns_plain on E: projectors VᵀV
    within NS_PROJ_TOL, the kernel's rows orthonormal within NS_ORTH_TOL
    → the projector error."""
    from doa_tpu_torch.ops.cuda import subspace_ns as sns
    Vk = sns._launch(E, K, form, iters=iters, squarings=squarings)
    Vp = sns.subspace_ns_plain(E, K, iters=iters, squarings=squarings)
    dp = 0.0
    for lo in range(0, E.shape[0], 4096):            # projectors in slices
        a, b = Vk[lo:lo + 4096], Vp[lo:lo + 4096]
        dp = max(dp, (a.transpose(1, 2) @ a - b.transpose(1, 2) @ b)
                 .abs().max().item())
    eye = torch.eye(2 * K, device=E.device)
    do = (Vk @ Vk.transpose(1, 2) - eye).abs().max().item()
    dq = (Vp @ Vp.transpose(1, 2) - eye).abs().max().item()
    log(f"kernel 11 {form} form, {tag} (2N, 2K) = ({E.shape[-1]}, {2 * K}), "
        f"{E.shape[0]} windows, squarings {squarings}, iters {iters}: "
        f"max|projector kernel - plain| = {dp!r} (tol {NS_PROJ_TOL}), "
        f"max|Vt Vtᵀ - I| = {do!r} (tol {NS_ORTH_TOL}; plain {dq!r})")
    check(dp <= NS_PROJ_TOL and do <= NS_ORTH_TOL,
          f"kernel 11 ({form} form) disagrees with plain at {tag}")
    return dp


def ns_scenes(torch, dev, x):
    """Kernel 11's scenes → [(tag, E, K, squarings, iters)]: the headline
    capture x's E at squarings 0, and at squarings 2 a 60/110 deg scene
    of its shape (the headline's 70 and 110 deg mirror each other about
    broadside: E⁴'s first columns then start the chain too near
    rank-deficient, and two rounds of it leave rows far from orthonormal
    in the reference's kernel as in the plain version;
    tests/test_torch_subspace_ns.py); three sources on 12 elements (24, 6)
    and two on 8 (16, 4), B_SUB_SMALL windows each, at squarings 0 (8
    rounds) and 2 (iters 16: 4 rounds); c5's first subband (128, 4),
    B_SUB_C5 windows, at squarings 0 and 2."""
    from doa_tpu_torch.ops.cuda import cov_embedded as ce
    from doa_tpu_torch.ops.cuda import wideband_cov as wc

    def ones(n):
        return torch.ones(n, device=dev), torch.zeros(n, device=dev)
    out = [("headline", ce.cov_embedded(x, *ones(16), N=16,
                                        snapshot_size=1024), 2, 0, 8)]
    x60 = make_ula_capture(torch, x.shape[0], 16, ((60.0, 1, 10),
                                                  (110.0, 31, 100)),
                           SNR_DB, dev, seed=16)
    out.append(("headline shape, 60/110 deg,", ce.cov_embedded(
        x60, *ones(16), N=16, snapshot_size=1024), 2, 2, 8))
    del x60
    for N, srcs in ((12, ((40.0, 1, 10), (70.0, 31, 100), (100.0, 3, 10))),
                    (8, ((60.0, 1, 10), (110.0, 31, 100)))):
        xs = make_ula_capture(torch, B_SUB_SMALL * 256, N, srcs, SNR_DB,
                              dev, seed=N)
        Es = ce.cov_embedded(xs, *ones(N), N=N, snapshot_size=256)
        out += [(f"ULA-{N}", Es, len(srcs), sq, 8 if sq == 0 else 16)
                for sq in (0, 2)]
        del xs
    x5 = make_c5_scene(torch, B_SUB_C5 * 1024, dev, seed=8)
    E5 = wc.wideband_cov_embedded(x5, *ones(64), N=64, F=16,
                                  snapshot_size=1024)[0].contiguous()
    out += [("c5 subband 0", E5, 2, sq, 8) for sq in (0, 2)]
    return out


def routes_vs_f64(torch, x, cr, ci, kw):
    """Both covariance routes on the whole capture x against the same
    windows summed in float64 (chunk Grams, prefix sums, embedding,
    correction and FB): logs each route's max error as a fraction of
    max|E|, and fails past 1e-2 for the "chunk" variant (its windows are
    FP32 prefix-sum differences, whose rounding grows with the chunk
    count) and past 1e-5 for the stacked one (kernel 9's window entry:
    each window its own chunks summed in order)."""
    from doa_tpu_torch.ops.cuda import cov_embedded as ce
    S, ov = kw["snapshot_size"], kw["overlap"]
    hop = S - ov
    g = math.gcd(S, hop)
    n = x.shape[0] // g
    xd = x[:n * g].double().view(n, g, -1)
    U = torch.bmm(xd.transpose(1, 2), xd)
    del xd
    Uw = ce.window_sums(U, (x.shape[0] - S) // hop + 1, S // g, hop // g)
    del U
    E64 = ce.uhat_windows_to_embedded(
        Uw, kw["N"], 1.0 / S, ce.correction_pattern(cr.double(), ci.double()),
        kw["fb"])
    del Uw
    sv = E64.abs().max().item()
    Ev = {v: ce.cov_embedded(x, cr, ci, variant=v, **kw) for v in ce.VARIANTS}
    errs = {v: (e.double() - E64).abs().max().item() / sv
            for v, e in Ev.items()}
    dv = (Ev["chunk"] - Ev["stacked"]).abs().max().item() / sv
    log(f"cov_embedded overlap {ov}, {x.shape[0]} samples: max|chunk - "
        f"stacked| / max|E64| = {dv!r}; against a float64 sum, max|E - E64|"
        f" / max|E64| chunk {errs['chunk']!r} (tol 1e-2), stacked "
        f"{errs['stacked']!r} (tol 1e-5)")
    check(errs["chunk"] <= 1e-2 and errs["stacked"] <= 1e-5,
          f"a covariance route drifts from float64 at overlap {ov}")


def embedded_route(torch, x, W):
    """The covariance stage where a window is one chunk (g = S = 1024, the
    main path's shape): chunk_grams_uhat(x, g, embed=...) launches kernel
    9's entry (by_epilogue "embedded"), bit for bit K1's Grams folded by
    uhat_windows_to_embedded and within 1e-5 of max|E| of the plain
    version, f32 and bf16, FB off and on, with a correction W."""
    from doa_tpu_torch.ops.cuda import cov_embedded as ce

    for dt in (torch.float32, torch.bfloat16):
        xk = x.to(dt)
        for fb in (False, True):
            emb = (16, 1.0 / 1024, W, fb)
            by, k9 = (dict(ce.chunk_grams_uhat.by_epilogue),
                      ce.chunk_embedded.launches)
            Er = ce.chunk_grams_uhat(xk, 1024, embed=emb)
            torch.cuda.synchronize()
            took = (ce.chunk_grams_uhat.by_epilogue["embedded"]
                    - by["embedded"], ce.chunk_embedded.launches - k9)
            Ek1 = ce.uhat_windows_to_embedded(ce.chunk_grams_uhat(xk, 1024),
                                              *emb)
            same = torch.equal(Er.view(torch.int32), Ek1.view(torch.int32))
            del Ek1
            Ep = ce.chunk_grams_uhat_plain(xk, 1024, embed=emb)
            e = (Er - Ep).abs().max().item()
            sc = Ep.abs().max().item()
            del Er, Ep
            log(f"covariance stage with embed, g=1024 {dt} fb={fb}: kernel "
                f"9's entry launched {took[1]} (by_epilogue 'embedded' "
                f"{took[0]}); bit-equal to K1 + the torch fold: {same}; "
                f"max|stage-plain| = {e!r}, max|E| = {sc!r}, tol "
                f"1e-5*max|E|")
            check(took == (1, 1) and same and e <= 1e-5 * sc,
                  f"the covariance stage's embedded epilogue ({dt}, "
                  f"fb={fb})")
        del xk


def window_route(torch, x, W, card):
    """The covariance stage where windows overlap, at c4's shape (2^24
    samples, S = 1024, overlap 512: g = 512, n_win 2, stride 1):
    chunk_grams_uhat(x, 512, embed=..., windows=...) launches kernel 9's
    window entry once (doa_chunk_windows, whose one kernel is
    chunk_windows_kernel: by_epilogue "windows", chunk_embedded.launches;
    K1 never; the card tests name the kernel from the profiler around
    cov_embedded's call, as a region holding its launch alone loses it),
    bit for bit kernel 9's per-chunk E summed in chunk order
    (chunk_embedded + ordered_window_sums) and within 1e-5 of max|E| of
    the plain version (chunk_windows_plain), f32 and bf16, FB off and on,
    with a correction W → the window entry's record (f32, FB on;
    launches filled in later)."""
    from doa_tpu_torch.cpx import fp32_matmuls
    from doa_tpu_torch.ops.cuda import cov_embedded as ce

    g, S = 512, 1024
    B = (x.shape[0] - S) // g + 1
    windows = (B, S // g, 1)
    err = 0.0
    for dt in (torch.float32, torch.bfloat16):
        xk = x.to(dt)
        for fb in (False, True):
            emb = (16, 1.0 / S, W, fb)
            by, k1, k9 = (dict(ce.chunk_grams_uhat.by_epilogue),
                          ce.chunk_grams_uhat.launches,
                          ce.chunk_embedded.launches)
            Ew = ce.chunk_grams_uhat(xk, g, embed=emb, windows=windows)
            torch.cuda.synchronize()
            took = (ce.chunk_grams_uhat.by_epilogue["windows"]
                    - by["windows"], ce.chunk_grams_uhat.launches - k1,
                    ce.chunk_embedded.launches - k9)
            Es = ce.ordered_window_sums(
                ce.chunk_embedded(xk, g, *emb), *windows)
            same = torch.equal(Ew.view(torch.int32), Es.view(torch.int32))
            del Es
            Ep = ce.chunk_windows_plain(xk, g, *emb, windows)
            e = (Ew - Ep).abs().max().item()
            sc = Ep.abs().max().item()
            del Ew, Ep
            log(f"covariance stage with embed and windows, g={g} n_win 2 "
                f"{dt} fb={fb}: by_epilogue 'windows' {took[0]}, K1 "
                f"{took[1]}, kernel 9's entries "
                f"{took[2]}; bit-equal to kernel 9's per-chunk E summed in "
                f"order: {same}; max|stage-plain| = {e!r}, max|E| = {sc!r}, "
                f"tol 1e-5*max|E|")
            check(took == (1, 0, 1) and same
                  and e <= 1e-5 * sc,
                  f"the covariance stage's window epilogue ({dt}, fb={fb})")
            if dt == torch.float32 and fb:
                err = e
        del xk
    emb = (16, 1.0 / S, W, True)
    xv = x.view(-1, g, 32)
    with fp32_matmuls():
        k_ms, p_ms, lib_ms, old_ms = turns_ms(
            torch,
            lambda: ce.chunk_grams_uhat(x, g, embed=emb, windows=windows),
            lambda: ce.chunk_windows_plain(x, g, *emb, windows),
            lambda: torch.bmm(xv.transpose(1, 2), xv),
            lambda: ce.uhat_windows_to_embedded(ce.window_sums(
                ce.chunk_grams_uhat(x, g), *windows), *emb))
    n = x.shape[0] // g
    # the capture read once and each window's E written once; the
    # symmetric Gram's half, the fold, correction and FB of each chunk,
    # and the windows' sums (4 values an item)
    b = bound(x.numel() * 4 + B * 32 * 32 * 4,
              x.shape[0] * 32 * 33 + n * 12 * 16 * 16 + B * 4 * 16 * 17)
    log(f"kernel 9's window entry time [{x.shape[0]}, 32] g={g} n_win 2, "
        f"correction + FB: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, "
        f"library (one torch.bmm of the chunks) {lib_ms:.4f} ms, the route "
        f"it replaces (K1, window_sums, the torch fold) {old_ms:.4f} ms, "
        f"bound {b['bound_ms']:.4f} ms ({b['bound_by']})  [{card}]")
    return dict(
        name="chunk_windows", route="cuda", launches=0,
        source="doa_tpu_torch/csrc/cov_gram.cu",
        replaces="doa_tpu/ops/pallas/cov_embedded.py:331",
        max_abs_err=err, ms=k_ms, plain_ms=p_ms, **b, library_ms=lib_ms,
        replaced_route_ms=old_ms)


def embedded_parity(torch, dev, x, card):
    """Phase 12's kernel-9 part → the records of kernel 9's entry and its
    window entry, by name (launches filled in later).
    x: the headline capture f32[T_MAIN, 32] on the card."""
    from doa_tpu_torch.cpx import fp32_matmuls
    from doa_tpu_torch.ops.cuda import cov_embedded as ce

    gen = torch.Generator(device=dev).manual_seed(9)
    # kernel 9 exact: integer samples |x| ≤ 8 (exact in bf16), integer
    # correction, scale 1/16: every Gram entry, fold, correction product
    # and FB half a multiple of 1/32 far below 2^24, so the kernel and the
    # plain version agree bit for bit (both register-tile forms; odd and
    # one-row chunks; views off the 16-byte alignment)
    ri = lambda lo, hi, shape: torch.randint(  # noqa: E731
        lo, hi, shape, generator=gen, device=dev).float()
    for n2 in GRAM_WIDTHS:
        N = n2 // 2
        W = ce.correction_pattern(ri(-1, 3, (N,)), ri(-1, 2, (N,)))
        for g, n in ((256, 9), (7, 300), (1, 700)):
            xi = ri(-8, 9, (n * g + 1, n2))
            for dt in (torch.float32, torch.bfloat16):
                views = gram_views(xi.to(dt), n2, g, n)
                for where, xk in views if g == 7 else views[:1]:
                    for fb in (False, True):
                        d = (ce.chunk_embedded(xk, g, N, 1.0 / 16, W, fb)
                             - ce.chunk_embedded_plain(xk, g, N, 1.0 / 16,
                                                       W, fb)
                             ).abs().max().item()
                        log(f"kernel 9 exact-input 2N={n2} g={g} {dt} at "
                            f"{where} fb={fb}: max|kernel-plain| = {d!r} "
                            f"(must be 0)")
                        check(d == 0.0, f"kernel 9 2N={n2} g={g} {dt} at "
                                        f"{where} fb={fb} differs on exact "
                                        f"inputs")
    # kernel 9 at the headline with a correction and FB, overlaps 0 and 512
    c = torch.polar(1.0 + 0.1 * torch.randn(16, generator=gen, device=dev),
                    0.3 * torch.randn(16, generator=gen, device=dev))
    cr, ci = c.real.contiguous(), c.imag.contiguous()
    W = ce.correction_pattern(cr, ci)
    e9 = 0.0
    for ov in (0, 512):
        g = math.gcd(1024, 1024 - ov)
        for dt in (torch.float32, torch.bfloat16):
            xk = x.to(dt)
            Ek = ce.chunk_embedded(xk, g, 16, 1.0 / 1024, W, True)
            Ep = ce.chunk_embedded_plain(xk, g, 16, 1.0 / 1024, W, True)
            e = (Ek - Ep).abs().max().item()
            sc = Ep.abs().max().item()
            log(f"kernel 9 headline overlap {ov} (g={g}) {dt}: "
                f"max|kernel-plain| = {e!r}, max|E| = {sc!r}, tol "
                f"1e-5*max|E|")
            check(e <= 1e-5 * sc, f"kernel 9 disagrees with plain ({dt}, "
                                  f"overlap {ov})")
            if dt == torch.float32 and ov == 0:
                e9 = e
            del Ek, Ep, xk
        if ov == 0:
            # both variants launch kernel 9's entry here: the stacked
            # route's stage (chunk_grams_uhat with embed) is held bit for
            # bit against K1 + the torch fold, and to the plain version
            embedded_route(torch, x, W)
            continue
        # the route against the stacked route (test_fused_path.py's
        # variants check on the card). With overlap the "chunk" variant's
        # windows are differences of prefix sums over the chunk stack,
        # whose f32 rounding grows with the chunk count: that case is held
        # on the first 2^17 samples (256 chunks), and at 2^24 each route is
        # held against a float64 sum; the stacked route's stage, kernel 9's
        # window entry, is held at 2^24 by window_route
        xo = x[:1 << 17]
        kw = dict(N=16, snapshot_size=1024, overlap=ov, fb=True)
        Ec = ce.cov_embedded(xo, cr, ci, variant="chunk", **kw)
        Es = ce.cov_embedded(xo, cr, ci, variant="stacked", **kw)
        dv = (Ec - Es).abs().max().item()
        sv = Es.abs().max().item()
        log(f"cov_embedded overlap {ov}, {xo.shape[0]} samples: max|chunk - "
            f"stacked| = {dv!r}, max|E| = {sv!r}, tol 2e-5*max|E|")
        check(dv <= 2e-5 * sv, f"variants chunk and stacked disagree at "
                               f"overlap {ov}")
        del Ec, Es
        routes_vs_f64(torch, x, cr, ci, kw)
        rec_w = window_route(torch, x, W, card)
    xv = x.view(-1, 1024, 32)
    with fp32_matmuls():
        k_ms, p_ms, lib9_ms = turns_ms(
            torch, lambda: ce.chunk_embedded(x, 1024, 16, 1.0 / 1024, W, True),
            lambda: ce.chunk_embedded_plain(x, 1024, 16, 1.0 / 1024, W, True),
            lambda: torch.bmm(xv.transpose(1, 2), xv))
    n = x.shape[0] // 1024
    # the symmetric Gram's half (K1's count); the fold, correction and
    # FB: about 12 FLOP a (rr, ri) pair of the chunk
    b9 = bound(x.numel() * 4 + n * 32 * 32 * 4,
               x.shape[0] * 32 * 33 + n * 12 * 16 * 16)
    log(f"kernel 9 time [{x.shape[0]}, 32] g=1024, correction + FB: kernel "
        f"{k_ms:.4f} ms, plain {p_ms:.4f} ms, library (one torch.bmm of "
        f"the chunks) {lib9_ms:.4f} ms, bound {b9['bound_ms']:.4f} ms "
        f"({b9['bound_by']})  [{card}]")
    rec9 = dict(
        name="chunk_embedded", route="cuda",
        source="doa_tpu_torch/csrc/cov_gram.cu",
        replaces="doa_tpu/ops/pallas/cov_embedded.py:99",
        max_abs_err=e9, ms=k_ms, plain_ms=p_ms, **b9, library_ms=lib9_ms)
    return {"chunk_embedded": rec9, "chunk_windows": rec_w}


def opt_in_parity(torch, dev, x, card):
    """Phase 12 → the records of kernels 11 and 9 (launches filled in
    later). x: the headline capture f32[T_MAIN, 32] on the card."""
    from doa_tpu_torch.cpx import fp32_matmuls
    from doa_tpu_torch.ops.cuda import subspace_ns as sns

    recs = {}
    # every form that takes a shape, against the plain version
    with fp32_matmuls():
        scenes = ns_scenes(torch, dev, x)
        err = 0.0
        for tag, E, K, sq, iters in scenes:
            forms = (("warp", "block")
                     if sns.ns_form(E.shape[-1], 2 * K) == "warp"
                     else ("block",))
            for form in forms:
                err = max(err, ns_parity(torch, tag, E, K, sq, iters, form))
        E, E60 = scenes[0][1], scenes[1][1]
        del scenes

        # both forms on the same E in turns with the plain version
        def ns(E, sq, form):
            return lambda: sns._launch(E, 2, form, iters=8, squarings=sq)
        p_ms, w_ms, b_ms = turns_ms(
            torch, lambda: sns.subspace_ns_plain(E, 2, iters=8, squarings=0),
            ns(E, 0, "warp"), ns(E, 0, "block"))
        w2_ms, b2_ms = turns_ms(torch, ns(E60, 2, "warp"),
                                ns(E60, 2, "block"))
        del E60
        lib_ms = time_ms(torch, lambda: torch.linalg.eigh(E), reps=5, warm=1)
    B = E.shape[0]
    b2 = bound(nbytes(E) + B * 4 * 32 * 4, ns_flops(B, 32, 4, 8, 2))
    log(f"kernel 11 time (B={B}, 2N=32, 2K=4, 8 rounds, squarings 0): warp "
        f"form {w_ms:.4f} ms, block form {b_ms:.4f} ms, plain {p_ms:.4f} "
        f"ms, library (one torch.linalg.eigh of the stack) {lib_ms:.4f} ms; "
        f"squarings 2 (2 rounds of E^4): warp form {w2_ms:.4f} ms, block "
        f"form {b2_ms:.4f} ms, bound {b2['bound_ms']:.4f} ms "
        f"({b2['bound_by']})  [{card}]")
    recs["subspace_ns"] = dict(
        name="subspace_ns", route="cuda",
        source="doa_tpu_torch/csrc/subspace_ns.cu",
        replaces="doa_tpu/ops/pallas/subspace.py:47",
        max_abs_err=err, ms=w_ms, plain_ms=p_ms,
        **bound(nbytes(E) + B * 4 * 32 * 4, ns_flops(B, 32, 4, 8, 0)),
        library_ms=lib_ms,
        by_form={"warp": {"ms": w_ms, "ms_squarings_2": w2_ms},
                 "block": {"ms": b_ms, "ms_squarings_2": b2_ms}})

    recs.update(embedded_parity(torch, dev, x, card))
    return recs


def opt_in_phases(torch, dev, card):
    """Phases 12 and 13 → (the records of kernels 11 and 9, the launches
    of the earlier kernels in these paths)."""
    from doa_tpu_torch import PRESETS, Estimator
    from doa_tpu_torch.ops import cpx_ops
    from doa_tpu_torch.ops.cuda import cov_embedded as ce
    from doa_tpu_torch.ops.cuda import music_scan as ms
    from doa_tpu_torch.ops.cuda import peaks2d as pk
    from doa_tpu_torch.ops.cuda import subspace_ns as sns
    from doa_tpu_torch.ops.cuda import wideband_cov as wc
    from doa_tpu_torch.ops.cuda import wideband_scan as wsc
    from doa_tpu_torch.pipeline_torch import build_pipeline_torch

    x = make_scene(torch, T_MAIN, 16, dev, seed=12)
    torch.cuda.synchronize()
    recs = opt_in_parity(torch, dev, x, card)

    counters = {"subspace_ns": sns.subspace_ns,
                "chunk_embedded": ce.chunk_embedded,
                "chunk_gram": ce.chunk_grams_uhat,
                "mgs_iterate": cpx_ops.mgs_iterate,
                "music_scan": ms.music_scan,
                "music_scan_peaks": ms.music_scan_peaks,
                "wideband_fft_gram": wc.subband_chunk_grams,
                "wideband_fusion": wsc.wideband_fused_spectrum,
                "peaks2d": pk.peaks2d}
    total = {n: 0 for n in counters}
    ns_forms = dict.fromkeys(sns.NS_FORMS, 0)     # kernel 11's, by form

    def drive(call):
        for f in counters.values():
            f.launches = 0
        sns.subspace_ns.by_form.update(dict.fromkeys(sns.NS_FORMS, 0))
        pk.peaks2d.by_form.update(dict.fromkeys(pk.PEAKS_FORMS, 0))
        res = call()
        torch.cuda.synchronize()
        n = {k: f.launches for k, f in counters.items()}
        for k, v in n.items():
            total[k] += v
        for f, v in sns.subspace_ns.by_form.items():
            ns_forms[f] += v
        return res, n

    cfg = headline_config()
    B = T_MAIN // 1024

    # 13a. the headline with subspace_impl="pallas": kernel 11, cold
    cfg_ns = dataclasses.replace(cfg, subspace_impl="pallas")
    for rs in (False, True):
        pipe = build_pipeline_torch(cfg_ns, device=dev, return_spectra=rs)
        show_plan(f"headline subspace_impl='pallas' return_spectra={rs}",
                  pipe)
        res, n = drive(lambda: pipe.interleaved(x))
        log(f"launches in the headline path, subspace_impl='pallas', "
            f"return_spectra={rs}: " + json.dumps(n) + ", kernel 11 by "
            f"form {json.dumps(sns.subspace_ns.by_form)}, planned "
            f"{json.dumps(pipe.plan.forms)}")
        check(n["subspace_ns"] > 0 and n["chunk_embedded"] > 0
              and n["chunk_gram"] == 0 and n["mgs_iterate"] == 0
              and n["music_scan" if rs else "music_scan_peaks"] > 0,
              "launch counts of the subspace_impl='pallas' path")
        check(sns.subspace_ns.by_form["warp"] == n["subspace_ns"]
              and pipe.plan.forms.get("subspace") == "warp",
              "the subspace_impl='pallas' headline did not launch kernel "
              "11's warp form alone, as planned")
        err = angle_err(torch, res.peak_angles["music"])
        log(f"headline subspace_impl='pallas' return_spectra={rs}: {B} "
            f"windows, max angle error {err!r} deg (limit {ANGLE_TOL}), "
            f"escalation flagged {int(res.escalation_flagged)}, overflow "
            f"{int(res.escalation_overflow)}")
        check(res.peak_angles["music"].shape[0] == B and err <= ANGLE_TOL,
              f"subspace_impl='pallas' angle error {err}")
        check(int(res.escalation_flagged) == 0
              and int(res.escalation_overflow) == 0,
              "subspace_impl='pallas' escalation counts are not zero")
        ts = call_times(torch, lambda: pipe.interleaved(x), reps=20, warm=3)
        med = 0.5 * (ts[9] + ts[10])
        log(f"headline subspace_impl='pallas' return_spectra={rs}: median "
            f"{med:.4f} ms per call of {B} windows (20 calls, min "
            f"{ts[0]:.4f}, max {ts[-1]:.4f}) = {B / (med / 1e3):.1f} "
            f"snapshots/s  [{card}]")
        if not rs:
            profile_window(torch, lambda: pipe.interleaved(x), card)
    del res

    # 13b. subspace_check under both subspace_impl values
    for impl in ("auto", "pallas"):
        c = dataclasses.replace(cfg, subspace_check=True, subspace_impl=impl)
        pipe = build_pipeline_torch(c, device=dev, return_spectra=False)
        res, n = drive(lambda: pipe.interleaved(x))
        r = res.subspace_residual
        check(r is not None and tuple(r.shape) == (B,)
              and bool(torch.isfinite(r).all()), "subspace_residual")
        err = angle_err(torch, res.peak_angles["music"])
        ts = call_times(torch, lambda: pipe.interleaved(x), reps=10, warm=2)
        log(f"headline subspace_check, subspace_impl={impl!r}: launches "
            f"{json.dumps(n)}; {int((r >= 1).sum())} of {B} windows "
            f"replaced, max residual of the rest "
            f"{float(r[r < 1].max()) if bool((r < 1).any()) else 0.0!r}; "
            f"max angle error {err!r} deg (limit {ANGLE_TOL}); median "
            f"{0.5 * (ts[4] + ts[5]):.4f} ms per call (10 calls)  [{card}]")
        check(err <= ANGLE_TOL, f"subspace_check angle error {err}")
        check(n["subspace_ns" if impl == "pallas" else "mgs_iterate"] > 0,
              f"subspace_check ({impl}): the subspace kernel never ran")
    del res

    # 13c. the guard's hard scene (tests/test_power_subspace.py): 30 : 1 at
    # 60/110 deg, 20 dB, c2 with MUSIC only and power_iters=4
    xh = make_ula_capture(torch, T_HARD, 8, ((60.0, 1, 10, 30.0),
                                             (110.0, 31, 100, 1.0)),
                          20.0, dev, seed=6)
    base = dataclasses.replace(PRESETS["c2_ula8_2src"],
                               estimators=(Estimator.MUSIC,), power_iters=4)
    a_eigh = build_pipeline_torch(dataclasses.replace(
        base, subspace_method="eigh"), device=dev, return_spectra=False)(
        (xh[..., 0], xh[..., 1])).peak_angles["music"].sort(-1).values
    for impl in ("auto", "pallas"):
        c = dataclasses.replace(base, subspace_check=True,
                                subspace_impl=impl)
        res, n = drive(lambda: build_pipeline_torch(
            c, device=dev, return_spectra=False).interleaved(xh))
        a = res.peak_angles["music"].sort(-1).values
        d = (a - a_eigh).abs().max().item()
        r = res.subspace_residual
        log(f"hard scene (30:1, 20 dB, power_iters=4, {a.shape[0]} windows) "
            f"subspace_impl={impl!r}: {int((r >= 1).sum())} windows "
            f"replaced; max|guarded - eigh| = {d!r} deg (tol {HARD_TOL}); "
            f"launches {json.dumps(n)}")
        check(d <= HARD_TOL, f"hard scene ({impl}): guarded angles off eigh")
    del xh

    # 13d. scan_capture on the headline, 8 blocks of 2^21, overlaps 0, 512
    blocks = x.view(-1, T_BLK, 32)
    M = blocks.shape[0]
    for ov in (0, 512):
        c = dataclasses.replace(cfg, overlap=ov)
        pipe = build_pipeline_torch(c, device=dev, return_spectra=False)
        out, n = drive(lambda: pipe.scan_capture(blocks))
        angs = out["peak_angles"]["music"]
        hop, pre = c.hop, pipe.scan_capture.prefix_windows
        C = hop * -(-ov // hop)
        d = 0.0
        for m in range(1, M):
            r = pipe.interleaved(x[m * T_BLK - C:(m + 1) * T_BLK])
            d = max(d, (angs[m] - r.peak_angles["music"]).abs().max().item())
        # block 0 beyond the prefix holds the plain call's windows, but one
        # window more (the zero-prefix one) moves the warm start's capture
        # mean: each window's sorted angles, within 1e-3 deg
        r0 = pipe.interleaved(blocks[0]).peak_angles["music"]
        d0 = (angs[0, pre:].sort(-1).values
              - r0[:angs.shape[1] - pre].sort(-1).values).abs().max().item()
        err = angle_err(torch, angs[:, pre:].reshape(-1, 2))
        ts = call_times(torch, lambda: pipe.scan_capture(blocks), reps=5,
                        warm=1)
        log(f"scan_capture headline overlap {ov}: {M} blocks of {T_BLK} "
            f"samples, {angs.shape[1]} windows each (prefix {pre}); "
            f"launches {json.dumps(n)}; max|block m - per-block call| = "
            f"{d!r} (tol 1e-4 deg), block 0 beyond the prefix {d0!r} (tol "
            f"1e-3 deg); max angle error {err!r} deg; median {ts[2]:.4f} ms "
            f"per capture (5 captures)  [{card}]")
        check(d <= 1e-4 and d0 <= 1e-3 and err <= ANGLE_TOL,
              f"scan_capture headline overlap {ov}")

    # 13e. a c5-shaped wideband scan_capture: overlap 512 (F | overlap), 4
    # blocks of 2^19 samples
    c5 = dataclasses.replace(PRESETS["c5_ura64_wideband"], overlap=512)
    xw = make_c5_scene(torch, 4 * T_WB_BLK, dev, seed=13)
    pipe = build_pipeline_torch(c5, device=dev, return_spectra=False)
    wblocks = xw.view(4, T_WB_BLK, 128)
    out, n = drive(lambda: pipe.scan_capture(wblocks))
    peaks_forms("scan_capture c5", pipe, n["peaks2d"])
    angs = out["peak_angles"]["music"]
    C = 512
    d = 0.0
    for m in range(1, 4):
        r = pipe.interleaved(xw[m * T_WB_BLK - C:(m + 1) * T_WB_BLK])
        d = max(d, (angs[m] - r.peak_angles["music"]).abs().max().item())
    e_max, e_med, med = c5_errors(torch, angs[1:].reshape(-1, 2, 2))
    ts = call_times(torch, lambda: pipe.scan_capture(wblocks), reps=3, warm=1)
    log(f"scan_capture c5 overlap 512: 4 blocks of {T_WB_BLK} samples, "
        f"{angs.shape[1]} windows each; launches {json.dumps(n)}; max|block "
        f"m - per-block call| = {d!r} (tol 1e-4 deg); median pair-sorted "
        f"(az, el) {med.tolist()}; median {ts[1]:.4f} ms per capture (3 "
        f"captures)  [{card}]")
    dmed = float((med - torch.tensor(C5_TRUTH, device=dev)).abs().max())
    check(d <= 1e-4 and dmed <= C5_ANGLE_TOL, "scan_capture c5")
    check(n["wideband_fft_gram"] == 4 and n["wideband_fusion"] > 0,
          "scan_capture c5 launch counts")
    del xw, wblocks, out

    # 13f. the chunk entry, cov_embedded(variant="chunk"), at T = 2^24
    c = torch.polar(torch.ones(16, device=dev),
                    torch.linspace(-0.3, 0.3, 16, device=dev))
    E9, n = drive(lambda: ce.cov_embedded(
        x, c.real.contiguous(), c.imag.contiguous(), N=16,
        snapshot_size=1024, fb=True, variant="chunk"))
    log(f"cov_embedded(variant='chunk') entry at T={T_MAIN}: launches "
        f"{json.dumps(n)}")
    check(tuple(E9.shape) == (B, 32, 32) and bool(torch.isfinite(E9).all())
          and n["chunk_embedded"] == 1 and n["chunk_gram"] == 0,
          "the chunk entry")
    del E9

    # the card against the CPU, 64 windows of each path
    xs = x[:B_CPU * 1024]
    for tag, c in (("subspace_impl='pallas'", cfg_ns),
                   ("subspace_check", dataclasses.replace(
                       cfg, subspace_check=True))):
        g = build_pipeline_torch(c, device=dev, return_spectra=False
                                 ).interleaved(xs)
        h = build_pipeline_torch(c, device="cpu", return_spectra=False
                                 ).interleaved(xs.cpu())
        d = (g.peak_angles["music"].cpu().sort(-1).values
             - h.peak_angles["music"].sort(-1).values).abs().max().item()
        log(f"{tag} card vs CPU pipeline on {B_CPU} windows: max sorted "
            f"angle difference {d!r} deg (tol 1e-3)")
        check(d <= 1e-3, f"{tag}: card and CPU pipelines disagree")
    del x
    for name in ("subspace_ns", "chunk_embedded"):
        recs[name]["launches"] = total.pop(name)
    for f, v in ns_forms.items():
        recs["subspace_ns"]["by_form"][f]["launches"] = v
    return recs, total


# ---------------------------------------------------------------------
# 14. the time-sharded pipeline on R ranks of one card (kernel 13)
# ---------------------------------------------------------------------
T_SHARD = 1 << 24                  # c4 at the single-card path's width
SHARD_RANKS = (2, 4)
SHARD_SEED = 14
SHARD_TOL = 5e-3                   # deg, sharded vs single card
#                                    (tests/test_sharded.py:376)
SHARD_REPS = 10


def shard_block(torch, T_loc, s, device):
    """Rank s's block of phase 14's capture: the planted scene on T_loc
    samples from seed SHARD_SEED + s. T_loc is a multiple of PERIOD, so
    the tones' phases run on across blocks and the blocks in rank order
    are one capture, which the single-card path reads whole."""
    return make_scene(torch, T_loc, 16, device, seed=SHARD_SEED + s)


def shard_rank(device, R, card):
    """Phase 14 on one of R ranks (a spawn_ranks target; every rank on
    cuda:0): kernel 13 against its plain version, the kernel's, the
    exchange's, the plain version's and the default halo's times, then the
    c4 preset's sharded fused path under halo_impl "pallas" and "xla",
    each driven once with the counts from zero, then timed, and under
    "pallas" a profile window of rank 0's calls."""
    import torch
    import torch.distributed as dist
    from doa_tpu_torch import PRESETS, _build
    from doa_tpu_torch.ops import cpx_ops
    from doa_tpu_torch.ops.cuda import cov_embedded as ce
    from doa_tpu_torch.ops.cuda import music_scan as ms
    from doa_tpu_torch.ops.cuda import ring as rg
    from doa_tpu_torch.parallel import (MeshSpec, build_sharded_pipeline,
                                        make_mesh)

    torch.set_float32_matmul_precision("highest")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = make_mesh(MeshSpec(R, 1), device=device)
    s = mesh.axis_index("snap")
    T_loc = T_SHARD // R
    cfg = PRESETS["c4_ula16_streaming"]
    ov = cfg.overlap
    x = shard_block(torch, T_loc, s, mesh.device)
    torch.cuda.synchronize()
    out = {"device": str(mesh.device), "backend": mesh.backend}

    def barrier():
        dist.barrier(group=mesh.halo_group)

    def together(fn, reps):
        """ms of each of reps calls of fn, every rank at once (a barrier
        before each call; host clock to the device's synchronize), after
        one warm call."""
        ts = []
        for _ in range(reps + 1):
            barrier()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t0) * 1e3)
        return ts[1:]

    # kernel 13 against its plain version (the ring through ppermute on
    # the host copy): every row, the wrap included; then a second
    # exchange of the same shape (on -x) must leave the first's result
    # as it was, since the public entry hands out a copy of the window
    k_out = rg.halo_ring(x, ov, mesh)
    k_next = rg.halo_ring(-x, ov, mesh)
    lib = _build.load("ring", rg._SIG)
    w = next(iter(mesh.halo_windows.values()))
    plain = rg.halo_ring_plain(x.cpu(), ov, mesh)
    k_cpu = k_out.cpu()
    out["ring_equal"] = bool(torch.equal(k_cpu, plain))
    out["ring_err"] = float((k_cpu - plain).abs().max())
    out["ring_own"] = (k_out.data_ptr() != w.own
                       and bool(torch.equal(k_next.cpu().neg_(), plain)))
    del k_out, k_next, k_cpu, plain
    # the kernel alone, one rank at a time (the card time-slices the
    # ranks' contexts, so concurrent events would count the others' work)
    stream = torch.cuda.current_stream().cuda_stream
    nb_halo = ov * x.shape[1] * 4

    def raw():
        _build.check(lib.doa_halo(x.data_ptr(), w.own, w.left + w.halo_offset,
                                  w.halo_offset, nb_halo, stream), "doa_halo")
    for r in range(R):
        barrier()
        if r == s:
            out["kernel_ms"] = time_ms(torch, raw)
        torch.cuda.synchronize()
    barrier()
    out["exchange_ms"] = together(lambda: rg._ring(x, ov, mesh),
                                  SHARD_REPS)
    out["xla_ms"] = together(
        lambda: rg.halo_exchange(x, ov, mesh, impl="xla"), SHARD_REPS)
    xc = x.cpu()
    out["plain_ms"] = together(lambda: rg.halo_ring_plain(xc, ov, mesh), 3)
    del xc

    counters = {"halo_ring": rg.halo_ring,
                "chunk_gram": ce.chunk_grams_uhat,
                "chunk_embedded": ce.chunk_embedded,
                "mgs_iterate": cpx_ops.mgs_iterate,
                "music_scan": ms.music_scan,
                "music_scan_peaks": ms.music_scan_peaks}
    by_epi = ce.chunk_grams_uhat.by_epilogue
    for impl in ("pallas", "xla"):
        pipe = build_sharded_pipeline(
            dataclasses.replace(cfg, halo_impl=impl), mesh,
            return_spectra=False)
        barrier()
        for f in counters.values():
            f.launches = 0
        by_epi.update(dict.fromkeys(by_epi, 0))
        res = pipe.local(x)
        torch.cuda.synchronize()
        out[impl] = {
            "launches": {k: f.launches for k, f in counters.items()},
            "by_epilogue": dict(by_epi),
            "form": pipe.plan.forms.get("covariance"),
            "angles": res["peak_angles_music"].cpu().numpy(),
            "values": res["peak_values_music"].cpu().numpy(),
            "flagged": int(res["escalation_flagged"]),
            "overflow": int(res["escalation_overflow"]),
            "plan": pipe.plan,
            "ms": together(lambda: pipe.local(x), SHARD_REPS)}
        del res
        if impl == "pallas":
            # rank 0's device share; the other ranks make the same calls
            barrier()
            if s == 0:
                log(f"R={R} profile of rank 0, halo_impl='pallas':")
                profile_window(torch, lambda: pipe.local(x), card)
            else:
                for _ in range(4):
                    pipe.local(x)
                torch.cuda.synchronize()
    mesh.close()
    return out


def window_epilogue(torch, pipe, x):
    """One call of a fused single-card pipeline whose windows overlap
    (c4), with the covariance stage's counters reset just before it: the
    stage must launch kernel 9's window entry once (by_epilogue "windows",
    chunk_embedded.launches) and K1 not at all wherever its plan names the
    "windows" epilogue, and K1 once where the plan names "gram" → (the
    planned form, the call's result)."""
    from doa_tpu_torch.ops.cuda import cov_embedded as ce

    form = pipe.plan.forms.get("covariance")
    by = ce.chunk_grams_uhat.by_epilogue
    by.update(dict.fromkeys(by, 0))
    ce.chunk_grams_uhat.launches = ce.chunk_embedded.launches = 0
    one = pipe.interleaved(x)
    torch.cuda.synchronize()
    took = dict(by)
    n = (ce.chunk_grams_uhat.launches, ce.chunk_embedded.launches)
    log(f"c4 single card: covariance stage by epilogue {json.dumps(took)}, "
        f"K1 {n[0]}, kernel 9's entries {n[1]} launches; planned {form}")
    check(form in ("windows", "gram") and took[form] == 1
          and sum(took.values()) == 1
          and n == ((0, 1) if form == "windows" else (1, 0)),
          f"c4's covariance stage took {took} (K1, kernel 9: {n}), "
          f"planned {form}")
    return form, one


def sharded_phases(torch, dev, card):
    """Phase 14 → (kernel 13's record, the launches of the earlier
    kernels in the ranks' main-path runs)."""
    import numpy as np
    from doa_tpu_torch import PRESETS
    from doa_tpu_torch.parallel.launch import spawn_ranks
    from doa_tpu_torch.parallel.sharded import num_valid_windows
    from doa_tpu_torch.pipeline_torch import build_pipeline_torch

    cfg = PRESETS["c4_ula16_streaming"]
    B = num_valid_windows(T_SHARD, cfg)
    log(f"phase 14: c4_ula16_streaming (S={cfg.snapshot_size}, overlap "
        f"{cfg.overlap}, G={cfg.grid.num_points}) at T={T_SHARD} ({B} "
        f"windows) on R ranks, each a process on {dev} (one card: gloo, "
        f"whose collectives the port stages through the host explicitly; "
        f"kernel 13 writes each halo through a CUDA IPC peer pointer)")
    total = {"chunk_gram": 0, "chunk_embedded": 0, "mgs_iterate": 0,
             "music_scan": 0, "music_scan_peaks": 0}
    ring_launches = 0
    rec = None
    for R in SHARD_RANKS:
        T_loc = T_SHARD // R
        x = torch.cat([shard_block(torch, T_loc, s, dev) for s in range(R)])
        pipe = build_pipeline_torch(cfg, device=dev, return_spectra=False)
        epi, one = window_epilogue(torch, pipe, x)
        a_one = one.peak_angles["music"].sort(-1).values.cpu().numpy()
        flagged_one = int(one.escalation_flagged)
        ts = call_times(torch, lambda: pipe.interleaved(x), reps=10, warm=2)
        m = 0.5 * (ts[4] + ts[5])
        log(f"R={R} the single-card path on the same capture, one process: "
            f"median {m:.4f} ms per call of {B} windows (10 calls, min "
            f"{ts[0]:.4f}, max {ts[-1]:.4f}) = {B / (m / 1e3):.1f} "
            f"snapshots/s  [{card}]")
        del x, one, pipe
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        outs = spawn_ranks(shard_rank, R, (R, card), device="cuda",
                           timeout=900)
        log(f"R={R}: {R} ranks ran in {time.perf_counter() - t0:.1f} s on "
            f"{sorted({o['device'] for o in outs})}, backend "
            f"{outs[0]['backend']}")
        err = max(o["ring_err"] for o in outs)
        log(f"R={R} kernel 13 vs plain (ring through ppermute): bit-equal "
            f"on every rank {[o['ring_equal'] for o in outs]}, max|diff| "
            f"{err!r}")
        check(all(o["ring_equal"] for o in outs),
              f"R={R}: kernel 13 differs from its plain version")
        log(f"R={R} halo_ring's result survives the next exchange of its "
            f"shape on every rank: {[o['ring_own'] for o in outs]}")
        check(all(o["ring_own"] for o in outs),
              f"R={R}: halo_ring's result aliases the rank's window")
        k_ms = max(o["kernel_ms"] for o in outs)
        med = lambda key: float(np.median(  # noqa: E731
            np.max([o[key] for o in outs], axis=0)))
        ex_ms, xla_ms, plain_ms = med("exchange_ms"), med("xla_ms"), \
            med("plain_ms")
        C = 32
        b = bound(2 * T_loc * C * 4 + 2 * cfg.overlap * C * 4, 0)
        log(f"R={R} kernel 13 [{T_loc}, {C}] overlap {cfg.overlap}: kernel "
            f"alone {k_ms:.4f} ms (slowest rank; ranks "
            f"{[round(o['kernel_ms'], 4) for o in outs]}), the exchange "
            f"into the window (the pipeline's route) with its two host "
            f"barriers {ex_ms:.4f} ms, the default "
            f"impl='xla' halo (host-staged ppermute + cat) {xla_ms:.4f} ms, "
            f"the plain version on the host {plain_ms:.4f} ms; bound "
            f"{b['bound_ms']:.4f} ms ({b['bound_by']})  [{card}]")
        for impl in ("pallas", "xla"):
            for o in outs:
                n, form = o[impl]["launches"], o[impl]["form"]
                cov = counter_of("chunk_gram", form)
                # the covariance stage: kernel 9's window entry once where
                # the plan names it (c4's hop 512), else K1
                check(n[cov] > 0 and n["chunk_gram" if cov != "chunk_gram"
                                       else "chunk_embedded"] == 0
                      and o[impl]["by_epilogue"][form] == n[cov]
                      and form == epi
                      and n["mgs_iterate"] > 0
                      and n["music_scan_peaks"] > 0
                      and n["halo_ring"] == (1 if impl == "pallas" else 0),
                      f"R={R} {impl}: launch counts {n}, covariance "
                      f"{o[impl]['by_epilogue']}, planned {form}, the "
                      f"single card's {epi}")
                for k in total:
                    total[k] += n[k]
            ring_launches += sum(o[impl]["launches"]["halo_ring"]
                                 for o in outs)
            log(f"R={R} launches in the sharded path, halo_impl={impl!r}, "
                f"rank 0: " + json.dumps(outs[0][impl]["launches"]))
            log(f"R={R} plan of the sharded path, halo_impl={impl!r}, "
                f"rank 0: " + json.dumps(outs[0][impl]["plan"]))
            check(all("plain" not in o[impl]["plan"].values() for o in outs),
                  f"R={R} {impl}: a rank plans a plain stage")
        ang = {impl: np.concatenate([o[impl]["angles"] for o in outs])[:B]
               for impl in ("pallas", "xla")}
        vals = {impl: np.concatenate([o[impl]["values"] for o in outs])[:B]
                for impl in ("pallas", "xla")}
        same = (np.array_equal(ang["pallas"], ang["xla"])
                and np.array_equal(vals["pallas"], vals["xla"]))
        d = float(np.abs(np.sort(ang["pallas"], -1) - a_one).max())
        terr = angle_err(torch, torch.from_numpy(ang["pallas"]))
        flagged = {o[i]["flagged"] for o in outs for i in ("pallas", "xla")}
        log(f"R={R} sharded fused path: pallas == xla on the {B} valid "
            f"windows: {same}; max|sorted sharded - single card| {d!r} deg "
            f"(tol {SHARD_TOL}); max angle error {terr!r} deg (limit "
            f"{ANGLE_TOL}); escalation flagged {sorted(flagged)}, single "
            f"card {flagged_one}")
        check(same, f"R={R}: halo_impl pallas and xla differ")
        check(d <= SHARD_TOL, f"R={R}: sharded vs single card {d}")
        check(terr <= ANGLE_TOL, f"R={R}: angle error {terr}")
        check(flagged == {flagged_one}, f"R={R}: escalation counts")
        for impl in ("pallas", "xla"):
            ts = np.max([o[impl]["ms"] for o in outs], axis=0)
            m = float(np.median(ts))
            log(f"R={R} ranks time-sliced on one card (not scaling), "
                f"halo_impl={impl!r}: median {m:.4f} ms per call of {B} "
                f"windows ({SHARD_REPS} calls, slowest rank each; min "
                f"{ts.min():.4f}, max {ts.max():.4f}) = {B / (m / 1e3):.1f} "
                f"snapshots/s  [{card}]")
        rec = dict(name="halo_ring", route="cuda",
                   source="doa_tpu_torch/csrc/ring.cu",
                   replaces="doa_tpu/ops/pallas/ring.py:35",
                   max_abs_err=err, ms=k_ms, plain_ms=plain_ms, **b,
                   library_ms=xla_ms)
    rec["launches"] = ring_launches
    # the ranks' kernel 9 launches are its window entry's (the covariance
    # stage where the plan names "windows")
    if epi == "windows":
        total["chunk_windows"] = total.pop("chunk_embedded")
    return rec, total


# ---------------------------------------------------------------------
# 15: fault C.5 — shapes doa_tpu runs that a kernel is not built for
# ---------------------------------------------------------------------

T_FAULT = 64 * 1024                # 64 windows of 1024, card and CPU
FAULT_TOL = 1e-3                   # deg, card against CPU (phase 5's)
# (name, N, sources (theta, num, den, amplitude), peaks, config fields):
# ULA-48 (2N = 96: K1 and kernel 8 do not take it) and ULA-16 at K = 5
# (2K = 10: K4 does not take it; K3 takes it in its CUDA-core form, K2
# and kernel 11 take it), distinct amplitudes so that the peaks rank
# alike on both devices. Under kernel 11 (a cold Newton-Schulz subspace,
# within 2e-5 of its plain version's projector) the 4th and 5th peaks
# come within rounding of each other, so that case asks for all five
FAULT_K5 = ((30.0, 3, 64, 1.0), (55.0, 7, 64, 0.8), (80.0, 11, 64, 0.65),
            (105.0, 17, 64, 0.5), (135.0, 23, 64, 0.4))
FAULT_CASES = (
    ("ULA-48", 48, ((60.0, 5, 64), (110.0, 9, 64)), 2, {}),
    ("ULA-16 K=5", 16, FAULT_K5, 4, {}),
    ("ULA-16 K=5 subspace_impl=pallas", 16, FAULT_K5, 5,
     {"subspace_impl": "pallas"}),
)


def raises(fn, what):
    """Check that fn() raises ValueError: a kernel wrapper given a CUDA
    tensor of a shape its kernel does not take."""
    try:
        fn()
    except ValueError as e:
        log(f"{what}: ValueError ({e})")
        return
    fail(f"{what} did not raise")


def fault_phase(torch, dev, card):
    """Phase 15: the configs of fault C.5 through build_pipeline_torch on
    the card: each plan names "plain" for the stages whose kernel does not
    take the shape, those kernels launch no time and the planned ones
    launch; angles equal to the CPU pipeline's within FAULT_TOL; and each
    kernel wrapper still raises on a CUDA tensor of such a shape."""
    from doa_tpu_torch import ArrayGeometry, DoaConfig, Estimator, GridSpec1D
    from doa_tpu_torch.ops import cpx_ops
    from doa_tpu_torch.ops.cuda import cov_embedded as ce
    from doa_tpu_torch.ops.cuda import covariance as cv
    from doa_tpu_torch.ops.cuda import music_scan as ms
    from doa_tpu_torch.ops.cuda import subspace_ns as sn
    from doa_tpu_torch.ops.cuda import wideband_cov as wc
    from doa_tpu_torch.ops.cuda import wideband_scan as wsc
    from doa_tpu_torch.pipeline_torch import build_pipeline_torch

    counters = {"chunk_gram": ce.chunk_grams_uhat,
                "chunk_embedded": ce.chunk_embedded,
                "planes_chunk_gram": cv.chunk_grams,
                "mgs_iterate": cpx_ops.mgs_iterate,
                "subspace_ns": sn.subspace_ns,
                "music_scan": ms.music_scan,
                "music_scan_peaks": ms.music_scan_peaks}
    for name, N, sources, k, fields in FAULT_CASES:
        cfg = DoaConfig(
            geometry=ArrayGeometry(kind="ula", num_elements=N,
                                   norm_spacing=0.5),
            snapshot_size=1024, num_sources=len(sources),
            estimators=(Estimator.MUSIC,), grid=GridSpec1D(num_points=1024),
            num_max_vals=k, power_schedule="e1", power_iters=8, **fields)
        x = make_ula_capture(torch, T_FAULT, N, sources, SNR_DB, dev,
                             seed=N).reshape(T_FAULT, 2 * N)
        for rs in (True, False):
            pipe = build_pipeline_torch(cfg, device=dev, return_spectra=rs)
            show_plan(f"{name} return_spectra={rs}", pipe, all_kernel=False)
            for f in counters.values():
                f.launches = 0
            ms.music_scan_peaks.tc_launches = 0
            sn.subspace_ns.by_form.update(dict.fromkeys(sn.NS_FORMS, 0))
            a_gpu = pipe.interleaved(x).peak_angles["music"]
            torch.cuda.synchronize()
            n = {key: f.launches for key, f in counters.items()}
            log(f"launches in the {name} path, return_spectra={rs}: "
                + json.dumps(n) + ", of K2's tensor-core form "
                f"{ms.music_scan_peaks.tc_launches}, kernel 11 by form "
                f"{json.dumps(sn.subspace_ns.by_form)}")
            if n["subspace_ns"]:
                check(sn.subspace_ns.by_form[pipe.plan.forms["subspace"]]
                      == n["subspace_ns"],
                      f"{name}: kernel 11 launched another form than "
                      f"the plan's {pipe.plan.forms}")
            # K2 here (2N = 96 at G = 1024, or 2K = 10): its CUDA-core form
            check(ms.music_scan_peaks.tc_launches == 0,
                  f"{name}: K2 took its tensor-core form")
            # the interleaved entry drives every stage but planes input's
            planned = {stage_counter(pipe.plan, key)
                       for key, v in pipe.plan.items()
                       if v != "plain" and key != "covariance_planes"}
            for key, count in n.items():
                check((count > 0) == (key in planned),
                      f"{name}: {key} launched {count} times against the "
                      f"plan {pipe.plan}")
            if rs and len(sources) == 5:
                # K3 at 2K = 10: its CUDA-core form, where K3's first form
                # also ran
                check(n["music_scan"] == 1, f"{name}: K3 did not launch")
            a_cpu = build_pipeline_torch(
                cfg, device="cpu", return_spectra=rs).interleaved(
                x.cpu()).peak_angles["music"]
            a_gpu = a_gpu.cpu().sort(-1).values
            d = (a_gpu - a_cpu.sort(-1).values).abs().max().item()
            truth = sorted(s[0] for s in sources)
            near = (a_gpu[:, :, None] - torch.tensor(truth)).abs().amin(
                -1).max().item()
            log(f"{name} return_spectra={rs}: {a_gpu.shape[0]} windows, "
                f"card vs CPU max angle difference {d!r} deg (tol "
                f"{FAULT_TOL}); every peak within {near!r} deg of a "
                f"source  [{card}]")
            check(bool(torch.isfinite(a_gpu).all()) and d <= FAULT_TOL,
                  f"{name}: card and CPU pipelines disagree")
            check(near <= ANGLE_TOL, f"{name}: a peak is {near} deg off")
        del x
    x48 = torch.zeros((4096, 96), device=dev)
    raises(lambda: ce.chunk_grams_uhat(x48, 1024), "K1 at 2N = 96")
    E = torch.eye(130, device=dev).expand(64, 130, 130).contiguous()
    raises(lambda: sn.subspace_ns(E, 2), "kernel 11 at 2N = 130")
    raises(lambda: sn._launch(E[:, :128, :128].contiguous(), 2, "warp"),
           "kernel 11's warp form at 2N = 128")
    raises(lambda: cv.chunk_grams(x48[:, :48], x48[:, 48:], 1024),
           "kernel 8 at N = 48")
    E = torch.eye(32, device=dev).expand(64, 32, 32).contiguous()
    raises(lambda: cpx_ops.mgs_iterate(E, 5, 3), "K4 at 2K = 10")
    Vt = torch.zeros((64, 10, 32), device=dev)
    At = torch.ones((256, 32), device=dev)
    raises(lambda: wsc.wideband_fused_spectrum(Vt[None], At[None]),
           "kernel 5 at 2K = 10")
    Vt = torch.zeros((64, 16, 160), device=dev)
    At = torch.ones((256, 160), device=dev)
    raises(lambda: ms.music_scan(Vt, At), "K3 at 2K = 16, 2N = 160")
    Vt = torch.zeros((64, 16, 3600), device=dev)
    At = torch.ones((1024, 3600), device=dev)
    raises(lambda: ms.music_scan_peaks(Vt, At, 2, 0.0, 180.0),
           "K2 at 2K = 16, 2N = 3600")
    raises(lambda: wc.subband_chunk_grams(
        torch.zeros((64, 16 * 200), device=dev), torch.ones(100, device=dev),
        torch.zeros(100, device=dev), F=16, N=100, g=4, scale=1.0),
        "kernel 4 at N = 100")
    for fn, what in ((wc.subband_embedded, "kernel 7 at N = 100"),
                     (wc.subband_embedded_frames,
                      "the frames launch at F = 12, N = 100")):
        raises(lambda: fn(torch.zeros((64, 12 * 200), device=dev),
                          torch.ones(100, device=dev),
                          torch.zeros(100, device=dev), F=12, N=100, g=4,
                          scale=1.0), what)


# ---------------------------------------------------------------------
# 16: the grid-free and projector estimators (root-MUSIC, ESPRIT, Unitary
# ESPRIT, min-norm; subspace_method="jacobi") on the fused, planes and
# coherent paths
# ---------------------------------------------------------------------

GRID_FREE = ("root_music_angles", "esprit_angles", "unitary_esprit_angles")
EST_REPS = 10                      # timed calls of each configuration
B_EST_CPU = 64                     # windows, the card against the CPU
EST_CPU_TOL = {False: 1e-3, True: 5e-3}   # deg: narrowband, wideband


def est_outputs(res):
    """{name: angles} of every estimate a result holds: each estimator's
    peak angles and the grid-free angles that are not None."""
    out = {f"peaks {k}": v for k, v in res.peak_angles.items()}
    out.update({k: getattr(res, k) for k in GRID_FREE
                if getattr(res, k) is not None})
    return out


def est_sorted(torch, a):
    """Each window's angles sorted: (B, K) by value, (B, K, 2) az/el
    pairs by azimuth."""
    return pair_sorted(torch, a) if a.dim() == 3 else a.sort(-1).values


def est_every_window(torch, name, res, truth, want):
    """Every window of every estimate in `want` within ANGLE_TOL of the
    planted truth (sorted angles); root-MUSIC as root_music_windows."""
    outs = est_outputs(res)
    check(set(want) <= set(outs), f"{name}: estimates {sorted(outs)}, want "
          f"{sorted(want)}")
    for key in want:
        if key == "root_music_angles":
            root_music_windows(torch, name, outs[key], truth)
            continue
        e = sorted_err(torch, outs[key], truth)
        log(f"{name} {key}: {outs[key].shape[0]} windows, max |sorted angle "
            f"- truth| {e!r} deg (limit {ANGLE_TOL})")
        check(e <= ANGLE_TOL, f"{name} {key} angle error {e}")


def root_music_windows(torch, name, ang, truth, allow_nonfinite=False):
    """Root-MUSIC's angles: every angle of every window within ANGLE_TOL
    of a planted source. The reference's rule takes the K roots inside
    the unit circle nearest it, and where a source's conjugate-reciprocal
    pair of roots both land inside in FP32, it takes that source twice
    and loses the other (ROADMAP §C.3; in both packages on the CPU,
    tests/test_torch_root_music.py): those windows are counted, not
    failed, and the card against the CPU holds them too. With
    allow_nonfinite (the complex root finder, whose roots can escape and
    overflow FP32 in both packages, §C.3) the windows with a non-finite
    angle are counted too, and the rest held."""
    bad = ~torch.isfinite(ang).all(-1)
    if bool(bad.any()) and not allow_nonfinite:
        fail(f"{name}: non-finite root-MUSIC angles")
    nonfinite = int(bad.sum())
    ang = ang[~bad]
    t = torch.tensor(truth, device=ang.device)
    d = (ang[..., None] - t).abs()                       # (B, K, K)
    near = float(d.amin(-1).max())
    lost = int((d.amin(-2) > ANGLE_TOL).any(-1).sum())
    B = ang.shape[0] + nonfinite
    log(f"{name} root_music_angles: {B} windows, every finite angle "
        f"within {near!r} deg of a source (limit {ANGLE_TOL}); {lost} "
        f"windows ({lost / B:.4f}) take one source twice, {nonfinite} "
        f"({nonfinite / B:.4f}) have a non-finite angle")
    check(near <= ANGLE_TOL, f"{name} root-MUSIC angle {near} off")


def est_medians(torch, name, res, truth, want, tol):
    """The median window's pair-sorted (az, el) of every estimate in
    `want` within `tol` of the planted truth (c5's cssm paths)."""
    outs = est_outputs(res)
    for key in want:
        e_max, e_med, med = c5_errors(torch, outs[key], truth)
        d = float((med - torch.tensor(truth, device=med.device)).abs().max())
        log(f"{name} {key}: per-window max |angle - truth| max {e_max!r}, "
            f"median {e_med!r} deg; median pair-sorted {med.tolist()} "
            f"(limit {tol} deg)")
        check(d <= tol, f"{name} {key} median off by {d}")


def est_path(torch, name, pipe, call, counters, card, check_angles,
             interleaved=True):
    """Drive one configuration once with every count from zero: the plan's
    kernels each launched (call.interleaved: but for the planes-input
    stage; planes input on a fused config: but for K1's stage), no other
    counted kernel; its peak allocation
    above what was held before the call; check_angles(result); then
    EST_REPS timed calls and a profile window (idle share, device ops) →
    (result, the launches)."""
    from doa_tpu_torch.ops.cuda import music_scan as ms
    for f in counters.values():
        f.launches = 0
        by = form_counts(f)
        if by is not None:
            by.update(dict.fromkeys(by, 0))
    ms.music_scan_peaks.tc_launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    res = call()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - held
    launches = {n: f.launches for n, f in counters.items()}
    show_plan(name, pipe)
    log(f"launches in {name}: {json.dumps(launches)} (K2's tensor-core form "
        f"{ms.music_scan_peaks.tc_launches}); the plan's forms "
        f"{json.dumps(pipe.plan.forms)}; peak allocation "
        f"{peak / 2 ** 30:.3f} GiB above the {held / 2 ** 30:.3f} GiB held")
    # the interleaved entry does not run kernel 8's planes-input stage,
    # and planes input on a fused config does not run K1's
    skip = ("covariance_planes" if interleaved
            else "covariance" if "covariance_planes" in pipe.plan else None)
    route = {s: stage_counter(pipe.plan, s) for s in pipe.plan.kernels
             if s != skip}
    for stage, kernel in route.items():
        check(launches[kernel] > 0,
              f"{name}: stage {stage}'s kernel {kernel} never launched")
    others = {n: v for n, v in launches.items()
              if n not in route.values() and v}
    check(not others, f"{name}: kernels outside its plan launched: {others}")
    check(ms.music_scan_peaks.tc_launches == launches["music_scan_peaks"],
          f"{name}: K2 left its tensor-core form")
    for stage, form in pipe.plan.forms.items():
        if stage not in route:
            continue
        by = form_counts(counters[pipe.plan.kernels[stage]])
        check(by[form] == launches[route[stage]],
              f"{name}: {stage} launched {dict(by)}, planned {form}")
    if "peaks" in pipe.plan:
        peaks_forms(name, pipe, launches["peaks2d"])
    check_angles(res)
    ts = call_times(torch, call, reps=EST_REPS, warm=2)
    med = 0.5 * (ts[EST_REPS // 2 - 1] + ts[EST_REPS // 2])
    B = next(iter(res.peak_angles.values())).shape[0]
    log(f"{name}: median {med:.4f} ms per call of {B} windows ({EST_REPS} "
        f"calls, min {ts[0]:.4f}, max {ts[-1]:.4f})  [{card}]")
    profile_window(torch, call, card)
    return res, launches


def grid_step(cfg):
    """The scan grid's step in degrees (the larger of az and el on 2-D)."""
    g2 = cfg.grid2d
    if g2 is not None:
        return max((g2.az_hi_deg - g2.az_lo_deg) / (g2.num_az - 1),
                   (g2.el_hi_deg - g2.el_lo_deg) / (g2.num_el - 1))
    g = cfg.grid
    return (g.hi_deg - g.lo_deg) / (g.num_points - 1)


# a quantized scan (compute_dtype bfloat16 / int8): windows whose scan
# inputs sit one rounding apart in the two runs may move their refined
# peak; at most this share of the windows may leave EST_CPU_TOL, each
# within one grid step (tests/test_torch_wideband_scans.py: 2 of 15)
QUANT_OFF_SHARE = 2 / 15


def est_card_vs_cpu(torch, name, cfg, call_of, x, B, wideband):
    """Every estimate of the card's pipeline against the same pipeline on
    the CPU on the first B windows of x, sorted (pair-sorted on az/el),
    within EST_CPU_TOL. Under a quantized compute_dtype the windows past
    it are counted, at most QUANT_OFF_SHARE of B, each within one grid
    step."""
    from doa_tpu_torch.pipeline_torch import build_pipeline_torch
    xs = x[:B * cfg.snapshot_size]
    gpu = est_outputs(call_of(build_pipeline_torch(cfg, device=x.device),
                              xs))
    t0 = time.perf_counter()
    cpu = est_outputs(call_of(build_pipeline_torch(cfg, device="cpu"),
                              xs.cpu()))
    tol = EST_CPU_TOL[wideband]
    check(gpu.keys() == cpu.keys(), f"{name}: card {sorted(gpu)}, CPU "
          f"{sorted(cpu)}")
    per = {k: (est_sorted(torch, gpu[k].cpu()) - est_sorted(torch, cpu[k])
               ).abs().flatten(1).amax(-1) for k in gpu}
    d = {k: v.max().item() for k, v in per.items()}
    log(f"{name} card vs CPU on {B} windows: max angle difference "
        + ", ".join(f"{k} {v!r}" for k, v in d.items())
        + f" deg (tol {tol}; CPU run {time.perf_counter() - t0:.1f} s)")
    if cfg.compute_dtype == "float32":
        check(all(v <= tol for v in d.values()),
              f"{name}: card and CPU disagree")
        return
    step = grid_step(cfg)
    for k, v in per.items():
        off = int((v > tol).sum())
        log(f"{name} {k}: {off} of {B} windows past {tol} deg (at most "
            f"{int(QUANT_OFF_SHARE * B)}, each within the grid step "
            f"{step!r} deg)")
        check(off <= QUANT_OFF_SHARE * B and d[k] <= step,
              f"{name} {k}: card and CPU disagree past one rounding")


def est_shares(torch, name, fns, card):
    """Each estimator's own time on the path's inputs, synced (CUDA
    events around a call; the host's launches inside)."""
    out = {k: time_ms(torch, f, reps=EST_REPS) for k, f in fns.items()}
    log(f"{name} estimator times, ms: " + ", ".join(
        f"{k} {v:.4f}" for k, v in out.items()) + f"  [{card}]")


def estimator_phase(torch, dev, card):
    """Phase 16 → the launches of the earlier kernels in these paths."""
    from doa_tpu_torch import Estimator, PRESETS
    from doa_tpu_torch.cpx import embed_planes, fp32_matmuls, unembed_planes
    from doa_tpu_torch.ops import cpx_ops, esprit, min_norm
    # the module (doa_tpu_torch.ops.root_music is the function)
    root_music = importlib.import_module("doa_tpu_torch.ops.root_music")
    from doa_tpu_torch.ops import wideband as wb
    from doa_tpu_torch.ops.cuda import cov_embedded as ce
    from doa_tpu_torch.ops.cuda import covariance as cv
    from doa_tpu_torch.ops.cuda import music_scan as ms
    from doa_tpu_torch.ops.cuda import peaks2d as pk
    from doa_tpu_torch.ops.cuda import wideband_cov as wc
    from doa_tpu_torch.ops.jacobi import subspace_projector_jacobi
    from doa_tpu_torch.ops.peaks import find_local_max
    from doa_tpu_torch.pipeline_torch import (build_pipeline_torch,
                                              compute_covariances)

    E_ = Estimator
    five = (E_.MUSIC, E_.ROOT_MUSIC, E_.ESPRIT, E_.UNITARY_ESPRIT,
            E_.MIN_NORM)
    counters = {"chunk_gram": ce.chunk_grams_uhat,
                "chunk_embedded": ce.chunk_embedded,
                "planes_chunk_gram": cv.chunk_grams,
                "wideband_fft_gram": wc.subband_chunk_grams,
                "mgs_iterate": cpx_ops.mgs_iterate,
                "music_scan": ms.music_scan,
                "music_scan_peaks": ms.music_scan_peaks,
                "peaks2d": pk.peaks2d}
    total = {n: 0 for n in counters}

    def add(n):
        for k, v in n.items():
            total[k] += v

    # 16a. the headline with the five estimators, both return_spectra
    cfg1 = dataclasses.replace(headline_config(), estimators=five)
    x = make_scene(torch, T_MAIN, 16, dev)
    want1 = ("peaks music", "peaks min_norm") + GRID_FREE
    for rs in (False, True):
        pipe = build_pipeline_torch(cfg1, device=dev, return_spectra=rs)
        name = f"headline + five estimators return_spectra={rs}"
        res, n = est_path(
            torch, name, pipe, lambda: pipe.interleaved(x), counters, card,
            lambda r: est_every_window(torch, name, r, THETA, want1))
        check(sorted(res.spectra) == (["min_norm", "music"] if rs else []),
              f"{name}: spectra {sorted(res.spectra)}")
        add(n)
        del res
    cr, ci = torch.ones(16, device=dev), torch.zeros(16, device=dev)
    with fp32_matmuls():
        E = ce.cov_embedded(x, cr, ci, N=16, snapshot_size=1024)
        esc = cfg1.escalate_kwargs
        vb = cpx_ops.signal_subspace_from_E_T(E.mean(0, keepdim=True), 2,
                                              iters=8, **esc)
        Vt = cpx_ops.signal_subspace_from_E_T(
            E, 2, iters=2, init=vb.expand(E.shape[0], -1, -1), **esc)
        V = Vt.transpose(-1, -2)
        R = unembed_planes(E)
        Ar, Ai = pipe.steering_planes

        def mn():
            P = cpx_ops.spectrum_from_den(
                min_norm.min_norm_denominator_subspace(V, Ar, Ai))
            return find_local_max(P, 2, 0.0, 180.0, refine=True)
        est_shares(torch, "headline", {
            "unembed R": lambda: unembed_planes(E),
            "root-MUSIC (noise projector + Aberth, 60 iterations)":
                lambda: root_music.root_music_cpx(
                    *R, 2, 0.5,
                    noise_proj=cpx_ops.noise_projector_from_signal(V)),
            "ESPRIT": lambda: esprit.esprit_cpx(*R, 2, 0.5),
            "Unitary ESPRIT": lambda: esprit.unitary_esprit_cpx(*R, 2, 0.5),
            "min-norm (den, spectrum, peaks)": mn}, card)
    del E, Vt, V, R
    small = x[:B_EST_CPU * 1024]
    for rs in (False, True):
        est_card_vs_cpu(torch, f"headline + five estimators return_spectra"
                        f"={rs}", cfg1, lambda p, xs: p.interleaved(xs),
                        small, B_EST_CPU, False)
    del x, small

    # 16b. c3 with subspace_method="jacobi", planes input (strided views)
    cfg3 = dataclasses.replace(PRESETS["c3_ula16_calib_smooth"],
                               subspace_method="jacobi")
    x3 = make_ula_capture(torch, T_C3, 16, c3_sources(), SNR_DB, dev, seed=3)
    xr, xi = x3[..., 0], x3[..., 1]
    for rs in (False, True):
        pipe = build_pipeline_torch(cfg3, device=dev, return_spectra=rs)
        check(dict(pipe.plan) == {"covariance": "planes_chunk_gram"},
              f"c3 jacobi plan {dict(pipe.plan)}")
        name = f"c3 jacobi return_spectra={rs}"
        res, n = est_path(
            torch, name, pipe, lambda: pipe((xr, xi)), counters, card,
            lambda r: est_every_window(torch, name, r, C3_TRUTH,
                                       ("peaks music",)),
            interleaved=False)
        add(n)
        del res
    with fp32_matmuls():
        R3 = compute_covariances(xr, xi, cfg3)
        E3 = embed_planes(*R3)
        est_shares(torch, "c3 jacobi", {
            "covariance (kernel 8 + windows, FB, smoothing)":
                lambda: compute_covariances(xr, xi, cfg3),
            "Jacobi noise projector (10 sweeps of 23 rounds, n = 24)":
                lambda: subspace_projector_jacobi(E3, 2 * (12 - 3)),
            "eigh noise projector (torch.linalg.eigh, for scale)":
                lambda: cpx_ops.noise_projector(*R3, 3)}, card)
    del R3, E3
    x3c = torch.view_as_complex(x3[:B_EST_CPU * 1024])
    for rs in (False, True):
        est_card_vs_cpu(
            torch, f"c3 jacobi return_spectra={rs}", cfg3,
            lambda p, xs: p((xs.real, xs.imag)),
            x3c, B_EST_CPU, False)
    del x3, xr, xi, x3c

    # 16c. c5 cssm and cssm_auto with MUSIC and 2-D ESPRIT on R_coh
    x16 = make_c5_scene(torch, T_C5, dev, seed=5)
    for fusion in ("cssm", "cssm_auto"):
        cfg5 = dataclasses.replace(c5_variant(fusion=fusion),
                                   estimators=(E_.MUSIC, E_.ESPRIT))
        pipe = build_pipeline_torch(cfg5, device=dev)
        name = f"c5 {fusion} + ESPRIT"
        res, n = est_path(
            torch, name, pipe, lambda: pipe.interleaved(x16), counters,
            card, lambda r: est_medians(torch, name, r, C5_TRUTH,
                                        ("peaks music", "esprit_angles"),
                                        CSSM_ANGLE_TOL))
        check(tuple(res.esprit_angles.shape) == (T_C5 // 1024, 2, 2),
              f"{name}: esprit_angles {tuple(res.esprit_angles.shape)}")
        add(n)
        del res
        est_card_vs_cpu(torch, name, cfg5, lambda p, xs: p.interleaved(xs),
                        x16, B_EST_CPU, True)
    cfg5 = c5_variant(fusion="cssm")
    T_foc = torch.from_numpy(wb.focusing_matrices(cfg5)).to(dev)
    with fp32_matmuls():
        E_sub = wc.wideband_cov_embedded(x16, torch.ones(64, device=dev),
                                         torch.zeros(64, device=dev), N=64,
                                         F=16, snapshot_size=1024)
        R = wb.cssm_covariance(torch.complex(*unembed_planes(E_sub)), T_foc)
        del E_sub
        Rr, Ri = R.real.contiguous(), R.imag.contiguous()
        est_shares(torch, "c5 cssm", {
            "2-D ESPRIT on R_coh": lambda: esprit.esprit_2d_cpx(
                Rr, Ri, 2, 0.5, (8, 8))}, card)
    del R, Rr, Ri, x16
    torch.cuda.empty_cache()
    return total


# ---------------------------------------------------------------------
# 17: beamspace, the hierarchical scans (narrowband MUSIC and Capon,
# wideband MUSIC) and model-order estimation on the fused, planes,
# coherent and incoherent paths
# ---------------------------------------------------------------------

HIER_DENSE_SLACK = 0.05            # deg, hierarchical vs dense headline
#                                    (tests/test_hierarchical.py:196-200)
B_MDL_CPU = 64                     # windows, MDL counts card against CPU


def spectra_keys(torch, name, res, want):
    check(sorted(res.spectra) == sorted(want),
          f"{name}: spectra {sorted(res.spectra)}, want {sorted(want)}")


def model_order_cell(torch, dev, x, cfg, card):
    """estimate_num_sources (MDL and AIC) on the headline's R windows:
    MDL gives K = 2 in every window; the median of EST_REPS calls; the
    card's counts equal to the CPU's on B_MDL_CPU windows."""
    from doa_tpu_torch.cpx import fp32_matmuls, unembed_planes
    from doa_tpu_torch.ops import model_order
    from doa_tpu_torch.ops.cuda import cov_embedded as ce
    cr, ci = torch.ones(16, device=dev), torch.zeros(16, device=dev)
    S = cfg.snapshot_size
    with fp32_matmuls():
        Rr, Ri = unembed_planes(ce.cov_embedded(x, cr, ci, N=16,
                                                snapshot_size=S))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    counts = {c: model_order.estimate_num_sources(Rr, Ri, S, c)
              for c in ("mdl", "aic")}
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - held
    B = Rr.shape[0]
    for c, k in counts.items():
        hist = torch.bincount(k.long(), minlength=4).tolist()
        log(f"model order {c.upper()} on the headline's {B} windows: counts "
            f"by K {hist}")
    check(bool((counts["mdl"] == 2).all()),
          "MDL does not give K = 2 in every headline window")
    check(bool((counts["aic"] >= counts["mdl"]).all()),
          "AIC counts fewer sources than MDL")
    ts = call_times(torch, lambda: model_order.estimate_num_sources(
        Rr, Ri, S), reps=EST_REPS, warm=2)
    med = 0.5 * (ts[EST_REPS // 2 - 1] + ts[EST_REPS // 2])
    log(f"model order (MDL, eigvalsh of E(R) + criterion): median "
        f"{med:.4f} ms per call of {B} windows ({EST_REPS} calls, min "
        f"{ts[0]:.4f}, max {ts[-1]:.4f}); peak allocation "
        f"{peak / 2 ** 30:.3f} GiB above the {held / 2 ** 30:.3f} GiB held"
        f"  [{card}]")
    profile_window(torch, lambda: model_order.estimate_num_sources(
        Rr, Ri, S), card)
    for c, k in counts.items():
        kc = model_order.estimate_num_sources(Rr[:B_MDL_CPU].cpu(),
                                              Ri[:B_MDL_CPU].cpu(), S, c)
        same = bool(torch.equal(k[:B_MDL_CPU].cpu(), kc))
        log(f"model order {c.upper()} card vs CPU on {B_MDL_CPU} windows: "
            f"equal counts {same}")
        check(same, f"model order {c}: card and CPU counts differ")


def dmin_parity(torch, pipe, x, cfg, card):
    """Kernel 5 with return_dmin on the c5 scene's subspaces: P bit-equal
    to the launch without it, dmin f32[F, B] within 1e-5·max‖a‖² of the
    plain version's (a den value, as K3's den check)."""
    from doa_tpu_torch.cpx import fp32_matmuls
    from doa_tpu_torch.ops import wideband as wb
    from doa_tpu_torch.ops.cuda import wideband_cov as wc
    from doa_tpu_torch.ops.cuda import wideband_scan as wsc
    N, F = cfg.geometry.num_elements, cfg.wideband.num_subbands
    with fp32_matmuls():
        E_sub = wc.wideband_cov_embedded(
            x, torch.ones(N, device=x.device), torch.zeros(N, device=x.device),
            N=N, F=F, snapshot_size=cfg.snapshot_size)
        Vt = wb.subband_subspaces_from_E(E_sub, cfg)
    del E_sub
    At = torch.cat(pipe.subband_planes, dim=-1).contiguous()
    nrm = (At * At).sum(dim=-1)
    n0 = wsc.wideband_fused_spectrum.launches
    P, dmin = wsc.wideband_fused_spectrum(Vt, At, nrm, return_dmin=True)
    check(wsc.wideband_fused_spectrum.launches == n0 + 1,
          "return_dmin took more than one launch of kernel 5")
    P1 = wsc.wideband_fused_spectrum(Vt, At, nrm)
    wsc.wideband_fused_spectrum.launches = n0
    _, dmin_p = wsc.wideband_fused_spectrum_plain(Vt, At, nrm,
                                                  return_dmin=True)
    e = (dmin - dmin_p).abs().max().item()
    tol = 1e-5 * nrm.max().item()
    log(f"wideband_fusion return_dmin at c5 (F={F}, B={Vt.shape[1]}): P "
        f"bit-equal to the launch without it: {bool(torch.equal(P, P1))}; "
        f"max|dmin kernel - plain| {e!r} (tol {tol!r}), dmin in "
        f"[{dmin.min().item()!r}, {dmin.max().item()!r}]")
    check(torch.equal(P, P1), "kernel 5's P changes under return_dmin")
    check(tuple(dmin.shape) == tuple(Vt.shape[:2]) and e <= tol,
          "kernel 5's dmin disagrees with its plain version")
    del Vt, P, P1, dmin, dmin_p


def hier_phase(torch, dev, card):
    """Phase 17 → the launches of the earlier kernels in these paths."""
    from doa_tpu_torch import BeamspaceSpec, Estimator, PRESETS
    from doa_tpu_torch.ops import cpx_ops
    from doa_tpu_torch.ops.cuda import cov_embedded as ce
    from doa_tpu_torch.ops.cuda import covariance as cv
    from doa_tpu_torch.ops.cuda import music_scan as ms
    from doa_tpu_torch.ops.cuda import peaks2d as pk
    from doa_tpu_torch.ops.cuda import wideband_cov as wc
    from doa_tpu_torch.ops.cuda import wideband_scan as wsc
    from doa_tpu_torch.pipeline_torch import build_pipeline_torch

    E_ = Estimator
    counters = {"chunk_gram": ce.chunk_grams_uhat,
                "chunk_embedded": ce.chunk_embedded,
                "planes_chunk_gram": cv.chunk_grams,
                "wideband_fft_gram": wc.subband_chunk_grams,
                "mgs_iterate": cpx_ops.mgs_iterate,
                "music_scan": ms.music_scan,
                "music_scan_peaks": ms.music_scan_peaks,
                "wideband_fusion": wsc.wideband_fused_spectrum,
                "peaks2d": pk.peaks2d}
    total = {n: 0 for n in counters}

    def add(n):
        for key, v in n.items():
            total[key] += v

    def every_window(name, keys, truth):
        return lambda r: est_every_window(torch, name, r, truth,
                                          [f"peaks {k}" for k in keys])

    mc = (E_.MUSIC, E_.CAPON)
    x = make_scene(torch, T_MAIN, 16, dev)

    # 17a. the headline + beamspace (8 beams at 90°), MUSIC + Capon
    cfg_bs = dataclasses.replace(
        headline_config(), estimators=mc,
        beamspace=BeamspaceSpec(num_beams=8, center_deg=90.0))
    for rs in (False, True):
        pipe = build_pipeline_torch(cfg_bs, device=dev, return_spectra=rs)
        name = f"headline + beamspace return_spectra={rs}"
        res, n = est_path(torch, name, pipe, lambda: pipe.interleaved(x),
                          counters, card, every_window(name, ("music",),
                                                       THETA))
        e_c = sorted_err(torch, res.peak_angles["capon"], THETA)
        log(f"{name} peaks capon: max |sorted angle - truth| {e_c!r} deg")
        spectra_keys(torch, name, res, ["capon", "music"] if rs else [])
        add(n)
        del res
    for rs in (False, True):
        est_card_vs_cpu(torch, f"headline + beamspace return_spectra={rs}",
                        cfg_bs, lambda p, xs: p.interleaved(xs),
                        x[:B_EST_CPU * 1024], B_EST_CPU, False)

    # 17b. the headline + hierarchical MUSIC, beside the dense headline on
    # the same capture
    dense = build_pipeline_torch(headline_config(), device=dev,
                                 return_spectra=False)
    e_dense = angle_err(torch, dense.interleaved(x).peak_angles["music"])
    cfg_h = dataclasses.replace(headline_config(), scan_mode="hierarchical")
    for rs in (False, True):
        pipe = build_pipeline_torch(cfg_h, device=dev, return_spectra=rs)
        name = f"headline + hierarchical return_spectra={rs}"
        res, n = est_path(torch, name, pipe, lambda: pipe.interleaved(x),
                          counters, card, every_window(name, ("music",),
                                                       THETA))
        e_h = angle_err(torch, res.peak_angles["music"])
        log(f"{name}: max angle error {e_h!r} deg, the dense headline's "
            f"{e_dense!r} deg on the same capture (limit dense + "
            f"{HIER_DENSE_SLACK})")
        check(e_h <= e_dense + HIER_DENSE_SLACK,
              f"{name}: hierarchical error {e_h} beyond dense {e_dense}")
        spectra_keys(torch, name, res, [])
        add(n)
        del res
    for rs in (False, True):
        est_card_vs_cpu(torch, f"headline + hierarchical return_spectra="
                        f"{rs}", cfg_h, lambda p, xs: p.interleaved(xs),
                        x[:B_EST_CPU * 1024], B_EST_CPU, False)

    # 17c. model order on the headline's R windows
    model_order_cell(torch, dev, x, cfg_h, card)
    del x, dense

    # 17d. c2 + hierarchical, MUSIC + Capon, planes input (kernel 8)
    cfg2 = dataclasses.replace(PRESETS["c2_ula8_2src"],
                               scan_mode="hierarchical")
    x2 = make_ula_capture(torch, T_C2, 8, ((60.0, 1, 10), (110.0, 31, 100)),
                          SNR_DB, dev, seed=2)
    xr, xi = x2[..., 0], x2[..., 1]
    pipe = build_pipeline_torch(cfg2, device=dev)
    name = "c2 + hierarchical (planes input)"
    res, n = est_path(torch, name, pipe, lambda: pipe((xr, xi)), counters,
                      card, every_window(name, ("music", "capon"),
                                         C2_TRUTH), interleaved=False)
    spectra_keys(torch, name, res, [])
    add(n)
    del res
    x2c = torch.view_as_complex(x2[:B_EST_CPU * 2048])
    est_card_vs_cpu(torch, name, cfg2, lambda p, xs: p((xs.real, xs.imag)),
                    x2c, B_EST_CPU, False)
    del x2, xr, xi, x2c

    # 17e. c5 + hierarchical (incoherent; kernel 5's dmin) and c5 cssm +
    # hierarchical, 2048 windows of exp_r5.py's scene
    x16 = make_c5_scene(torch, T_C5, dev, seed=5)
    for fusion in ("incoherent", "cssm"):
        cfg5 = dataclasses.replace(c5_variant(fusion=fusion),
                                   scan_mode="hierarchical")
        pipe = build_pipeline_torch(cfg5, device=dev)
        name = f"c5 {fusion} + hierarchical"
        tol = C5_ANGLE_TOL if fusion == "incoherent" else CSSM_ANGLE_TOL
        res, n = est_path(
            torch, name, pipe, lambda: pipe.interleaved(x16), counters,
            card, lambda r: est_medians(torch, name, r, C5_TRUTH,
                                        ("peaks music",), tol))
        check(tuple(res.peak_angles["music"].shape) == (T_C5 // 1024, 2, 2),
              f"{name}: angles {tuple(res.peak_angles['music'].shape)}")
        spectra_keys(torch, name, res, [])
        add(n)
        del res
        if fusion == "incoherent":
            dmin_parity(torch, pipe, x16, cfg5, card)
        est_card_vs_cpu(torch, name, cfg5, lambda p, xs: p.interleaved(xs),
                        x16, B_EST_CPU, True)
    del x16
    torch.cuda.empty_cache()
    return total


# ---------------------------------------------------------------------
# 18: the complex-typed public entry (pipeline.build_pipeline,
# estimate_doa) with its ops, and MVDR extraction; library calls on
# complex64 tensors, no hand-written kernel
# ---------------------------------------------------------------------

CPX_TOL = 2e-5                     # of max|R| and max|y|, card against CPU
T_IRR = 1 << 20                    # 18c: S = 96, overlap 40 (18724 windows)
T_URA_CPX = 512 * 1024             # 18d: 512 windows of the 8x8 URA
T_MVDR = 1 << 22                   # 18f: 4096 windows of the headline scene


def launch_counts():
    """{wrapper: launches} of every kernel wrapper of the port."""
    out = {}
    for mod in [m for n, m in sys.modules.items()
                if n.startswith("doa_tpu_torch.ops")]:
        for k, v in vars(mod).items():
            if callable(v) and hasattr(v, "launches"):
                out[f"{mod.__name__}.{k}"] = v.launches
    return out


def no_kernel(torch, name, fn):
    """fn() → its result; fails if it launched a kernel of the port (the
    complex path is library calls alone)."""
    before = launch_counts()
    out = fn()
    torch.cuda.synchronize()
    moved = {k: v - before.get(k, 0) for k, v in launch_counts().items()
             if v != before.get(k, 0)}
    check(not moved, f"{name}: kernels launched on the complex path: "
          f"{moved}")
    return out


def make_ura_capture(torch, T, shape, sources, snr_db, device, seed):
    """A narrowband planar-array capture by the model of
    doa_tpu.io.synth_ura_iq as complex64[T, nx·ny] (x-major), made on the
    device: each source (az_deg, el_deg, num, den) a unit tone of num/den
    cycles a sample with a random start phase, complex white noise of
    power 10^(−snr/10) per element."""
    import numpy as np

    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=device).manual_seed(seed)
    nx, ny = shape
    x = torch.randn((T, nx * ny, 2), generator=gen, device=device)
    x *= math.sqrt(10.0 ** (-snr_db / 10.0) / 2.0)
    xc = torch.view_as_complex(x)
    t = torch.arange(T, device=device, dtype=torch.int64)
    ix = torch.arange(nx, device=device, dtype=torch.float64)[:, None]
    iy = torch.arange(ny, device=device, dtype=torch.float64)[None, :]
    for az, el, num, den in sources:
        ph = (2.0 * math.pi / den) * ((t * num) % den).to(torch.float64)
        ph += rng.uniform(0.0, 2.0 * math.pi)
        s = torch.polar(torch.ones_like(ph), ph).to(torch.complex64)
        a, e = math.radians(az), math.radians(el)
        pa = -math.pi * (math.cos(e) * math.sin(a) * ix
                         + math.cos(e) * math.cos(a) * iy)
        st = torch.polar(torch.ones_like(pa), pa).reshape(-1).to(
            torch.complex64)
        xc += s[:, None] * st[None, :]
        del ph, s
    return xc


def duplicate_windows(torch, ang, truth):
    """bool[B]: the windows whose root-MUSIC angles leave a planted
    source with none within ANGLE_TOL (one source taken twice, C.3)."""
    t = torch.tensor(truth, device=ang.device)
    return ((ang[..., None] - t).abs().amin(-2) > ANGLE_TOL).any(-1)


def cpx_card_vs_cpu(torch, name, cfg, x, B, truth, correction=None):
    """The complex pipeline on the card against the same pipeline on the
    CPU on the first B windows of x (complex64): the covariance within
    CPX_TOL of max|R|; every estimate, sorted (pair-sorted on az/el),
    within FAULT_TOL; root-MUSIC's windows that differ beyond it must be
    windows where the card or the CPU takes one source twice (C.3), and
    are counted."""
    from doa_tpu_torch.pipeline import build_pipeline
    hop = cfg.snapshot_size - cfg.overlap
    xs = x[:(B - 1) * hop + cfg.snapshot_size]
    c = None if correction is None else correction.cpu()
    gpu = no_kernel(torch, name, lambda: build_pipeline(
        cfg, return_covariance=True, device=x.device)(xs, correction))
    t0 = time.perf_counter()
    cpu = build_pipeline(cfg, return_covariance=True, device="cpu")(
        xs.cpu(), c)
    secs = time.perf_counter() - t0
    Rg, Rc = gpu.covariance.cpu(), cpu.covariance
    check(Rg.shape == Rc.shape and Rg.shape[0] == B,
          f"{name}: covariance {tuple(Rg.shape)} on the card, "
          f"{tuple(Rc.shape)} on the CPU")
    dR = float((Rg - Rc).abs().max() / Rc.abs().max())
    og, oc = est_outputs(gpu), est_outputs(cpu)
    check(og.keys() == oc.keys(), f"{name}: card {sorted(og)}, CPU "
          f"{sorted(oc)}")
    d, split, nonfinite = {}, 0, 0
    for k in og:
        a, b = est_sorted(torch, og[k].cpu()), est_sorted(torch, oc[k])
        per = (a - b).abs().flatten(1).amax(-1)
        if k == "root_music_angles":
            fin = torch.isfinite(a).all(-1) & torch.isfinite(b).all(-1)
            dup = (duplicate_windows(torch, a, truth)
                   | duplicate_windows(torch, b, truth))
            off = ~(per <= FAULT_TOL)
            split = int((off & dup & fin).sum())
            nonfinite = int((~fin).sum())
            check(not bool((off & ~dup & fin).any()),
                  f"{name}: root-MUSIC differs outside the duplicate-pair "
                  f"and non-finite windows")
            per = torch.where(dup | ~fin, 0.0, per)
        d[k] = float(per.max())
    log(f"{name} card vs CPU on {B} windows: covariance max|dR|/max|R| "
        f"{dR!r} (tol {CPX_TOL}); max angle difference "
        + ", ".join(f"{k} {v!r}" for k, v in d.items())
        + f" deg (tol {FAULT_TOL})"
        + (f"; root-MUSIC windows split differently {split}, non-finite "
           f"on the card or the CPU {nonfinite}, of {B}"
           if "root_music_angles" in og else "")
        + f"; CPU run {secs:.1f} s")
    check(dR <= CPX_TOL, f"{name}: card and CPU covariances disagree")
    check(all(v <= FAULT_TOL for v in d.values()),
          f"{name}: card and CPU disagree")


def cpx_timed(torch, name, call, B, card):
    """Median ms of 10 calls (CUDA events) and a profile window."""
    ts = call_times(torch, call, reps=EST_REPS, warm=2)
    med = 0.5 * (ts[EST_REPS // 2 - 1] + ts[EST_REPS // 2])
    log(f"{name}: median {med:.4f} ms per call of {B} windows ({EST_REPS} "
        f"calls, min {ts[0]:.4f}, max {ts[-1]:.4f})  [{card}]")
    profile_window(torch, call, card)
    return med


def complex_phase(torch, dev, card):
    """Phase 18: the complex-typed public entry on the card."""
    from doa_tpu_torch import (BeamspaceSpec, Estimator, PRESETS,
                               WidebandSpec, estimate_doa)
    from doa_tpu_torch.ops.beamform import extract_source_ula
    from doa_tpu_torch.ops.covariance import cov_from_stream
    from doa_tpu_torch.pipeline import build_pipeline
    from doa_tpu_torch.pipeline_torch import build_pipeline_torch

    seven = tuple(Estimator)

    # 18a. the headline capture through estimate_doa, all seven estimators
    cfg7 = dataclasses.replace(headline_config(), estimators=seven)
    x = make_scene(torch, T_MAIN, 16, dev)
    xc = torch.view_as_complex(x.view(T_MAIN, 16, 2))
    B = T_MAIN // 1024
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    name = "complex headline, seven estimators (estimate_doa)"
    res = no_kernel(torch, name, lambda: estimate_doa(xc, cfg7, device=dev))
    peak = torch.cuda.max_memory_allocated() - held
    check(sorted(res.spectra) == ["bartlett", "capon", "min_norm", "music"],
          f"{name}: spectra {sorted(res.spectra)}")
    check(all(tuple(P.shape) == (B, 1024) and bool(torch.isfinite(P).all())
              for P in res.spectra.values()), f"{name}: spectra")
    est_every_window(torch, name, res, THETA,
                     ("peaks music", "peaks capon", "peaks min_norm",
                      "esprit_angles", "unitary_esprit_angles"))
    root_music_windows(torch, name, res.root_music_angles, THETA,
                       allow_nonfinite=True)
    e_b = sorted_err(torch, res.peak_angles["bartlett"], THETA)
    log(f"{name} peaks bartlett: max |sorted angle - truth| {e_b!r} deg "
        f"(not checked: the estimator's own bias); peak allocation "
        f"{peak / 2 ** 30:.3f} GiB above the {held / 2 ** 30:.3f} GiB held")
    del res
    cfg1 = headline_config()
    pipe7 = build_pipeline(cfg7, device=dev)
    pipe1 = build_pipeline(cfg1, device=dev)
    fast = build_pipeline_torch(cfg1, device=dev, return_spectra=False)
    e1 = angle_err(torch, pipe1(xc).peak_angles["music"])
    log(f"complex headline, MUSIC: max angle error {e1!r} deg")
    ms7 = cpx_timed(torch, name, lambda: pipe7(xc), B, card)
    ms1 = cpx_timed(torch, "complex headline, MUSIC (build_pipeline)",
                    lambda: pipe1(xc), B, card)
    msf = cpx_timed(torch, "fast headline, MUSIC (build_pipeline_torch, "
                    "same capture)", lambda: fast.interleaved(x), B, card)
    log(f"complex headline against the fast path on one capture: MUSIC "
        f"{ms1:.4f} against {msf:.4f} ms ({ms1 / msf:.2f}x); seven "
        f"estimators {ms7:.4f} ms  [{card}]")
    del pipe7, pipe1, fast
    cpx_card_vs_cpu(torch, name, cfg7, xc, B_EST_CPU, THETA)

    # 18e. beamspace, 8 beams at 90°, MUSIC, on the same capture
    cfg_bs = dataclasses.replace(
        cfg1, beamspace=BeamspaceSpec(num_beams=8, center_deg=90.0))
    name = "complex headline + beamspace (8 beams at 90°)"
    est_every_window(torch, name, no_kernel(
        torch, name, lambda: build_pipeline(cfg_bs, device=dev)(xc)), THETA,
        ("peaks music",))
    cpx_card_vs_cpu(torch, name, cfg_bs, xc, B_EST_CPU, THETA)

    # 18f. MVDR extraction toward 70° on the headline scene's windows
    Bm = T_MVDR // 1024
    xr, xi = x[:T_MVDR, 0::2], x[:T_MVDR, 1::2]
    R = cov_from_stream(xc[:T_MVDR], 1024, 0)
    theta = torch.full((Bm,), THETA[0], device=dev)
    y = no_kernel(torch, "MVDR extraction", lambda: extract_source_ula(
        xr, xi, R.real, R.imag, theta, 0.5, 1024))
    check(all(tuple(p.shape) == (Bm, 1024) and bool(torch.isfinite(p).all())
              for p in y), "MVDR extraction: shape or non-finite values")
    n = B_EST_CPU
    yc = extract_source_ula(xr[:n * 1024].cpu(), xi[:n * 1024].cpu(),
                            R.real[:n].cpu(), R.imag[:n].cpu(),
                            theta[:n].cpu(), 0.5, 1024)
    yg = torch.complex(y[0][:n].cpu(), y[1][:n].cpu())
    yc = torch.complex(*yc)
    dy = float((yg - yc).abs().max() / yc.abs().max())
    pw = float((y[0] * y[0] + y[1] * y[1]).mean())
    log(f"MVDR extraction toward {THETA[0]} deg: {Bm} windows of 1024, mean "
        f"|y|^2 {pw!r} (the source's power {2 * 10 ** (SNR_DB / 10)}); card "
        f"vs CPU on {n} windows max|dy|/max|y| {dy!r} (tol {CPX_TOL})")
    check(dy <= CPX_TOL, "MVDR extraction: card and CPU disagree")
    del x, xc, xr, xi, R, y, yc, yg

    # 18b. c2 (MUSIC + Capon), c3 (FB, smoothing L = 12, M = 5, with the
    # calibration correction) and c4 (overlap 512) at the presets' widths
    x2 = torch.view_as_complex(make_ula_capture(
        torch, T_C2, 8, ((60.0, 1, 10), (110.0, 31, 100)), SNR_DB, dev,
        seed=2))
    x3 = make_ula_capture(torch, T_C3, 16, c3_sources(), SNR_DB, dev,
                          seed=3)
    factor = impairments(16)
    x3 = torch.view_as_complex(impair(torch, x3, factor))
    corr = torch.from_numpy((1.0 / factor).astype("complex64")).to(dev)
    x4 = torch.view_as_complex(make_scene(torch, T_MAIN, 16, dev,
                                          seed=4).view(T_MAIN, 16, 2))
    for tag, xb, truth, c, keys in (
            ("c2_ula8_2src", x2, C2_TRUTH, None, ("music", "capon")),
            ("c3_ula16_calib_smooth", x3, C3_TRUTH, corr, ("music",)),
            ("c4_ula16_streaming", x4, THETA, None, ("music",))):
        cfg = PRESETS[tag]
        pipe = build_pipeline(cfg, device=dev)
        name = f"complex {tag}" + (" + correction" if c is not None else "")
        res = no_kernel(torch, name, lambda: pipe(xb, c))
        nb = next(iter(res.peak_angles.values())).shape[0]
        est_every_window(torch, name, res, truth,
                         [f"peaks {k}" for k in keys])
        del res
        cpx_timed(torch, name, lambda: pipe(xb, c), nb, card)
        cpx_card_vs_cpu(torch, name, cfg, xb, B_EST_CPU, truth, c)
        del pipe
    del x2, x3, x4

    # 18c. an irregular overlap (S = 96, overlap 40: the explicit frames)
    cfg_i = dataclasses.replace(cfg1, snapshot_size=96, overlap=40)
    xi_ = torch.view_as_complex(make_ula_capture(
        torch, T_IRR, 16, ((70.0, 1, 10), (110.0, 31, 100)), SNR_DB, dev,
        seed=18))
    name = "complex S = 96, overlap 40"
    res = no_kernel(torch, name, lambda: build_pipeline(
        cfg_i, return_covariance=True, device=dev)(xi_))
    Bi = (T_IRR - 96) // 56 + 1
    check(tuple(res.covariance.shape) == (Bi, 16, 16)
          and bool(torch.isfinite(res.covariance).all()),
          f"{name}: covariance {tuple(res.covariance.shape)}")
    a = res.peak_angles["music"].sort(-1).values
    med = a.median(dim=0).values
    e_med = float((med - torch.tensor(THETA, device=dev)).abs().max())
    log(f"{name}: {Bi} windows, max |sorted angle - truth| "
        f"{sorted_err(torch, a, THETA)!r} deg, the median window's "
        f"{e_med!r} deg (limit {ANGLE_TOL})")
    check(e_med <= ANGLE_TOL, f"{name}: median window off by {e_med}")
    del res, a
    cpx_card_vs_cpu(torch, name, cfg_i, xi_, B_EST_CPU * 8, THETA)
    del xi_

    # 18d. the 8x8 URA narrowband on c5's 181x91 grid, MUSIC + 2-D ESPRIT,
    # at 512 windows (the (B, G, N) complex64 products are 4.3 GB there)
    cfg5 = dataclasses.replace(PRESETS["c5_ura64_wideband"],
                               wideband=WidebandSpec(num_subbands=1),
                               estimators=(Estimator.MUSIC,
                                           Estimator.ESPRIT))
    x5 = make_ura_capture(torch, T_URA_CPX, (8, 8),
                          [(az, el, num, den) for (az, el), (num, den)
                           in zip(C5_TRUTH, ((1, 10), (31, 100)))],
                          SNR_DB, dev, seed=5)
    pipe = build_pipeline(cfg5, device=dev)
    name = "complex 8x8 URA narrowband (c5 grid), MUSIC + 2-D ESPRIT"
    res = no_kernel(torch, name, lambda: pipe(x5))
    for key, ang in (("peaks music", res.peak_angles["music"]),
                     ("esprit_angles", res.esprit_angles)):
        check(tuple(ang.shape) == (T_URA_CPX // 1024, 2, 2),
              f"{name} {key}: {tuple(ang.shape)}")
        e_max, e_med, medp = c5_errors(torch, ang)
        log(f"{name} {key}: {ang.shape[0]} windows, max |pair-sorted "
            f"angle - truth| {e_max!r}, median {e_med!r} deg (limit "
            f"{ANGLE_TOL})")
        check(e_max <= ANGLE_TOL, f"{name} {key}: angle error {e_max}")
    del res
    cpx_timed(torch, name, lambda: pipe(x5), T_URA_CPX // 1024, card)
    del pipe
    cpx_card_vs_cpu(torch, name, cfg5, x5, B_EST_CPU, C5_TRUTH)
    del x5
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------
# 19: the rest of single-card wideband: TOPS (ops/tops.py), and the
# incoherent scans the reference keeps off its fusion kernel (quantized,
# eigh projectors); torch ops around the ported kernels, no new kernel
# ---------------------------------------------------------------------

TOPS_ANGLE_TOL = 2.0               # deg, the median (tests/test_tops.py's)
B_TOPS_CPU = 32                    # windows, card against CPU (c5, ULA K=2)
B_TOPS3_CPU = 16                   # ULA-16 at K = 3 (Jacobi λ_min on the CPU)
B_QUANT_CPU = 32                   # windows, c5 bf16 / int8 card against CPU
ULA3_TRUTH = (45.0, 80.0, 120.0)   # the K = 3 wideband ULA scene
T_EIGH_C5 = 8 * 1024               # c5 eigh, reduced depth: 8 windows
B_EIGH_C5_CPU = 8                  # windows, c5 eigh card against CPU


def tops_layers(torch, cfg, pipe, x, card):
    """The layers of a TOPS call, each synced and timed on the call's own
    intermediates: the front end (kernel 4), unembed, the complex signal
    subspaces, accumulate (leakage row, Σ CᴴC and the guard), finalize
    (λ_min, the normalisation) and the peaks (kernel 6) → the spectrum,
    checked equal to the pipeline's."""
    from doa_tpu_torch.cpx import fp32_matmuls, unembed_planes
    from doa_tpu_torch.ops import tops
    from doa_tpu_torch.ops.cuda import wideband_cov as wc
    N, K = cfg.geometry.num_elements, cfg.num_sources
    F, r = cfg.wideband.num_subbands, cfg.wideband.tops_ref_band
    g2 = cfg.grid2d
    dev = x.device
    cr, ci = torch.ones(N, device=dev), torch.zeros(N, device=dev)
    A = torch.complex(*pipe.subband_planes)
    w = [0.0 if f == r else 1.0 for f in range(F)]
    st = {}
    with fp32_matmuls():
        st["E"] = wc.wideband_cov_embedded(
            x, cr, ci, N=N, F=F, snapshot_size=cfg.snapshot_size,
            kernel=pipe.plan.op("covariance"))
        st["R"] = torch.complex(*unembed_planes(st["E"]))
        st["S"] = tops.tops_subspaces(st["R"], K, cfg.power_iters)

        def accumulate():
            v = tops.tops_leakage_row(A[r], st["S"][r])
            return v, tops.tops_accumulate_cc(st["S"], A, A[r],
                                              st["S"][r], v, w)

        st["v"], (ccr, cci, mus) = accumulate()
        guard = mus if cfg.wideband.tops_guard else None
        P = tops.tops_finalize(ccr, cci, st["v"], F, guard=guard)
        layers = {
            "front end (kernel 4)": lambda: wc.wideband_cov_embedded(
                x, cr, ci, N=N, F=F, snapshot_size=cfg.snapshot_size,
                kernel=pipe.plan.op("covariance")),
            "unembed": lambda: torch.complex(*unembed_planes(st["E"])),
            "complex subspaces (signal_subspace_cpx)":
                lambda: tops.tops_subspaces(st["R"], K, cfg.power_iters),
            "accumulate (v, sum CᴴC, guard)": accumulate,
            "finalize (λ_min, normalise)": lambda: tops.tops_finalize(
                ccr, cci, st["v"], F, guard=guard),
        }
        if g2 is not None:
            P2 = P.reshape(P.shape[0], g2.num_az, g2.num_el)
            layers["peaks (kernel 6)"] = lambda: pipe.plan.op("peaks")(
                P2, cfg.num_max_vals, (g2.az_lo_deg, g2.az_hi_deg),
                (g2.el_lo_deg, g2.el_hi_deg), refine=True)
        out = {k: time_ms(torch, f, reps=5) for k, f in layers.items()}
    log(f"TOPS layer times (B = {x.shape[0] // cfg.snapshot_size}), ms: "
        + ", ".join(f"{k} {v:.4f}" for k, v in out.items()) + f"  [{card}]")
    return P


def tops_cell(torch, name, cfg, x, counters, card, truth, B_cpu, total):
    """One TOPS configuration on the card in both return_spectra modes
    (est_path: every count from zero, the plan's kernels each launched,
    kernel 4 and kernel 6 once a call, no other, so neither K4 nor kernel
    5; the peak allocation; EST_REPS timed calls; a profile window),
    its median sorted (pair-sorted on az/el) angles within TOPS_ANGLE_TOL
    of the scene, its layers, and the card against the CPU on B_cpu
    windows within 5e-3 deg."""
    from doa_tpu_torch.pipeline_torch import build_pipeline_torch
    B = x.shape[0] // cfg.snapshot_size
    two_d = cfg.geometry.kind == "ura"
    for rs in (True, False):
        pipe = build_pipeline_torch(cfg, device=x.device, return_spectra=rs)
        tag = f"{name} return_spectra={rs}"

        def angles(res, tag=tag):
            a = res.peak_angles["tops"]
            check(list(res.peak_angles) == ["tops"]
                  and tuple(a.shape) == ((B, cfg.num_max_vals, 2) if two_d
                                         else (B, cfg.num_max_vals)),
                  f"{tag}: peaks {list(res.peak_angles)} {tuple(a.shape)}")
            if two_d:
                est_medians(torch, tag, res, truth, ("peaks tops",),
                            TOPS_ANGLE_TOL)
                return
            a = a.sort(-1).values
            check(bool(torch.isfinite(a).all()), f"{tag}: non-finite angles")
            per = (a - torch.tensor(truth, device=a.device)).abs().amax(-1)
            med = a.median(dim=0).values
            d = float((med - torch.tensor(truth, device=a.device)).abs().max())
            log(f"{tag} peaks tops: per-window max |angle - truth| max "
                f"{float(per.max())!r}, median {float(per.median())!r} deg; "
                f"median sorted {med.tolist()} (limit {TOPS_ANGLE_TOL} deg)")
            check(d <= TOPS_ANGLE_TOL, f"{tag} median off by {d}")

        res, n = est_path(torch, tag, pipe, lambda: pipe.interleaved(x),
                          counters, card, angles)
        check(n["wideband_fft_gram"] == 1
              and n["peaks2d"] == (1 if two_d else 0),
              f"{tag}: kernel 4 and kernel 6 not once each: {n}")
        spectra_keys(torch, tag, res, ["tops"] if rs else [])
        if rs:
            P = tops_layers(torch, cfg, pipe, x, card)
            d = (P - res.spectra["tops"]).abs().max().item()
            log(f"{tag}: the layers' spectrum against the call's: max "
                f"difference {d!r} (tol 1e-6)")
            check(d <= 1e-6, f"{tag}: the layers do not give the call's "
                  "spectrum")
            del P
        for key, v in n.items():
            total[key] += v
        del res
    est_card_vs_cpu(torch, name, cfg, lambda p, xs: p.interleaved(xs),
                    x, B_cpu, True)


def wideband_rest_phase(torch, dev, card):
    """Phase 19 → the launches of the earlier kernels in these paths."""
    from doa_tpu_torch import (ArrayGeometry, DoaConfig, Estimator,
                               WidebandSpec)
    from doa_tpu_torch.ops import cpx_ops
    from doa_tpu_torch.ops.cuda import music_scan as ms
    from doa_tpu_torch.ops.cuda import peaks2d as pk
    from doa_tpu_torch.ops.cuda import wideband_cov as wc
    from doa_tpu_torch.ops.cuda import wideband_scan as wsc
    from doa_tpu_torch.pipeline_torch import build_pipeline_torch

    counters = {"wideband_fft_gram": wc.subband_chunk_grams,
                "subband_embedded_frames": wc.subband_embedded_frames,
                "mgs_iterate": cpx_ops.mgs_iterate,
                "music_scan": ms.music_scan,
                "music_scan_peaks": ms.music_scan_peaks,
                "wideband_fusion": wsc.wideband_fused_spectrum,
                "peaks2d": pk.peaks2d}
    total = {n: 0 for n in counters}
    t0 = time.perf_counter()

    def done(cell):
        log(f"phase 19: {cell} done at {time.perf_counter() - t0:.1f} s")

    # 19a. c5 with fusion="tops", 2048 windows of exp_r5.py's scene
    x16 = make_c5_scene(torch, T_C5, dev, seed=5)
    tops_cell(torch, "c5 tops", c5_variant(fusion="tops"), x16, counters,
              card, C5_TRUTH, B_TOPS_CPU, total)
    torch.cuda.empty_cache()
    done("c5 tops")

    # 19b. ULA-16 TOPS (S = 1024, F = 16, fractional bandwidth 0.4) at
    # K = 2 on the 65/115 deg scene and at K = 3 (the Jacobi λ_min)
    for K, truth, B_cpu in ((2, ULA_TRUTH, B_TOPS_CPU),
                            (3, ULA3_TRUTH, B_TOPS3_CPU)):
        cfg_u = DoaConfig(
            geometry=ArrayGeometry(kind="ula", num_elements=16,
                                   norm_spacing=0.5),
            snapshot_size=1024, num_sources=K, num_max_vals=K,
            estimators=(Estimator.MUSIC,),
            wideband=WidebandSpec(num_subbands=16, fractional_bw=0.4,
                                  fusion="tops"))
        xu = make_wideband_ula_capture(torch, T_ULA, 16, truth, 0.5, 0.4,
                                       SNR_DB, dev, seed=1)
        tops_cell(torch, f"ULA-16 tops K={K}", cfg_u, xu, counters, card,
                  truth, B_cpu, total)
        del xu
        done(f"ULA-16 tops K={K}")
    torch.cuda.empty_cache()

    # 19c. c5 incoherent at compute_dtype bfloat16 and int8, and
    # hierarchical + bfloat16: K4, then the quantized scan (torch ops),
    # no kernel 5; the card against the CPU on B_QUANT_CPU windows
    for name, over in (("c5 incoherent bf16", dict(compute_dtype="bfloat16")),
                       ("c5 incoherent int8", dict(compute_dtype="int8")),
                       ("c5 hierarchical + bf16", dict(
                           compute_dtype="bfloat16",
                           scan_mode="hierarchical"))):
        cfg5 = dataclasses.replace(c5_variant(), **over)
        pipe = build_pipeline_torch(cfg5, device=dev)
        res, n = est_path(
            torch, name, pipe, lambda: pipe.interleaved(x16), counters, card,
            lambda r, name=name: est_medians(torch, name, r, C5_TRUTH,
                                             ("peaks music",), C5_ANGLE_TOL))
        check(n["mgs_iterate"] > 0 and n["wideband_fusion"] == 0,
              f"{name}: K4 {n['mgs_iterate']}, kernel 5 "
              f"{n['wideband_fusion']} launches")
        spectra_keys(torch, name, res, [] if "scan_mode" in over
                     else ["music"])
        for key, v in n.items():
            total[key] += v
        del res
        est_card_vs_cpu(torch, name, cfg5, lambda p, xs: p.interleaved(xs),
                        x16, B_QUANT_CPU, True)
        done(name)
    del x16
    torch.cuda.empty_cache()

    # 19d. c5 with subspace_method="eigh" at reduced depth (8 windows:
    # cuSOLVER's batched Jacobi eigh of the F·B = 128 matrices of 128x128
    # takes ~0.25 s a call, thousands of launches): the eigh noise
    # projectors and their scan, no K4, no kernel 5
    x5 = make_c5_scene(torch, T_EIGH_C5, dev, seed=6)
    cfg_e = dataclasses.replace(c5_variant(), subspace_method="eigh")
    pipe = build_pipeline_torch(cfg_e, device=dev)
    name = f"c5 eigh ({T_EIGH_C5 // 1024} windows)"
    res, n = est_path(
        torch, name, pipe, lambda: pipe.interleaved(x5), counters, card,
        lambda r: est_medians(torch, name, r, C5_TRUTH, ("peaks music",),
                              C5_ANGLE_TOL))
    for key, v in n.items():
        total[key] += v
    del res
    est_card_vs_cpu(torch, name, cfg_e, lambda p, xs: p.interleaved(xs),
                    x5, B_EIGH_C5_CPU, True)
    del x5
    torch.cuda.empty_cache()
    done(name)
    return total


# ---------------------------------------------------------------------
# 20. the rest of the sharded pipeline on R ranks of one card: the
# estimators, Jacobi and beamspace (c4), and the EP wideband builders (c5)
# ---------------------------------------------------------------------
T_SH_EST = 1 << 21                 # c4: 4095 windows of 1024 at hop 512
T_SH_C5 = 1 << 20                  # c5: 1024 windows of 1024
SH_C5_SEED = 20
SH_REPS = 3                        # timed calls a case; the median is kept
# mesh shape → the cases its ranks run, in one launch. c5's 16471-point
# grid does not split in two, so CSSM's grid-sharded scan of R_coh and
# cssm_auto's EP psums run on phase 11c's ULA-16 scene (180 points)
SH_REST = (((2, 1), ("c4 estimators", "c4 beamspace", "c4 jacobi",
                     "c5 cssm")),
           ((1, 2), ("c5 incoherent", "c5 tops", "u16 cssm",
                     "u16 cssm_auto")),
           ((2, 2), ("c5 incoherent",)))


def sh_case(name):
    """Phase 20's case → (the sharded config, return_spectra, the config
    of the single-card run it is held to). The sharded general path takes
    eigh's projector under "jacobi" and a cold subspace (its reference's),
    so those single-card runs take eigh and no warm start."""
    from doa_tpu_torch import BeamspaceSpec, Estimator, PRESETS
    c4 = PRESETS["c4_ula16_streaming"]
    if name == "c4 estimators":
        cfg = dataclasses.replace(c4, halo_impl="pallas", estimators=(
            Estimator.MUSIC, Estimator.MIN_NORM, Estimator.ROOT_MUSIC,
            Estimator.ESPRIT, Estimator.UNITARY_ESPRIT))
        return cfg, False, cfg
    if name == "c4 beamspace":
        cfg = dataclasses.replace(c4, beamspace=BeamspaceSpec(
            num_beams=8, center_deg=90.0))
        return cfg, True, dataclasses.replace(cfg, subspace_warm_start=False)
    if name == "c4 jacobi":
        cfg = dataclasses.replace(c4, subspace_method="jacobi")
        return cfg, True, dataclasses.replace(cfg, subspace_method="eigh")
    fusion = name.split()[1]
    cfg = (c5_variant(fusion=fusion) if name.startswith("c5")
           else ula16_wideband(fusion, (Estimator.MUSIC,)))
    return cfg, True, cfg


def sh_capture(torch, name, device):
    """A case's whole capture x f32[T, 2N] on `device`: c4's planted scene
    as R blocks of phase 14's kind (every rank count divides T), or the c5
    scene, made alike on every rank from one seed."""
    if name.startswith("c4"):
        R = 4
        return torch.cat([shard_block(torch, T_SH_EST // R, s, device)
                          for s in range(R)])
    if name.startswith("u16"):
        return make_wideband_ula_capture(torch, T_ULA, 16, ULA_TRUTH, 0.5,
                                         0.4, SNR_DB, device, seed=1)
    return make_c5_scene(torch, T_SH_C5, device, seed=SH_C5_SEED)


def sh_counters():
    from doa_tpu_torch.ops import cpx_ops
    from doa_tpu_torch.ops.cuda import cov_embedded as ce
    from doa_tpu_torch.ops.cuda import covariance as cv
    from doa_tpu_torch.ops.cuda import music_scan as ms
    from doa_tpu_torch.ops.cuda import peaks2d as pk
    from doa_tpu_torch.ops.cuda import ring as rg
    from doa_tpu_torch.ops.cuda import wideband_cov as wc
    from doa_tpu_torch.ops.cuda import wideband_scan as wsc
    return {"halo_ring": rg.halo_ring, "chunk_gram": ce.chunk_grams_uhat,
            "chunk_embedded": ce.chunk_embedded,
            "planes_chunk_gram": cv.chunk_grams,
            "mgs_iterate": cpx_ops.mgs_iterate,
            "music_scan": ms.music_scan,
            "music_scan_peaks": ms.music_scan_peaks,
            "wideband_fft_gram": wc.subband_chunk_grams,
            "subband_embedded_frames": wc.subband_embedded_frames,
            "wideband_fusion": wsc.wideband_fused_spectrum,
            "peaks2d": pk.peaks2d}


def sh_angles(out):
    """{key: angles} of a sharded output dict (peaks and grid-free)."""
    return {k: v for k, v in out.items()
            if k.startswith("peak_angles") or k in GRID_FREE}


def shard_rest_rank(device, spec, names, card):
    """Phase 20 on one rank of a (n_snap, n_grid) mesh on cuda:0 (a
    spawn_ranks target): each case's pipeline driven once with every
    count from zero (launches, kernel 6's forms, the angles), then
    SH_REPS calls timed, every rank at once."""
    import torch
    import torch.distributed as dist
    from doa_tpu_torch.ops.cuda import peaks2d as pk
    from doa_tpu_torch.parallel import (MeshSpec, build_sharded_pipeline,
                                        make_mesh, sharded)
    from doa_tpu_torch.parallel.sharded import _block_rows

    torch.set_float32_matmul_precision("highest")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = make_mesh(MeshSpec(*spec), device=device)
    counters = sh_counters()
    out = {"device": str(mesh.device), "backend": mesh.backend,
           "coords": dict(mesh.coords)}
    for name in names:
        cfg, spectra, _ = sh_case(name)
        x = sh_capture(torch, name, mesh.device)
        lo, hi = _block_rows(x.shape[0], mesh)
        xb = x[lo:hi].clone()
        del x
        pipe = build_sharded_pipeline(cfg, mesh, return_spectra=spectra)
        torch.cuda.synchronize()
        dist.barrier()
        for f in counters.values():
            f.launches = 0
        pk.peaks2d.by_form = dict.fromkeys(pk.peaks2d.by_form, 0)
        res = pipe.local(xb)
        torch.cuda.synchronize()
        rec = {"launches": {k: f.launches for k, f in counters.items()},
               "by_form": dict(pk.peaks2d.by_form),
               "plan": dict(pipe.plan), "forms": dict(pipe.plan.forms),
               "angles": {k: v.cpu().numpy()
                          for k, v in sh_angles(res).items()},
               "keys": sorted(res)}
        del res
        ts = []
        for _ in range(SH_REPS + 1):
            dist.barrier()
            t0 = time.perf_counter()
            pipe.local(xb)
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t0) * 1e3)
        rec["ms"] = ts[1:]
        if name in ("c5 incoherent", "c5 tops") and spec[1] > 1:
            # the EP fusion's psum inside the call (the rank's (B_loc, G)
            # spectrum sum, or TOPS's Σ CᴴC planes and guard sum in one
            # buffer): SH_REPS more calls with a span around each psum
            # over the grid axis, the card synchronized and the grid
            # ranks met at a barrier first, so that the span holds the
            # host-staged all_reduce and no wait for the other rank
            plain_psum, spans = sharded.psum, []

            def timed_psum(t, mesh_, axis):
                if axis != "grid":
                    return plain_psum(t, mesh_, axis)
                torch.cuda.synchronize()
                dist.barrier(group=mesh_.group(axis))
                t0 = time.perf_counter()
                r = plain_psum(t, mesh_, axis)
                torch.cuda.synchronize()
                spans.append(((time.perf_counter() - t0) * 1e3,
                              4 * t.numel()))
                return r
            sharded.psum = timed_psum
            try:
                for _ in range(SH_REPS + 1):
                    pipe.local(xb)
                    torch.cuda.synchronize()
            finally:
                sharded.psum = plain_psum
            check(len(spans) == SH_REPS + 1, f"{name}: {len(spans)} EP "
                  f"psums in {SH_REPS + 1} calls")
            rec["psum_ms"] = [t for t, _ in spans[1:]]
            rec["psum_bytes"] = spans[0][1]
        out[name] = rec
        del pipe, xb
        torch.cuda.empty_cache()
    mesh.close()
    return out


def sh_gather(outs, spec, name, key):
    """A sharded angle output over the whole capture: grid rank 0's rows
    (the peaks are the same on every grid rank) in snap order."""
    import numpy as np
    by = {(o["coords"]["snap"], o["coords"]["grid"]): o[name]["angles"][key]
          for o in outs}
    for o in outs:
        check(np.array_equal(o[name]["angles"][key],
                             by[(o["coords"]["snap"], 0)], equal_nan=True),
              f"{name} {key}: grid ranks of one snap row disagree")
    return np.concatenate([by[(s, 0)] for s in range(spec[0])])


def sharded_rest_phase(torch, dev, card):
    """Phase 20 → the launches of the earlier kernels in the ranks'
    main-path runs."""
    import numpy as np
    from doa_tpu_torch.parallel.launch import spawn_ranks
    from doa_tpu_torch.parallel.sharded import num_valid_windows
    from doa_tpu_torch.pipeline_torch import build_pipeline_torch

    total = {n: 0 for n in sh_counters()}
    t_phase = time.perf_counter()
    for spec, names in SH_REST:
        R = spec[0] * spec[1]
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        outs = spawn_ranks(shard_rest_rank, R, (spec, names, card),
                           device="cuda", timeout=900)
        log(f"phase 20: MeshSpec{spec}: {R} ranks ran {list(names)} in "
            f"{time.perf_counter() - t0:.1f} s on "
            f"{sorted({o['device'] for o in outs})}, backend "
            f"{outs[0]['backend']}")
        for name in names:
            cfg, spectra, cfg_one = sh_case(name)
            recs = [o[name] for o in outs]
            plan = recs[0]["plan"]
            log(f"{name} on MeshSpec{spec}: plan {json.dumps(plan)}")
            check("plain" not in plan.values(),
                  f"{name}: a stage is planned plain on the card")
            # the covariance stage's launches land on kernel 9's counter
            # where its plan names kernel 9's entries (counter_of)
            planned = {counter_of(k, recs[0]["forms"].get(st))
                       for st, k in plan.items()}
            for r in recs:
                n = r["launches"]
                ran = {k for k, v in n.items() if v}
                check(ran == planned, f"{name} MeshSpec{spec}: launched "
                      f"{sorted(ran)}, planned {sorted(planned)}: {n}")
                if "peaks2d" in planned:
                    want = r["forms"].get("peaks")
                    check(r["by_form"].get(want) == n["peaks2d"]
                          == sum(r["by_form"].values()),
                          f"{name}: kernel 6 by form {r['by_form']}, "
                          f"planned {want}")
                    for f, v in r["by_form"].items():
                        PEAKS_TALLY[f] = PEAKS_TALLY.get(f, 0) + v
                for k, v in n.items():
                    total[k] += v
            log(f"{name} on MeshSpec{spec}: launches a rank "
                + json.dumps([r["launches"] for r in recs]))
            # the single-card port on the same capture
            x = sh_capture(torch, name, dev)
            B = (num_valid_windows(x.shape[0], cfg) if name.startswith("c4")
                 else x.shape[0] // cfg.snapshot_size)
            pipe = build_pipeline_torch(cfg_one, device=dev,
                                        return_spectra=spectra)
            if pipe.fast_path or cfg.wideband.enabled:
                run_one = functools.partial(pipe.interleaved, x)
            else:           # the planes route: the capture's two views
                xv = x.view(x.shape[0], -1, 2)
                run_one = functools.partial(pipe, (xv[..., 0], xv[..., 1]))
            one = run_one()
            t_one = call_times(torch, run_one, reps=SH_REPS, warm=1)
            del x, pipe, run_one
            ref = {f"peak_angles_{k}": v for k, v in one.peak_angles.items()}
            ref.update({k: getattr(one, k) for k in GRID_FREE
                        if getattr(one, k) is not None})
            check(set(ref) == set(sh_angles(dict.fromkeys(recs[0]["keys"]))),
                  f"{name}: sharded keys {recs[0]['keys']}, single card "
                  f"{sorted(ref)}")
            for key, want in ref.items():
                got = torch.from_numpy(sh_gather(outs, spec, name, key)[:B])
                want = want.cpu()
                check(tuple(got.shape) == tuple(want.shape),
                      f"{name} {key}: shapes {tuple(got.shape)}, "
                      f"{tuple(want.shape)}")
                if key == "root_music_angles":
                    # the windows where either run takes one source twice
                    # (ROADMAP §C.3) are counted, the rest held
                    t = torch.tensor(THETA)
                    twice = lambda a: ((a[..., None] - t).abs()  # noqa
                                       .amin(-2) > ANGLE_TOL).any(-1)
                    keep = ~(twice(got) | twice(want))
                    root_music_windows(torch, f"{name} sharded", got, THETA)
                    log(f"{name} root_music_angles: {int((~keep).sum())} "
                        f"of {B} windows take one source twice in the "
                        f"sharded or the single-card run; held on the rest")
                    got, want = got[keep], want[keep]
                d = float((est_sorted(torch, got)
                           - est_sorted(torch, want)).abs().max())
                log(f"{name} {key}: max|sharded - single card| {d!r} deg "
                    f"over {B} windows (tol {SHARD_TOL})")
                check(d <= SHARD_TOL, f"{name} {key}: sharded vs single "
                      f"card {d}")
                if name.startswith("u16"):
                    med = est_sorted(torch, got).median(0).values
                    dm = float((med - torch.tensor(ULA_TRUTH)).abs().max())
                    log(f"{name} {key}: median sorted {med.tolist()} "
                        f"(limit {CSSM_ANGLE_TOL} deg)")
                    check(dm <= CSSM_ANGLE_TOL, f"{name} median off by {dm}")
                elif name.startswith("c5"):
                    e_max, e_med, med = c5_errors(torch, got)
                    dm = float((med - torch.tensor(C5_TRUTH)).abs().max())
                    log(f"{name} {key}: median pair-sorted {med.tolist()}, "
                        f"per-window max |angle - truth| median {e_med!r}, "
                        f"max {e_max!r} deg (limit {C5_ANGLE_TOL} on the "
                        f"median)")
                    check(dm <= C5_ANGLE_TOL, f"{name} median off by {dm}")
                elif key != "root_music_angles":
                    e = sorted_err(torch, got, THETA)
                    log(f"{name} {key}: max |sorted angle - truth| {e!r} "
                        f"deg (limit {ANGLE_TOL})")
                    check(e <= ANGLE_TOL, f"{name} {key} angle error {e}")
            del one
            ts = np.max([r["ms"] for r in recs], axis=0)
            log(f"{name} on MeshSpec{spec} (ranks time-sliced on one card, "
                f"not scaling): median {float(np.median(ts)):.4f} ms a call "
                f"of {B} windows ({SH_REPS} calls, slowest rank each: "
                f"{[round(float(t), 4) for t in ts]}); the single-card "
                f"port on the same capture {t_one[len(t_one) // 2]:.4f} ms "
                f"(median of {SH_REPS})  [{card}]")
            if "psum_ms" in recs[0]:
                ps = np.max([r["psum_ms"] for r in recs], axis=0)
                log(f"{name} on MeshSpec{spec}: the EP psum inside the call "
                    f"({recs[0]['psum_bytes']} bytes a rank, host-staged "
                    f"gloo all_reduce, the grid ranks met first) median "
                    f"{float(np.median(ps)):.4f} ms ({SH_REPS} calls, "
                    f"slowest rank each: "
                    f"{[round(float(t), 4) for t in ps]})  [{card}]")
    log(f"phase 20: {time.perf_counter() - t_phase:.1f} s")
    return total


T_HOST_C2 = 32768                  # 21a: c2, 16 windows of 2048
T_HOST_C4 = 1 << 21                # 21a/b: c4, 4095 windows of 1024 at 512
TRACK_CARD_CMP = 512               # 21b: kernel against plain on the card
TRACK_RESUME = 2048                # 21e: the checkpoint's cut
TRACK_PLAIN_REPS = 1               # 21b: plain on the card, 4095 windows
T_STREAM = 1 << 20                 # 21c: c4, 2047 windows, blocks of 2^17
T_UDP = 1 << 16                    # 21d: c4 over loopback, blocks of 2^14
HOST_TOL_CPU = 1e-3                # deg, c2 medians: card against CPU
STREAM_TOL = 0.01                  # deg, streamed against offline
UDP_TOL = 1.0                      # deg, tests/test_socket_source.py's
TRACK_TOL = 1.5                    # deg, tests/test_streaming_tracking.py's


def cli_run(torch, tag, argv, card):
    """`python -m doa_tpu_torch` in this process: cli.main(argv) → its
    JSON lines; the wall time (to the card's sync) on a log line."""
    import contextlib
    import io
    from doa_tpu_torch import cli
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        cli.main(argv)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    out = [json.loads(s) for s in buf.getvalue().splitlines() if s.strip()]
    log(f"cli {tag}: {dt:.3f} s wall  [{card}]")
    return out


def track_equal(torch, a, b):
    """Bit-equal tracks or track states: the same NaN masks, the other
    values equal bit for bit (angles and velocities as int32 words)."""
    if isinstance(a, torch.Tensor):
        a, b = (a,), (b,)
    for x, y in zip(a, b):
        if x.dtype == torch.float32:
            if not torch.equal(x.isnan().cpu(), y.isnan().cpu()):
                return False
            x, y = (t.nan_to_num(0.0).view(torch.int32) for t in (x, y))
        if not torch.equal(x.cpu(), y.cpu()):
            return False
    return True


def track_scenes(np):
    """Detections that reach the tracker's corner cases → [(name, angles,
    values f32[B, K], TrackerConfig kwargs)]: NaN angles (a NaN wins its
    track's argmin and fails the gate) and NaN values (spawned last);
    tied values with -0.0 and 0.0 and duplicated angles (stable order,
    first-index argmin); 32 slots and 32 detections (every lane)."""
    rng = np.random.default_rng(23)
    B, t = 150, np.arange(150)
    nan_a = np.stack([40 + 0.2 * t, 90 - 0.1 * t, 140 + 0 * t,
                      rng.uniform(0, 180, B)], 1)
    nan_a = nan_a + 0.5 * rng.standard_normal((B, 4))
    nan_a[rng.random((B, 4)) < 0.1] = np.nan
    nan_v = rng.random((B, 4))
    nan_v[rng.random((B, 4)) < 0.1] = np.nan
    tie_a = np.round(rng.uniform(20, 160, (90, 6)) / 4) * 4
    tie_a[:, 3] = tie_a[:, 1]
    tie_v = rng.integers(0, 3, (90, 6)).astype(np.float64)
    tie_v[::7], tie_v[1::7] = -0.0, 0.0
    wide_a = rng.uniform(0, 180, (200, 32))
    wide_a[rng.random((200, 32)) < 0.05] = np.nan
    wide_v = rng.integers(0, 4, (200, 32)).astype(np.float64)
    return [("nan", nan_a, nan_v, dict(max_tracks=3, gate_deg=4.0,
                                       min_age=2)),
            ("ties", tie_a, tie_v, dict(max_tracks=5, gate_deg=6.0,
                                        alpha=0.3, beta=0.05, max_missed=2,
                                        min_age=1)),
            ("32 lanes", wide_a, wide_v, dict(max_tracks=32, gate_deg=3.0))]


def host_phase(torch, dev, card):
    """Phase 21: the host side — `python -m doa_tpu_torch`'s commands on
    the card (cli.main in this process), the tracker kernel against its
    plain version, the streaming driver, UDP ingest through the C++
    framer, the checkpoint and the profiling fence. → the track kernel's
    record (its launches: the `track` command's)."""
    import numpy as np
    from doa_tpu_torch import PRESETS, checkpoint, tracking
    from doa_tpu_torch.io import recorded, socket_source, synthetic
    from doa_tpu_torch.io.stream import StreamingDriver
    from doa_tpu_torch.ops.cuda import track as trk
    from doa_tpu_torch.pipeline_torch import build_pipeline_torch
    from doa_tpu_torch.utils.profiling import Timer, trace_to

    t_phase = time.perf_counter()
    c4 = PRESETS["c4_ula16_streaming"]
    with tempfile.TemporaryDirectory() as d:
        p = lambda name: os.path.join(d, name)  # noqa: E731

        # 21a. the commands at c2's and c4's full widths
        cli_run(torch, "simulate c2", [
            "simulate", "--preset", "c2_ula8_2src", "--angles", "60,110",
            "--samples", str(T_HOST_C2), "--out", p("c2.npz")], card)
        meds = {}
        for device in ("cuda", "cpu"):
            (r,) = cli_run(torch, f"estimate c2 --device {device}", [
                "estimate", "--preset", "c2_ula8_2src", "--input",
                p("c2.npz"), "--device", device], card)
            meds[device] = np.asarray(r["music"]["median_angles_deg"]
                                      + r["capon"]["median_angles_deg"])
        e = float(np.abs(meds["cuda"] - [60, 110, 60, 110]).max())
        dc = float(np.abs(meds["cuda"] - meds["cpu"]).max())
        log(f"cli estimate c2 on the card: medians {meds['cuda'].tolist()}"
            f", max |median - truth| {e!r} deg (limit {ANGLE_TOL}), max "
            f"|card - cpu| {dc!r} deg (limit {HOST_TOL_CPU})")
        check(e <= ANGLE_TOL and dc <= HOST_TOL_CPU, "cli estimate c2")
        cli_run(torch, "simulate c4", [
            "simulate", "--preset", "c4_ula16_streaming", "--angles",
            "70,110", "--samples", str(T_HOST_C4), "--out", p("c4.npz")],
            card)
        (r,) = cli_run(torch, "estimate c4", [
            "estimate", "--preset", "c4_ula16_streaming", "--input",
            p("c4.npz")], card)
        med = r["music"]["median_angles_deg"]
        e = float(np.abs(np.asarray(med) - THETA).max())
        log(f"cli estimate c4: {r['music']['windows']} windows, medians "
            f"{med}, max |median - truth| {e!r} deg (limit {ANGLE_TOL})")
        check(r["music"]["windows"] == 4095 and e <= ANGLE_TOL,
              "cli estimate c4")
        # the calibration workflow of tests/test_cli.py
        for name, ang, snr in (("common", "90", "30"),
                               ("pilot", "68", "25")):
            cli_run(torch, f"simulate {name}", [
                "simulate", "--preset", "c1_ula4_tone", "--elements", "8",
                "--angles", ang, "--samples", "16384", "--snr", snr,
                "--out", p(f"{name}.npz")], card)
        (r,) = cli_run(torch, "calibrate-phase", [
            "calibrate-phase", "--input", p("common.npz"), "--out",
            p("cal1.npz")], card)
        check(len(r["phase_offsets_rad"]) == 8, "calibrate-phase")
        (r,) = cli_run(torch, "calibrate-elements", [
            "calibrate-elements", "--input", p("pilot.npz"), "--pilot",
            "68", "--phase-calib", p("cal1.npz"), "--out", p("cal2.npz")],
            card)
        check(len(r["gains"]) == 8, "calibrate-elements")
        (r,) = cli_run(torch, "estimate c2 --calib", [
            "estimate", "--preset", "c2_ula8_2src", "--input", p("c2.npz"),
            "--calib", p("cal2.npz")], card)
        e = float(np.abs(np.asarray(r["music"]["median_angles_deg"])
                         - [60, 110]).max())
        log(f"cli estimate c2 calibrated: max |median - truth| {e!r} deg "
            f"(limit 1.5, tests/test_cli.py's)")
        check(e <= 1.5, "calibrated estimate")
        # track on a moving-emitter c4 capture: the main path of the
        # tracker kernel (counts from zero here)
        x_mov = synthetic.synth_moving_ula_iq(
            [(50.0, 80.0), (130.0, 100.0)], 16, 0.5, T_HOST_C4,
            snr_db=10, seed=5)
        recorded.save_iq(p("moving.npz"), x_mov)
        trk.track_scan.launches = 0
        (r,) = cli_run(torch, "track c4", [
            "track", "--preset", "c4_ula16_streaming", "--input",
            p("moving.npz")], card)
        launches = trk.track_scan.launches
        finals = [a for a in r["final_track_angles_deg"] if a is not None]
        log(f"cli track c4: {r['windows']} windows, {r['active_tracks']} "
            f"active tracks, final {r['final_track_angles_deg']}; track "
            f"kernel launches {launches}")
        check(launches == 1, f"track kernel launches {launches}")
        check(r["active_tracks"] >= 2 and any(
            abs(a - 80.0) < 2 for a in finals) and any(
            abs(a - 100.0) < 2 for a in finals), "cli track c4")
        rows = cli_run(torch, "evaluate c2", [
            "evaluate", "--preset", "c2_ula8_2src", "--snrs", "0,10",
            "--trials", "2"], card)
        for row in rows:
            log(f"  evaluate: {json.dumps(row)}")
        check(len(rows) == 4 and all(
            math.isfinite(r["rmse_deg"]) and r["rmse_deg"] < ANGLE_TOL
            for r in rows), "cli evaluate c2")

        # 21b. the tracker kernel against its plain version
        pipe = build_pipeline_torch(c4, device=dev)
        res = pipe(x_mov)
        ang, val = res.peak_angles["music"], res.peak_values["music"]
        B = ang.shape[0]
        tc = tracking.TrackerConfig(max_tracks=4, gate_deg=4.0)
        init = tracking.init_tracks(tc, device=dev)
        n = TRACK_CARD_CMP
        sk, tk = trk.track_scan(ang[:n], val[:n], tc, init)
        sp, tp = tracking.track_batch_plain(ang[:n], val[:n], tc, init)
        torch.cuda.synchronize()
        check(track_equal(torch, tk, tp) and track_equal(torch, sk, sp),
              f"track kernel and plain differ on the card ({n} windows)")
        s_all, t_all = trk.track_scan(ang, val, tc, init)
        t0 = time.perf_counter()
        s_cpu, t_cpu = tracking.track_batch_plain(
            ang.cpu(), val.cpu(), tc, tracking.init_tracks(tc, "cpu"))
        t_cpu_s = time.perf_counter() - t0
        check(track_equal(torch, t_all, t_cpu)
              and track_equal(torch, s_all, s_cpu),
              f"track kernel and the CPU's plain version differ ({B} "
              f"windows)")
        for name, a_np, v_np, kw in track_scenes(np):
            tcs = tracking.TrackerConfig(**kw)
            a_c = torch.from_numpy(a_np.astype(np.float32)).to(dev)
            v_c = torch.from_numpy(v_np.astype(np.float32)).to(dev)
            i_c = tracking.init_tracks(tcs, device=dev)
            outs = (trk.track_scan(a_c, v_c, tcs, i_c),
                    tracking.track_batch_plain(a_c, v_c, tcs, i_c),
                    tracking.track_batch_plain(
                        a_c.cpu(), v_c.cpu(), tcs,
                        tracking.init_tracks(tcs, "cpu")))
            same = all(track_equal(torch, o[1], outs[0][1])
                       and track_equal(torch, o[0], outs[0][0])
                       for o in outs[1:])
            log(f"track kernel, scene {name} ({a_np.shape[0]} windows, K = "
                f"{a_np.shape[1]}, M = {tcs.max_tracks}): bit-equal to the "
                f"plain version on the card and on the CPU: {same}; "
                f"{int(outs[0][1].isfinite().sum())} confirmed slot-windows")
            check(same, f"track kernel differs from plain on scene {name}")
        nan_share = float(t_all.isnan().float().mean())
        log(f"track kernel bit-equal to its plain version: on the card "
            f"over {n} windows, against the CPU's run over all {B} "
            f"({t_cpu_s:.3f} s on the host); NaN share {nan_share:.4f}, "
            f"masks equal")
        tracks = t_all.cpu().numpy()
        u = (np.arange(B) * c4.hop + c4.snapshot_size / 2) / T_HOST_C4
        tail = slice(B // 2, None)
        for name, truth in (("50->80", 50.0 + 30.0 * u),
                            ("130->100", 130.0 - 30.0 * u)):
            err = float(np.nanmean(np.nanmin(np.abs(
                tracks[tail] - truth[tail, None]), axis=1)))
            log(f"track {name}: mean error over the second half {err!r} "
                f"deg (limit {TRACK_TOL})")
            check(err < TRACK_TOL, f"track {name} error {err}")
        a_n, v_n = ang[:n].contiguous(), val[:n].contiguous()
        k_n = time_ms(torch, lambda: trk.track_scan(a_n, v_n, tc, init))
        p_n = time_ms(torch, lambda: tracking.track_batch_plain(
            a_n, v_n, tc, init), warm=1)
        k_ms = time_ms(torch, lambda: trk.track_scan(ang, val, tc, init))
        p_ms = time_ms(torch, lambda: tracking.track_batch_plain(
            ang, val, tc, init), reps=TRACK_PLAIN_REPS, warm=0)
        b = bound(B * ang.shape[1] * 8 + B * tc.max_tracks * 4, 0.0)
        log(f"track kernel at {B} windows (K = {ang.shape[1]}, M = "
            f"{tc.max_tracks}): {k_ms:.4f} ms (median of 10) against the "
            f"plain version's {p_ms:.4f} ms ({TRACK_PLAIN_REPS} call); "
            f"at {n} windows {k_n:.4f} against {p_n:.4f} ms (median of "
            f"10 each); bound {b['bound_ms']:.6f} ms ({b['bound_by']}; the "
            f"kernel is set by its dependent chain)  [{card}]")

        # 21e. checkpoint: the state at window TRACK_RESUME through the
        # .npz and back onto the card resumes the uninterrupted tracks
        cut = TRACK_RESUME
        s_half, _ = trk.track_scan(ang[:cut], val[:cut], tc, init)
        checkpoint.save_stream_state(p("stream"), checkpoint.StreamState(
            track_state=s_half, samples_processed=cut * c4.hop,
            overlap_tail=x_mov[cut * c4.hop:cut * c4.hop + c4.overlap]))
        st = checkpoint.load_stream_state(p("stream"))
        check(st.track_state.angle.is_cuda
              and st.samples_processed == cut * c4.hop, "checkpoint load")
        s_rest, t_rest = trk.track_scan(ang[cut:], val[cut:], tc,
                                        st.track_state)
        check(track_equal(torch, t_rest, t_all[cut:])
              and track_equal(torch, s_rest, s_all),
              "the resumed tracks differ from the uninterrupted ones")
        log(f"checkpoint: the card's track state at window {cut} saved, "
            f"loaded onto the card and resumed: bit-equal to the "
            f"uninterrupted tracks over windows {cut}-{B - 1}")

        # 21c. the streaming driver on the card's pipeline
        xs = synthetic.synth_ula_iq(
            [synthetic.SourceSpec(theta_deg=70.0, freq_norm=0.1),
             synthetic.SourceSpec(theta_deg=110.0, freq_norm=0.3)],
            16, 0.5, T_STREAM, snr_db=10, seed=21)
        off = pipe(xs)
        # each window's peaks sorted: the prefix sums of a block's windows
        # start at the block, so two peaks of equal power may trade
        # places against the offline call's
        offline = off.peak_angles["music"].sort(-1).values
        blk = T_STREAM // 8
        blocks = [xs[j:j + blk] for j in range(0, T_STREAM, blk)]
        t0 = time.perf_counter()
        drv = StreamingDriver(pipe, block_samples=blk)
        outs = list(drv.run_iter(blocks))
        t_iter = time.perf_counter() - t0
        got = torch.cat([r.peak_angles["music"] for _, r in outs]).sort(
            -1).values
        d_iter = float((got - offline).abs().max())
        esc = sum(int(r.escalation_flagged) for _, r in outs)
        drv = StreamingDriver(pipe, block_samples=blk, ring_capacity=8)
        for b_ in blocks:
            drv.push(b_)
        t0 = time.perf_counter()
        drv.start()
        drv.stop(wait=True)
        t_thr = time.perf_counter() - t0
        res_t = [drv.results.get_nowait() for _ in blocks]
        got_t = torch.cat([r.peak_angles["music"] for _, r in res_t]).sort(
            -1).values
        d_thr = float((got_t - offline).abs().max())
        st_ = drv.stats
        log(f"streaming c4 ({len(blocks)} blocks of {blk}): run_iter "
            f"max|streamed - offline| {d_iter!r} deg, threaded {d_thr!r} "
            f"(limit {STREAM_TOL}); {st_.windows_emitted} windows emitted, "
            f"{st_.blocks_dropped} dropped, escalated {st_.windows_escalated}"
            f" (run_iter's blocks {esc}, offline "
            f"{int(off.escalation_flagged)}); {t_iter:.3f} s and "
            f"{t_thr:.3f} s wall  [{card}]")
        check(d_iter <= STREAM_TOL and d_thr <= STREAM_TOL
              and [i for i, _ in res_t] == list(range(len(blocks)))
              and st_.windows_emitted == offline.shape[0]
              and st_.blocks_dropped == 0
              and st_.windows_escalated == esc, "streaming driver")

        # 21d. UDP: NativeUdpSource → driver → the card's pipeline
        xu = xs[:T_UDP]
        blk = T_UDP // 4
        drv = StreamingDriver(pipe, block_samples=blk).start()
        src = socket_source.NativeUdpSource(drv, num_channels=16,
                                            block_samples=blk).start()
        t0 = time.perf_counter()
        seq = 0
        for j in range(0, T_UDP, 4096):       # paced, as a radio is
            seq = socket_source.send_capture_udp(
                xu[j:j + 4096], src.addr, datagram_frames=250, seq0=seq)
            time.sleep(0.002)
        results = []
        while len(results) < 4 and time.perf_counter() - t0 < 30:
            try:
                results.append(drv.results.get(timeout=0.5))
            except Exception:
                pass
        src.stop()
        drv.stop()
        lost = src.stats.packets_lost
        check(len(results) == 4, f"udp c4: {len(results)} of 4 blocks "
              f"came through ({src.stats}, {drv.stats})")
        e = sorted_err(torch, torch.cat(
            [r.peak_angles["music"] for _, r in results]), THETA)
        log(f"udp c4 ({src.stats.packets_in} datagrams of 250 frames, "
            f"{len(results)} blocks of {blk}): {lost} lost, max |sorted "
            f"angle - truth| {e!r} deg (limit {UDP_TOL})")
        check(lost == 0 and e <= UDP_TOL, "udp c4")
        gbps, loss, deliv = socket_source.loopback_rate_bench(
            num_channels=16, seconds=0.5, native=True, native_sender=True,
            target_gbps=1.28)
        log(f"loopback_rate_bench (a host figure, no device; native "
            f"receiver and sender, offered 1.28 GB/s, 16 channels): "
            f"{gbps:.4f} GB/s received, loss {loss:.6f}, {deliv:.4f} GB/s "
            f"delivered as blocks")

        # 21f. profiling: the fence on a card result, a trace file
        tm = Timer()
        with tm:
            r_ = pipe(xs)
            Timer.fence(r_)
        with trace_to(p("trace")):
            Timer.fence(pipe(xs))
        files = os.listdir(p("trace"))
        size = sum(os.path.getsize(os.path.join(p("trace"), f))
                   for f in files)
        log(f"profiling: Timer.fence on a card DoaResult, one c4 call "
            f"{tm.best * 1e3:.3f} ms wall; trace_to wrote {files} "
            f"({size} bytes)")
        check(len(files) == 1 and size > 0, "trace_to wrote no trace")
    rec = dict(name="track", route="cuda",
               source="doa_tpu_torch/csrc/track.cu",
               replaces="doa_tpu/tracking.py:110 (the lax.scan of "
                        "track_batch; no pallas_call)",
               launches=launches, max_abs_err=0.0, ms=k_ms, plain_ms=p_ms,
               library_ms=None, **b,
               by_shape={f"{n} windows": {"ms": k_n, "plain_ms": p_n}})
    log(f"phase 21: {time.perf_counter() - t_phase:.1f} s")
    return rec


def main():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test needs "
             "an NVIDIA GPU")
    sys.path.insert(0, HERE)
    import doa_tpu_torch
    if not os.path.abspath(doa_tpu_torch.__file__).startswith(
            os.path.join(HERE, "doa_tpu_torch")):
        fail(f"doa_tpu_torch imported from {doa_tpu_torch.__file__}, not "
             f"from this checkout")
    from doa_tpu_torch import PRESETS, _build
    from doa_tpu_torch.ops.cuda import cov_embedded as ce
    from doa_tpu_torch.ops import cpx_ops
    from doa_tpu_torch.ops.cuda import music_scan as ms
    from doa_tpu_torch.pipeline_torch import build_pipeline_torch

    # 1. environment
    card = card_line()
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, device "
        f"{torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")
    torch.set_float32_matmul_precision("highest")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    # 2. build
    from concurrent.futures import ThreadPoolExecutor
    from doa_tpu_torch.ops.cuda import (covariance, peaks2d, ring,
                                        subspace_ns, track, wideband_cov,
                                        wideband_scan)
    sigs = {"cov_gram": ce._SIG, "music_scan": ms._SIG, "ring": ring._SIG,
            "subspace_ns": subspace_ns._SIG,
            "subspace": cpx_ops._SIG, "wideband_cov": wideband_cov._SIG,
            "wideband_scan": wideband_scan._SIG, "peaks2d": peaks2d._SIG,
            "covariance": covariance._SIG, "track": track._SIG}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(SOURCES)) as pool:   # one nvcc per source
        list(pool.map(lambda name: _build.load(name, sigs[name]), SOURCES))
    log(f"build: {time.perf_counter() - t0:.2f} s (nvcc per source: "
        + ", ".join(f"{k} {v:.2f} s" for k, v in _build.build_seconds.items())
        + ")")
    for name, text in _build.build_log.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")

    # 3. kernel parity (inputs of the main path's shapes)
    cfg = headline_config()
    x = make_scene(torch, T_MAIN, 16, dev)
    pipe_f = build_pipeline_torch(cfg, device=dev, return_spectra=False)
    pipe_s = build_pipeline_torch(cfg, device=dev, return_spectra=True)
    show_plan("headline return_spectra=False", pipe_f)
    show_plan("headline return_spectra=True", pipe_s)
    # every preset's plan (a pure function of its config) is all-kernel,
    # in both return_spectra modes, and so are the c5 variants driven here
    from doa_tpu_torch.pipeline_torch import kernel_plan
    for name, c in (*PRESETS.items(), ("c5_f12", c5_variant(
            snapshot_size=768, num_subbands=12)),
            ("c5 cssm", c5_variant(fusion="cssm")),
            ("c5 cssm_auto", c5_variant(fusion="cssm_auto"))):
        for rs in (True, False):
            plan = kernel_plan(c, return_spectra=rs)
            check("plain" not in plan.values(),
                  f"{name} return_spectra={rs} plans a plain stage: {plan}")
    log("every preset plans a kernel for every stage (kernel_plan)")
    Ar, Ai = pipe_f.steering_planes
    At = torch.cat([Ar, Ai], -1).contiguous()
    nrm = (At * At).sum(-1)
    from doa_tpu_torch.cpx import fp32_matmuls
    from doa_tpu_torch.ops.cpx_ops import signal_subspace_from_E_T
    with fp32_matmuls():
        E = ce.cov_embedded(x, torch.ones(16, device=dev),
                            torch.zeros(16, device=dev), N=16,
                            snapshot_size=1024)
        Vt = signal_subspace_from_E_T(E, 2, iters=8)
    torch.cuda.synchronize()
    recs = kernel_parity(torch, dev, x, Vt, At, nrm, card)
    del E, Vt

    # 4. main path
    counters = {"chunk_gram": ce.chunk_grams_uhat,
                "chunk_embedded": ce.chunk_embedded,
                "music_scan": ms.music_scan,
                "music_scan_peaks": ms.music_scan_peaks,
                "mgs_iterate": cpx_ops.mgs_iterate}
    for f in counters.values():
        f.launches = 0
    by_epi = ce.chunk_grams_uhat.by_epilogue
    by_epi.update(dict.fromkeys(by_epi, 0))
    ms.music_scan_peaks.tc_launches = 0
    k4_forms_zero()
    res_f = pipe_f.interleaved(x)
    res_s = pipe_s.interleaved(x)
    torch.cuda.synchronize()
    k9_main = ce.chunk_embedded.launches     # kernel 9's record comes later
    for name, f in counters.items():
        if name != "chunk_embedded":
            recs[name]["launches"] = f.launches
    # overlap 0: the covariance stage is kernel 9's entry, once a call
    check(k9_main == 2 and recs["chunk_gram"]["launches"] == 0
          and by_epi == {"gram": 0, "embedded": 2, "windows": 0}
          and pipe_f.plan.forms.get("covariance") == "embedded",
          f"the main path's covariance stage: kernel 9 {k9_main}, K1 "
          f"{recs['chunk_gram']['launches']} launches, by epilogue "
          f"{dict(by_epi)}; planned {pipe_f.plan.forms.get('covariance')}")
    k4_forms("main path", (pipe_f, pipe_s), cpx_ops.mgs_iterate.launches)
    recs["music_scan_peaks"]["tc_launches"] = ms.music_scan_peaks.tc_launches
    check(ms.music_scan_peaks.tc_launches
          == ms.music_scan_peaks.launches > 0,
          "K2 did not run its tensor-core form on the headline path")
    log("launches in the main path: " + json.dumps(
        {n: r["launches"] for n, r in recs.items()}
        | {"chunk_embedded": k9_main}))
    for name, r in recs.items():
        if name != "chunk_gram":
            check(r["launches"] > 0,
                  f"kernel {name} never ran in the main path")
    B = T_MAIN // 1024
    for tag, res in (("return_spectra=False", res_f),
                     ("return_spectra=True", res_s)):
        ang = res.peak_angles["music"]
        check(tuple(ang.shape) == (B, 2), f"angles shape {tuple(ang.shape)}")
        err = angle_err(torch, ang)
        log(f"main path {tag}: {B} windows, max angle error {err!r} deg "
            f"(limit {ANGLE_TOL}), escalation flagged "
            f"{int(res.escalation_flagged)}, overflow "
            f"{int(res.escalation_overflow)}")
        check(err <= ANGLE_TOL, f"main path {tag} angle error {err}")
    P = res_s.spectra["music"]
    check(tuple(P.shape) == (B, 1024) and bool(torch.isfinite(P).all()),
          "spectra not finite or of the wrong shape")
    for tag, pipe in (("return_spectra=False", pipe_f),
                      ("return_spectra=True", pipe_s)):
        ts = call_times(torch, lambda: pipe.interleaved(x), reps=20,
                        warm=3)
        med = 0.5 * (ts[9] + ts[10])
        log(f"main path {tag}: median {med:.4f} ms per call of {B} windows "
            f"(20 calls, min {ts[0]:.4f}, max {ts[-1]:.4f}) = "
            f"{B / (med / 1e3):.1f} snapshots/s  [{card}]")
    stage_times(torch, pipe_f, cfg, x, card)
    del x, res_f, res_s, P

    # 5. presets, and the card against the CPU on a small capture
    xs = make_scene(torch, T_PRESET, 16, dev, seed=2)
    xc64 = xs.cpu().numpy().view("complex64")            # (T, 16) c64
    runs = (
        ("c4_ula16_streaming", True, lambda p: p(xc64)),
        ("fast_bf16", False, lambda p: p.interleaved(xs.to(torch.bfloat16))),
        ("fast_int8", False, lambda p: p.interleaved(xs)),
    )
    for name, spectra, run in runs:
        pipe = build_pipeline_torch(PRESETS[name], device=dev,
                                    return_spectra=spectra)
        show_plan(f"preset {name}", pipe)
        res = run(pipe)
        err = angle_err(torch, res.peak_angles["music"])
        log(f"preset {name}: {res.peak_angles['music'].shape[0]} windows, "
            f"max angle error {err!r} deg (limit {ANGLE_TOL}), escalation "
            f"flagged {int(res.escalation_flagged)}")
        check(err <= ANGLE_TOL, f"preset {name} angle error {err}")
    small = xc64[:64 * 1024]
    a_gpu = build_pipeline_torch(cfg, device=dev, return_spectra=False)(
        small).peak_angles["music"].cpu()
    a_cpu = build_pipeline_torch(cfg, device="cpu", return_spectra=False)(
        small).peak_angles["music"]
    d = (a_gpu - a_cpu).abs().max().item()
    log(f"card vs CPU pipeline on 64 windows: max angle difference {d!r} "
        f"deg (tol 1e-3)")
    check(d <= 1e-3, "card and CPU pipelines disagree")
    del xs, xc64

    # 6. wideband kernel parity at c5's shapes, 7. the c5 path
    k4_shapes = recs["mgs_iterate"]["by_shape"]
    wb_recs, k4_c5 = c5_phases(torch, dev, card, counters, k4_shapes)
    recs["mgs_iterate"]["launches"] += k4_c5    # the c5 path's, counted apart
    recs.update(wb_recs)

    # 8. planes kernel parity, 9. the c3, c2, eigh paths and calibration
    pl_recs, k4_planes = planes_phases(
        torch, dev, card, k4_shapes,
        recs["music_scan_peaks"].setdefault("by_shape", {}))
    recs["mgs_iterate"]["launches"] += k4_planes
    recs.update(pl_recs)

    # 10. kernels 7 and 10, 11. c5_f12, c5 cssm / cssm_auto, ULA-16 cssm
    sb_recs, sb_launches, k3_c5 = coherent_phases(torch, dev, card,
                                                  k4_shapes)
    for name, n in sb_launches.items():
        recs[name]["launches"] += n
    recs.update(sb_recs)
    recs["music_scan"].update(k3_c5)

    # 12. kernels 11 and 9, 13. subspace_impl="pallas", subspace_check,
    # the hard scene, scan_capture (narrowband and c5), the chunk entry
    op_recs, op_launches = opt_in_phases(torch, dev, card)
    for name, n in op_launches.items():
        recs[name]["launches"] += n
    recs.update(op_recs)
    recs["chunk_embedded"]["launches"] += k9_main

    # 14. the time-sharded pipeline on 2 and 4 ranks of this card
    torch.cuda.empty_cache()
    recs["halo_ring"], sh_launches = sharded_phases(torch, dev, card)
    for name, n in sh_launches.items():
        recs[name]["launches"] += n
    # 15. fault C.5: ULA-48 and ULA-16 at K = 5 on the card
    fault_phase(torch, dev, card)
    # 16. the grid-free and projector estimators: the headline with all
    # five, c3 with Jacobi, c5 cssm and cssm_auto with 2-D ESPRIT
    for name, n in estimator_phase(torch, dev, card).items():
        recs[name]["launches"] += n
    # 17. beamspace and the hierarchical scans: the headline with 8 beams
    # and hierarchical, model order, c2, c5 and c5 cssm hierarchical
    for name, n in hier_phase(torch, dev, card).items():
        recs[name]["launches"] += n
    # 18. the complex-typed public entry (estimate_doa, build_pipeline):
    # the headline with seven estimators, c2, c3, c4, S = 96, the 8x8 URA,
    # beamspace and MVDR extraction; no kernel launched
    complex_phase(torch, dev, card)
    # 19. the rest of single-card wideband: c5 and ULA-16 TOPS, c5
    # incoherent in bf16 and int8, hierarchical + bf16, c5 with eigh
    for name, n in wideband_rest_phase(torch, dev, card).items():
        recs[name]["launches"] += n
    # 20. the rest of the sharded pipeline on 2 and 4 ranks of this card:
    # c4 with the estimators, beamspace and Jacobi; c5 incoherent (EP),
    # cssm and TOPS
    for name, n in sharded_rest_phase(torch, dev, card).items():
        recs[name]["launches"] += n
    # 21. the host side: python -m doa_tpu_torch's commands, the tracker
    # kernel, streaming, UDP through the C++ framer, the checkpoint
    recs["track"] = host_phase(torch, dev, card)
    for f, v in PEAKS_TALLY.items():
        recs["peaks2d"]["by_form"][f]["launches"] = v
    recs["mgs_iterate"]["launches_by_form"] = K4_TALLY
    check(K4_TALLY.get("group", 0) > 0 and K4_TALLY.get("block", 0) > 0,
          f"K4's forms were not both launched on the paths: {K4_TALLY}")
    check(sum(PEAKS_TALLY.values()) == recs["peaks2d"]["launches"],
          f"kernel 6's launches by form {PEAKS_TALLY} do not add up to its "
          f"{recs['peaks2d']['launches']} path launches")
    check(not any(m == "jax" or m.startswith(("jax.", "doa_tpu."))
                  or m == "doa_tpu" for m in sys.modules),
          "jax or doa_tpu was imported")
    missing = [r["name"] for r in recs.values()
               if set(KERNEL_KEYS) - set(r)]
    check(not missing, f"kernel records without every key: {missing}")
    # every process this run started has ended: nvcc and nvidia-smi were
    # waited for, the ranks joined, and the ranks' resource tracker ends here
    stop_resource_tracker()
    left = live_children()
    check(not left, f"processes still running: {left}")

    print(json.dumps({"kernels": list(recs.values())}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
