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
   plain version's.
4. main path: the headline configuration (ULA-16, S=1024, K=2, G=1024,
   MUSIC, e1 power schedule, warm start + escalation) at T=2^24 samples
   (16384 windows) through build_pipeline_torch(...).interleaved, with
   return_spectra False (fused scan + peaks, K2) and True (K3); launch
   counts reset before and read after; every window within 0.5° of the
   planted 70°/110°; the median call time from CUDA events.
5. the same scene check on the c4_ula16_streaming, fast_bf16 and
   fast_int8 presets at T=2^20, and the card's pipeline against the same
   pipeline on the CPU on a small capture.

The last two lines: one JSON object with the kernels, then
{"ok": true, "device": {...}}.
"""

import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
THETA = (70.0, 110.0)      # planted truth (bench.py's scene)
CYCLES = (5, 9)            # tone frequencies, cycles per PERIOD samples
PERIOD = 1024
SNR_DB = 10.0
T_MAIN = 1 << 24
T_PRESET = 1 << 20
ANGLE_TOL = 0.5            # degrees, every window (bench.py tripwire)


def log(msg):
    print(msg, flush=True)


def fail(msg):
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


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


def pair_ms(torch, kernel, plain):
    """(kernel ms, plain ms) measured in turns: plain, kernel, kernel,
    plain; each figure is the mean of its two medians."""
    p0 = time_ms(torch, plain)
    k0 = time_ms(torch, kernel)
    k1 = time_ms(torch, kernel)
    p1 = time_ms(torch, plain)
    return 0.5 * (k0 + k1), 0.5 * (p0 + p1)


def check(cond, msg):
    if not cond:
        fail(msg)


def kernel_parity(torch, dev, x, Vt, At, nrm, card):
    """Phase 3 → the kernel records for the JSON line (launches filled in
    after the main path)."""
    from doa_tpu_torch.io.native import quantize_interleaved_int8
    from doa_tpu_torch.ops.cuda import cov_embedded as ce
    from doa_tpu_torch.ops.cuda import music_scan as ms

    g = 1024
    recs = {}
    gen = torch.Generator(device=dev).manual_seed(1)

    # K1 exact: integer-valued samples, every partial sum an integer
    # below 2^24, so FP32 sums are exact in any order
    # (every 2N the kernel takes: its 4x4 and 2x2 register-tile forms)
    for n2 in (6, 16, 30, 32, 64):
        xi = torch.randint(-20, 21, (64 * g, n2), generator=gen, device=dev)
        for dt in (torch.float32, torch.bfloat16, torch.int8):
            xk = xi.to(dt)
            d = (ce.chunk_grams_uhat(xk, g)
                 - ce.chunk_grams_uhat_plain(xk, g)).abs().max().item()
            log(f"K1 exact-input 2N={n2} {dt}: max|kernel-plain| = {d!r} "
                f"(must be 0)")
            check(d == 0.0, f"K1 2N={n2} {dt} differs on exact inputs")
    # K1 at the main path's shape on the planted scene
    Uk = ce.chunk_grams_uhat(x, g)
    Up = ce.chunk_grams_uhat_plain(x, g)
    err = (Uk - Up).abs().max().item()
    scale = Up.abs().max().item()
    log(f"K1 f32 scene T={x.shape[0]}: max|kernel-plain| = {err!r}, "
        f"max|U| = {scale!r}, tol 1e-5*max|U|")
    check(err <= 1e-5 * scale, "K1 f32 disagrees with plain")
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
    k_ms, p_ms = pair_ms(torch, lambda: ce.chunk_grams_uhat(x, g),
                         lambda: ce.chunk_grams_uhat_plain(x, g))
    kq_ms, pq_ms = pair_ms(torch, lambda: ce.chunk_grams_uhat(xq, g),
                           lambda: ce.chunk_grams_uhat_plain(xq, g))
    log(f"K1 time f32 [{x.shape[0]}, 32] g={g}: kernel {k_ms:.4f} ms, plain "
        f"{p_ms:.4f} ms; int8: kernel {kq_ms:.4f} ms, plain (f64 bmm) "
        f"{pq_ms:.4f} ms  [{card}]")
    recs["chunk_gram"] = dict(
        name="chunk_gram", route="cuda",
        source="doa_tpu_torch/csrc/cov_gram.cu",
        replaces="doa_tpu/ops/pallas/cov_embedded.py:191",
        max_abs_err=err, ms=k_ms, plain_ms=p_ms)

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
    log(f"K3 exact-input: max|kernel-plain| = {d3!r} (must be 0)")
    check(d3 == 0.0, "K3 differs on exact inputs")
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

    # K3 / K2 at the main path's shapes on the scene's subspaces
    Pk = ms.music_scan(Vt, At, nrm)
    Pp = ms.music_scan_plain(Vt, At, nrm)
    e3 = (1.0 / Pk - 1.0 / Pp).abs().max().item()
    tol3 = 1e-5 * nrm.max().item()
    log(f"K3 scene B={Vt.shape[0]} G={At.shape[0]}: max|den kernel - den "
        f"plain| = {e3!r}, tol 1e-5*max‖a‖² = {tol3!r}")
    check(e3 <= tol3, "K3 disagrees with plain")
    k3_ms, p3_ms = pair_ms(torch, lambda: ms.music_scan(Vt, At, nrm),
                           lambda: ms.music_scan_plain(Vt, At, nrm))
    log(f"K3 time: kernel {k3_ms:.4f} ms, plain {p3_ms:.4f} ms  [{card}]")
    recs["music_scan"] = dict(
        name="music_scan", route="cuda",
        source="doa_tpu_torch/csrc/music_scan.cu",
        replaces="doa_tpu/ops/pallas/music_scan.py:56",
        max_abs_err=e3, ms=k3_ms, plain_ms=p3_ms)
    vk, lk = ms.music_scan_peaks(Vt, At, 2, 0.0, 180.0, True, nrm)
    vp, lp = ms.music_scan_peaks_plain(Vt, At, 2, 0.0, 180.0, True, nrm)
    # the two planted sources have equal power, so which peak ranks first
    # may flip on rounding: compare each window's sorted angles
    e2 = (lk.sort(-1).values - lp.sort(-1).values).abs().max().item()
    log(f"K2 scene: max|sorted loc kernel - plain| = {e2!r} deg, tol 0.01; "
        f"max angle error vs truth {angle_err(torch, lk)!r}")
    check(e2 <= 0.01, "K2 disagrees with plain")
    k2_ms, p2_ms = pair_ms(
        torch, lambda: ms.music_scan_peaks(Vt, At, 2, 0.0, 180.0, True, nrm),
        lambda: ms.music_scan_peaks_plain(Vt, At, 2, 0.0, 180.0, True, nrm))
    log(f"K2 time: kernel {k2_ms:.4f} ms, plain {p2_ms:.4f} ms  [{card}]")
    recs["music_scan_peaks"] = dict(
        name="music_scan_peaks", route="cuda",
        source="doa_tpu_torch/csrc/music_scan.cu",
        replaces="doa_tpu/ops/pallas/music_scan.py:138",
        max_abs_err=e2, ms=k2_ms, plain_ms=p2_ms)

    # K4 on the scene's windows: the pipeline's warm refine (3 rounds from
    # the capture-mean subspace) and a cold 8-round start; rsqrt and the
    # sums' order differ, so projectors VᵀV are held to 1e-5
    from doa_tpu_torch.cpx import fp32_matmuls
    from doa_tpu_torch.ops import cpx_ops
    with fp32_matmuls():
        E = ce.cov_embedded(x, torch.ones(16, device=dev),
                            torch.zeros(16, device=dev), N=16,
                            snapshot_size=1024)
        init = cpx_ops.mgs_iterate_plain(E.mean(0, keepdim=True), 2, 8)[0]
        init = init.expand(E.shape[0], -1, -1)
        e4 = 0.0
        for rounds, ini in ((3, init), (8, None)):
            outk = cpx_ops.mgs_iterate(E, 2, rounds, ini)
            outp = cpx_ops.mgs_iterate_plain(E, 2, rounds, ini)
            proj = [o.transpose(1, 2) @ o for o in (outk[0], outp[0])]
            dp = (proj[0] - proj[1]).abs().max().item()
            dw = ((outk[1] - outp[1]).abs().max()
                  / outp[1].abs().max()).item()
            start = "warm" if ini is not None else "cold"
            log(f"K4 scene rounds={rounds} {start}: max|projector kernel - "
                f"plain| = {dp!r} (tol 1e-5), "
                f"max|W kernel - plain|/max|W| = {dw!r} (tol 1e-5)")
            check(dp <= 1e-5 and dw <= 1e-5, "K4 disagrees with plain")
            e4 = max(e4, dp)
        k4_ms, p4_ms = pair_ms(
            torch, lambda: cpx_ops.mgs_iterate(E, 2, 3, init),
            lambda: cpx_ops.mgs_iterate_plain(E, 2, 3, init))
    log(f"K4 time (warm, 3 rounds, B={E.shape[0]}): kernel {k4_ms:.4f} ms, "
        f"plain {p4_ms:.4f} ms  [{card}]")
    recs["mgs_iterate"] = dict(
        name="mgs_iterate", route="cuda",
        source="doa_tpu_torch/csrc/subspace.cu",
        replaces="doa_tpu/ops/cpx_ops.py:347",
        max_abs_err=e4, ms=k4_ms, plain_ms=p4_ms)
    return recs


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
    from doa_tpu_torch.ops.cuda.music_scan import music_scan_peaks

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
        out["scan + peaks (K2)"] = time_ms(
            torch, lambda: music_scan_peaks(Vt, At, 2, 0.0, 180.0, True,
                                            nrm))
    log("layer times, ms: " + ", ".join(f"{k} {v:.4f}"
                                        for k, v in out.items())
        + f"  [{card}]")

    # device busy share of whole calls, from a short profiler window
    from torch.profiler import ProfilerActivity, profile
    pipe.interleaved(x)
    torch.cuda.synchronize()
    calls = 3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            pipe.interleaved(x)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0))
        if dev_us > 0:
            rows.append((dev_us, ev.count, ev.key))
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows) / 1e3
    log(f"profile of {calls} calls: wall {wall_ms:.3f} ms, device busy "
        f"{busy_ms:.3f} ms, idle share {1 - busy_ms / wall_ms:.3f}; "
        f"{sum(r[1] for r in rows)} device ops  [{card}]")
    for dev_us, count, key in rows[:10]:
        log(f"  {dev_us / 1e3 / calls:9.4f} ms/call  x{count // calls:<4d} "
            f"{key[:90]}")


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
    t0 = time.perf_counter()
    _build.load("cov_gram", ce._SIG)
    _build.load("music_scan", ms._SIG)
    _build.load("subspace", cpx_ops._SIG)
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
                "music_scan": ms.music_scan,
                "music_scan_peaks": ms.music_scan_peaks,
                "mgs_iterate": cpx_ops.mgs_iterate}
    for f in counters.values():
        f.launches = 0
    res_f = pipe_f.interleaved(x)
    res_s = pipe_s.interleaved(x)
    torch.cuda.synchronize()
    for name, f in counters.items():
        recs[name]["launches"] = f.launches
    log("launches in the main path: " + json.dumps(
        {n: r["launches"] for n, r in recs.items()}))
    for name, r in recs.items():
        check(r["launches"] > 0, f"kernel {name} never ran in the main path")
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
    check("jax" not in sys.modules, "jax was imported")

    print(json.dumps({"kernels": list(recs.values())}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
