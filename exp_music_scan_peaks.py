#!/usr/bin/env python3
"""Time the fused scan + peaks kernel K2 (doa_tpu_torch/csrc/music_scan.cu)
at the headline's, c3's and c2's shapes on one NVIDIA GPU, beside its
plain version, another music_scan.cu, the unfused route and its parts.

    python3 exp_music_scan_peaks.py [--against OTHER/music_scan.cu ...]

The package's K2 is called as the pipelines call it (its grid operand made
once). Each `--against` source (this C ABI, or the earlier one whose K2
entry `doa_music_scan_peaks` reads Vt and Aᵀ: e.g. an earlier commit's
file from `git show`, with the headers it includes beside it or taken
from the package's csrc/) is built by nvcc into a temporary directory,
and so are patched copies of the package's source (each patch exits if
its anchor text is not in the source exactly once; only the first two
are timed as whole calls, all alone):

- "products and den only": the tile's peak phase cut out (den is still
  written to shared memory; the least den, now unread, is not tracked);
- "peak phase only": the tile products cut out, so den = nrm, which the
  run gives as the scene's ‖a‖² times a random factor in [1, 1.5) a bin
  (a row with a local extremum every ~3 bins: more peaks than a scene);
- "no candidate tests": the peak rule's second pass (the divisions at
  the marked bins) cut out;
- "no scan (no candidates)": its first pass cut out;
- "products, den of one row of each m64 tile": the peak phase cut out
  and den_pair replaced by one sum of the two accumulators a bin (what
  reading the accumulators costs, without den_pair's arithmetic);
- "products only": the peak phase and den_pair cut out (the products'
  results unused; den rows of ones).

Every whole kernel is first held bit-equal to the plain version on exact
inputs (quarter-step V, integer A, a constant nrm; chip_smoke's
`k2_exact` for the package, k = 2 with refine on for the others), then
within 0.01° (each window's sorted angles) of the plain version on the
three scenes: the headline (B = 16384, 2K = 4, 2N = 32, G = 1024, k = 2;
chip_smoke's planted scene, cold subspaces), c3 (16384, 6, 24, 1024, 3;
chip_smoke's c3 capture, unimpaired, smoothed covariances, cold
subspaces) and c2 (8192, 4, 16, 181, 2; chip_smoke's c2 capture). Each
time is the mean of two medians of 10 calls (CUDA events), all in turns:
plain, the package, each `--against`, the unfused route (K3 with its A'
made once, normalise, find_local_max), the package's CUDA-core form on
the same inputs and the first two patched copies; then the package's
kernel and the patched ones alone (their C entry called with every
operand ready, none of the wrapper's host work). ptxas lines of every
build, and the bounds of §6 of PERF.md.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile

import torch

from doa_tpu_torch import _build

HERE = os.path.dirname(os.path.abspath(__file__))
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
OLD_SIG = {"doa_music_scan_peaks": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                    _F, _F, _I, _P]}
TC_CALL = "    tile_products<K2>(vp, S, 0, dk, d_step, d_plane, hh, cr);\n"
NO_PEAKS = ("    if (j < nJ - 1) continue;\n", "    continue;\n")
SCAN = "  for (int m = 0, g0 = 4 * lane; g0 < G; ++m, g0 += 128) {\n"
TESTS = "    for (unsigned long long c = cand[r]; c; c &= c - 1) {\n"
EPILOGUE = "      den_pair<K2>(hh, cr, nrm_s + g0, jj, tq, d);\n"
PATCHES = {
    "products and den only": (NO_PEAKS,),
    "peak phase only": ((TC_CALL,
                         "    (void)dk;\n#pragma unroll\n"
                         "    for (int i = 0; i < MT; ++i)\n#pragma unroll\n"
                         "      for (int q = 0; q < NA; ++q) "
                         "hh[i][q] = cr[i][q] = 0.f;\n"),),
    "no candidate tests": ((TESTS, TESTS.replace("= cand[r]", "= 0")),),
    "no scan (no candidates)": ((SCAN, SCAN.replace("g0 < G", "g0 < 0")),),
    "products, den of one row of each m64 tile": (NO_PEAKS, (
        EPILOGUE, "      d[0] = hh[0][4 * jj] + cr[0][4 * jj];\n"
        "      d[1] = hh[0][4 * jj + 1] + cr[0][4 * jj + 1];\n")),
    "products only": (NO_PEAKS,
                       (EPILOGUE, EPILOGUE.replace(
                           "den_pair<K2>(hh, cr, nrm_s + g0, jj, tq, d);",
                           "d[0] = d[1] = 1.f;"))),
}


def ptxas_lines(log):
    """nvcc -Xptxas=-v's lines of each entry: its name, spills and
    registers."""
    return [ln.strip() for ln in log.splitlines()
            if any(w in ln for w in ("entry function", "spill",
                                     "registers"))]


def build(tmp, src, tag):
    """→ (the loaded library of the source text, whether it has the
    earlier ABI, ptxas lines)."""
    from doa_tpu_torch.ops.cuda import music_scan as ms

    cu = os.path.join(tmp, f"music_scan_{len(os.listdir(tmp))}.cu")
    with open(cu, "w") as f:
        f.write(src)
    so = cu[:-3] + ".so"
    # a header the source's own directory lacks comes from the package's
    proc = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-I",
                           _build.CSRC, "-o", so, cu], capture_output=True,
                          text=True)
    if proc.returncode != 0:
        sys.exit(f"{tag}: nvcc failed\n{proc.stdout}{proc.stderr}")
    old = "doa_music_scan_peaks_tc" not in src
    lib = ctypes.CDLL(so)
    for fn, argtypes in (OLD_SIG if old else ms._SIG).items():
        getattr(lib, fn).argtypes = argtypes
    return lib, old, ptxas_lines(proc.stdout + proc.stderr)


def patched(src, edits, tag):
    for anchor, text in edits:
        if src.count(anchor) != 1:
            sys.exit(f"{tag}: anchor found {src.count(anchor)} times, not "
                     f"once:\n{anchor}")
        src = src.replace(anchor, text)
    return src


def peaks_with(lib, old, Vt, At, nrm, k, refine, op=None):
    """K2 of `lib` → (vals, locs), called as the package's wrapper calls
    its own (either ABI; `op`: the form's grid operand, made if None)."""
    from doa_tpu_torch.ops.cuda import music_scan as ms

    B, K2, n2 = Vt.shape
    G = At.shape[0]
    dx = 180.0 / (G - 1)
    if not old:
        if op is None:
            op = ms.peaks_tiles(At, K2)
        form = ms._peaks_tc if ms.peaks_tc_takes(K2, n2, G) else ms._peaks_fma
        return form(Vt, op, nrm, k, 0.0, dx, refine, lib)
    vals = torch.empty((B, k), device=Vt.device)
    locs = torch.empty((B, k), device=Vt.device)
    if op is None:
        op = At.T.contiguous()
    _build.check(lib.doa_music_scan_peaks(
        Vt.contiguous().data_ptr(), op.data_ptr(), nrm.data_ptr(),
        vals.data_ptr(), locs.data_ptr(), B, K2, n2, G, k, 0.0, dx,
        int(refine), torch.cuda.current_stream().cuda_stream),
        "doa_music_scan_peaks")
    return vals, locs


def scenes(dev):
    """→ {name: (Vt, Ã, nrm, k, truth)} at the headline's, c3's and c2's
    shapes."""
    import chip_smoke as cs
    from doa_tpu_torch import PRESETS
    from doa_tpu_torch.cpx import embed_planes, fp32_matmuls
    from doa_tpu_torch.ops import cpx_ops
    from doa_tpu_torch.ops.cuda import cov_embedded as ce
    from doa_tpu_torch.pipeline_torch import (build_pipeline_torch,
                                              compute_covariances)

    def grid(cfg):
        At = torch.cat(build_pipeline_torch(cfg, device=dev)
                       .steering_planes, -1).contiguous()
        return At, (At * At).sum(-1)

    out = {}
    with fp32_matmuls():
        x = cs.make_scene(torch, cs.T_MAIN, 16, dev)
        E = ce.cov_embedded(x, torch.ones(16, device=dev),
                            torch.zeros(16, device=dev), N=16,
                            snapshot_size=1024)
        out["headline"] = (cpx_ops.signal_subspace_from_E_T(E, 2, iters=8),
                           *grid(cs.headline_config()), 2, cs.THETA)
        del x, E
        cfg3 = PRESETS["c3_ula16_calib_smooth"]
        x3 = cs.make_ula_capture(torch, cs.T_C3, 16, cs.c3_sources(),
                                 cs.SNR_DB, dev, seed=3)
        one = (torch.ones(16, device=dev), torch.zeros(16, device=dev))
        R = compute_covariances(x3[..., 0], x3[..., 1], cfg3, one)
        out["c3"] = (cpx_ops.signal_subspace_from_E_T(embed_planes(*R), 3,
                                                      iters=8),
                     *grid(cfg3), 3, cs.C3_TRUTH)
        del x3, R
        x2 = cs.make_ula_capture(torch, cs.T_C2, 8,
                                 ((60.0, 1, 10), (110.0, 31, 100)),
                                 cs.SNR_DB, dev, seed=2)
        E2 = ce.cov_embedded(x2, torch.ones(8, device=dev),
                             torch.zeros(8, device=dev), N=8,
                             snapshot_size=2048)
        out["c2"] = (cpx_ops.signal_subspace_from_E_T(E2, 2, iters=8),
                     *grid(PRESETS["c2_ula8_2src"]), 2, cs.C2_TRUTH)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--against", action="append", default=[],
                    help="another music_scan.cu (repeatable)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("exp_music_scan_peaks.py needs an NVIDIA GPU")
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from doa_tpu_torch.ops import cpx_ops
    from doa_tpu_torch.ops.cuda import cov_embedded as ce
    from doa_tpu_torch.ops.cuda import covariance as cv
    from doa_tpu_torch.ops.cuda import music_scan as ms
    from doa_tpu_torch.ops.peaks import find_local_max

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    card = cs.card_line()
    dev = torch.device("cuda", 0)
    for name, sig in (("cov_gram", ce._SIG), ("subspace", cpx_ops._SIG),
                      ("covariance", cv._SIG)):
        _build.load(name, sig)
    pkg = _build.load("music_scan", ms._SIG)
    for ln in ptxas_lines(_build.build_log.get("music_scan", "")):
        print(f"ptxas package: {ln}")
    gen = torch.Generator(device=dev).manual_seed(3)
    cs.k2_exact(torch, dev, gen)
    src = _build.expanded_source(os.path.join(_build.CSRC, "music_scan.cu"))

    def ri(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=gen,
                             device=dev).float()

    res, errs = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        others, parts = {}, {}
        for path in args.against:
            lib, old, ptx = build(tmp, _build.expanded_source(path), path)
            others[f"against {path}"] = (lib, old)
            for ln in ptx:
                print(f"ptxas against {path}: {ln}")
        for tag, edits in PATCHES.items():
            lib, _, ptx = build(tmp, patched(src, edits, tag), tag)
            parts[tag] = lib
            for ln in ptx:
                print(f"ptxas {tag}: {ln}")
        for name, (lib, old) in others.items():
            for k2, n2, G in cs.K2_EXACT:
                Vq = ri(-2, 3, (1000, k2, n2)) / 4
                Vq[0] = 0.0
                Aq = ri(-3, 4, (G, n2))
                nq = torch.full((G,), 300000.0, device=dev)
                d = max((a - b).abs().max().item() for a, b in zip(
                    peaks_with(lib, old, Vq, Aq, nq, 2, True),
                    ms.music_scan_peaks_plain(Vq, Aq, 2, 0.0, 180.0, True,
                                              nq)))
                print(f"{name}: exact inputs (2K, 2N, G) = ({k2}, {n2}, "
                      f"{G}) max|kernel - plain| = {d!r} (must be 0)")
                if d != 0.0:
                    sys.exit(f"{name}: exact inputs differ")
        for tag, (Vt, At, nrm, k, truth) in scenes(dev).items():
            Vt = Vt.contiguous()
            B, K2, n2 = Vt.shape
            G = At.shape[0]
            op = ms.peaks_tiles(At, K2)
            At_T = At.T.contiguous()
            _, lp = ms.music_scan_peaks_plain(Vt, At, k, 0.0, 180.0, True,
                                              nrm)
            whole = {"package": lambda: ms.music_scan_peaks(
                Vt, At, k, 0.0, 180.0, True, nrm, op)}
            for name, (lib, old) in others.items():
                whole[name] = (lambda lib=lib, old=old: peaks_with(
                    lib, old, Vt, At, nrm, k, True,
                    At_T if old else op))
            for name, fn in whole.items():
                lk = fn()[1]
                e = (lk.sort(-1).values - lp.sort(-1).values).abs().max()
                errs[f"{tag}: {name}"] = e.item()
                et = cs.sorted_err(torch, lk, truth)
                print(f"{tag} (B={B}, 2K={K2}, 2N={n2}, G={G}, k={k}): "
                      f"{name} max|sorted loc - plain| = {e.item()!r} deg "
                      f"(tol 0.01), vs the planted {truth} {et!r} deg")
                if e.item() > 0.01 or et > cs.ANGLE_TOL:
                    sys.exit(f"{name} disagrees at {tag}")
            k3_tiles = ms.scan_tiles(At, K2)

            def unfused():
                P = ms.music_scan(Vt, At, nrm, k3_tiles)
                return find_local_max(P / P.max(-1, keepdim=True).values,
                                      k, 0.0, 180.0, refine=True)
            nrm_r = nrm * (1.0 + 0.5 * torch.rand(G, generator=gen,
                                                  device=dev))
            fns = {"plain": lambda: ms.music_scan_peaks_plain(
                Vt, At, k, 0.0, 180.0, True, nrm)}
            fns.update(whole)
            fns["unfused route: K3, normalise, find_local_max"] = unfused
            if ms.peaks_tc_takes(K2, n2, G):
                fns["package: CUDA-core form"] = lambda: ms._peaks_fma(
                    Vt, At_T, nrm, k, 0.0, 180.0 / (G - 1), True)
                for ptag, lib in list(parts.items())[:2]:
                    fns[f"package: {ptag}"] = (
                        lambda lib=lib, ptag=ptag: ms._peaks_tc(
                            Vt, op, nrm_r if ptag == "peak phase only"
                            else nrm, k, 0.0, 180.0 / (G - 1), True, lib))
            for name, t in zip(fns, cs.turns_ms(torch, *fns.values())):
                res[f"{tag}: {name}"] = t
            if ms.peaks_tc_takes(K2, n2, G):
                vk = torch.empty((B, k), device=dev)
                lk = torch.empty((B, k), device=dev)
                grid = min(-(-B // 32), ms._sm_count(dev))
                for name, lib in {"package": pkg, **parts}.items():
                    nr = nrm_r if name == "peak phase only" else nrm

                    def alone(lib=lib, nr=nr):
                        _build.check(lib.doa_music_scan_peaks_tc(
                            Vt.data_ptr(), op.data_ptr(), nr.data_ptr(),
                            vk.data_ptr(), lk.data_ptr(), B, K2,
                            ms.fusion_bins(K2), n2, ms.fusion_kp(n2), G, k,
                            0.0, 180.0 / (G - 1), 1, grid,
                            torch.cuda.current_stream().cuda_stream), "K2")
                    res[f"{tag}: {name}: kernel alone ({grid} blocks)"] = (
                        cs.time_ms(torch, alone))
            vals = torch.empty((B, k), device=dev)
            moved = cs.nbytes(Vt, At, nrm, vals, vals)
            res[f"{tag}: bound at the FP32 rate"] = cs.bound(
                moved, cs.scan_flops(B, G, K2, n2))["bound_ms"]
            res[f"{tag}: bound, 3 products at the TF32 rate"] = cs.bound(
                moved, 3 * 2 * B * K2 * n2 * G, cs.H100_TF32_PER_S)[
                    "bound_ms"]
            del Vt, At, nrm, op, At_T, k3_tiles
    for n, t in res.items():
        print(f"{n}: {t:.4f} ms  [{card}]")
    print(json.dumps({"card": card, "ms": res, "max_sorted_loc_err": errs}))


if __name__ == "__main__":
    main()
