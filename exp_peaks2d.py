#!/usr/bin/env python3
"""Time kernel 6, the 2-D az/el peaks (doa_tpu_torch/csrc/peaks2d.cu), by
parts on one NVIDIA GPU, beside its plain version and other peaks2d.cu
files.

    python3 exp_peaks2d.py [--against OTHER/peaks2d.cu ...]

The package's kernel is loaded as the pipelines load it and launched in
each form (`peaks2d._launch`). Each `--against` source (the C entry
`doa_peaks2d`, e.g. an earlier commit's file from `git show`) and each cut
of the package's ring form is built by nvcc into a temporary directory,
all at once; a cut patches lines and exits if an anchor text is not in
the source exactly once:

* "copy only": the ring's bulk copies and waits; no stencil (lane 0 of
  each stencil warp lists its first row's first bin as a peak), no
  merges, no argmax walk, no refine;
* "stencil only": the stencil and the list stores on whatever the slots
  hold (the bulk copies of zero bytes), no merges, no argmax walk, no
  refine;
* "merge and refine only": both merges, the pad and the refine on the
  listed bins; no copy, no stencil.

The cuts compute wrong peaks by design and are only timed. The spectra
are the MUSIC spectra of three c5 paths on chip_smoke's c5 scene (c5,
c5_f12, c5 cssm; B = 2048 windows of 181 × 91 each). Every whole kernel
(the package's two forms, each `--against`) is first held bit-equal to
find_local_max_2d at k = 2 with refine on each spectrum and on
chip_smoke's exact inputs (integer spectra full of ties and plateaus, a
rising window, a flat one) at k = 1, 2, 3, 4. Then, on each spectrum,
everything in turns (CUDA events; each figure the mean of two medians of
10): the plain version, the ring form, the block form, each `--against`
and, on the c5 spectrum, the cuts; then each kernel's device time a
launch from the profiler's kernel records (`device_ms`: the kernel
alone, where the event times include the host's cost of a call); beside
them the bound (P read and the outputs written once). Prints nvcc's
ptxas lines of every build (registers, spills).
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

import torch

from doa_tpu_torch import _build

HERE = os.path.dirname(os.path.abspath(__file__))
AZ_RNG, EL_RNG = (-90.0, 90.0), (0.0, 90.0)

COPY = "    const uint32_t bytes = (uint32_t)(b - a);\n"
STENCIL = "      if (r0 < r1) {\n"
LANE_MERGE = ("      warp_merge<K>(tv, ti);                // the warp's "
              "lanes\n")
WARP_MERGE = ("    warp_merge<K>(tv, ti);                  // the block's "
              "warps\n")
FALLBACK = "    if (!isfinite(tv[0])) {\n"
REFINE = "    if (lane < K) {\n"


def once(src, text):
    if src.count(text) != 1:
        sys.exit(f"exp_peaks2d.py: {text!r} is not in the source once")
    return text


def sub(old, new):
    return lambda src: src.replace(once(src, old), new)


CUT_COPY = sub(COPY, "    const uint32_t bytes = 0;\n")
# each stencil warp's lane 0 lists its first row's first bin as a peak
CUT_STENCIL = sub(STENCIL, "      if (r0 < r1 && lane == 0) { tv[0] = 1.f; "
                  "ti[0] = r0 * Ge; }\n      if (false) {\n")
CUT_MERGE = [sub(LANE_MERGE, ""), sub(WARP_MERGE, ""),
             sub(FALLBACK, "    if (false) {\n"),
             sub(REFINE, "    if (false) {\n")]
CUT = {"copy only": [CUT_STENCIL, *CUT_MERGE],
       "stencil only": [CUT_COPY, *CUT_MERGE],
       "merge and refine only": [CUT_COPY, CUT_STENCIL]}


def ptxas_lines(log):
    """nvcc -Xptxas=-v's lines of each entry: its name, spills and
    registers."""
    return [ln.strip() for ln in log.splitlines()
            if any(w in ln for w in ("entry function", "spill",
                                     "registers"))]


def build(tmp, name, src):
    """→ (the loaded library, ptxas lines) of CUDA source text `src`."""
    cu = os.path.join(tmp, name.replace(" ", "_").replace("/", "_") + ".cu")
    with open(cu, "w") as f:
        f.write(src)
    so = cu[:-3] + ".so"
    proc = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", so,
                           cu], capture_output=True, text=True)
    if proc.returncode != 0:
        sys.exit(f"{name}: nvcc failed\n{proc.stdout}{proc.stderr}")
    from doa_tpu_torch.ops.cuda import peaks2d as pk
    lib = ctypes.CDLL(so)
    lib.doa_peaks2d.argtypes = pk._SIG["doa_peaks2d"]
    lib.doa_peaks2d.restype = ctypes.c_int
    return lib, ptxas_lines(proc.stdout + proc.stderr)


def run(lib, P, k, refine=True):
    """Kernel 6 of `lib` through its C entry doa_peaks2d → (values, az,
    el)."""
    B, Ga, Ge = P.shape
    outs = [torch.empty((B, k), device=P.device) for _ in range(3)]
    _build.check(lib.doa_peaks2d(
        P.data_ptr(), *(o.data_ptr() for o in outs), B, Ga, Ge, k,
        AZ_RNG[0], (AZ_RNG[1] - AZ_RNG[0]) / (Ga - 1), EL_RNG[0],
        (EL_RNG[1] - EL_RNG[0]) / (Ge - 1), int(refine),
        torch.cuda.current_stream().cuda_stream), "doa_peaks2d")
    return tuple(outs)


def device_ms(fn, reps=10):
    """Device ms a launch of fn's kernel 6 (every entry's name has
    "peaks2d"), from the profiler's kernel records over reps calls: the
    kernel alone, without the host's cost of a call."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages() if "peaks2d" in e.key]
    us = sum(e.self_device_time_total for e in ev)
    n = sum(e.count for e in ev)
    return us / n / 1e3 if n else float("nan")


def spectra(cs, dev):
    """{tag: P f32[B, 181, 91]}: the MUSIC spectra of the c5, c5_f12 and
    c5 cssm paths on chip_smoke's c5 scenes."""
    from doa_tpu_torch import PRESETS
    from doa_tpu_torch.pipeline_torch import build_pipeline_torch

    out = {}
    for tag, cfg, T in (
            ("c5", PRESETS["c5_ura64_wideband"], cs.T_C5),
            ("c5_f12", cs.c5_variant(snapshot_size=768, num_subbands=12),
             cs.T_F12),
            ("c5 cssm", cs.c5_variant(fusion="cssm"), cs.T_C5)):
        x = cs.make_c5_scene(torch, T, dev)
        P = build_pipeline_torch(cfg, device=dev).interleaved(
            x).spectra["music"]
        g2 = cfg.grid2d
        out[tag] = P.reshape(-1, g2.num_az, g2.num_el).contiguous()
        del x
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--against", action="append", default=[],
                    help="another peaks2d.cu (repeatable)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("exp_peaks2d.py needs an NVIDIA GPU")
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from doa_tpu_torch.ops.cuda import cov_embedded as ce
    from doa_tpu_torch.ops.cuda import music_scan as ms
    from doa_tpu_torch.ops.cuda import peaks2d as pk
    from doa_tpu_torch.ops.cuda import wideband_cov as wc
    from doa_tpu_torch.ops.cuda import wideband_scan as wsc
    from doa_tpu_torch.ops import cpx_ops
    from doa_tpu_torch.ops.peaks import find_local_max_2d

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    card = cs.card_line()
    print(card)
    dev = torch.device("cuda", 0)
    pkg_src = _build.expanded_source(os.path.join(_build.CSRC, "peaks2d.cu"))
    sources = {}
    for name, patches in CUT.items():
        src = pkg_src
        for p in patches:
            src = p(src)
        sources[name] = src
    for path in args.against:
        sources[f"against {path}"] = _build.expanded_source(path)
    with tempfile.TemporaryDirectory() as tmp, ThreadPoolExecutor(
            len(sources) + 6) as pool:
        futs = {n: pool.submit(build, tmp, n, s) for n, s in sources.items()}
        loads = [pool.submit(_build.load, name, sig) for name, sig in (
            ("peaks2d", pk._SIG), ("wideband_cov", wc._SIG),
            ("wideband_scan", wsc._SIG), ("subspace", cpx_ops._SIG),
            ("music_scan", ms._SIG), ("cov_gram", ce._SIG))]
        for f in loads:
            f.result()
        built = {n: f.result() for n, f in futs.items()}
    for ln in ptxas_lines(_build.build_log.get("peaks2d", "")):
        print(f"ptxas package: {ln}")
    for name, (_, ptx) in built.items():
        for ln in ptx:
            print(f"ptxas {name}: {ln}")

    def form(f):
        return lambda P, k, refine=True: pk._launch(P, k, AZ_RNG, EL_RNG,
                                                    refine, f)
    whole = {"ring form": form("ring"), "block form": form("block")}
    whole.update({n: (lambda P, k, refine=True, lib=lib: run(lib, P, k,
                                                             refine))
                  for n, (lib, _) in built.items() if n not in CUT})

    def diff(got, P, k, refine):
        want = find_local_max_2d(P, k, AZ_RNG, EL_RNG, refine)
        return max((a - b).abs().max().item() for a, b in zip(got, want))

    errs, res = {}, {}
    gen = torch.Generator(device=dev).manual_seed(6)
    Pq = torch.randint(1, 6, (512, 181, 91), generator=gen, device=dev,
                       dtype=torch.int32).float()
    Pq[0] = torch.arange(181 * 91, device=dev,
                         dtype=torch.float32).reshape(181, 91)
    Pq[1] = 2.0
    for name, fn in whole.items():
        for k in (1, 2, 3, 4):
            for refine in (False, True):
                d = diff(fn(Pq, k, refine), Pq, k, refine)
                errs[f"exact k={k} refine={refine}: {name}"] = d
                if d != 0.0:
                    sys.exit(f"{name} differs from plain on exact inputs "
                             f"(k={k}, refine={refine}): {d!r}")
    print("every whole kernel bit-equal to plain on the exact inputs")
    for tag, P in spectra(cs, dev).items():
        label = f"{tag} (B={P.shape[0]}, {P.shape[1]}x{P.shape[2]}, k=2)"
        for name, fn in whole.items():
            d = diff(fn(P, 2), P, 2, True)
            errs[f"{label}: {name}"] = d
            print(f"{label}: {name}: max|kernel - plain| = {d!r} (must "
                  f"be 0)")
            if d != 0.0:
                sys.exit(f"{name} differs from plain on {label}")
        fns = {"plain": lambda: find_local_max_2d(P, 2, AZ_RNG, EL_RNG,
                                                  True)}
        for name, fn in whole.items():
            fns[name] = lambda fn=fn: fn(P, 2)
        if tag == "c5":
            for name in CUT:
                lib = built[name][0]
                fns[name] = lambda lib=lib: run(lib, P, 2)
        for name, t in zip(fns, cs.turns_ms(torch, *fns.values())):
            res[f"{label}: {name}"] = t
        for name, fn in fns.items():
            if name != "plain":
                res[f"{label}: {name}, device time a launch"] = (
                    device_ms(fn))
        bnd = cs.bound(cs.nbytes(P) + 3 * P.shape[0] * 2 * 4,
                       4 * P.numel())
        res[f"{label}: bound ({bnd['bound_by']})"] = bnd["bound_ms"]
    for n, t in res.items():
        print(f"{n}: {t:.4f} ms  [{card}]")
    print(json.dumps({"card": card, "ms": res, "max_err": errs}))


if __name__ == "__main__":
    main()
