#!/usr/bin/env python3
"""Time kernel 11, the cold Newton–Schulz subspace
(doa_tpu_torch/csrc/subspace_ns.cu), by parts on one NVIDIA GPU, beside its
plain version, other subspace_ns.cu files and torch.linalg.eigh.

    python3 exp_subspace_ns.py [--against OTHER/subspace_ns.cu ...]

The package's kernel is loaded as the pipelines load it and launched in
each form (`subspace_ns._launch`). Each `--against` source (the C entry
`doa_subspace_ns`, e.g. an earlier commit's file from `git show`) and each
cut of the package's warp form is built by nvcc into a temporary
directory, all at once; a cut patches one line and exits if its anchor
text is not in the source exactly once:

* "copy only": no applies and no orthonormalisation (E in, scaled by its
  trace; rows 0..2K-1 out);
* "applies only": no copy into shared memory, no orthonormalisation;
* "chain only": no copy, no applies (each round's Gram, Newton–Schulz
  chain and output product on whatever the slice holds).

The cuts compute wrong bases by design and are only timed. Every whole
kernel (the package's two forms, each `--against`) is first held to
subspace_ns_plain on chip_smoke.ns_scenes (the headline's E at squarings
0, a 60/110 deg scene of its shape at squarings 2, ULA-12 (24, 6) and
ULA-8 (16, 4) at squarings 0 and 2, c5's first subband (128, 4) at
squarings 0 and 2): projectors within chip_smoke.NS_PROJ_TOL, rows
orthonormal within NS_ORTH_TOL. Then, at each scene, everything that
takes it in turns (CUDA events; each figure the mean of two medians of
10): the plain version, the warp form, the block form, each `--against`,
and at the headline's two scenes the cuts and one torch.linalg.eigh of
the stack; then each kernel's device time a launch from the profiler's
kernel records (`device_ms`: the kernel alone, where the event times
include the host's cost of a call); beside them the bound
(chip_smoke.ns_flops, E read and Vt written once). Prints nvcc's ptxas
lines of every build (registers, spills).
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

COPY = "  for (int i = lane; i < nn / 4; i += 32) {\n"
APPLY = "    if (r > 0) apply<K2, CPL>(v, A, Vs, n2, lane);\n"
CHAIN = "    orthonormalise<K2, CPL>(\n"


def once(src, text):
    if src.count(text) != 1:
        sys.exit(f"exp_subspace_ns.py: {text!r} is not in the source once")
    return text


def sub(old, new):
    return lambda src: src.replace(once(src, old), new)


CUT_COPY = sub(COPY, COPY.replace("i < nn / 4", "i < 0"))
CUT_APPLY = sub(APPLY, "")
CUT_CHAIN = sub(CHAIN, "    if (false) orthonormalise<K2, CPL>(\n")
CUT = {"copy only": [CUT_APPLY, CUT_CHAIN],
       "applies only": [CUT_COPY, CUT_CHAIN],
       "chain only": [CUT_COPY, CUT_APPLY]}


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
    lib = ctypes.CDLL(so)
    lib.doa_subspace_ns.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                    *[ctypes.c_int] * 7, ctypes.c_void_p]
    lib.doa_subspace_ns.restype = ctypes.c_int
    return lib, ptxas_lines(proc.stdout + proc.stderr)


def run(lib, E, K, iters, squarings, ns_iters=12, ns_iters_mid=8):
    """Kernel 11 of `lib` through its C entry doa_subspace_ns → Vt."""
    from doa_tpu_torch.ops.cuda import subspace_ns as sns

    B, n2 = E.shape[0], E.shape[-1]
    out = torch.empty((B, 2 * K, n2), device=E.device)
    _build.check(lib.doa_subspace_ns(
        E.data_ptr(), out.data_ptr(), B, n2, 2 * K,
        sns.ns_rounds(iters, squarings), ns_iters, ns_iters_mid, squarings,
        torch.cuda.current_stream().cuda_stream), "doa_subspace_ns")
    return out


def device_ms(fn, reps=10):
    """Device ms a launch of fn's kernel 11 (every entry's name has
    "subspace_ns"), from the profiler's kernel records over reps calls:
    the kernel alone, without the host's cost of a call."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages() if "subspace_ns" in e.key]
    us = sum(e.self_device_time_total for e in ev)
    n = sum(e.count for e in ev)
    return us / n / 1e3 if n else float("nan")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--against", action="append", default=[],
                    help="another subspace_ns.cu (repeatable)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("exp_subspace_ns.py needs an NVIDIA GPU")
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from doa_tpu_torch.cpx import fp32_matmuls
    from doa_tpu_torch.ops.cuda import cov_embedded as ce
    from doa_tpu_torch.ops.cuda import subspace_ns as sns
    from doa_tpu_torch.ops.cuda import wideband_cov as wc

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    card = cs.card_line()
    print(card)
    dev = torch.device("cuda", 0)
    pkg_src = _build.expanded_source(os.path.join(_build.CSRC,
                                                  "subspace_ns.cu"))
    sources = {}
    for name, patches in CUT.items():
        src = pkg_src
        for p in patches:
            src = p(src)
        sources[name] = src
    for path in args.against:
        sources[f"against {path}"] = _build.expanded_source(path)
    with tempfile.TemporaryDirectory() as tmp, ThreadPoolExecutor(
            len(sources) + 3) as pool:
        futs = {n: pool.submit(build, tmp, n, s) for n, s in sources.items()}
        loads = [pool.submit(_build.load, name, sig) for name, sig in (
            ("cov_gram", ce._SIG), ("subspace_ns", sns._SIG),
            ("wideband_cov", wc._SIG))]
        for f in loads:
            f.result()
        built = {n: f.result() for n, f in futs.items()}
    for ln in ptxas_lines(_build.build_log.get("subspace_ns", "")):
        print(f"ptxas package: {ln}")
    for name, (_, ptx) in built.items():
        for ln in ptx:
            print(f"ptxas {name}: {ln}")

    def form(f):
        return lambda E, K, it, sq: sns._launch(E, K, f, iters=it,
                                                squarings=sq)
    against = {n: (lambda E, K, it, sq, lib=lib: run(lib, E, K, it, sq))
               for n, (lib, _) in built.items() if n not in CUT}
    x = cs.make_scene(torch, cs.T_MAIN, 16, dev, seed=12)
    with fp32_matmuls():
        scenes = cs.ns_scenes(torch, dev, x)
    del x
    res, errs = {}, {}
    for s_i, (tag, E, K, sq, iters) in enumerate(scenes):
        B, n2 = E.shape[0], E.shape[-1]
        label = f"{tag} (B={B}, 2N={n2}, 2K={2 * K}, squarings {sq}, " \
                f"{sns.ns_rounds(iters, sq)} rounds)"
        whole = {}
        if sns.ns_form(n2, 2 * K) == "warp":
            whole["warp form"] = form("warp")
        whole["block form"] = form("block")
        whole.update(against)
        with fp32_matmuls():
            want = sns.subspace_ns_plain(E, K, iters=iters, squarings=sq)
        eye = torch.eye(2 * K, device=dev)
        for name, fn in whole.items():
            got = fn(E, K, iters, sq)
            dp = 0.0
            for lo in range(0, B, 4096):
                a, b = got[lo:lo + 4096], want[lo:lo + 4096]
                dp = max(dp, (a.transpose(1, 2) @ a - b.transpose(1, 2) @ b
                              ).abs().max().item())
            do = (got @ got.transpose(1, 2) - eye).abs().max().item()
            errs[f"{label}: {name}"] = [dp, do]
            print(f"{label}: {name}: max|projector - plain| = {dp!r} (tol "
                  f"{cs.NS_PROJ_TOL}), max|Vt Vtᵀ - I| = {do!r} (tol "
                  f"{cs.NS_ORTH_TOL})")
            if dp > cs.NS_PROJ_TOL or do > cs.NS_ORTH_TOL:
                sys.exit(f"{name} disagrees with plain at {label}")
        del want
        fns = {"plain": lambda: sns.subspace_ns_plain(E, K, iters=iters,
                                                      squarings=sq)}
        for name, fn in whole.items():
            fns[name] = lambda fn=fn: fn(E, K, iters, sq)
        if s_i < 2:                         # the headline's shape
            for name in CUT:
                lib = built[name][0]
                fns[name] = lambda lib=lib: run(lib, E, K, iters, sq)
            fns["torch.linalg.eigh (library)"] = lambda: torch.linalg.eigh(E)
        with fp32_matmuls():
            for name, t in zip(fns, cs.turns_ms(torch, *fns.values())):
                res[f"{label}: {name}"] = t
            for name, fn in fns.items():
                if name != "plain" and "eigh" not in name:
                    res[f"{label}: {name}, device time a launch"] = (
                        device_ms(fn))
        bnd = cs.bound(cs.nbytes(E) + B * 2 * K * n2 * 4,
                       cs.ns_flops(B, n2, 2 * K, iters, sq))
        res[f"{label}: bound ({bnd['bound_by']})"] = bnd["bound_ms"]
    for n, t in res.items():
        print(f"{n}: {t:.4f} ms  [{card}]")
    print(json.dumps({"card": card, "ms": res, "max_err": errs}))


if __name__ == "__main__":
    main()
