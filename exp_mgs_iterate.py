#!/usr/bin/env python3
"""Time the MGS subspace kernel K4 (doa_tpu_torch/csrc/subspace.cu) by
parts on one NVIDIA GPU, beside its plain version, other subspace.cu files
and one FP32 product of the same operands.

    python3 exp_mgs_iterate.py [--against OTHER/subspace.cu ...]
                               [--scenes headline,c3,...]

The package's K4 is loaded as the pipelines load it. Each `--against`
source (the same C ABI, e.g. an earlier commit's file from `git show`)
and each variant of a source is built by nvcc into a temporary directory
(all builds at once); a variant patches a few lines of its source:

* "block form everywhere": every 2N takes the block form (8 warps a
  window, E in shared memory); whole, so it is held to the same checks
  and timed at the narrowband shapes too.
* cuts, each built from every source (the package's, each `--against`)
  that holds each of its anchor lines exactly once: "copy only" (no apply
  products, no MGS after an apply), "applies only" (no copy, no MGS),
  "MGS only" (no copy, no apply products), and for the block form "no
  copy" (E never leaves device memory: the compute on whatever shared
  memory holds). The block form's cuts are built from the package's
  source alone and timed at its shapes (2N > 64), "one apply" being
  "applies only" at 2 rounds from an init; the cuts of a form for
  2N <= 64 at the narrowband shapes. They compute wrong bases by design
  and are only timed.

Every whole kernel is first held bit-equal to mgs_iterate_plain on exact
inputs (E a signed permutation a window, B = 1001, cold and warm) at
each (2K, 2N) of EXACT, then within 1e-5 (projectors VᵀV, and W over
max|W|) of the plain version on each scene. Scenes (chip_smoke.py's;
`--scenes` picks some): c5 warm (32768 windows of 2N = 128 through kernel
4, 3 rounds from one init per subband), c5 cold (8 rounds), c5 cssm R_coh
(2048 × 128, cold 8), the c5 subband means (16 × 128, cold 8), the
headline (16384 × 32, warm 3 from the capture mean), the headline's mean
(the capture mean, B = 1, cold 8: the launch before the warm one), c3
(16384 × 24, 2K = 6, cold 8, the smoothed windows of the c3 scene) and c2
(8192 × 16, warm 3 from its capture mean). Each time is the mean of two
medians of 10 calls (CUDA events around a call, which include the host's
cost of a call), everything at a shape in turns: plain, the package, the
whole variants, each `--against`, `torch.matmul(Vt, E)` in FP32 (TF32
off: the apply's product alone, not the same function), then the cuts;
beside them the bound of chip_smoke.mgs_bound. Then each K4 build's
device time a launch from the profiler's kernel records (`device_ms`: the
kernel alone). Prints nvcc's ptxas lines of every build (registers,
spills).
"""

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

import torch

from doa_tpu_torch import _build

HERE = os.path.dirname(os.path.abspath(__file__))
EXACT = ((2, 66), (4, 128), (8, 128), (6, 96), (4, 32), (6, 24), (2, 8),
         (4, 16), (8, 32), (2, 34), (6, 48), (8, 64))
B_EXACT = 1001
C2_SOURCES = ((60.0, 1, 10), (110.0, 31, 100))   # chip_smoke.py's c2 scene
SCENES = ("c5 warm", "c5 cold", "c5 subband means", "c5 cssm R_coh",
          "headline", "headline mean", "c3", "c2")

GROUP_MAX = "constexpr int GROUP_MAX_N2 = 64;"
COPY = (
    '  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], '
    '%1;"\n'
    '               :: "r"(bar), "r"(bytes) : "memory");\n'
    '  asm volatile(\n'
    '      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::'
    'bytes"\n'
    '      " [%0], [%1], %2, [%3];"\n'
    '      :: "r"(smem_addr(Es)), "l"(src), "r"(bytes), "r"(bar) : '
    '"memory");\n')
NO_COPY = ('  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" :: '
           '"r"(bar)\n               : "memory");\n')
APPLY = "  for (int p = p0; p < p1; ++p) {\n"
MGS = "        if (warp == 0)\n          block_mgs<K2>(VW, VW,"
# the warp form's anchors (one warp a window)
W_COPY = ("#pragma unroll 4\n  for (int idx = lane; idx < n2 * n2 / 4; "
          "idx += 32) S4[idx] = Eb4[idx];\n")
W_APPLY = "  for (int n = 0; n < n2; ++n) {\n"
W_MGS_COLD = "    mgs<CPL>(Es, V, n2, K2, 1, lane);   // rows 0..K2-1 of E\n"
W_MGS = "    mgs<CPL>(W, V, n2, K2, r == rounds - 2 ? 2 : 1, lane);\n"
# the group form's (a window per group of lanes)
G_APPLY = ("      if (cn == C - 1 && n >= n2) break;   // the window's rows "
           "end\n")
G_MGS_COLD = "      mgs_rows<K2, L, C>(v, ok, 1, mask);\n"
G_MGS = "        mgs_rows<K2, L, C>(v, ok, r == applies - 1 ? 2 : 1, mask);\n"


def sub(old, new):
    """A patch: `old` (exactly once in the source) → `new`; None where
    the source does not hold `old` exactly once."""
    return lambda src: src.replace(old, new) if src.count(old) == 1 else None


def cut(text):
    return sub(text, "")


CUT_COPY = sub(COPY, NO_COPY)
CUT_APPLY = sub(APPLY, APPLY.replace("p < p1", "p < p0"))
CUT_MGS = sub(MGS, MGS.replace("(warp == 0)", "(false)"))
W_CUT_COPY = cut(W_COPY)
W_CUT_APPLY = sub(W_APPLY, W_APPLY.replace("n < n2", "n < 0"))
W_CUT_MGS = [cut(W_MGS_COLD), cut(W_MGS)]
G_CUT_APPLY = sub(G_APPLY, G_APPLY.replace("cn == C - 1 && n >= n2",
                                           "n >= 0"))
G_CUT_MGS = [cut(G_MGS_COLD), cut(G_MGS)]
WHOLE = {"block form everywhere": [sub(GROUP_MAX, GROUP_MAX.replace("64",
                                                                    "0"))]}
# cut name → (the shapes it is timed at: "block" 2N > 64, "narrow"
# 2N <= 64; whether it is built from the package's source alone; its
# patches, each of which must apply)
CUT = {"copy only": ("block", True, [CUT_APPLY, CUT_MGS]),
       "applies only": ("block", True, [CUT_COPY, CUT_MGS]),
       "MGS only": ("block", True, [CUT_COPY, CUT_APPLY]),
       "no copy": ("block", True, [CUT_COPY]),
       "warp form: copy only": ("narrow", False,
                                [W_CUT_APPLY, *W_CUT_MGS]),
       "warp form: applies only": ("narrow", False,
                                   [W_CUT_COPY, *W_CUT_MGS]),
       "warp form: MGS only": ("narrow", False,
                               [W_CUT_COPY, W_CUT_APPLY]),
       "group form: copy only": ("narrow", False,
                                 [G_CUT_APPLY, *G_CUT_MGS]),
       "group form: applies only": ("narrow", False,
                                    [CUT_COPY, *G_CUT_MGS]),
       "group form: MGS only": ("narrow", False,
                                [CUT_COPY, G_CUT_APPLY])}


def patched(src, patches):
    """`src` with every patch applied, or None where one does not apply."""
    for p in patches:
        src = p(src)
        if src is None:
            return None
    return src


def ptxas_lines(log):
    """nvcc -Xptxas=-v's lines of each entry: its name, spills and
    registers."""
    return [ln.strip() for ln in log.splitlines()
            if any(w in ln for w in ("entry function", "spill",
                                     "registers"))]


def build(tmp, name, src):
    """→ (the loaded library, ptxas lines) of CUDA source text `src`."""
    from doa_tpu_torch.ops import cpx_ops

    cu = os.path.join(tmp, re.sub(r"\W+", "_", name) + ".cu")
    with open(cu, "w") as f:
        f.write(src)
    so = cu[:-3] + ".so"
    proc = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", so,
                           cu], capture_output=True, text=True)
    if proc.returncode != 0:
        sys.exit(f"{name}: nvcc failed\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(so)
    for fn, argtypes in cpx_ops._SIG.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    return lib, ptxas_lines(proc.stdout + proc.stderr)


def run(lib, E, K, rounds, init=None):
    """K4 of `lib` → (Vt, W, Vt_prev), called as cpx_ops.mgs_iterate
    calls the package's."""
    from doa_tpu_torch.ops import cpx_ops

    B, n2 = E.shape[0], E.shape[-1]
    group = 0
    if init is not None:
        m, init = cpx_ops._init_rows(init, B)
        group = B // m
        init = init.contiguous()
    outs = [torch.empty((B, 2 * K, n2), device=E.device) for _ in range(3)]
    _build.check(lib.doa_mgs_iterate(
        E.data_ptr(), None if init is None else init.data_ptr(), group,
        *(o.data_ptr() for o in outs), B, n2, 2 * K, rounds,
        torch.cuda.current_stream().cuda_stream), "doa_mgs_iterate")
    return outs


def device_ms(fn, reps=10):
    """Device ms a launch of fn's K4 kernel (every entry's name has
    "mgs_"), from the profiler's kernel records over reps calls: the
    kernel alone, without the host's cost of a call."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages() if "mgs_" in e.key]
    us = sum(e.self_device_time_total for e in ev)
    n = sum(e.count for e in ev)
    return us / n / 1e3 if n else float("nan")


def scenes(dev, names):
    """→ {name: (E, K, rounds, init)} at the paths' shapes, for `names`."""
    import chip_smoke as cs
    from doa_tpu_torch import PRESETS
    from doa_tpu_torch.cpx import embed_planes, fp32_matmuls, unembed_planes
    from doa_tpu_torch.ops import cpx_ops
    from doa_tpu_torch.ops import wideband as wb
    from doa_tpu_torch.ops.cuda import cov_embedded as ce
    from doa_tpu_torch.ops.cuda import wideband_cov as wc
    from doa_tpu_torch.pipeline_torch import compute_covariances

    out = {}
    with fp32_matmuls():
        if any(n.startswith("c5") for n in names):
            x = cs.make_c5_scene(torch, cs.T_C5, dev, seed=5)
            E_sub = wc.wideband_cov_embedded(
                x, torch.ones(64, device=dev), torch.zeros(64, device=dev),
                N=64, F=16, snapshot_size=1024)
            del x
            E = E_sub.reshape(-1, 128, 128)
            init = cpx_ops.mgs_iterate_plain(E_sub.mean(dim=1), 2, 8)[0]
            out["c5 warm"] = (E, 2, 3, init)
            out["c5 cold"] = (E, 2, 8, None)
            out["c5 subband means"] = (E_sub.mean(dim=1), 2, 8, None)
            if "c5 cssm R_coh" in names:
                cfg = cs.c5_variant(fusion="cssm")
                R = wb.cssm_covariance(
                    torch.complex(*unembed_planes(E_sub)),
                    torch.from_numpy(wb.focusing_matrices(cfg)).to(dev))
                out["c5 cssm R_coh"] = (embed_planes(
                    R.real.contiguous(), R.imag.contiguous()), 2, 8, None)
                del R
        if "headline" in names or "headline mean" in names:
            x = cs.make_scene(torch, cs.T_MAIN, 16, dev)
            E = ce.cov_embedded(x, torch.ones(16, device=dev),
                                torch.zeros(16, device=dev), N=16,
                                snapshot_size=1024)
            del x
            Em = E.mean(0, keepdim=True)
            init = cpx_ops.mgs_iterate_plain(Em, 2, 8)[0]
            out["headline"] = (E, 2, 3, init.expand(E.shape[0], -1, -1))
            out["headline mean"] = (Em, 2, 8, None)
        if "c3" in names:
            x3 = cs.make_ula_capture(torch, cs.T_C3, 16, cs.c3_sources(),
                                     cs.SNR_DB, dev, seed=3)
            R = compute_covariances(x3[..., 0], x3[..., 1],
                                    PRESETS["c3_ula16_calib_smooth"],
                                    (torch.ones(16, device=dev),
                                     torch.zeros(16, device=dev)))
            del x3
            out["c3"] = (embed_planes(*R), 3, 8, None)
        if "c2" in names:
            x2 = cs.make_ula_capture(torch, cs.T_C2, 8, C2_SOURCES,
                                     cs.SNR_DB, dev, seed=2)
            E = ce.cov_embedded(x2, torch.ones(8, device=dev),
                                torch.zeros(8, device=dev), N=8,
                                snapshot_size=2048)
            del x2
            init = cpx_ops.mgs_iterate_plain(E.mean(0, keepdim=True), 2,
                                             8)[0]
            out["c2"] = (E, 2, 3, init.expand(E.shape[0], -1, -1))
    return {n: out[n] for n in names}


def exact_cases(dev, gen):
    """→ [(tag, E, K, rounds, init)]: signed-permutation windows."""
    import chip_smoke as cs

    cases = []
    for k2, n2 in EXACT:
        Eq = cs.signed_permutations(torch, B_EXACT, n2, gen, dev)
        rows = Eq[:, :k2, :]
        for start, rounds, ini in (("cold", 8, None), ("cold", 1, None),
                                   ("per group", 3, rows[::143].clone()),
                                   ("per window", 3, rows.clone())):
            cases.append((f"(2K, 2N) = ({k2}, {n2}) {start} {rounds} rounds",
                          Eq, k2 // 2, rounds, ini))
    return cases


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--against", action="append", default=[],
                    help="another subspace.cu (repeatable)")
    ap.add_argument("--scenes", default=",".join(SCENES),
                    help="comma-separated scenes of " + ", ".join(SCENES))
    args = ap.parse_args()
    names = [n.strip() for n in args.scenes.split(",")]
    if not set(names) <= set(SCENES):
        sys.exit(f"unknown scenes {sorted(set(names) - set(SCENES))}")
    if not torch.cuda.is_available():
        sys.exit("exp_mgs_iterate.py needs an NVIDIA GPU")
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from doa_tpu_torch.cpx import fp32_matmuls
    from doa_tpu_torch.ops import cpx_ops
    from doa_tpu_torch.ops.cuda import cov_embedded as ce
    from doa_tpu_torch.ops.cuda import wideband_cov as wc

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    card = cs.card_line()
    print(card)
    dev = torch.device("cuda", 0)
    pkg_src = _build.expanded_source(os.path.join(_build.CSRC,
                                                  "subspace.cu"))
    origins = {"package": pkg_src}
    for path in args.against:
        origins[f"against {path}"] = _build.expanded_source(path)
    sources, cuts = {}, {}          # cuts: variant name → its form's shapes
    for name, patches in WHOLE.items():
        src = patched(pkg_src, patches)
        if src is not None:
            sources[name] = src
    for path in args.against:
        sources[f"against {path}"] = origins[f"against {path}"]
    for name, (shapes, package_only, patches) in CUT.items():
        for origin, src in origins.items():
            if package_only and origin != "package":
                continue
            src = patched(src, patches)
            if src is not None:
                vname = name if origin == "package" else f"{origin}: {name}"
                sources[vname] = src
                cuts[vname] = shapes
    with tempfile.TemporaryDirectory() as tmp, ThreadPoolExecutor(
            len(sources) + 3) as pool:
        futs = {n: pool.submit(build, tmp, n, s) for n, s in sources.items()}
        loads = [pool.submit(_build.load, name, sig) for name, sig in (
            ("cov_gram", ce._SIG), ("subspace", cpx_ops._SIG),
            ("wideband_cov", wc._SIG))]
        for f in loads:
            f.result()
        built = {n: f.result() for n, f in futs.items()}
    for ln in ptxas_lines(_build.build_log.get("subspace", "")):
        print(f"ptxas package: {ln}")
    for name, (_, ptx) in built.items():
        for ln in ptx:
            print(f"ptxas {name}: {ln}")
    whole = {"package": cpx_ops.mgs_iterate}
    for name, (lib, _) in built.items():
        if name not in cuts:
            whole[name] = (lambda E, K, r, i=None, lib=lib:
                           run(lib, E, K, r, i))
    gen = torch.Generator(device=dev).manual_seed(3)
    for tag, E, K, rounds, ini in exact_cases(dev, gen):
        want = cpx_ops.mgs_iterate_plain(E, K, rounds, ini)
        for name, fn in whole.items():
            d = max((a - b).abs().max().item()
                    for a, b in zip(fn(E, K, rounds, ini), want))
            print(f"{name}: exact inputs {tag}: max|kernel - plain| = "
                  f"{d!r} (must be 0)")
            if d != 0.0:
                sys.exit(f"{name}: exact inputs differ at {tag}")
    res, errs, dev_ms = {}, {}, {}
    for tag, (E, K, rounds, init) in scenes(dev, names).items():
        B, n2 = E.shape[0], E.shape[-1]
        form = "block" if cpx_ops.mgs_form(n2, 2 * K) == "block" else \
            "narrow"
        with fp32_matmuls():
            want = cpx_ops.mgs_iterate_plain(E, K, rounds, init)
        for name, fn in whole.items():
            got = fn(E, K, rounds, init)
            dp = 0.0
            for lo in range(0, B, 4096):
                a, b = got[0][lo:lo + 4096], want[0][lo:lo + 4096]
                dp = max(dp, (a.transpose(1, 2) @ a - b.transpose(1, 2) @ b
                              ).abs().max().item())
            dw = ((got[1] - want[1]).abs().max()
                  / want[1].abs().max()).item()
            errs[f"{tag}: {name}"] = [dp, dw]
            print(f"{tag} (B={B}, 2N={n2}, 2K={2 * K}, {rounds} rounds): "
                  f"{name}: max|projector - plain| = {dp!r}, max|W - "
                  f"plain|/max|W| = {dw!r} (tol 1e-5 each)")
            if dp > 1e-5 or dw > 1e-5:
                sys.exit(f"{name} disagrees with plain at {tag}")
            del got
        Vt = want[0]
        fns = {"plain": lambda: cpx_ops.mgs_iterate_plain(E, K, rounds,
                                                         init)}
        k4 = {}
        for name, fn in whole.items():
            k4[name] = fns[name] = lambda fn=fn: fn(E, K, rounds, init)

        def product():
            with fp32_matmuls():
                return torch.matmul(Vt, E)
        fns["torch.matmul(Vt, E) FP32, product only"] = product
        for name, shapes in cuts.items():
            if shapes == form:
                lib = built[name][0]
                k4[name] = fns[name] = (lambda lib=lib:
                                        run(lib, E, K, rounds, init))
        if form == "block":
            Vi = Vt.contiguous()
            k4["one apply (applies only, 2 rounds from an init)"] = fns[
                "one apply (applies only, 2 rounds from an init)"] = (
                lambda: run(built["applies only"][0], E, K, 2, Vi))
        with fp32_matmuls():
            for name, t in zip(fns, cs.turns_ms(torch, *fns.values())):
                res[f"{tag}: {name}"] = t
            for name, fn in k4.items():
                dev_ms[f"{tag}: {name}"] = device_ms(fn)
        bnd = cs.mgs_bound(E, 2 * K, rounds, cold=init is None)
        res[f"{tag}: bound ({bnd['bound_by']})"] = bnd["bound_ms"]
        del want, Vt, fns, k4
    for n, t in res.items():
        print(f"{n}: {t:.4f} ms  [{card}]")
    for n, t in dev_ms.items():
        print(f"{n}: device {t:.4f} ms a launch  [{card}]")
    print(json.dumps({"card": card, "ms": res, "device_ms": dev_ms,
                      "max_err": errs}))


if __name__ == "__main__":
    main()
