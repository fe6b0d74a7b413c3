#!/usr/bin/env python3
"""Time the MGS subspace kernel K4 (doa_tpu_torch/csrc/subspace.cu) by
parts on one NVIDIA GPU, beside its plain version, other subspace.cu files
and one FP32 product of the same operands.

    python3 exp_mgs_iterate.py [--against OTHER/subspace.cu ...]

The package's K4 is loaded as the pipelines load it. Each `--against`
source (the same C ABI, e.g. an earlier commit's file from `git show`)
and each variant of the package's source is built by nvcc into a
temporary directory (all builds at once); a variant patches a few lines,
and exits if its anchor text is not in the source exactly once:

* "block form everywhere": every 2N takes the block form (8 warps a
  window, E in shared memory), the warp form none; whole, so it is held
  to the same checks and timed at the warp form's shapes too.
* the block form cut: "copy only" (no apply products, no MGS after an
  apply), "applies only" (no copy, no MGS), "MGS only" (no copy, no
  apply products), "no copy" (E never leaves device memory: the compute
  on whatever shared memory holds). They compute wrong bases by design
  and are only timed, at the block form's shapes; "one apply" is
  "applies only" at 2 rounds from an init.

Every whole kernel is first held bit-equal to mgs_iterate_plain on exact
inputs (E a signed permutation a window, B = 1001, cold and warm) at
(2K, 2N) = (2, 66), (4, 128), (8, 128), (6, 96), (4, 32), (6, 24), then
within 1e-5 (projectors VᵀV, and W over max|W|) of the plain version on
each scene. Shapes (chip_smoke.py's scenes): c5 warm (32768 windows of
2N = 128 through kernel 4, 3 rounds from one init per subband), c5 cold
(8 rounds), c5 cssm R_coh (2048 × 128, cold 8), the c5 subband means (16
× 128, cold 8), the headline (16384 × 32, warm 3 from the capture mean)
and c3 (16384 × 24, 2K = 6, cold 8, the smoothed windows of the c3
scene). Each time is the mean of two medians of 10 calls (CUDA events),
everything at a shape in turns: plain, the package, the whole variants,
each `--against`, `torch.matmul(Vt, E)` in FP32 (TF32 off: the apply's
product alone, not the same function), then the cut variants; beside
them the bound of chip_smoke.mgs_bound. Prints nvcc's ptxas lines of
every build (registers, spills).
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
EXACT = ((2, 66), (4, 128), (8, 128), (6, 96), (4, 32), (6, 24))
B_EXACT = 1001

WARP_MAX = "constexpr int WARP_MAX_N2 = 64;"
COPY = '''  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(bar), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];"
      :: "r"(smem_addr(Es)), "l"(src), "r"(bytes), "r"(bar) : "memory");
'''
NO_COPY = '''  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" :: "r"(bar)
               : "memory");
'''
APPLY = "  for (int p = p0; p < p1; ++p) {\n"
MGS = "        if (warp == 0)\n          block_mgs<K2>(VW, VW,"


def once(src, text):
    if src.count(text) != 1:
        sys.exit(f"exp_mgs_iterate.py: {text!r} is not in the source once")
    return text


def sub(old, new):
    return lambda src: src.replace(once(src, old), new)


CUT_COPY = sub(COPY, NO_COPY)
CUT_APPLY = sub(APPLY, APPLY.replace("p < p1", "p < p0"))
CUT_MGS = sub(MGS, MGS.replace("(warp == 0)", "(false)"))
WHOLE = {"block form everywhere": [sub(WARP_MAX, WARP_MAX.replace("64",
                                                                  "0"))]}
CUT = {"copy only": [CUT_APPLY, CUT_MGS],
       "applies only": [CUT_COPY, CUT_MGS],
       "MGS only": [CUT_COPY, CUT_APPLY],
       "no copy": [CUT_COPY]}


def ptxas_lines(log):
    """nvcc -Xptxas=-v's lines of each entry: its name, spills and
    registers."""
    return [ln.strip() for ln in log.splitlines()
            if any(w in ln for w in ("entry function", "spill",
                                     "registers"))]


def build(tmp, name, src):
    """→ (the loaded library, ptxas lines) of CUDA source text `src`."""
    from doa_tpu_torch.ops import cpx_ops

    cu = os.path.join(tmp, name.replace(" ", "_").replace("/", "_") + ".cu")
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


def scenes(dev):
    """→ {name: (E, K, rounds, init)} at the paths' shapes."""
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
        cfg = cs.c5_variant(fusion="cssm")
        R = wb.cssm_covariance(torch.complex(*unembed_planes(E_sub)),
                               torch.from_numpy(wb.focusing_matrices(cfg))
                               .to(dev))
        out["c5 cssm R_coh"] = (embed_planes(R.real.contiguous(),
                                             R.imag.contiguous()), 2, 8, None)
        del R
        x = cs.make_scene(torch, cs.T_MAIN, 16, dev)
        E = ce.cov_embedded(x, torch.ones(16, device=dev),
                            torch.zeros(16, device=dev), N=16,
                            snapshot_size=1024)
        del x
        init = cpx_ops.mgs_iterate_plain(E.mean(0, keepdim=True), 2, 8)[0]
        out["headline"] = (E, 2, 3, init.expand(E.shape[0], -1, -1))
        x3 = cs.make_ula_capture(torch, cs.T_C3, 16, cs.c3_sources(),
                                 cs.SNR_DB, dev, seed=3)
        R = compute_covariances(x3[..., 0], x3[..., 1],
                                PRESETS["c3_ula16_calib_smooth"],
                                (torch.ones(16, device=dev),
                                 torch.zeros(16, device=dev)))
        del x3
        out["c3"] = (embed_planes(*R), 3, 8, None)
    return out


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
    args = ap.parse_args()
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
    sources = {}
    for name, patches in {**WHOLE, **CUT}.items():
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
        if name not in CUT:
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
    res, errs = {}, {}
    for tag, (E, K, rounds, init) in scenes(dev).items():
        B, n2 = E.shape[0], E.shape[-1]
        block = cpx_ops.mgs_form(n2, 2 * K) == "block"
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
        for name, fn in whole.items():
            fns[name] = lambda fn=fn: fn(E, K, rounds, init)

        def product():
            with fp32_matmuls():
                return torch.matmul(Vt, E)
        fns["torch.matmul(Vt, E) FP32, product only"] = product
        if block:
            Vi = Vt.contiguous()
            for name in CUT:
                lib = built[name][0]
                fns[name] = (lambda lib=lib:
                             run(lib, E, K, rounds, init))
            fns["one apply (applies only, 2 rounds from an init)"] = (
                lambda: run(built["applies only"][0], E, K, 2, Vi))
        with fp32_matmuls():
            for name, t in zip(fns, cs.turns_ms(torch, *fns.values())):
                res[f"{tag}: {name}"] = t
        bnd = cs.mgs_bound(E, 2 * K, rounds, cold=init is None)
        res[f"{tag}: bound ({bnd['bound_by']})"] = bnd["bound_ms"]
        del want, Vt, fns
    for n, t in res.items():
        print(f"{n}: {t:.4f} ms  [{card}]")
    print(json.dumps({"card": card, "ms": res, "max_err": errs}))


if __name__ == "__main__":
    main()
