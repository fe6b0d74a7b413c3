#!/usr/bin/env python3
"""Time the wideband fusion kernel (doa_tpu_torch/csrc/wideband_scan.cu)
by parts, and with parts of it cut out, at c5's shape on one NVIDIA GPU.

    python3 exp_wideband_scan.py [--against OTHER/wideband_scan.cu ...]

Each variant is a copy of the source with a few lines patched, built by
nvcc into a temporary directory and loaded with ctypes, alone or
together: "hi.hi only" issues only the first of the three 3xTF32
products (a third of the tensor-core work); "no den stores" keeps pass
A's epilogue but not its stores of the workspace; "no epilogue" replaces
the epilogue (den, its stores, the dmin atomics) by a sum of the
accumulators behind a store no run takes, so the products stay live;
"no V' loads" loads each window tile's fragments for its first two
k-steps only; "no split" hands the fragments to wgmma unsplit. Each
`--against` adds another wideband_scan.cu as a whole variant: one with
this ABI, or the two-pass FP32 kernel's (`doa_wideband_fusion`, an
earlier commit's). Whole variants are first
held bit-equal to the plain version on exact inputs and to 2e-4 +
2e-4 |P| on the c5 scene; cut variants compute wrong spectra by design
and are only timed. Shapes: c5 (F = 16, 2048 windows of the chip_smoke
c5 scene, 2K = 4, 2N = 128, G = 16471). Each time is the mean of two
medians of 10 calls (CUDA events), the variants in turns; the package's
parts (V' layout copy, pass A, pass B, and the one-time A' split)
alone.
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
CORRECTIONS = tuple(
    "#pragma unroll\n  for (int i = 0; i < MT; ++i) "
    f"mma<NT>(cr[i], {a}[P][i], {d});\n" for a, d in (("ah", "d_lo"),
                                                     ("al", "d_hi")))
STORE = ("        if (b_ok)\n"
         "          __stcs(reinterpret_cast<float2*>(row + g), ")
EPILOGUE = ("    // den of window b at the thread's NT/4 bins",
            "                __float_as_int(m));\n")
# the accumulators stay live (a store no run takes), so the products
# are not dead code
KEEP_LIVE = """    {
      float z = 0.f;
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int q = 0; q < NA; ++q) z += hh[i][q] + cr[i][q];
      if (G < 0) den[t] = z;
    }
"""
LOADS = "raw[P][i] = ld_policy(vp + ((s + 2) * MT + i) * 128, pol);"
SPLIT = ("ah[P][i][e] = rna_tf32(v[e]);",
         "al[P][i][e] = rna_tf32(v[e] - __uint_as_float(ah[P][i][e]));")
_P, _I = ctypes.c_void_p, ctypes.c_int
OLD_SIG = {"doa_wideband_fusion": [_P] * 5 + [_I] * 5 + [_P]}


def once(src, text):
    if src.count(text) != 1:
        sys.exit(f"exp_wideband_scan.py: {text!r} is not in "
                 f"wideband_scan.cu (with scan_tc.cuh) once")
    return text


def hh_only(src):
    for t in CORRECTIONS:
        src = src.replace(once(src, t), "")
    return src


def no_stores(src):
    return src.replace(once(src, STORE),
                       STORE.replace("b_ok", "b_ok && G < 0"))


def no_epilogue(src):
    a = src.index(once(src, EPILOGUE[0]))
    b = src.index(once(src, EPILOGUE[1])) + len(EPILOGUE[1])
    return src[:a] + KEEP_LIVE + src[b:]


def no_loads(src):
    return src.replace(once(src, LOADS), "raw[P][i] = raw[P][i];")


def no_split(src):
    for t in SPLIT:
        src = src.replace(once(src, t), t.split(" = ")[0]
                          + " = __float_as_uint(v[e]);")
    return src


def chain(*patches):
    def patch(src):
        for p in patches:
            src = p(src)
        return src
    return patch


VARIANTS = {            # name: (patch, whole)
    "package": (chain(), True),
    "no den stores": (no_stores, False),
    "no epilogue": (no_epilogue, False),
    "no V' loads": (no_loads, False),
    "hi.hi only": (hh_only, False),
    "no split": (no_split, False),
    "no V' loads, no epilogue": (chain(no_loads, no_epilogue), False),
    "hi.hi only, no V' loads, no epilogue":
        (chain(hh_only, no_loads, no_epilogue), False),
}


def build(tmp, name, src):
    from doa_tpu_torch.ops.cuda import wideband_scan as wsc

    cu = os.path.join(tmp, f"wideband_scan_{len(os.listdir(tmp))}.cu")
    with open(cu, "w") as f:
        f.write(src)
    so = cu[:-3] + ".so"
    proc = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", so,
                           cu], capture_output=True, text=True)
    if proc.returncode != 0:
        sys.exit(f"{name}: nvcc failed\n{proc.stdout}{proc.stderr}")
    if name == "package" or name.startswith("against"):
        for ln in (proc.stdout + proc.stderr).splitlines():
            if any(w in ln for w in ("entry function", "spill",
                                     "registers")):
                print(f"ptxas {name}: {ln.strip()}")
    lib = ctypes.CDLL(so)
    sig = OLD_SIG if "doa_wideband_fusion" in src else wsc._SIG
    for fn, argtypes in sig.items():
        getattr(lib, fn).argtypes = argtypes
    return lib


def fused(lib, Vt, At, nrm, parts=None):
    """P f32[B, G] through `lib` (either ABI), as the package's wrapper
    calls it; `parts` (new ABI) → the closures of its parts instead."""
    from doa_tpu_torch.ops.cuda import wideband_scan as wsc

    F, B, K2, n2 = Vt.shape
    G = At.shape[1]
    stream = torch.cuda.current_stream().cuda_stream
    dmin = torch.full((F, B), float("inf"), device=Vt.device)
    P = torch.empty((B, G), device=Vt.device)
    if hasattr(lib, "doa_wideband_fusion"):
        AtT = At.transpose(1, 2).contiguous()
        _build.check(lib.doa_wideband_fusion(
            Vt.data_ptr(), AtT.data_ptr(), nrm.data_ptr(), dmin.data_ptr(),
            P.data_ptr(), F, B, K2, n2, G, stream), "doa_wideband_fusion")
        return P
    KP, Gs = wsc.fusion_kp(n2), -(-G // 4) * 4
    Af = wsc._tiles_of(At, K2)
    Vf = wsc.subspace_fragments(Vt)
    den = torch.empty((F * B * Gs,), device=Vt.device)

    def pass_a():
        _build.check(lib.doa_fusion_den(
            Vf.data_ptr(), Af.data_ptr(), nrm.data_ptr(), den.data_ptr(),
            dmin.data_ptr(), F, B, 0, B, K2, wsc.fusion_bins(K2), KP, G, Gs,
            stream), "doa_fusion_den")

    def pass_b():
        _build.check(lib.doa_fusion_sum(
            den.data_ptr(), dmin.data_ptr(), P.data_ptr(), F, B, 0, B, G,
            Gs, stream), "doa_fusion_sum")

    if parts is not None:
        return {"V' layout copy": lambda: wsc.subspace_fragments(Vt),
                "pass A": pass_a, "pass B": pass_b,
                "A' split and layout (once a stack)":
                    lambda: wsc.steering_tiles(At, K2)}
    pass_a()
    pass_b()
    return P


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--against", action="append", default=[],
                    help="another wideband_scan.cu (repeatable)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("exp_wideband_scan.py needs an NVIDIA GPU")
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from doa_tpu_torch import PRESETS
    from doa_tpu_torch.cpx import fp32_matmuls
    from doa_tpu_torch.ops import cpx_ops
    from doa_tpu_torch.ops import wideband as wb
    from doa_tpu_torch.ops.cuda import wideband_cov as wc
    from doa_tpu_torch.ops.cuda import wideband_scan as wsc
    from doa_tpu_torch.pipeline_torch import build_pipeline_torch

    card = cs.card_line()
    dev = torch.device("cuda", 0)
    for name, sig in (("wideband_cov", wc._SIG), ("subspace", cpx_ops._SIG)):
        _build.load(name, sig)
    # the source with csrc/scan_tc.cuh expanded in place: the patches
    # reach the shared mainloop, and a copy compiles in any directory
    src = _build.expanded_source(os.path.join(_build.CSRC, "wideband_scan.cu"))
    srcs = {n: (patch(src), whole) for n, (patch, whole) in VARIANTS.items()}
    for path in args.against:
        srcs[f"against {path}"] = (_build.expanded_source(path), True)

    cfg = PRESETS["c5_ura64_wideband"]
    pipe = build_pipeline_torch(cfg, device=dev)
    x = cs.make_c5_scene(torch, cs.T_C5, dev)
    with fp32_matmuls():
        E_sub = wc.wideband_cov_embedded(
            x, torch.ones(64, device=dev), torch.zeros(64, device=dev),
            N=64, F=16, snapshot_size=1024)
        Vt = wb.subband_subspaces_from_E(E_sub, cfg)
    del x, E_sub
    At = torch.cat(pipe.subband_planes, dim=-1).contiguous()
    nrm = (At * At).sum(dim=-1)
    Pp = wsc.wideband_fused_spectrum_plain(Vt, At, nrm)
    gen = torch.Generator(device=dev).manual_seed(3)

    def ri(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=gen,
                             device=dev).float()

    with tempfile.TemporaryDirectory() as tmp:
        libs = {n: build(tmp, n, s) for n, (s, _) in srcs.items()}
        for name, lib in libs.items():
            if not srcs[name][1]:
                continue
            for K2, n2 in ((4, 20), (8, 128)):
                Vq = ri(-2, 3, (4, 100, K2, n2)) / 4
                Aq = ri(-3, 4, (4, 1000, n2))
                nq = 300000.0 + ri(0, 64, (4, 1000))
                d = (fused(lib, Vq, Aq, nq) - wsc.wideband_fused_spectrum_plain(
                    Vq, Aq, nq)).abs().max().item()
                if d != 0.0:
                    sys.exit(f"{name}: exact inputs 2K={K2} differ by {d!r}")
            P = fused(lib, Vt, At, nrm)
            if not bool(((P - Pp).abs() <= 2e-4 + 2e-4 * Pp.abs()).all()):
                sys.exit(f"{name}: disagrees with plain on the c5 scene")
        fns = {n: (lambda lib=lib: fused(lib, Vt, At, nrm))
               for n, lib in libs.items()}
        fns["plain"] = lambda: wsc.wideband_fused_spectrum_plain(Vt, At, nrm)
        res = dict(zip(fns, cs.turns_ms(torch, *fns.values())))
        parts = fused(libs["package"], Vt, At, nrm, parts=True)
        res.update({f"package: {k}": cs.time_ms(torch, f)
                    for k, f in parts.items()})
    F, B, K2, n2 = Vt.shape
    prod = 2 * F * B * At.shape[1] * K2 * n2
    res["bound (3 products at the TF32 rate)"] = (
        3 * prod / cs.H100_TF32_PER_S * 1e3)
    for n, t in res.items():
        print(f"{n}: {t:.4f} ms  [{card}]")
    print(json.dumps({"card": card, "ms": res}))


if __name__ == "__main__":
    main()
