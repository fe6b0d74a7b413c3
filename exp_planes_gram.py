#!/usr/bin/env python3
"""Time kernels 8 and 12 (doa_tpu_torch/csrc/covariance.cu) by parts and
against another covariance.cu, on one NVIDIA GPU.

    python3 exp_planes_gram.py [--against OTHER/covariance.cu ...]

Each variant is a copy of the source (with csrc/gram_ring.cuh, the ring
mainloop kernel 8 shares with K1, expanded in place) with a few lines
patched, built by nvcc into a temporary directory and loaded with ctypes;
each whole build's ptxas lines (registers, spills) are printed a kernel
each. Variants: the package; for kernel 8's ring form "no FMAs" (the
mainloop's multiply-adds cut: the copies, the walk and the chunk-end work
remain), "no epilogue stores" (the fold's (Rr, Ri) stores cut) and
"copies only" (the FMAs and the whole chunk-end reduction and epilogue
cut); for kernel 12's chunk-sum form "no window adds", "no chunk Grams",
"no fold stores" and "loads only" (all three cut). Each patch exits if its anchor text is not in the source
exactly once. Each `--against` adds another covariance.cu with the
staged entries' C ABI (doa_planes_chunk_grams, doa_planes_cov_windows:
an earlier commit's, say) as a whole variant; it runs its staged kernel 8
and its per-window kernel 12.

The whole variants are first held exact against the plain versions on
integer inputs (kernel 8 at N = 16 and 15, chunks of 128, f32 and bf16,
stride-2 views and separate planes; kernel 12 at N = 16, S = 1024,
overlap 1000 and S = 256, overlap 200); the cut ones compute wrong
results by design and are only timed. Shapes: kernel 8 at c3's (T =
2^24, N = 16, g = 1024) on the stride-2 views of the capture (f32, bf16)
and on separate planes (f32); kernel 12 at T = 2^20, N = 16, S = 1024,
overlap 1000 (43649 windows), beside the plain versions and one complex
torch.matmul. Each time is the mean of two medians of 10 launches (CUDA
events), the variants in turns.
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
FMAS = "for (int it = 0; it < cnt; ++it, pa += stride, pb += stride) {"
REDUCTION = ("          __syncthreads();\n          if (active) {\n"
             "            // this tile's entries",
             "          ++c;\n          coff = 0;")
EPI_STORES = ("      oc_r[p] = __fadd_rn(tl, br);\n"
              "      oc_i[p] = __fsub_rn(bl, tr);\n")
WIN_ADDS = "      for (int w = 0; w < W; ++w) {\n        acc[w][0] += G.x;"
CHUNK_GRAMS = "for (int r = 0; r < g; ++r, zr += n2) {"
FOLD_STORES = ("      rr_out[o] = __fadd_rn(tl, br);\n"
               "      ri_out[o] = __fsub_rn(bl, tr);\n")
CODE = {"float32": 0, "bfloat16": 1}


def once(src, text):
    if src.count(text) != 1:
        sys.exit(f"exp_planes_gram.py: {text!r} is not in covariance.cu "
                 f"(with gram_ring.cuh) once")
    return src.index(text)


def cut(text, new=""):
    def patch(src):
        once(src, text)
        return src.replace(text, new)
    return patch


def no_reduction(src):
    a, b = once(src, REDUCTION[0]), once(src, REDUCTION[1])
    return src[:a] + src[b:]


def chain(*patches):
    def patch(src):
        for p in patches:
            src = p(src)
        return src
    return patch


no_fmas = cut(FMAS, FMAS.replace("it < cnt", "it < 0"))
no_adds = cut(WIN_ADDS, WIN_ADDS.replace("w < W", "w < 0"))
no_grams = cut(CHUNK_GRAMS, CHUNK_GRAMS.replace("r < g", "r < 0"))
no_fold = cut(FOLD_STORES)
VARIANTS = {            # name: (patch, whole)
    "package": (lambda src: src, True),
    "k8 no FMAs": (no_fmas, False),
    "k8 no epilogue stores": (cut(EPI_STORES), False),
    "k8 copies only": (chain(no_fmas, no_reduction), False),
    "k12 no window adds": (no_adds, False),
    "k12 no chunk Grams": (no_grams, False),
    "k12 no fold stores": (no_fold, False),
    "k12 loads only": (chain(no_adds, no_grams, no_fold), False),
}


def build(tmp, name, src):
    from exp_cov_gram import ptxas_summary
    from doa_tpu_torch.ops.cuda import covariance as cv

    cu = os.path.join(tmp, f"covariance_{abs(hash(name))}.cu")
    with open(cu, "w") as f:
        f.write(src)
    so = cu[:-3] + ".so"
    proc = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", so,
                           cu], capture_output=True, text=True)
    if proc.returncode != 0:
        sys.exit(f"{name}: nvcc failed\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(so)
    for fn, argtypes in cv._SIG.items():
        if hasattr(lib, fn):
            getattr(lib, fn).argtypes = argtypes
    lib.ptxas = ptxas_summary(proc.stdout + proc.stderr)
    lib.ring = hasattr(lib, "doa_planes_chunk_grams_ring")
    return lib


def k8(lib, xr, xi, g, dtype):
    """Kernel 8 through `lib`: the ring form where it has one (the form
    chunk_form names for the planes' layout), else its staged kernel."""
    from doa_tpu_torch.ops.cuda import covariance as cv

    N = xr.shape[1]
    n = xr.shape[0] // g
    rr = torch.empty((n, N, N), device=xr.device)
    ri = torch.empty_like(rr)
    s = torch.cuda.current_stream().cuda_stream
    xr, xi, rs, es, load, layout = cv._kernel_args(xr, xi, N)
    form = cv.chunk_form(N, layout)
    if lib.ring and form != "staged":
        err = lib.doa_planes_chunk_grams_ring(
            xr.data_ptr(), xi.data_ptr(), int(form == "ring_planar"),
            rr.data_ptr(), ri.data_ptr(), n, g, N, CODE[dtype], s)
    else:
        err = lib.doa_planes_chunk_grams(
            xr.data_ptr(), xi.data_ptr(), rs, es, load, rr.data_ptr(),
            ri.data_ptr(), n, g, N, CODE[dtype], s)
    _build.check(err, "kernel 8")
    return rr, ri


def k12(lib, xr, xi, S, ov):
    """Kernel 12 through `lib`: the chunk-sum form where it has one and
    windows_form names it, else its per-window kernel."""
    from doa_tpu_torch.ops.cuda import covariance as cv

    N = xr.shape[1]
    hop, g, B = cv._framing(xr.shape[0], S, ov)
    xr, xi, rs, es, load, _ = cv._kernel_args(xr, xi, N)
    rr = torch.empty((B, N, N), device=xr.device)
    ri = torch.empty_like(rr)
    s = torch.cuda.current_stream().cuda_stream
    if lib.ring and cv.windows_form(N, S, ov) == "chunk_sums":
        err = lib.doa_planes_window_sums(
            xr.data_ptr(), xi.data_ptr(), rs, es, load, rr.data_ptr(),
            ri.data_ptr(), B, S, hop, g, N, s)
    else:
        err = lib.doa_planes_cov_windows(
            xr.data_ptr(), xi.data_ptr(), rs, es, load, rr.data_ptr(),
            ri.data_ptr(), B, S, hop, N, s)
    _build.check(err, "kernel 12")
    return rr, ri


def dmax(a, b):
    return max((p - q).abs().max().item() for p, q in zip(a, b))


def exact(name, lib, dev):
    """Sys-exit unless `lib`'s kernels 8 and 12 equal the plain versions
    on integer inputs."""
    from doa_tpu_torch.ops.cuda import covariance as cv

    gen = torch.Generator(device=dev).manual_seed(5)
    for N in (16, 15):
        T = 63 * 128 + 17
        buf = torch.randint(-20, 21, (T, N, 2), generator=gen,
                            device=dev).float()
        for xr, xi in ((buf[..., 0], buf[..., 1]),
                       (buf[..., 0].contiguous(), buf[..., 1].contiguous())):
            for dt in CODE:
                d = dmax(k8(lib, xr, xi, 128, dt),
                         cv.chunk_grams_plain(xr, xi, 128, dt))
                if d != 0.0:
                    sys.exit(f"{name}: kernel 8 N={N} {dt} differs by {d!r}")
    for S, ov, T in ((1024, 1000, 1 << 16), (256, 200, 1 << 14)):
        x = torch.randint(-20, 21, (T, 16, 2), generator=gen,
                          device=dev).float()
        d = dmax(k12(lib, x[..., 0], x[..., 1], S, ov),
                 cv.cov_windows_plain(x[..., 0], x[..., 1], S, ov))
        if d != 0.0:
            sys.exit(f"{name}: kernel 12 S={S} overlap={ov} differs by "
                     f"{d!r}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--against", action="append", default=[],
                    help="another covariance.cu, the staged entries' C ABI "
                         "(repeatable)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("exp_planes_gram.py needs an NVIDIA GPU")
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from doa_tpu_torch.cpx import fp32_matmuls
    from doa_tpu_torch.ops.cuda import covariance as cv

    card = cs.card_line()
    dev = torch.device("cuda", 0)
    src = _build.expanded_source(os.path.join(_build.CSRC, "covariance.cu"))
    srcs = {n: (patch(src), whole) for n, (patch, whole) in VARIANTS.items()}
    for path in args.against:
        srcs[f"against {path}"] = (_build.expanded_source(path), True)
    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        with ThreadPoolExecutor(len(srcs)) as pool:    # nvcc in parallel
            libs = dict(zip(srcs, pool.map(
                lambda n: build(tmp, n, srcs[n][0]), srcs)))
        for n, lib in libs.items():
            if srcs[n][1]:
                for line in lib.ptxas:
                    print(f"ptxas {n}: {line}")
                exact(n, lib, dev)
                print(f"{n}: exact on integer inputs")
        x3 = cs.make_ula_capture(torch, 1 << 24, 16, cs.c3_sources(),
                                 cs.SNR_DB, dev, seed=3)
        xr, xi = x3[..., 0], x3[..., 1]
        xp = (xr.contiguous(), xi.contiguous())
        T3 = xr.shape[0]
        k8_libs = {n: lib for n, lib in libs.items()
                   if not n.startswith("k12")}
        for tag, planes, dt in (("k8 stride-2 f32", (xr, xi), "float32"),
                                ("k8 planar f32", xp, "float32"),
                                ("k8 stride-2 bf16", (xr, xi), "bfloat16")):
            fns = {n: (lambda lib=lib: k8(lib, *planes, 1024, dt))
                   for n, lib in k8_libs.items()}
            fns["plain"] = lambda: cv.chunk_grams_plain(xr, xi, 1024, dt)
            res[tag] = dict(zip(fns, cs.turns_ms(torch, *fns.values())))
            res[tag]["bound"] = cs.bound(
                2 * T3 * 16 * 4 + 2 * (T3 // 1024) * 256 * 4,
                4 * T3 * 256)["bound_ms"]
        xc = torch.view_as_complex(x3).view(-1, 1024, 16)
        with fp32_matmuls():
            res["k8 stride-2 f32"]["torch.matmul (complex)"] = cs.time_ms(
                torch, lambda: torch.matmul(xc.mT, xc.conj()))
        del xc, xp
        S, ov, T12 = 1024, 1000, 1 << 20
        xr, xi = x3[:T12, :, 0], x3[:T12, :, 1]
        k12_libs = {n: lib for n, lib in libs.items()
                    if not n.startswith("k8")}
        fns = {n: (lambda lib=lib: k12(lib, xr, xi, S, ov))
               for n, lib in k12_libs.items()}
        fns["plain"] = lambda: cv.cov_windows_plain(xr, xi, S, ov)
        res["k12 S=1024 overlap=1000"] = dict(
            zip(fns, cs.turns_ms(torch, *fns.values())))
        xw = torch.view_as_complex(x3[:T12]).unfold(0, S, S - ov)
        with fp32_matmuls():
            res["k12 S=1024 overlap=1000"]["torch.matmul (complex)"] = (
                cs.time_ms(torch, lambda: torch.matmul(xw, xw.mT.conj())))
        B12 = (T12 - S) // (S - ov) + 1
        res["k12 S=1024 overlap=1000"]["bound"] = cs.bound(
            T12 * 32 * 4 + B12 * 2 * 256 * 4,
            4 * T12 * 256 + (T12 // 8 + B12) * 256)["bound_ms"]
    for tag, row in res.items():
        print(f"{tag}: " + ", ".join(f"{n} {t:.4f} ms" for n, t in
                                     row.items()) + f"  [{card}]")
    print(json.dumps({"card": card, "ms": res}))


if __name__ == "__main__":
    main()
