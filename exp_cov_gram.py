#!/usr/bin/env python3
"""Time K1 and kernel 9 (doa_tpu_torch/csrc/cov_gram.cu) in other ring
shapes and with parts of the kernel cut out, beside one torch.bmm, on one
NVIDIA GPU.

    python3 exp_cov_gram.py [--against OTHER/cov_gram.cu ...]

Each variant is a copy of the source (with csrc/gram_ring.cuh, the ring
mainloop it shares with kernel 8, expanded in place) with a few lines
patched, built by nvcc into a temporary directory and loaded with ctypes,
and each whole variant's ptxas lines (registers, spills) are printed a
kernel each, and for each `--against` source how many of its kernels
compile to the package's SASS word for word: the ring's STAGES
and STAGE_BYTES; "no FMAs" skips the mainloop's multiply-adds (the
copies, the walk and the chunk-end work remain); "no chunk-end
reduction" cuts the class sums, their barriers and the entry stores
where the classes share a chunk (large g); "no whole-chunk stores" drops
the tile stores where each class takes whole chunks (small g). Each
`--against` adds another cov_gram.cu with the same C ABI (an earlier
commit's, say) as a whole variant. The whole variants are first held
exact against the plain version on integer inputs (2N = 6, 32, 64;
chunks of 7 and 1024 rows; f32, bf16, int8; a view at row 1); the cut
variants compute wrong Grams by design and are only timed. Shapes: the
headline capture (T = 2^24, 2N = 32) at g = 1024 in f32, bf16 and int8,
at g = 512 and g = 8 in f32, and kernel 9 (correction + FB) in f32. Each
time is the mean of two medians of 10 launches (CUDA events), the
variants in turns.
"""

import argparse
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

import torch

from doa_tpu_torch import _build

HERE = os.path.dirname(os.path.abspath(__file__))
RING = ("constexpr int STAGES = 3;", "constexpr int STAGE_BYTES = 32768;")
FMAS = "for (int it = 0; it < cnt; ++it, pa += stride, pb += stride) {"
REDUCTION = ("          __syncthreads();\n          if (active) {\n"
             "            // this tile's entries",
             "          ++c;\n          coff = 0;")
TILE_STORES = "          epi.tile(cc, i0, j0, acc);\n"
CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def once(src, text):
    if src.count(text) != 1:
        sys.exit(f"exp_cov_gram.py: {text!r} is not in cov_gram.cu once")
    return src.index(text)


def ptxas_summary(log):
    """nvcc -Xptxas=-v output → one line a kernel: its (demangled) name,
    registers and spill bytes."""
    rows, name = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            rows.append([name, "", ""])
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and rows:
            rows[-1][2] = f"spill {m.group(1)}/{m.group(2)} bytes"
        m = re.search(r"Used (\d+) registers", line)
        if m and rows:
            rows[-1][1] = f"{m.group(1)} registers"
    filt = shutil.which("cu++filt") or shutil.which("c++filt")
    nvcc_dir = os.path.dirname(_build.nvcc_path())
    if os.path.exists(os.path.join(nvcc_dir, "cu++filt")):
        filt = os.path.join(nvcc_dir, "cu++filt")
    names = [r[0] for r in rows]
    if filt and names:
        out = subprocess.run([filt], input="\n".join(names),
                             capture_output=True, text=True).stdout
        names = out.splitlines() if out.count("\n") >= len(names) - 1 \
            else names
    return [f"{n}: {r[1]}, {r[2]}" for n, r in zip(names, rows)]


# the translation unit's tag nvcc puts in the names of an anonymous
# namespace (it differs between two files of the same code)
_ANON = re.compile(r"\d+_GLOBAL__N__[0-9a-f]+_\d+_\w+?_cu_[0-9a-f]{8}")


def sass(so):
    """{kernel name, the TU tag cut: its SASS, addresses and encodings
    included} of a built library (cuobjdump -sass)."""
    tool = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    out = subprocess.run([tool, "-sass", so], capture_output=True,
                         text=True).stdout
    funcs, name = {}, None
    for line in out.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = _ANON.sub("ANON", m.group(1))
            funcs[name] = []
        elif name and line.strip().startswith("/*"):
            funcs[name].append(line.strip())
    return {k: "\n".join(v) for k, v in funcs.items()}


def same_sass(a, b):
    """→ (kernels of `a` whose SASS `b` has word for word, kernels of a)."""
    return sum(b.get(k) == v for k, v in a.items()), len(a)


def ring(stages, stage_bytes):
    def patch(src):
        once(src, RING[0]), once(src, RING[1])
        return (src.replace(RING[0], f"constexpr int STAGES = {stages};")
                .replace(RING[1],
                         f"constexpr int STAGE_BYTES = {stage_bytes};"))
    return patch


def no_fmas(src):
    once(src, FMAS)
    return src.replace(FMAS, FMAS.replace("it < cnt", "it < 0"))


def no_reduction(src):
    a, b = once(src, REDUCTION[0]), once(src, REDUCTION[1])
    return src[:a] + src[b:]


def no_tile_stores(src):
    once(src, TILE_STORES)
    return src.replace(TILE_STORES, "")


VARIANTS = {            # name: (patch, whole)
    "package (3 x 32 KiB)": (lambda src: src, True),
    "4 x 16 KiB": (ring(4, 16384), True),
    "no FMAs": (no_fmas, False),
    "no chunk-end reduction": (no_reduction, False),
    "no whole-chunk stores": (no_tile_stores, False),
}


def build(tmp, name, src):
    from doa_tpu_torch.ops.cuda import cov_embedded as ce

    cu = os.path.join(tmp, f"cov_gram_{abs(hash(name))}.cu")
    with open(cu, "w") as f:
        f.write(src)
    so = cu[:-3] + ".so"
    proc = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", so,
                           cu], capture_output=True, text=True)
    if proc.returncode != 0:
        sys.exit(f"{name}: nvcc failed\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(so)
    lib.ptxas = ptxas_summary(proc.stdout + proc.stderr)
    lib.sass = sass(so)
    for fn, argtypes in ce._SIG.items():
        getattr(lib, fn).argtypes = argtypes
    return lib


def gram(lib, x, g):
    n, n2 = x.shape[0] // g, x.shape[1]
    out = torch.empty((n, n2, n2), device=x.device)
    err = lib.doa_chunk_gram(x.data_ptr(), out.data_ptr(), n, g, n2,
                             CODE[x.dtype], torch.cuda.current_stream()
                             .cuda_stream)
    _build.check(err, "doa_chunk_gram")
    return out


def embedded(lib, x, g, W):
    n, n2 = x.shape[0] // g, x.shape[1]
    out = torch.empty((n, n2, n2), device=x.device)
    err = lib.doa_chunk_embedded(
        x.data_ptr(), W[0].data_ptr(), W[1].data_ptr(), out.data_ptr(), n,
        g, n2, CODE[x.dtype], 1, 1.0 / g,
        torch.cuda.current_stream().cuda_stream)
    _build.check(err, "doa_chunk_embedded")
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--against", action="append", default=[],
                    help="another cov_gram.cu, same C ABI (repeatable)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("exp_cov_gram.py needs an NVIDIA GPU")
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from doa_tpu_torch.cpx import fp32_matmuls
    from doa_tpu_torch.io.native import quantize_interleaved_int8
    from doa_tpu_torch.ops.cuda import cov_embedded as ce

    card = cs.card_line()
    dev = torch.device("cuda", 0)
    src = _build.expanded_source(os.path.join(_build.CSRC, "cov_gram.cu"))
    srcs = {n: (patch(src), whole) for n, (patch, whole) in VARIANTS.items()}
    for path in args.against:
        srcs[f"against {path}"] = (_build.expanded_source(path), True)
    with tempfile.TemporaryDirectory() as tmp:
        with ThreadPoolExecutor(len(srcs)) as pool:    # nvcc in parallel
            libs = dict(zip(srcs, pool.map(
                lambda n: build(tmp, n, srcs[n][0]), srcs)))
        for n, lib in libs.items():
            if srcs[n][1]:
                for line in lib.ptxas:
                    print(f"ptxas {n}: {line}")
        for path in args.against:
            same, of = same_sass(libs[f"against {path}"].sass,
                                 libs["package (3 x 32 KiB)"].sass)
            print(f"SASS: {same} of the {of} kernels of {path} are the "
                  f"package's word for word")
        gen = torch.Generator(device=dev).manual_seed(5)
        for name, lib in libs.items():
            if not srcs[name][1]:
                continue
            for n2 in (6, 32, 64):
                for g in (7, 1024):
                    xi = torch.randint(-20, 21, (40 * g + 1, n2),
                                       generator=gen, device=dev)
                    for dt in CODE:
                        for _, xv in cs.gram_views(xi.to(dt), n2, g, 40)[:2]:
                            d = (gram(lib, xv, g)
                                 - ce.chunk_grams_uhat_plain(xv, g)
                                 ).abs().max().item()
                            if d != 0.0:
                                sys.exit(f"{name}: 2N={n2} g={g} {dt} "
                                         f"differs by {d!r}")
        x = cs.make_scene(torch, cs.T_MAIN, 16, dev)
        W = ce.correction_pattern(torch.ones(16, device=dev),
                                  torch.zeros(16, device=dev))
        cases = {"f32": (x, 1024), "bf16": (x.to(torch.bfloat16), 1024),
                 "int8": (quantize_interleaved_int8(x)[0], 1024),
                 "f32 g=512": (x, 512), "f32 g=8": (x, 8)}
        res = {}
        for tag, (xk, g) in cases.items():
            xv = x.view(-1, g, 32)
            fns = {n: (lambda lib=lib: gram(lib, xk, g))
                   for n, lib in libs.items()}
            fns["torch.bmm (f32)"] = lambda: torch.bmm(xv.transpose(1, 2),
                                                       xv)
            with fp32_matmuls():
                res[tag] = dict(zip(fns, cs.turns_ms(torch, *fns.values())))
            T, n2 = xk.shape
            res[tag]["bound"] = cs.bound(
                cs.nbytes(xk) + (T // g) * n2 * n2 * 4, T * n2 * (n2 + 1),
                cs.H100_INT8_PER_S if xk.dtype == torch.int8
                else cs.H100_FP32_PER_S)["bound_ms"]
        fns = {n: (lambda lib=lib: embedded(lib, x, 1024, W))
               for n, lib in libs.items()}
        res["kernel 9 f32"] = dict(zip(fns, cs.turns_ms(torch,
                                                        *fns.values())))
    for tag, row in res.items():
        print(f"{tag}: " + ", ".join(f"{n} {t:.4f} ms" for n, t in
                                     row.items()) + f"  [{card}]")
    print(json.dumps({"card": card, "ms": res}))


if __name__ == "__main__":
    main()
