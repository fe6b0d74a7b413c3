#!/usr/bin/env python3
"""Time the wideband front-end ring kernel (doa_tpu_torch/csrc/
wideband_cov.cu: kernel 4, the F-point DFT channelizer and each chunk's
embedded subband Grams from the frames; kernel 7, the same Grams from the
channelized stream; kernel 10, the stream's real interleaved-basis Grams)
by parts, and with parts of it cut out, on one NVIDIA GPU.

    python3 exp_wideband_cov.py [--against OTHER/wideband_cov.cu ...]
                                [--against OTHER/subband_gram.cu ...]
                                [--whole]

Each variant is a copy of a source with a few lines patched, built by nvcc
into a temporary directory (all builds at once) and loaded with ctypes.
Every source (the package's and each `--against`: an earlier commit's
wideband_cov.cu, whose kernel 4 entry has this C ABI, or subband_gram.cu,
whose kernel 7 entry does) is timed whole through each entry it has, and
cut where its form is known:

* the block-per-(chunk, subband) form (the kernel before the ring):
  "no Gram" keeps the DFT and the stage and drops the accumulation;
  "no DFT" keeps the F loads of each sample and drops the twiddles, the
  modulo and the complex products (y = the sum of the F samples); "one
  subband read" takes subband f's samples as x[m, f, c], so each block
  reads 1/F of the chunk; "no E stores" keeps the epilogue's inputs live
  behind a store that no run takes.
* the ring form (persistent blocks, a bulk-copy ring, subband groups):
  "no Gram", "no DFT" (y = the sum of the F ring samples), "no E stores"
  (the class sums stay, the tile stores go) as above; "evict-first
  stores" stores E's 16-byte vectors evict-first (st.global.cs); "no DFT, no Gram" leaves the copies, the walk and the
  epilogue; "copies only" leaves the copies and the walk; "stores only"
  the walk and the epilogue, with no copies; "copies only, 1/G of each
  stage" has group q's block copy part q of each stage, so each chunk
  leaves L2 once. The ring's shape (STAGES x STAGE_BYTES), the threads
  and items a thread (MAXT, J) and the tile order (BAND) other than the
  source's are variants too.

The ring form's cuts act on both of its sources (the y-buffer's DFT or
copy, then the same Gram, epilogue and ring); kernel 7 (the stream) is
timed whole and by "no Gram", "no E stores", "copies only" and "stores
only". The torch lines are yardsticks of the memory system: E written
alone (zero_), and the input read once with twice its bytes written
(cat). Kernel 10 (the C entry doa_subband_gram: the ring kernel's third
source, or an earlier subband_gram.cu's block-per-(chunk, subband)
kernel) is held to its plain version on the exact streams and to
1e-5 max|U| on the c5 scene channelized at F = 16, then timed whole in
turns with each whole source's kernels 4 and 7 at that shape and one
batched torch.matmul. For every `--against` wideband_cov.cu the SASS of
kernels 4 and 7 (each doa_fft_gram_ring<RT, Src::Frames> and
<RT, Src::Stream> instantiation, from cuobjdump -sass, addresses cut) is
compared with the package's, function by function.

Whole variants are first held bit-equal to the float64 plain version on
exact inputs (frames: F <= 4, integer samples and correction; streams:
any F, integer values; the chip_smoke.py cases, views one complex element
in among them) and to 1e-5 max|E| on the c5 scene (frames) and the
c5_f12 scene channelized (streams); cut variants compute wrong Grams by
design and are only timed. Shapes: c5 (M = 131072 frames of F = 16
subbands of N = 64 elements, g = 64, the chip_smoke.py c5 scene), the
ULA-16 cssm front end (N = 16, F = 16, g = 64, M = 65536, normal
samples) and c5_f12 (M = 131072 frames of F = 12, g = 64: kernel 7 on
the channelized stream; the frames launch against the channelizer matmul
followed by each source's kernel 7). Each time is the mean of two medians
of 10 calls (CUDA events), the variants and the plain version in turns.
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

# the block-per-(chunk, subband) form
BLOCK_FORM = "const int f = blockIdx.x % F;"
B_GRAM = "    if (active) {\n      for (int m = rg; m < rows; m += groups) {"
B_DFT = """      for (int t = 0; t < F; ++t) {
        const int k = (f * t) % F;        // W[f, t] = tw[k]
        const float wr = __ldg(tw + 2 * k), wi = __ldg(tw + 2 * k + 1);
        const float2 v = xm[(size_t)t * N];
        yr += wr * v.x - wi * v.y;
        yi += wr * v.y + wi * v.x;
      }
"""
B_SUM = """      for (int t = 0; t < F; ++t) {
        const float2 v = xm[(size_t)t * N];
        yr += v.x;
        yi += v.y;
      }
"""
B_ONE = """      {
        const float2 v = xm[(size_t)f * N];
        yr = v.x;
        yi = v.y;
      }
"""
B_STORES = ("    oc[i * n2 + j] = er;\n", "    oc[(N + i) * n2 + N + j] = er;\n")

# the ring form
RING_FORM = "        store_tiles(cc);\n"
BANDS = "constexpr int BAND = "
R_GRAM = "      gram_rows(yb, first, pos + seg);\n"
R_DFT = "      dft_point(src, N, tws, yv);\n"   # any indent
R_SUM = """      {
        float2 z = make_float2(0.f, 0.f);
        for (int t = 0; t < F; ++t) {
          z.x += src[t * N].x;
          z.y += src[t * N].y;
        }
        for (int s = 0; s < 4; ++s) yv[s] = z;
      }
"""
R_TILE = "        store_tile<RT>(oc, N, "
R_STWB = "    __stwb(reinterpret_cast<float4*>(p), "
R_BYTES = "    const uint32_t bytes = (uint32_t)(b - a);\n"
# 1/G of the stage's aligned middle, part q of G, for group q's block
R_PART = ("    const uint32_t bytes = (uint32_t)((b - a) / G) & ~15u;\n"
          "    const uintptr_t a_ = a + q * bytes;\n")
R_DST = "          :: \"r\"(smem_addr(dst + (a - s0))),\n"
R_SRC = "             \"l\"(reinterpret_cast<const void*>(a)), "


def once(src, text):
    if src.count(text) != 1:
        sys.exit(f"exp_wideband_cov.py: {text!r} is not in the source once")
    return text


def sub(old, new):
    return lambda src: src.replace(once(src, old), new)


def skip(line):
    """The line (one statement) behind a condition no run meets."""
    return sub(line, line.replace(line.lstrip(), "if (g < 0) " + line.lstrip(),
                                  1))


def consts(**values):
    """Set `constexpr int NAME = value;` for each NAME (once in the
    source)."""
    def patch(src):
        for name, val in values.items():
            pat = rf"constexpr int {name} = \d+;"
            if len(re.findall(pat, src)) != 1:
                sys.exit(f"exp_wideband_cov.py: {pat!r} is not in the source "
                         f"once")
            src = re.sub(pat, f"constexpr int {name} = {val};", src)
        return src
    return patch


def part_copies(src):
    src = sub(R_BYTES, R_PART)(src)
    src = sub(R_DST, R_DST.replace("(a - s0)", "(a_ - s0)"))(src)
    return sub(R_SRC, R_SRC.replace("(a)", "(a_)"))(src)


def b_no_stores(src):
    a = src.index(once(src, B_STORES[0]))
    b = src.index(once(src, B_STORES[1])) + len(B_STORES[1])
    return src[:a] + "    if (g < 0) {\n" + src[a:b] + "    }\n" + src[b:]


def chain(*patches):
    def patch(src):
        for p in patches:
            src = p(src)
        return src
    return patch


COPIES_ONLY = chain(sub(R_DFT, R_SUM), skip(R_GRAM), skip(R_TILE))
CUTS = {
    BLOCK_FORM: {
        "no Gram": sub(B_GRAM, B_GRAM.replace("(active)", "(active && g < 0)")),
        "no DFT": sub(B_DFT, B_SUM),
        "one subband read": sub(B_DFT, B_ONE),
        "no E stores": b_no_stores,
    },
    RING_FORM: {
        "no Gram": skip(R_GRAM),
        "no DFT": sub(R_DFT, R_SUM),
        "no E stores": skip(R_TILE),
        "evict-first stores": sub(R_STWB, R_STWB.replace("__stwb", "__stcs")),
        "no DFT, no Gram": chain(sub(R_DFT, R_SUM), skip(R_GRAM)),
        "copies only": COPIES_ONLY,
        "stores only": chain(sub(R_BYTES, "    const uint32_t bytes = 0;\n"),
                             sub(R_DFT, R_SUM), skip(R_GRAM)),
        "copies only, 1/G of each stage": chain(COPIES_ONLY, part_copies),
        "3 x 32 KiB": consts(STAGES=3, STAGE_BYTES=32768),
        "2 x 32 KiB": consts(STAGES=2, STAGE_BYTES=32768),
        "3 x 24 KiB": consts(STAGES=3, STAGE_BYTES=24576),
        "4 x 16 KiB": consts(STAGES=4, STAGE_BYTES=16384),
        "2 items a thread, 288 threads": consts(MAXT=288, J=2),
        "3 items a thread, 192 threads": consts(MAXT=192, J=3),
    },
    BANDS: {f"bands of {h} tile rows": consts(BAND=h) for h in (1, 2, 4, 8)},
}


# the ring form's cuts that kernel 7's stream source is timed by
STREAM_CUTS = ("no Gram", "no E stores", "copies only", "stores only")


def variants(tag, src):
    """→ {name: (source, whole)}: the source whole, then its cuts (but a
    ring shape it already has); a subband_gram.cu (kernels 10 and the
    first kernel 7) whole only."""
    out = {tag: (src, True)}
    if "doa_wideband_fft_gram" not in src:
        return out
    for marker, cuts in CUTS.items():
        if marker in src:
            for n, p in cuts.items():
                cut = p(src)
                if cut != src:          # a ring shape the source has
                    out[f"{tag}: {n}"] = (cut, False)
    return out


def build(tmp, i, name, src):
    from doa_tpu_torch.ops.cuda import wideband_cov as wc

    cu = os.path.join(tmp, f"wideband_cov_{i}.cu")
    with open(cu, "w") as f:
        f.write(src)
    so = cu[:-3] + ".so"
    proc = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", so,
                           cu], capture_output=True, text=True)
    if proc.returncode != 0:
        sys.exit(f"{name}: nvcc failed\n{proc.stdout}{proc.stderr}")
    regs = [ln.strip() for ln in (proc.stdout + proc.stderr).splitlines()
            if "registers" in ln or "spill" in ln or "entry function" in ln]
    lib = ctypes.CDLL(so)
    for fn, argtypes in wc._SIG.items():
        if hasattr(lib, fn):
            getattr(lib, fn).argtypes = argtypes
    return lib, regs, so


# a kernel instantiation's mangled name without its anonymous namespace
# (which names the file and a hash of it)
ANON = re.compile(r"^_ZN\d+_GLOBAL__N__[0-9a-f]+_\d+_\w+?_cu_[0-9a-f]{8}")


def sass(so):
    """{kernel instantiation: its SASS lines, addresses cut} of a built
    library (cuobjdump -sass)."""
    tool = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    text = subprocess.run([tool, "-sass", so], capture_output=True,
                          text=True, check=True).stdout
    funcs, name = {}, None
    for ln in text.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            name = ANON.sub("", m.group(1))
            funcs[name] = []
        elif name is not None and "/*" in ln:
            funcs[name].append(re.sub(r"/\*[0-9a-f]{4}\*/", "", ln).strip())
    return funcs


def ring_sass_diff(pkg_so, other_so):
    """→ (kernel 4 and 7 instantiations compared, those whose SASS
    differs): doa_fft_gram_ring<RT, Src::Frames> and <RT, Src::Stream>."""
    a, b = sass(pkg_so), sass(other_so)
    keys = sorted(k for k in a if "doa_fft_gram_ring" in k
                  and re.search(r"SrcE[01]E", k))
    return keys, [k for k in keys if a[k] != b.get(k)]


def subband_gram(lib, y, F, N, g, out=None):
    """Kernel 10's U f32[F, n, 2N, 2N] of the stream y through `lib`'s
    doa_subband_gram."""
    n = y.shape[0] // g
    if out is None:
        out = torch.empty((F, n, 2 * N, 2 * N), device=y.device)
    _build.check(lib.doa_subband_gram(
        y.data_ptr(), out.data_ptr(), F, N, g, n,
        torch.cuda.current_stream().cuda_stream), "doa_subband_gram")
    return out


def grams(lib, xf, cr, ci, F, N, g, scale, out=None):
    """E f32[F, n, 2N, 2N] through `lib`, as the package's wrapper calls
    it (any row offset of xf; `out` reused where given)."""
    from doa_tpu_torch.ops.cuda import wideband_cov as wc

    n = xf.shape[0] // g
    if out is None:
        out = torch.empty((F, n, 2 * N, 2 * N), device=xf.device)
    tw = wc.twiddles_on(F, xf.device)
    _build.check(lib.doa_wideband_fft_gram(
        xf.data_ptr(), tw.data_ptr(), cr.data_ptr(), ci.data_ptr(),
        out.data_ptr(), F, N, g, n, scale,
        torch.cuda.current_stream().cuda_stream), "doa_wideband_fft_gram")
    return out


def stream_grams(lib, y, cr, ci, F, N, g, scale, out=None):
    """Kernel 7's E f32[F, n, 2N, 2N] of the channelized stream y through
    `lib`, as the package's wrapper calls it."""
    n = y.shape[0] // g
    if out is None:
        out = torch.empty((F, n, 2 * N, 2 * N), device=y.device)
    _build.check(lib.doa_subband_embedded(
        y.data_ptr(), cr.data_ptr(), ci.data_ptr(), out.data_ptr(), F, N, g,
        n, scale, torch.cuda.current_stream().cuda_stream),
        "doa_subband_embedded")
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--against", action="append", default=[],
                    help="another wideband_cov.cu or subband_gram.cu, "
                         "same C ABI (repeatable)")
    ap.add_argument("--whole", action="store_true",
                    help="build and time the whole sources only (no cuts)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("exp_wideband_cov.py needs an NVIDIA GPU")
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from doa_tpu_torch.ops.cuda import wideband_cov as wc

    card = cs.card_line()
    dev = torch.device("cuda", 0)
    with open(os.path.join(_build.CSRC, "wideband_cov.cu")) as f:
        srcs = variants("package", f.read())
    for path in args.against:
        with open(path) as f:
            srcs.update(variants(f"against {path}", f.read()))
    if args.whole:
        srcs = {n: v for n, v in srcs.items() if v[1]}
    with tempfile.TemporaryDirectory() as tmp, \
            ThreadPoolExecutor(len(srcs)) as pool:
        built = dict(zip(srcs, pool.map(
            lambda a: build(tmp, a[0], a[1][0], a[1][1][0]),
            enumerate(srcs.items()))))
        libs = {n: lib for n, (lib, _, _) in built.items()}
        for n, (_, regs, _) in built.items():
            if srcs[n][1]:
                for ln in regs:
                    print(f"ptxas {n}: {ln}")
        for n, (lib, _, so) in built.items():
            if (srcs[n][1] and n != "package"
                    and hasattr(lib, "doa_wideband_fft_gram")):
                keys, diff = ring_sass_diff(built["package"][2], so)
                print(f"SASS of kernels 4 and 7 against {n}: {len(keys)} "
                      f"instantiations compared, {len(diff)} differ"
                      + (f": {diff}" if diff else " (word for word)"))
        gen = torch.Generator(device=dev).manual_seed(3)

        def ri(lo, hi, shape):
            return torch.randint(lo, hi, shape, generator=gen,
                                 device=dev).float()

        frames = {n: lib for n, lib in libs.items()
                  if hasattr(lib, "doa_wideband_fft_gram")}
        streams = {n: lib for n, lib in libs.items()
                   if hasattr(lib, "doa_subband_embedded")}
        whole = {n for n in libs if srcs[n][1]}
        for name in whole:
            for Fx, Nx, gx, n, off in (cs.FFT_GRAM_EXACT if name in frames
                                       else ()):
                buf = ri(-4, 5, (n * gx * Fx * 2 * Nx + 2,))
                xf = buf[off:off + n * gx * Fx * 2 * Nx].view(
                    n * gx, Fx * 2 * Nx)
                cr, ci = ri(-1, 3, (Nx,)), ri(-1, 2, (Nx,))
                kw = dict(F=Fx, N=Nx, g=gx, scale=1.0 / 16)
                d = (grams(frames[name], xf, cr, ci, **kw)
                     - wc.subband_chunk_grams_plain(xf.double(), cr, ci,
                                                    **kw)
                     ).abs().max().item()
                if d != 0.0:
                    sys.exit(f"{name}: exact frames F={Fx} N={Nx} g={gx} "
                             f"n={n} offset {off} differ by {d!r}")
            for Fx, Nx, gx, n, off in (cs.SUBBAND_EXACT if name in streams
                                       else ()):
                buf = ri(-4, 5, (n * gx * Fx * 2 * Nx + 2,))
                y = buf[off:off + n * gx * Fx * 2 * Nx].view(
                    n * gx, Fx * 2 * Nx)
                cr, ci = ri(-1, 3, (Nx,)), ri(-1, 2, (Nx,))
                kw = dict(F=Fx, N=Nx, g=gx, scale=1.0 / 16)
                d = (stream_grams(streams[name], y, cr, ci, **kw)
                     - wc.subband_embedded_plain(y.double(), cr, ci, **kw)
                     ).abs().max().item()
                if d != 0.0:
                    sys.exit(f"{name}: exact stream F={Fx} N={Nx} g={gx} "
                             f"n={n} offset {off} differ by {d!r}")
            for Fx, Nx, gx, n, off in (cs.SUBBAND_EXACT if hasattr(
                    libs[name], "doa_subband_gram") else ()):
                buf = ri(-4, 5, (n * gx * Fx * 2 * Nx + 2,))
                y = buf[off:off + n * gx * Fx * 2 * Nx].view(
                    n * gx, Fx * 2 * Nx)
                d = (subband_gram(libs[name], y, Fx, Nx, gx)
                     - wc.subband_grams_plain(y.double(), F=Fx, N=Nx, g=gx)
                     ).abs().max().item()
                if d != 0.0:
                    sys.exit(f"{name}: kernel 10 exact F={Fx} N={Nx} g={gx} "
                             f"n={n} offset {off} differs by {d!r}")
        print("exact cases: every whole source bit-equal to the float64 "
              "plain version")

        def held(tag, fn, Ep, names):
            tol = 1e-5 * Ep.abs().max().item()
            for name in names:
                e = (fn(name) - Ep).abs().max().item()
                print(f"{tag} {name}: max|kernel - plain| = {e!r} (tol "
                      f"{tol!r})")
                if e > tol:
                    sys.exit(f"{name}: disagrees with plain at {tag}")

        x = cs.make_c5_scene(torch, cs.T_C5, dev)
        res = {}
        # kernel 10 at c5 (F = 16, N = 64, g = 64) on the scene channelized,
        # in turns with each whole source's kernels 4 (the frames) and 7
        # (the stream) at the same shape
        F, N, g = 16, 64, 64
        xf = x.reshape(-1, F * 2 * N)
        y = wc.channelize_frames(xf, wc.channelizer_on(F, N, dev))
        Up = wc.subband_grams_plain(y, F=F, N=N, g=g)
        out = torch.empty_like(Up)
        k10 = sorted(n for n in whole if hasattr(libs[n], "doa_subband_gram"))
        held("c5 kernel 10", lambda n: subband_gram(libs[n], y, F, N, g,
                                                    out=out), Up, k10)
        del Up
        cr, ci = torch.ones(N, device=dev), torch.zeros(N, device=dev)
        kw = dict(F=F, N=N, g=g, scale=1.0 / 16)
        fns = {f"kernel 10 of {n}": (lambda lib=libs[n]: subband_gram(
            lib, y, F, N, g, out=out)) for n in k10}
        for n in sorted(whole & set(frames)):
            fns[f"kernel 4 of {n}"] = (lambda lib=libs[n]: grams(
                lib, xf, cr, ci, out=out, **kw))
        for n in sorted(whole & set(streams)):
            fns[f"kernel 7 of {n}"] = (lambda lib=libs[n]: stream_grams(
                lib, y, cr, ci, out=out, **kw))
        yv = y.view(-1, g, F, 2 * N).permute(2, 0, 1, 3)
        fns["torch: batched matmul (library)"] = lambda: torch.matmul(
            yv.transpose(-1, -2), yv)
        tag = "c5 kernel 10 (stream, F = 16)"
        res[tag] = dict(zip(fns, cs.turns_ms(torch, *fns.values())))
        res[tag]["bound"] = cs.bound(
            cs.nbytes(y, out), g * 2 * N * (2 * N + 1) * F * out.shape[1]
        )["bound_ms"]
        del y, yv, out, xf
        shapes = {"c5": (x.reshape(-1, 16 * 128), 16, 64, 64),
                  "ULA-16 cssm": (torch.randn((65536, 16 * 32), generator=gen,
                                              device=dev), 16, 16, 64)}
        for tag, (xf, F, N, g) in shapes.items():
            cr, ci = torch.ones(N, device=dev), torch.zeros(N, device=dev)
            kw = dict(F=F, N=N, g=g, scale=1.0 / 64)
            Ep = wc.subband_chunk_grams_plain(xf, cr, ci, **kw)
            out = torch.empty_like(Ep)
            held(tag, lambda n: grams(frames[n], xf, cr, ci, out=out, **kw),
                 Ep, sorted(whole & set(frames)))
            del Ep
            fns = {n: (lambda lib=lib: grams(lib, xf, cr, ci, out=out, **kw))
                   for n, lib in frames.items()}
            fns["plain"] = lambda: wc.subband_chunk_grams_plain(xf, cr, ci,
                                                                **kw)
            # the memory system's yardsticks: E's bytes written alone, and
            # the capture read once with twice its bytes written
            fns["torch: E.zero_()"] = out.zero_
            if out.numel() >= 2 * xf.numel():
                two = out.view(-1)[:2 * xf.numel()].view(xf.shape[0], -1)
                fns["torch: cat((x, x), 1) into E"] = (
                    lambda: torch.cat((xf, xf), 1, out=two))
            res[tag] = dict(zip(fns, cs.turns_ms(torch, *fns.values())))
            M = xf.shape[0]
            res[tag]["bound"] = cs.fft_gram_bound(M, F, N, g)["bound_ms"]
            del out
        del x, shapes, xf

        # c5_f12: kernel 7 on the channelized stream, whole and by parts,
        # against each other source's kernel 7; then the frames launch
        # against the channelizer followed by each source's kernel 7
        F, N, g = 12, 64, 64
        xf = cs.make_c5_scene(torch, cs.T_F12, dev, seed=4).reshape(
            -1, F * 2 * N)
        K = wc.channelizer_on(F, N, dev)
        y = wc.channelize_frames(xf, K)
        cr, ci = torch.ones(N, device=dev), torch.zeros(N, device=dev)
        kw = dict(F=F, N=N, g=g, scale=1.0 / 64)
        Ep = wc.subband_embedded_plain(y, cr, ci, **kw)
        out = torch.empty_like(Ep)
        held("c5_f12 stream", lambda n: stream_grams(streams[n], y, cr, ci,
                                                     out=out, **kw),
             Ep, sorted(whole & set(streams)))
        del Ep
        timed = {n: lib for n, lib in streams.items() if n in whole or any(
            n.endswith(": " + c) for c in STREAM_CUTS)}
        fns = {n: (lambda lib=lib: stream_grams(lib, y, cr, ci, out=out,
                                                **kw))
               for n, lib in timed.items()}
        fns["plain"] = lambda: wc.subband_embedded_plain(y, cr, ci, **kw)
        fns["torch: E.zero_()"] = out.zero_
        two = out.view(-1)[:2 * y.numel()].view(y.shape[0], -1)
        fns["torch: cat((y, y), 1) into E"] = (
            lambda: torch.cat((y, y), 1, out=two))
        tag = "c5_f12 kernel 7 (stream)"
        res[tag] = dict(zip(fns, cs.turns_ms(torch, *fns.values())))
        res[tag]["bound"] = cs.bound(
            cs.nbytes(y, out), 4 * (g + 1) * N * N * F * out.shape[1]
        )["bound_ms"]
        Ep = wc.subband_embedded_frames_plain(xf, cr, ci, **kw)
        held("c5_f12 frames", lambda n: grams(frames[n], xf, cr, ci,
                                              out=out, **kw),
             Ep, sorted(whole & set(frames)))
        del Ep, y
        fns = {f"frames: {n}": (lambda lib=lib: grams(lib, xf, cr, ci,
                                                      out=out, **kw))
               for n, lib in frames.items() if n in whole}
        for n, lib in streams.items():
            if n in whole:
                fns[f"channelizer + kernel 7 of {n}"] = (
                    lambda lib=lib: stream_grams(
                        lib, wc.channelize_frames(xf, K), cr, ci, out=out,
                        **kw))
        fns["channelizer alone"] = lambda: wc.channelize_frames(xf, K)
        fns["plain (channelizer + kernel 7's plain version)"] = (
            lambda: wc.subband_embedded_frames_plain(xf, cr, ci, **kw))
        tag = "c5_f12 front-end stage (frames)"
        res[tag] = dict(zip(fns, cs.turns_ms(torch, *fns.values())))
        res[tag]["bound"] = cs.fft_gram_bound(xf.shape[0], F, N, g)[
            "bound_ms"]
        del out, xf
    for tag, row in res.items():
        for n, t in row.items():
            print(f"{tag} {n}: {t:.4f} ms  [{card}]")
    print(json.dumps({"card": card, "ms": res}))


if __name__ == "__main__":
    main()
