#!/usr/bin/env python3
"""Time the MUSIC spectrum kernel K3 (doa_tpu_torch/csrc/music_scan.cu) at
the headline's and c5 cssm's shapes on one NVIDIA GPU, beside its plain
version, another music_scan.cu and one FP32 product of the same operands.

    python3 exp_music_scan.py [--against OTHER/music_scan.cu ...]

The package's K3 is loaded as the pipelines load it; each `--against`
source (this C ABI, or the earlier CUDA-core kernel's: Vt, Aᵀ, nrm, P,
B, 2K, 2N, G, e.g. an earlier commit's file from `git show`) is built by
nvcc into a temporary directory. Every kernel is first held bit-equal to
the plain version on exact inputs (quarter-step V, integer A, an odd G
and a ragged B) at (2K, 2N) = (4, 32), (6, 24), (4, 128), (2, 200), then
within 1e-5·max‖a‖² of the plain version's den on the two scenes: the
headline (B = 16384, 2K = 4, 2N = 32, G = 1024; chip_smoke's planted
scene, its warm-start subspaces) and c5 cssm (B = 2048, 2K = 4,
2N = 128, G = 16471; chip_smoke's c5 scene through kernel 4, R_coh and
the cold subspace). Each time is the mean of two medians of 10 calls
(CUDA events), everything in turns: plain, the package, each
`--against`, and `torch.matmul(Vt, Ãᵀ)` in FP32 (TF32 off: the product
alone, not the same function). The package's parts (the V' layout copy,
the kernel on a prepared V') alone, and the two bounds of §6 of PERF.md.
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
_P, _I = ctypes.c_void_p, ctypes.c_int
OLD_SIG = {"doa_music_scan": [_P, _P, _P, _P, _I, _I, _I, _I, _P]}
EXACT = ((4, 32), (6, 24), (4, 128), (2, 200))


def build(tmp, path):
    """→ (the loaded library, whether it has the earlier ABI, ptxas
    lines)."""
    from doa_tpu_torch.ops.cuda import music_scan as ms

    src = _build.expanded_source(path)
    cu = os.path.join(tmp, f"music_scan_{len(os.listdir(tmp))}.cu")
    with open(cu, "w") as f:
        f.write(src)
    so = cu[:-3] + ".so"
    proc = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", so,
                           cu], capture_output=True, text=True)
    if proc.returncode != 0:
        sys.exit(f"{path}: nvcc failed\n{proc.stdout}{proc.stderr}")
    old = "SCAN_GT" in src
    lib = ctypes.CDLL(so)
    # K3's entry only: another source need not have the package's others
    sig = OLD_SIG if old else {"doa_music_scan": ms._SIG["doa_music_scan"]}
    for fn, argtypes in sig.items():
        getattr(lib, fn).argtypes = argtypes
    return lib, old, ptxas_lines(proc.stdout + proc.stderr)


def ptxas_lines(log):
    """nvcc -Xptxas=-v's lines of each entry: its name, spills and
    registers."""
    return [ln.strip() for ln in log.splitlines()
            if any(w in ln for w in ("entry function", "spill",
                                     "registers"))]


def scan_with(lib, old, Vt, At, nrm, tiles=None):
    """K3 of `lib` → P f32[B, G], called as the package's wrapper calls
    its own (either ABI; `tiles`: scan_tiles(At, 2K), made if None)."""
    from doa_tpu_torch.ops.cuda import music_scan as ms

    B, K2, n2 = Vt.shape
    G = At.shape[0]
    P = torch.empty((B, G), device=Vt.device)
    stream = torch.cuda.current_stream().cuda_stream
    if old:
        AtT = At.T.contiguous()
        _build.check(lib.doa_music_scan(
            Vt.contiguous().data_ptr(), AtT.data_ptr(), nrm.data_ptr(),
            P.data_ptr(), B, K2, n2, G, stream), "doa_music_scan")
        return P
    GB, KP = 2 * ms.fusion_bins(K2), ms.fusion_kp(n2)
    if tiles is None:
        tiles = ms.scan_tiles(At, K2)
    Vf = ms.subspace_fragments(Vt[None])
    sms = torch.cuda.get_device_properties(Vt.device).multi_processor_count
    _, per = ms.window_groups(-(-G // GB), -(-B // 32), sms)
    _build.check(lib.doa_music_scan(
        Vf.data_ptr(), tiles.data_ptr(), nrm.data_ptr(), P.data_ptr(), B,
        K2, GB // 2, KP, G, per, stream), "doa_music_scan")
    return P


def scenes(dev):
    """→ {name: (Vt, Ã, nrm)} at the headline's and c5 cssm's shapes."""
    import chip_smoke as cs
    from doa_tpu_torch.cpx import fp32_matmuls, unembed_planes
    from doa_tpu_torch.ops import cpx_ops
    from doa_tpu_torch.ops import wideband as wb
    from doa_tpu_torch.ops.cuda import cov_embedded as ce
    from doa_tpu_torch.ops.cuda import wideband_cov as wc
    from doa_tpu_torch.pipeline_torch import build_pipeline_torch

    out = {}
    with fp32_matmuls():
        cfg = cs.headline_config()
        x = cs.make_scene(torch, cs.T_MAIN, 16, dev)
        E = ce.cov_embedded(x, torch.ones(16, device=dev),
                            torch.zeros(16, device=dev), N=16,
                            snapshot_size=1024)
        Vt = cpx_ops.signal_subspace_from_E_T(E, 2, iters=8)
        At = torch.cat(build_pipeline_torch(cfg, device=dev)
                       .steering_planes, -1).contiguous()
        out["headline"] = (Vt, At, (At * At).sum(-1))
        del x, E
        cfg = cs.c5_variant(fusion="cssm")
        x = cs.make_c5_scene(torch, cs.T_C5, dev, seed=5)
        E_sub = wc.wideband_cov_embedded(
            x, torch.ones(64, device=dev), torch.zeros(64, device=dev),
            N=64, F=16, snapshot_size=1024)
        R = wb.cssm_covariance(torch.complex(*unembed_planes(E_sub)),
                               torch.from_numpy(wb.focusing_matrices(cfg))
                               .to(dev))
        del x, E_sub
        V = cpx_ops.signal_subspace_embedded(
            R.real.contiguous(), R.imag.contiguous(), 2, iters=8)
        At = torch.cat(build_pipeline_torch(cfg, device=dev)
                       .steering_planes, -1).contiguous()
        out["c5 cssm"] = (V.transpose(-1, -2).contiguous(), At,
                          (At * At).sum(-1))
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--against", action="append", default=[],
                    help="another music_scan.cu (repeatable)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("exp_music_scan.py needs an NVIDIA GPU")
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from doa_tpu_torch.cpx import fp32_matmuls
    from doa_tpu_torch.ops import cpx_ops
    from doa_tpu_torch.ops.cuda import cov_embedded as ce
    from doa_tpu_torch.ops.cuda import music_scan as ms
    from doa_tpu_torch.ops.cuda import wideband_cov as wc

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    card = cs.card_line()
    dev = torch.device("cuda", 0)
    for name, sig in (("cov_gram", ce._SIG), ("subspace", cpx_ops._SIG),
                      ("wideband_cov", wc._SIG)):
        _build.load(name, sig)
    pkg = _build.load("music_scan", ms._SIG)
    for ln in ptxas_lines(_build.build_log.get("music_scan", "")):
        print(f"ptxas package: {ln}")
    gen = torch.Generator(device=dev).manual_seed(3)

    def ri(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=gen,
                             device=dev).float()

    res, errs = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        libs = {"package": (pkg, False)}
        for path in args.against:
            lib, old, ptx = build(tmp, path)
            libs[f"against {path}"] = (lib, old)
            for ln in ptx:
                print(f"ptxas against {path}: {ln}")
        for name, (lib, old) in libs.items():
            for k2, n2 in EXACT:
                Vq = ri(-2, 3, (1000, k2, n2)) / 4
                Aq = ri(-3, 4, (1001, n2))
                nq = 300000.0 + ri(0, 64, (1001,))
                d = (scan_with(lib, old, Vq, Aq, nq)
                     - ms.music_scan_plain(Vq, Aq, nq)).abs().max().item()
                print(f"{name}: exact inputs (2K, 2N) = ({k2}, {n2}) "
                      f"max|kernel - plain| = {d!r} (must be 0)")
                if d != 0.0:
                    sys.exit(f"{name}: exact inputs differ")
        for tag, (Vt, At, nrm) in scenes(dev).items():
            B, K2, n2 = Vt.shape
            G = At.shape[0]
            den_p = 1.0 / ms.music_scan_plain(Vt, At, nrm)
            tol = 1e-5 * nrm.max().item()
            tiles = ms.scan_tiles(At, K2)
            for name, (lib, old) in libs.items():
                e = (1.0 / scan_with(lib, old, Vt, At, nrm, tiles) - den_p
                     ).abs().max().item()
                errs[f"{tag}: {name}"] = e
                print(f"{tag} (B={B}, 2K={K2}, 2N={n2}, G={G}): {name} "
                      f"max|den - den plain| = {e!r} (tol {tol!r})")
                if e > tol:
                    sys.exit(f"{name} disagrees with plain at {tag}")
            fns = {"plain": lambda: ms.music_scan_plain(Vt, At, nrm)}
            fns["package"] = lambda: ms.music_scan(Vt, At, nrm, tiles)
            for name, (lib, old) in list(libs.items())[1:]:
                fns[name] = (lambda lib=lib, old=old:
                             scan_with(lib, old, Vt, At, nrm, tiles))

            def product():
                with fp32_matmuls():
                    return torch.matmul(Vt, At.T)
            fns["torch.matmul(Vt, At.T) FP32, product only"] = product
            for name, t in zip(fns, cs.turns_ms(torch, *fns.values())):
                res[f"{tag}: {name}"] = t
            Vf = ms.subspace_fragments(Vt[None])
            GB, KP = 2 * ms.fusion_bins(K2), ms.fusion_kp(n2)
            sms = torch.cuda.get_device_properties(dev).multi_processor_count
            groups, per = ms.window_groups(-(-G // GB), -(-B // 32), sms)
            P = torch.empty((B, G), device=dev)

            def kernel_alone():
                _build.check(pkg.doa_music_scan(
                    Vf.data_ptr(), tiles.data_ptr(), nrm.data_ptr(),
                    P.data_ptr(), B, K2, GB // 2, KP, G, per,
                    torch.cuda.current_stream().cuda_stream), "K3")
            res[f"{tag}: package: V' layout copy"] = cs.time_ms(
                torch, lambda: ms.subspace_fragments(Vt[None]))
            res[f"{tag}: package: kernel alone ({groups} window groups "
                f"of {per} tiles)"] = cs.time_ms(torch, kernel_alone)
            prod = 2 * B * K2 * n2 * G
            res[f"{tag}: bound at the FP32 rate"] = (
                cs.bound(cs.nbytes(Vt, At, nrm, P),
                         cs.scan_flops(B, G, K2, n2))["bound_ms"])
            res[f"{tag}: bound, 3 products at the TF32 rate"] = max(
                3 * prod / cs.H100_TF32_PER_S,
                cs.nbytes(Vt, At, nrm, P) / cs.H100_BYTES_PER_S) * 1e3
            del Vt, At, nrm, tiles, Vf, P, den_p
    for n, t in res.items():
        print(f"{n}: {t:.4f} ms  [{card}]")
    print(json.dumps({"card": card, "ms": res, "max_abs_den_err": errs}))


if __name__ == "__main__":
    main()
