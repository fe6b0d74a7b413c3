"""Build the package's CUDA sources with nvcc at first use and load them
with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface (pointers and the
stream as ``void*``, sizes as ``int``; every entry returns the
``cudaGetLastError()`` of its launch), so the build needs no PyTorch
headers and takes seconds. The shared object lands in ``_build/`` next to
this file, named by the hash of its source (with the ``csrc/`` headers it
includes, expanded in place) and flags: an edited source or header
rebuilds, an unchanged one is loaded as it is. A failed build raises.

`launch_counts` is the one count of kernel launches: each wrapper calls
`count(kernel, form)` once a call that launches on the card, `kernel`
the name the plan gives it (plan.KERNELS; a wrapper no plan stage names
counts under its own name) and `form` the form plan.kernel_forms names
for it, else None. `counting()` gives the launches made inside a block.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_loaded: dict[str, ctypes.CDLL] = {}
# per source name: seconds spent compiling (0.0 when a cached object was
# loaded) and nvcc's output (ptxas: registers, shared memory, spills)
build_seconds: dict[str, float] = {}
build_log: dict[str, str] = {}
# (kernel, form) → launches since the process started
launch_counts: collections.Counter = collections.Counter()


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
        return os.path.join(home, "bin", "nvcc")
    if os.path.exists("/usr/local/cuda/bin/nvcc"):
        return "/usr/local/cuda/bin/nvcc"
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): "
                       "the doa_tpu_torch CUDA kernels cannot be built")


_INCLUDE = re.compile(r'^#include "([^"]+)"[^\n]*$', re.M)


def expanded_source(path: str, _seen=None) -> str:
    """The text of the CUDA source at `path` with each ``#include "x"`` of
    a file beside it replaced by that file's text (recursively, each file
    once): what the build's hash covers, and a source that compiles in
    any directory."""
    seen = set() if _seen is None else _seen
    here = os.path.dirname(path)
    with open(path) as f:
        text = f.read()

    def sub(m):
        inc = os.path.join(here, m.group(1))
        if not os.path.exists(inc):
            return m.group(0)
        if inc in seen:
            return ""
        seen.add(inc)
        return expanded_source(inc, seen).replace("#pragma once\n", "")
    return _INCLUDE.sub(sub, text)


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """→ the loaded library built from ``csrc/<name>.cu``, with
    ``argtypes`` set from ``signatures`` (C entry name → ctypes argument
    types) and every entry returning an int error code."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    src = os.path.join(CSRC, name + ".cu")
    digest = hashlib.sha256(
        (expanded_source(src) + " ".join(NVCC_FLAGS)).encode())
    so = os.path.join(BUILD_DIR, f"lib{name}_{digest.hexdigest()[:16]}.so")
    build_seconds[name] = 0.0
    if not os.path.exists(so):
        os.makedirs(BUILD_DIR, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        t0 = time.perf_counter()
        try:
            proc = subprocess.run(
                [nvcc_path(), *NVCC_FLAGS, "-o", tmp, src],
                capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed on {src} (rc {proc.returncode}):\n"
                    f"{proc.stdout}\n{proc.stderr}")
            build_log[name] = proc.stdout + proc.stderr
            os.replace(tmp, so)     # atomic: concurrent builds agree
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
        build_seconds[name] = time.perf_counter() - t0
    lib = ctypes.CDLL(so)
    for fn, argtypes in signatures.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    _loaded[name] = lib
    return lib


def check(err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry."""
    if err != 0:
        raise RuntimeError(f"CUDA launch of {what} failed: cudaError {err}")


def count(kernel: str, form: str | None = None) -> None:
    """Count one launch of `kernel` in `form` (see the module's header)."""
    launch_counts[kernel, form] += 1


@contextlib.contextmanager
def counting():
    """Yields a Counter {(kernel, form): launches} that holds, once the
    block has ended, the launches made inside it (nested blocks each
    count their own)."""
    before = launch_counts.copy()
    inside = collections.Counter()
    try:
        yield inside
    finally:
        inside.update(launch_counts - before)
