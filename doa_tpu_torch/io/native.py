"""Host-side native ingest: the C++ framer and the int8 ingest quantizer.

The framer (``csrc/framer.cpp``, the port's copy of doa_tpu's
``native/framer.cpp``) is a shared library with a plain C interface,
loaded with ctypes: the complex64 split and merge (``split_c64``,
``merge_c64``), the overlap-aware block framing (``frame_block``), and
the GIL-free UDP receive loop and batched sender that
``io.socket_source`` drives. It is built with ``g++ -O3 -shared -fPIC``
at first use into ``doa_tpu_torch/_build/``, named by the hash of its
source and flags, as ``_build.py`` names the CUDA builds: an edited source
rebuilds, an unchanged one is loaded as it is. The flags carry no
``-march=native``, so the object runs on any x86-64 or AArch64 host that
built the same source.

Two departures from doa_tpu.io.native:

* a failed build raises (RuntimeError with g++'s output); doa_tpu's
  returns None and its callers fall back to numpy;
* so nothing here or in ``io.socket_source`` falls back:
  ``NativeUdpSource`` raises where doa_tpu's takes the Python receive
  loop, and ``send_capture_udp(native=True)`` raises where doa_tpu's
  sends from Python.

``quantize_interleaved_int8`` is the int8 ingest quantizer
(``cov_dtype="int8"``) on torch tensors.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading

import numpy as np
import torch

_HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_HERE, "csrc", "framer.cpp")
BUILD_DIR = os.path.join(_HERE, "_build")
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")
_LIB = None
_LIB_LOCK = threading.Lock()
_DEFAULT_THREADS = min(8, os.cpu_count() or 1)


def _build_and_load(src: str) -> ctypes.CDLL:
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(CXX_FLAGS).encode())
    so = os.path.join(BUILD_DIR,
                      f"libdoaframer_{digest.hexdigest()[:16]}.so")
    if not os.path.exists(so):
        os.makedirs(BUILD_DIR, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            proc = subprocess.run(
                ["g++", *CXX_FLAGS, "-o", tmp, src, "-lpthread"],
                capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"g++ failed on {src} (rc {proc.returncode}):\n"
                    f"{proc.stdout}\n{proc.stderr}")
            os.replace(tmp, so)     # atomic: concurrent builds agree
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    lib = ctypes.CDLL(so)
    fp = ctypes.POINTER(ctypes.c_float)
    lib.doa_split_c64.argtypes = [fp, fp, fp, ctypes.c_int64, ctypes.c_int]
    lib.doa_merge_c64.argtypes = [fp, fp, fp, ctypes.c_int64, ctypes.c_int]
    lib.doa_frame_block.argtypes = [fp, ctypes.c_int64, fp, ctypes.c_int64,
                                    ctypes.c_int64, fp, fp, ctypes.c_int]
    lib.doa_frame_block.restype = ctypes.c_int64
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.doa_udp_drain.argtypes = [ctypes.c_int, u8p, ctypes.c_int64,
                                  ctypes.c_int64, ctypes.c_int, i64p]
    lib.doa_udp_drain.restype = ctypes.c_int64
    lib.doa_udp_send.argtypes = [ctypes.c_int, u8p, ctypes.c_int64,
                                 ctypes.c_int64, ctypes.c_int64,
                                 ctypes.c_int64]
    lib.doa_udp_send.restype = ctypes.c_int64
    return lib


def get_lib() -> ctypes.CDLL:
    """The loaded framer library, built from ``_SRC`` at first use; a
    failed build raises (and the next call tries again)."""
    global _LIB
    if _LIB is None:
        with _LIB_LOCK:
            if _LIB is None:
                _LIB = _build_and_load(_SRC)
    return _LIB


def _fp(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def split_c64(x: np.ndarray, threads: int = 0):
    """x: complex64 array (any shape) → (re, im) f32 arrays, one native
    pass."""
    x = np.ascontiguousarray(x, dtype=np.complex64)
    lib = get_lib()
    re = np.empty(x.shape, np.float32)
    im = np.empty(x.shape, np.float32)
    lib.doa_split_c64(
        _fp(x.view(np.float32)), _fp(re), _fp(im), x.size,
        threads or _DEFAULT_THREADS)
    return re, im


def merge_c64(re: np.ndarray, im: np.ndarray, threads: int = 0):
    """(re, im) f32 planes → interleaved complex64 array."""
    re = np.ascontiguousarray(re, dtype=np.float32)
    im = np.ascontiguousarray(im, dtype=np.float32)
    lib = get_lib()
    out = np.empty(re.shape, np.complex64)
    lib.doa_merge_c64(_fp(re), _fp(im), _fp(out.view(np.float32)), re.size,
                      threads or _DEFAULT_THREADS)
    return out


def frame_block(tail: np.ndarray | None, block: np.ndarray,
                threads: int = 0):
    """Assemble [tail; block] (both (t, N) complex64) directly into split
    planes (overlap + T, N) f32 each."""
    block = np.ascontiguousarray(block, dtype=np.complex64)
    T, N = block.shape
    overlap = 0 if tail is None else tail.shape[0]
    lib = get_lib()
    re = np.empty((overlap + T, N), np.float32)
    im = np.empty((overlap + T, N), np.float32)
    tail_c = (np.ascontiguousarray(tail, np.complex64) if overlap
              else np.empty((0, N), np.complex64))
    lib.doa_frame_block(
        _fp(tail_c.view(np.float32)), overlap,
        _fp(block.view(np.float32)), T, N,
        _fp(re), _fp(im), threads or _DEFAULT_THREADS)
    return re, im


def quantize_interleaved_int8(xil: torch.Tensor, clip_sigma: float = 6.0):
    """Interleaved float sample rows → (int8 rows, scale) for the int8
    ingest mode (cov_dtype="int8").

    q = round(clip(x, ±A)·127/A), A = clip_sigma·RMS — a symmetric
    mid-tread quantizer, as an int8 ADC driven at `clip_sigma` sigmas of
    headroom. The scale (127/A, a 0-d tensor) is informational: the
    quantized covariance is scale²·R and every consumer downstream is
    scale-invariant. Runs on the tensor's device."""
    x = xil.to(torch.float32)
    rms = torch.sqrt(torch.mean(x * x))
    A = clip_sigma * rms.clamp_min(1e-30)
    s = 127.0 / A
    q = torch.round(x * s).clamp(-127, 127).to(torch.int8)
    return q, s
