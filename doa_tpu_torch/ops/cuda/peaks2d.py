"""2-D peak extraction over az/el pseudospectra (csrc/peaks2d.cu).

Port of doa_tpu/ops/pallas/peaks2d.py::find_local_max_2d_pallas. The
kernel reproduces ops/peaks.py::find_local_max_2d bit for bit (peak rule,
first-index ties, padding, no-peak fallback and the separable
reciprocal-space refine) on a positive pseudospectrum, for k ≤ 4.
"""

from __future__ import annotations

import ctypes

import torch

from doa_tpu_torch import _build
from doa_tpu_torch.ops.peaks import find_local_max_2d

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIG = {"doa_peaks2d": [_P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _F, _F, _I,
                        _P]}
MAX_PEAKS2D_K = 4


def peaks2d(P: torch.Tensor, k: int, az_rng, el_rng, refine: bool = False):
    """The 2-D peaks kernel: P f32[B, Ga, Ge] → (values, az, el) each
    f32[B, k], k ≤ MAX_PEAKS2D_K, Ga, Ge ≥ 2.

    A CPU tensor takes the plain version (find_local_max_2d); a CUDA
    tensor launches the kernel and raises if that fails."""
    if P.dim() != 3 or P.dtype != torch.float32:
        raise ValueError(f"need P f32[B, Ga, Ge], got {tuple(P.shape)} "
                         f"{P.dtype}")
    B, Ga, Ge = P.shape
    if not 1 <= k <= MAX_PEAKS2D_K or Ga < 2 or Ge < 2:
        raise ValueError(f"peaks2d takes 1 ≤ k ≤ {MAX_PEAKS2D_K} and a grid "
                         f"of at least 2 x 2 (k={k}, grid {Ga} x {Ge})")
    if P.device.type == "cpu":
        return find_local_max_2d(P, k, az_rng, el_rng, refine)
    if not P.is_cuda:
        raise ValueError(f"unsupported device {P.device}")
    P = P.contiguous()
    outs = [torch.empty((B, k), dtype=torch.float32, device=P.device)
            for _ in range(3)]
    daz = (az_rng[1] - az_rng[0]) / (Ga - 1)
    de = (el_rng[1] - el_rng[0]) / (Ge - 1)
    lib = _build.load("peaks2d", _SIG)
    err = lib.doa_peaks2d(
        P.data_ptr(), *(o.data_ptr() for o in outs), B, Ga, Ge, k,
        az_rng[0], daz, el_rng[0], de, int(refine),
        torch.cuda.current_stream(P.device).cuda_stream)
    _build.check(err, "doa_peaks2d")
    peaks2d.launches += 1
    return tuple(outs)


peaks2d.launches = 0
