"""2-D peak extraction over az/el pseudospectra (csrc/peaks2d.cu).

Port of doa_tpu/ops/pallas/peaks2d.py::find_local_max_2d_pallas. The
kernel reproduces ops/peaks.py::find_local_max_2d bit for bit (peak rule,
first-index ties, padding, no-peak fallback and the separable
reciprocal-space refine) on a positive pseudospectrum, for k ≤ 4.

The kernel has two forms, chosen by `peaks_form` with no fallback: "ring"
(a persistent grid whose blocks walk runs of windows through a ring of
RING_SLOTS window slots in shared memory, filled by bulk copies; the
stencil from shared memory, the lists merged by warp shuffles; every grid
whose window fits a slot, c5's 181×91 included) and "block" (the first
kernel, one window a block, for larger grids). Each launch is counted as
("peaks2d", its form) in _build.launch_counts.
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
                        _P],
        "doa_peaks2d_form": [_P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _F, _F,
                             _I, _I, _P]}
MAX_PEAKS2D_K = 4
RING_SLOTS = 3           # csrc/peaks2d.cu: windows in the ring form's ring
HEAD_BYTES = 2048        # csrc/peaks2d.cu: its barriers and lists
SMEM_LIMIT = 232448      # csrc/peaks2d.cu: shared bytes a block may use
PEAKS_FORMS = ("ring", "block")


def slot_bytes(G: int) -> int:
    """A ring slot's bytes for a window of G bins (csrc/peaks2d.cu
    `slot_bytes`): the window at its address mod 16, rounded up to 16."""
    return (4 * G + 12 + 15) & ~15


def peaks_form(Ga: int, Ge: int) -> str:
    """Kernel 6's form for a Ga × Ge grid (csrc/peaks2d.cu `ring_form`):
    "ring" where HEAD_BYTES and RING_SLOTS slots of the window fit in
    SMEM_LIMIT bytes of shared memory, else "block"."""
    fits = HEAD_BYTES + RING_SLOTS * slot_bytes(Ga * Ge) <= SMEM_LIMIT
    return "ring" if fits else "block"


def _check(P: torch.Tensor, k: int):
    if P.dim() != 3 or P.dtype != torch.float32:
        raise ValueError(f"need P f32[B, Ga, Ge], got {tuple(P.shape)} "
                         f"{P.dtype}")
    _, Ga, Ge = P.shape
    if not 1 <= k <= MAX_PEAKS2D_K or Ga < 2 or Ge < 2:
        raise ValueError(f"peaks2d takes 1 ≤ k ≤ {MAX_PEAKS2D_K} and a grid "
                         f"of at least 2 x 2 (k={k}, grid {Ga} x {Ge})")


def _launch(P: torch.Tensor, k: int, az_rng, el_rng, refine: bool,
            form: str):
    """One launch of kernel 6 in `form` ("ring" or "block", a form that
    takes P's grid) on a CUDA tensor P → (values, az, el); counted as
    ("peaks2d", form). peaks2d launches the form peaks_form
    names; chip_smoke.py and exp_peaks2d.py call this to hold and time the
    block form where the ring form runs."""
    B, Ga, Ge = P.shape
    if form not in PEAKS_FORMS or (form == "ring"
                                   and peaks_form(Ga, Ge) != "ring"):
        raise ValueError(f"peaks2d has no {form!r} form for a {Ga} x {Ge} "
                         f"grid")
    P = P.contiguous()
    outs = [torch.empty((B, k), dtype=torch.float32, device=P.device)
            for _ in range(3)]
    daz = (az_rng[1] - az_rng[0]) / (Ga - 1)
    de = (el_rng[1] - el_rng[0]) / (Ge - 1)
    lib = _build.load("peaks2d", _SIG)
    err = lib.doa_peaks2d_form(
        P.data_ptr(), *(o.data_ptr() for o in outs), B, Ga, Ge, k,
        az_rng[0], daz, el_rng[0], de, int(refine), int(form == "ring"),
        torch.cuda.current_stream(P.device).cuda_stream)
    _build.check(err, "doa_peaks2d_form")
    _build.count("peaks2d", form)
    return tuple(outs)


def peaks2d(P: torch.Tensor, k: int, az_rng, el_rng, refine: bool = False):
    """The 2-D peaks kernel: P f32[B, Ga, Ge] → (values, az, el) each
    f32[B, k], k ≤ MAX_PEAKS2D_K, Ga, Ge ≥ 2.

    A CPU tensor takes the plain version (find_local_max_2d); a CUDA
    tensor launches the kernel in the form peaks_form names and raises if
    that fails."""
    _check(P, k)
    if P.device.type == "cpu":
        return find_local_max_2d(P, k, az_rng, el_rng, refine)
    if not P.is_cuda:
        raise ValueError(f"unsupported device {P.device}")
    return _launch(P, k, az_rng, el_rng, refine, peaks_form(*P.shape[1:]))
