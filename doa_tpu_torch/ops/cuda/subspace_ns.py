"""Cold Newton–Schulz signal subspace: E(R) windows → orthonormal Vt.

Port of doa_tpu/ops/pallas/subspace.py (`subspace_packed_pallas`, the
`subspace_impl="pallas"` route of the fused path). Per window, with
E f32[2N, 2N] symmetric:

    Ep = E / max(tr(E)/2N, 1e-30), then `squarings` times
    Ep ← Ep·Ep, Ep ← ½(Ep + Epᵀ)                  (E^(2^squarings))
    Vt = the first 2K rows of Ep, then rounds = max(1, iters // 2^squarings)
    rounds of [Vt ← Vt·Ep (not in round 0); orthonormalise Vt]

where orthonormalise is the Jacobi-preconditioned Newton–Schulz chain:
G = Vt Vtᵀ, d = 1/√max(diag G, 1e-30), G̃ = G ∘ (d dᵀ), fro = ‖G̃‖_F,
Y = G̃/max(fro, 1e-30), Z = I, then n times T = 1.5·I − 0.5·Z·Y, Y ← Y·T,
Z ← T·Z (n = ns_iters in the first and last rounds, ns_iters_mid between),
and Vt ← Zᵀ·(d ∘ Vt)/√max(fro, 1e-30). The Frobenius norm is taken of the
preconditioned Gram: it bounds λmax(G̃) and keeps the chain in its basin
λ(Y) < 2.

The TPU kernel packs 128/2N windows into one block-diagonal tile and W
windows' chains into one consolidated (W·2K)² chain; block-diagonal
algebra is closed, so each window's result is this per-window chain. The
port keeps the per-window form and the layout the scan kernels read,
Vt f32[B, 2K, 2N] (no packed layout).

The kernel (csrc/subspace_ns.cu) has two forms, chosen by `ns_form` with
no fallback: "warp" (one warp a window, the 2K×2K chain in registers on
half-warps, no block barrier; 2N ≤ 64 and 2K ≤ 8: every preset's shape)
and "block" (the first form, one window a thread block; every other shape
`ns_takes` takes). `subspace_ns.by_form` counts the launches of each form
beside `subspace_ns.launches`. The plain version is the same chain as
batched FP32 torch ops. The XLA chain
of doa_tpu's `signal_subspace_from_E_T(orth="ns")` is the same but for
one step, the symmetrisation after each squaring; `ns_subspace` carries
both behind its `symmetrize` switch.
"""

from __future__ import annotations

import ctypes

import torch

from doa_tpu_torch import _build
from doa_tpu_torch.cpx import fp32_matmuls

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIG = {"doa_subspace_ns": [_P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
        "doa_subspace_ns_form": [_P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                                 _P]}
NS_MAX_N2 = 128          # csrc/subspace_ns.cu: E and its square in shared
NS_MAX_K2 = 16           # csrc/subspace_ns.cu: the 2K x 2K chain in shared
NS_WARP_MAX_N2 = 64      # csrc/subspace_ns.cu WARP_MAX_N2: the warp form's
NS_WARP_MAX_K2 = 8       #   shapes (WARP_MAX_K2)
NS_FORMS = ("warp", "block")


def ns_takes(n2: int, k2: int) -> bool:
    """The shapes kernel 11 is built for: an even 2N ≤ NS_MAX_N2 and
    2K ≤ NS_MAX_K2."""
    return n2 <= NS_MAX_N2 and n2 % 2 == 0 and k2 <= NS_MAX_K2


def ns_form(n2: int, k2: int) -> str | None:
    """Kernel 11's form for (2N, 2K) (csrc/subspace_ns.cu `warp_form`):
    "warp" for 2N ≤ NS_WARP_MAX_N2 and 2K ≤ NS_WARP_MAX_K2, "block" for
    every other shape ns_takes takes, None where it takes none."""
    if not ns_takes(n2, k2):
        return None
    return ("warp" if n2 <= NS_WARP_MAX_N2 and k2 <= NS_WARP_MAX_K2
            else "block")


def ns_rounds(iters: int, squarings: int) -> int:
    """Rounds of apply + orthonormalise: max(1, iters // 2^squarings)."""
    return max(1, iters // (1 << squarings))


def _orthonormalize(Vt: torch.Tensor, n_ns: int) -> torch.Tensor:
    """Jacobi-preconditioned Newton–Schulz on the rows of Vt f32[B, 2K, 2N]
    → rows orthonormal per window."""
    k2 = Vt.shape[-2]
    eye = torch.eye(k2, dtype=Vt.dtype, device=Vt.device)
    G = torch.matmul(Vt, Vt.transpose(-1, -2))                # (B, 2K, 2K)
    d = 1.0 / torch.sqrt(torch.diagonal(G, dim1=-2, dim2=-1).clamp_min(
        1e-30))                                               # (B, 2K)
    G = G * d[:, None, :] * d[:, :, None]
    fro = torch.sqrt((G * G).sum(dim=(-2, -1)))               # (B,)
    Y = G * (1.0 / fro.clamp_min(1e-30))[:, None, None]
    Z = eye.expand_as(Y)
    for _ in range(n_ns):
        T = 1.5 * eye - 0.5 * torch.matmul(Z, Y)
        Y = torch.matmul(Y, T)
        Z = torch.matmul(T, Z)
    return (torch.matmul(Z.transpose(-1, -2), Vt * d[:, :, None])
            * (1.0 / torch.sqrt(fro.clamp_min(1e-30)))[:, None, None])


def ns_subspace(E: torch.Tensor, num_sources: int, iters: int,
                ns_iters: int, ns_iters_mid: int, squarings: int,
                symmetrize: bool) -> torch.Tensor:
    """The Newton–Schulz subspace chain of the module docstring as FP32
    torch ops: E f32[B, 2N, 2N] → Vt f32[B, 2K, 2N]. symmetrize=True is
    kernel 11's chain (subspace_ns_plain), False doa_tpu's XLA chain
    (cpx_ops.signal_subspace_from_E_T(orth="ns"))."""
    k2 = 2 * num_sources
    n2 = E.shape[-1]
    with fp32_matmuls():
        tr = torch.diagonal(E, dim1=-2, dim2=-1).sum(-1) / n2
        Ep = E * (1.0 / tr.clamp_min(1e-30))[:, None, None]
        for _ in range(squarings):
            Ep = torch.matmul(Ep, Ep)
            if symmetrize:
                Ep = 0.5 * (Ep + Ep.transpose(-1, -2))
        rounds = ns_rounds(iters, squarings)
        # rows of Ep: Ep is symmetric (the embedding of a Hermitian R)
        Vt = _orthonormalize(Ep[:, :k2, :], ns_iters)
        for r in range(rounds - 1):
            Vt = _orthonormalize(torch.matmul(Vt, Ep),
                                 ns_iters if r == rounds - 2 else ns_iters_mid)
    return Vt


def _check(E: torch.Tensor, num_sources: int, iters: int, ns_iters: int,
           ns_iters_mid: int, squarings: int):
    if E.dim() != 3 or E.shape[1] != E.shape[2] or E.dtype != torch.float32:
        raise ValueError(f"need E f32[B, 2N, 2N], got {tuple(E.shape)} "
                         f"{E.dtype}")
    if num_sources < 1 or 2 * num_sources > E.shape[-1]:
        raise ValueError(f"need 1 ≤ num_sources ≤ N, got {num_sources} "
                         f"for 2N = {E.shape[-1]}")
    if min(iters, ns_iters, ns_iters_mid, squarings) < 0:
        raise ValueError("iters, ns_iters, ns_iters_mid and squarings must "
                         "be ≥ 0")


def subspace_ns_plain(E: torch.Tensor, num_sources: int, iters: int = 8,
                      ns_iters: int = 12, ns_iters_mid: int = 8,
                      squarings: int = 2) -> torch.Tensor:
    """Plain PyTorch version of kernel 11: E f32[B, 2N, 2N] → Vt
    f32[B, 2K, 2N], rows orthonormal per window (the module docstring's
    chain, symmetrised after each squaring as the kernel)."""
    _check(E, num_sources, iters, ns_iters, ns_iters_mid, squarings)
    return ns_subspace(E, num_sources, iters, ns_iters, ns_iters_mid,
                       squarings, symmetrize=True)


def _launch(E: torch.Tensor, num_sources: int, form: str, iters: int = 8,
            ns_iters: int = 12, ns_iters_mid: int = 8,
            squarings: int = 2) -> torch.Tensor:
    """One launch of kernel 11 in `form` ("warp" or "block", a form that
    takes E's shape) on a CUDA tensor E → Vt f32[B, 2K, 2N]; counted in
    subspace_ns.launches and .by_form. subspace_ns launches the form
    ns_form names; chip_smoke.py and exp_subspace_ns.py call this to time
    the block form where the warp form runs."""
    B, n2 = E.shape[0], E.shape[-1]
    k2 = 2 * num_sources
    if form not in NS_FORMS or (form == "warp"
                                and ns_form(n2, k2) != "warp"):
        raise ValueError(f"subspace_ns has no {form!r} form for 2N={n2}, "
                         f"2K={k2}")
    E = E.contiguous()
    if E.data_ptr() % 16:               # the kernel reads E as float4
        E = E.clone()
    out = torch.empty((B, k2, n2), dtype=torch.float32, device=E.device)
    lib = _build.load("subspace_ns", _SIG)
    err = lib.doa_subspace_ns_form(
        E.data_ptr(), out.data_ptr(), B, n2, k2,
        ns_rounds(iters, squarings), ns_iters, ns_iters_mid, squarings,
        int(form == "warp"), torch.cuda.current_stream(E.device).cuda_stream)
    _build.check(err, "doa_subspace_ns_form")
    subspace_ns.launches += 1
    subspace_ns.by_form[form] += 1
    return out


def subspace_ns(E: torch.Tensor, num_sources: int, iters: int = 8,
                ns_iters: int = 12, ns_iters_mid: int = 8,
                squarings: int = 2) -> torch.Tensor:
    """Kernel 11: the cold Newton–Schulz subspace of every window of
    E f32[B, 2N, 2N] (2N ≤ 128 even, 2K ≤ 16) in one launch
    (csrc/subspace_ns.cu) → Vt f32[B, 2K, 2N] as subspace_ns_plain.

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel in the form ns_form names and raises if that fails."""
    _check(E, num_sources, iters, ns_iters, ns_iters_mid, squarings)
    if E.device.type == "cpu":
        return subspace_ns_plain(E, num_sources, iters, ns_iters,
                                 ns_iters_mid, squarings)
    if not E.is_cuda:
        raise ValueError(f"unsupported device {E.device}")
    n2, k2 = E.shape[-1], 2 * num_sources
    if not ns_takes(n2, k2):
        raise ValueError(f"subspace_ns kernel takes an even 2N ≤ {NS_MAX_N2} "
                         f"and 2K ≤ {NS_MAX_K2} (2N={n2}, 2K={k2})")
    return _launch(E, num_sources, ns_form(n2, k2), iters, ns_iters,
                   ns_iters_mid, squarings)


subspace_ns.launches = 0
subspace_ns.by_form = dict.fromkeys(NS_FORMS, 0)
