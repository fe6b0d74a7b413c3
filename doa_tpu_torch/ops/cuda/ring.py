"""Halo exchange over the snap ring of a mesh: kernel 13
(csrc/ring.cu) and the default ppermute route.

Port of doa_tpu/ops/pallas/ring.py. A rank's plane x[T_loc, C] (a block
of the time-sharded capture) becomes x_ext[T_loc + overlap, C]: x, then
the first `overlap` rows of its right neighbour's block, so the windows
that start in the block but end past it see their samples.

* impl="xla" (the config's default, the reference's ``lax.ppermute``):
  one ppermute of the head rows over the snap group (batch_isend_irecv;
  staged through the host when ranks share a card under gloo). The last
  rank's halo is zeros.
* impl="pallas": kernel 13, the ring. Each rank copies x into its window
  and writes its head into its left neighbour's window through a CUDA IPC
  peer pointer (csrc/ring.cu says how the exchange is ordered); the last
  rank gets rank 0's head. Its plain version, the same ring through
  ppermute, runs for CPU tensors. Either way the last rank's tail windows
  are invalid (parallel.sharded.num_valid_windows), so the two impls give
  equal valid windows.

The kernel writes into the rank's window, kept on the mesh; the public
entries return a copy of it, and only the sharded pipeline reads the
window itself (_halo_exchange), before the next exchange of its shape
overwrites it. ``Mesh.close`` frees the windows.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch
import torch.distributed as dist

from doa_tpu_torch import _build
from doa_tpu_torch.parallel.collectives import ppermute
from doa_tpu_torch.parallel.mesh import SNAP_AXIS, Mesh

IMPLS = ("xla", "pallas")
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIG = {
    "doa_halo": [_P, _P, _P, _LL, _LL, _P],
    "doa_ring_window_alloc": [_LL, _I, _P, _P],
    "doa_ring_window_open": [_P, _I, _P],
    "doa_ring_window_close": [_P],
    "doa_ring_window_free": [_P],
    "doa_ring_event_create": [_I, _P, _P],
    "doa_ring_event_open": [_P, _I, _P],
    "doa_ring_event_destroy": [_P],
    "doa_ring_record": [_P, _P],
    "doa_ring_wait": [_P, _P],
    "doa_ring_can_access_peer": [_I, _I, _P],
}
_HANDLE_BYTES = 64          # cudaIpcMemHandle_t, cudaIpcEventHandle_t


class _DeviceBytes:
    """Raw device bytes as a __cuda_array_interface__ object, which
    torch.as_tensor wraps without a copy (and keeps alive)."""

    def __init__(self, ptr: int, nbytes: int):
        self.__cuda_array_interface__ = {
            "shape": (nbytes,), "typestr": "|u1", "data": (ptr, False),
            "version": 2}


@dataclasses.dataclass
class _Window:
    """One rank's symmetric window and the handles it opened."""
    out: torch.Tensor           # (T_loc + overlap, C) view of own window
    own: int                    # own window pointer (cudaMalloc)
    left: int                   # the left neighbour's window, opened
    ev_free: int                # own events (exported)
    ev_done: int
    left_free: int              # the left neighbour's free event, opened
    right_done: int             # the right neighbour's done event, opened
    halo_offset: int            # bytes from a window's start to its halo


def _call(lib, name: str, *args) -> None:
    _build.check(getattr(lib, name)(*args), name)


def _out_param():
    v = ctypes.c_void_p()
    return v, ctypes.addressof(v)


def _handle():
    buf = ctypes.create_string_buffer(_HANDLE_BYTES)
    return buf, ctypes.addressof(buf)


def _barrier(mesh: Mesh) -> None:
    """Host barrier of the snap column, bounded by the halo group's
    timeout (mesh.HALO_TIMEOUT): raises on expiry."""
    dist.barrier(group=mesh.halo_group)


def _window(mesh: Mesh, rows: int, C: int, overlap: int,
            dtype: torch.dtype) -> _Window:
    """This rank's window for the shape, made on first use: cudaMalloc,
    both events, the handles exchanged over the gloo snap group, the left
    neighbour's window and events opened."""
    key = (rows, C, overlap, dtype)
    w = mesh.halo_windows.get(key)
    if w is not None:
        return w
    lib = _build.load("ring", _SIG)
    dev = mesh.device.index
    esize = torch.empty((), dtype=dtype).element_size()
    nbytes = (rows + overlap) * C * esize
    own, own_p = _out_param()
    mem_h, mem_hp = _handle()
    _call(lib, "doa_ring_window_alloc", nbytes, dev, own_p, mem_hp)
    evs, ev_handles = [], []
    for _ in range(2):
        ev, ev_p = _out_param()
        h, hp = _handle()
        _call(lib, "doa_ring_event_create", dev, ev_p, hp)
        evs.append(ev)
        ev_handles.append(h.raw)
    info = (dev, mem_h.raw, ev_handles[0], ev_handles[1])
    infos = [None] * mesh.axis_size(SNAP_AXIS)
    dist.all_gather_object(infos, info, group=mesh.halo_group)
    n, me = mesh.axis_size(SNAP_AXIS), mesh.axis_index(SNAP_AXIS)
    left_info, right_info = infos[(me - 1) % n], infos[(me + 1) % n]
    if left_info[0] != dev:
        ok = ctypes.c_int(0)
        _call(lib, "doa_ring_can_access_peer", dev, left_info[0],
              ctypes.addressof(ok))
        if not ok.value:
            raise RuntimeError(f"cuda:{dev} cannot access cuda:"
                               f"{left_info[0]} as a peer: kernel 13 "
                               "writes the halo through a peer pointer")
    opened = []
    for name, h in (("doa_ring_window_open", left_info[1]),
                    ("doa_ring_event_open", left_info[2]),
                    ("doa_ring_event_open", right_info[3])):
        v, vp = _out_param()
        hb = ctypes.create_string_buffer(h, _HANDLE_BYTES)
        _call(lib, name, ctypes.addressof(hb), dev, vp)
        opened.append(v.value)
    raw = torch.as_tensor(_DeviceBytes(own.value, nbytes),
                          device=mesh.device)
    out = raw.view(dtype).view(rows + overlap, C)
    w = _Window(out=out, own=own.value, left=opened[0], ev_free=evs[0].value,
                ev_done=evs[1].value, left_free=opened[1],
                right_done=opened[2], halo_offset=rows * C * esize)
    mesh.halo_windows[key] = w
    return w


def close_windows(mesh: Mesh) -> None:
    """Unmap the neighbours' windows and events, then free this rank's
    (every rank of the snap column together; a no-op without windows)."""
    if not mesh.halo_windows:
        return
    lib = _build.load("ring", _SIG)
    torch.cuda.synchronize(mesh.device)
    _barrier(mesh)                  # no rank writes into a window any more
    for w in mesh.halo_windows.values():
        _call(lib, "doa_ring_window_close", w.left)
        for ev in (w.left_free, w.right_done):
            _call(lib, "doa_ring_event_destroy", ev)
    _barrier(mesh)                  # no rank maps a window any more
    for w in mesh.halo_windows.values():
        w.out = None
        _call(lib, "doa_ring_window_free", w.own)
        for ev in (w.ev_free, w.ev_done):
            _call(lib, "doa_ring_event_destroy", ev)
    mesh.halo_windows.clear()


def _ppermute_halo(plane: torch.Tensor, overlap: int, mesh: Mesh,
                   wrap: bool) -> torch.Tensor:
    """plane with its right neighbour's head rows appended: one ppermute
    (rank i + 1 → i; with `wrap` also 0 → n − 1, else the last rank's
    halo is zeros)."""
    n = mesh.axis_size(SNAP_AXIS)
    perm = [((i + 1) % n, i) for i in range(n if wrap else n - 1)]
    halo = ppermute(plane[:overlap], mesh, SNAP_AXIS, perm)
    return torch.cat([plane, halo], dim=0)


def halo_ring_plain(plane: torch.Tensor, overlap: int,
                    mesh: Mesh) -> torch.Tensor:
    """Plain version of kernel 13: the ring with wrap through ppermute."""
    return _ppermute_halo(plane, overlap, mesh, wrap=True)


def _check_plane(plane: torch.Tensor, overlap: int) -> None:
    if plane.dim() != 2:
        raise ValueError(f"need a plane [T_loc, C], got {tuple(plane.shape)}")
    if not 0 <= overlap <= plane.shape[0]:
        raise ValueError(f"need 0 ≤ overlap ≤ T_loc, got {overlap} and "
                         f"{plane.shape[0]}")


def _ring(plane: torch.Tensor, overlap: int, mesh: Mesh) -> torch.Tensor:
    """halo_ring without the copy: a CUDA plane's result is the rank's
    window itself (see the module's docstring)."""
    _check_plane(plane, overlap)
    if mesh.axis_size(SNAP_AXIS) < 2:
        raise ValueError("the ring needs a snap axis of 2 or more ranks")
    if plane.device.type == "cpu":
        return halo_ring_plain(plane, overlap, mesh)
    if not plane.is_cuda or plane.device != mesh.device:
        raise ValueError(f"plane on {plane.device}, the mesh's rank on "
                         f"{mesh.device}")
    rows, C = plane.shape
    x = plane.contiguous()
    w = _window(mesh, rows, C, overlap, x.dtype)
    lib = _build.load("ring", _SIG)
    stream = torch.cuda.current_stream(mesh.device).cuda_stream
    # readers of this window's last epoch are queued before this record
    _call(lib, "doa_ring_record", w.ev_free, stream)
    _barrier(mesh)
    _call(lib, "doa_ring_wait", stream, w.left_free)
    err = lib.doa_halo(x.data_ptr(), w.own, w.left + w.halo_offset,
                       w.halo_offset, overlap * C * x.element_size(), stream)
    _build.check(err, "doa_halo")
    _build.count("halo_ring")
    _call(lib, "doa_ring_record", w.ev_done, stream)
    _barrier(mesh)
    # the right neighbour's head has landed in this window's halo slot
    _call(lib, "doa_ring_wait", stream, w.right_done)
    return w.out


def halo_ring(plane: torch.Tensor, overlap: int, mesh: Mesh) -> torch.Tensor:
    """Kernel 13: plane [T_loc, C] → [T_loc + overlap, C], the right
    neighbour's head rows appended, the ring wrapping (the snap axis must
    have 2 or more ranks; every rank of it calls together).

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel on the current stream and raises if that fails. Either way the
    result is a tensor of its own: a later exchange does not change it."""
    out = _ring(plane, overlap, mesh)
    return out.clone() if out.is_cuda else out


def _halo_exchange(plane: torch.Tensor, overlap: int, mesh: Mesh,
                   impl: str = "xla") -> torch.Tensor:
    """halo_exchange without the copy: under impl="pallas" a CUDA plane's
    result is the rank's window, which the next exchange of its shape
    overwrites (the sharded pipeline consumes it at once)."""
    if impl not in IMPLS:
        raise ValueError(f"unknown halo impl {impl!r}; one of {IMPLS}")
    _check_plane(plane, overlap)
    if overlap == 0 or mesh.axis_size(SNAP_AXIS) == 1:
        return plane
    if impl == "pallas":
        return _ring(plane, overlap, mesh)
    return _ppermute_halo(plane, overlap, mesh, wrap=False)


def halo_exchange(plane: torch.Tensor, overlap: int, mesh: Mesh,
                  impl: str = "xla") -> torch.Tensor:
    """Overlap halo exchange of a rank's plane [T_loc, C] over the snap
    axis → [T_loc + overlap, C] (every rank of the snap column calls
    together): impl="xla" → ppermute of the head rows, the last rank
    zero-filled; impl="pallas" → kernel 13's ring (halo_ring). overlap 0
    or a snap axis of one rank returns the plane unchanged. A result
    with a halo is a tensor of its own."""
    out = _halo_exchange(plane, overlap, mesh, impl)
    if impl == "pallas" and out.is_cuda and out is not plane:
        out = out.clone()                   # the window → a tensor of its own
    return out
