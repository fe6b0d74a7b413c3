"""Collectives over one axis of a mesh: the port's psum, all_gather and
ppermute (the jax.lax collectives the reference calls inside shard_map).

Written once for both backends. Under nccl a CUDA operand goes to the
collective as it is. Under gloo a CUDA operand (ranks sharing a card,
where NCCL refuses two ranks on one device) is copied to the host, reduced
or exchanged there and copied back, explicitly: the operands here are
small (a (2N, 2N) capture mean, O(k) peak candidates, escalation counts,
one column of a spectrum). The halo kernel (ops/cuda/ring.py) never takes
this route. An axis of size 1 needs no communication.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from doa_tpu_torch.parallel.mesh import Mesh


def _to_host(t: torch.Tensor, mesh: Mesh):
    """→ (the operand the collective takes, its device to return to)."""
    if mesh.host_staged(t):
        return t.detach().to("cpu"), t.device
    return t.contiguous(), None


def _back(t: torch.Tensor, device):
    return t if device is None else t.to(device)


def psum(t: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """Sum of `t` over the ranks of `axis` (jax.lax.psum), on every one."""
    grp = mesh.group(axis)
    if grp is None:
        return t
    buf, dev = _to_host(t, mesh)
    buf = buf.clone()
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=grp)
    return _back(buf, dev)


def all_gather(t: torch.Tensor, mesh: Mesh, axis: str,
               dim: int = 1) -> torch.Tensor:
    """The ranks' `t` along `axis`, concatenated along `dim` in axis order
    (jax.lax.all_gather(..., axis=dim, tiled=True))."""
    grp = mesh.group(axis)
    if grp is None:
        return t
    buf, dev = _to_host(t, mesh)
    parts = [torch.empty_like(buf) for _ in range(mesh.axis_size(axis))]
    dist.all_gather(parts, buf, group=grp)
    return _back(torch.cat(parts, dim=dim), dev)


def ppermute(t: torch.Tensor, mesh: Mesh, axis: str, perm) -> torch.Tensor:
    """jax.lax.ppermute over `axis`: `perm` lists (source, destination)
    axis indices; a rank that no pair sends to receives zeros."""
    n = mesh.axis_size(axis)
    me = mesh.axis_index(axis)
    perm = [(s % n, d % n) for s, d in perm]
    send_to = [d for s, d in perm if s == me]
    recv_from = [s for s, d in perm if d == me]
    if len(recv_from) > 1:
        raise ValueError(f"ppermute: index {me} receives from {recv_from}")
    buf, dev = _to_host(t, mesh)
    out = torch.zeros_like(buf)
    ranks = mesh.axis_ranks(axis)
    ops = []
    for d in send_to:
        if d == me:
            out.copy_(buf)
        else:
            ops.append(dist.P2POp(dist.isend, buf, ranks[d],
                                  mesh.group(axis)))
    for s in recv_from:
        if s != me:
            ops.append(dist.P2POp(dist.irecv, out, ranks[s],
                                  mesh.group(axis)))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return _back(out, dev)
