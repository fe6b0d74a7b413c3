"""Multi-process bring-up (port of doa_tpu/parallel/multihost.py).

One process per rank; ``initialize`` forms the process group and this
rank's mesh. Each rank then owns the time block of its snap index and
feeds it to ``build_sharded_pipeline(...).local``, which is the analog of
the reference's ``host_local_to_global``: no rank gathers the capture.
There is no elasticity: a lost rank fails the job.

One divergence from the reference: a failure to form the process group
raises. The reference catches ValueError and RuntimeError from
``jax.distributed.initialize`` and goes on as a single process
(multihost.py:50-57), which can run a job on one rank that was meant for
many.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
from typing import Optional

import torch.distributed as dist

from doa_tpu_torch.parallel.mesh import (Mesh, MeshSpec, default_backend,
                                         make_mesh)


@dataclasses.dataclass
class DistributedContext:
    num_hosts: int          # ranks in the process group
    host_id: int            # this rank
    mesh: Mesh

    @property
    def is_leader(self) -> bool:
        return self.host_id == 0


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               n_grid: int = 1, device="cuda") -> DistributedContext:
    """Join (or form) the process group and build this rank's mesh of
    (world // n_grid, n_grid) ranks on `device`.

    coordinator_address: "host:port" (or any torch init_method URL) of
    rank 0's TCP store; None reads the environment (MASTER_ADDR,
    MASTER_PORT, WORLD_SIZE, RANK, as torchrun sets them). num_processes
    and process_id are the world size and this rank (default from the
    environment). A single process (num_processes=1, no coordinator) runs
    on a private file store. The backend is nccl when every rank has a
    card of its own, else gloo (mesh.default_backend). An already
    initialised process group is used as it is. Any failure raises."""
    if not dist.is_initialized():
        world = num_processes if num_processes is not None else int(
            os.environ.get("WORLD_SIZE", "1"))
        rank = process_id if process_id is not None else int(
            os.environ.get("RANK", "0"))
        backend = default_backend(device, world)
        if coordinator_address is not None:
            url = (coordinator_address if "://" in coordinator_address
                   else f"tcp://{coordinator_address}")
            dist.init_process_group(backend, init_method=url,
                                    world_size=world, rank=rank)
        elif world == 1 and "MASTER_ADDR" not in os.environ:
            path = os.path.join(tempfile.mkdtemp(prefix="doa_torch_pg_"),
                                "store")
            dist.init_process_group(backend, store=dist.FileStore(path, 1),
                                    world_size=1, rank=0)
        else:
            dist.init_process_group(backend, init_method="env://",
                                    world_size=world, rank=rank)
    world = dist.get_world_size()
    if world % n_grid:
        raise ValueError(f"{world} ranks do not split into n_grid={n_grid}")
    mesh = make_mesh(MeshSpec(n_snap=world // n_grid, n_grid=n_grid),
                     device=device)
    return DistributedContext(num_hosts=world, host_id=dist.get_rank(),
                              mesh=mesh)
