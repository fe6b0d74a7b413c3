"""The (snap, grid) mesh over torch.distributed ranks (port of
doa_tpu/parallel/mesh.py).

One rank is one process. Ranks are laid out row-major, rank = s·n_grid + g,
as ``np.asarray(devices).reshape(n_snap, n_grid)`` lays out devices in
the reference. The snap group of a rank holds the ranks of its grid
column (the time-sharded ring); its grid group holds the ranks of its
snap row (the steering-grid shards). Every rank creates every group, in
the same order, as ``dist.new_group`` requires.

Backends: gloo on the CPU; nccl when each rank has a card of its own;
gloo again when ranks share a card (NCCL refuses two ranks on one
device). The collectives (parallel/collectives.py) stage CUDA operands
through the host under gloo, explicitly. Every mesh also keeps a gloo
group over its snap axis for the halo kernel's handle exchange and host
barriers (ops/cuda/ring.py), and the kernel's symmetric windows, which
``Mesh.close`` releases.
"""

from __future__ import annotations

import dataclasses
import datetime
import os

import torch
import torch.distributed as dist

SNAP_AXIS = "snap"   # time/snapshot data-parallel axis (DP+SP)
GRID_AXIS = "grid"   # steering-grid tensor-parallel axis (TP)
# bound of every host-side wait of the halo kernel's protocol
HALO_TIMEOUT = datetime.timedelta(seconds=120)


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    n_snap: int
    n_grid: int = 1

    @property
    def n_devices(self) -> int:
        return self.n_snap * self.n_grid


def default_backend(device, world: int) -> str:
    """gloo for CPU ranks and for ranks that share a card; nccl when this
    host's ranks (LOCAL_WORLD_SIZE, default `world`) fit one a card."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return "gloo"
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    return "nccl" if local <= torch.cuda.device_count() else "gloo"


def rank_device(device) -> torch.device:
    """The rank's device: "cpu", or for "cuda" cuda:{LOCAL_RANK mod the
    card count} (LOCAL_RANK defaults to the global rank). Raises when
    CUDA is asked for and torch sees no card."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but torch sees no CUDA "
                           "device; the mesh does not fall back to CPU")
    if dev.index is not None:
        return dev
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
    return torch.device("cuda", local % torch.cuda.device_count())


class Mesh:
    """This rank's view of the (snap, grid) mesh: its coordinates, its
    device, the process groups of its two axes (None for an axis of size
    1) and the ranks along them."""

    def __init__(self, spec: MeshSpec, device: torch.device):
        self.spec = spec
        rank = dist.get_rank()
        self.backend = dist.get_backend()
        self.device = device
        self.coords = {SNAP_AXIS: rank // spec.n_grid,
                       GRID_AXIS: rank % spec.n_grid}
        self.shape = {SNAP_AXIS: spec.n_snap, GRID_AXIS: spec.n_grid}
        self._ranks = {}
        self._groups = {}
        self.halo_group = None
        # every rank creates every group in one order: the snap columns,
        # then the grid rows, then (CUDA meshes, whose device type every
        # rank shares) the gloo snap columns of the halo kernel
        columns = [[s * spec.n_grid + g for s in range(spec.n_snap)]
                   for g in range(spec.n_grid)]
        rows = [[s * spec.n_grid + g for g in range(spec.n_grid)]
                for s in range(spec.n_snap)]
        for axis, sets, mine in ((SNAP_AXIS, columns, self.coords[GRID_AXIS]),
                                 (GRID_AXIS, rows, self.coords[SNAP_AXIS])):
            self._ranks[axis] = sets[mine]
            self._groups[axis] = None
            for i, ranks in enumerate(sets):
                if len(ranks) > 1:
                    grp = dist.new_group(ranks)
                    if i == mine:
                        self._groups[axis] = grp
        for i, ranks in enumerate(columns):
            if len(ranks) > 1 and device.type == "cuda":
                grp = dist.new_group(ranks, backend="gloo",
                                     timeout=HALO_TIMEOUT)
                if i == self.coords[GRID_AXIS]:
                    self.halo_group = grp
        self.halo_windows: dict = {}

    def axis_index(self, axis: str) -> int:
        return self.coords[axis]

    def axis_size(self, axis: str) -> int:
        return self.shape[axis]

    def axis_ranks(self, axis: str) -> list:
        """Global ranks along `axis` through this rank, by axis index."""
        return self._ranks[axis]

    def group(self, axis: str):
        return self._groups[axis]

    def host_staged(self, t: torch.Tensor) -> bool:
        """Whether a collective on `t` goes through the host: a CUDA
        tensor under gloo (ranks sharing a card)."""
        return t.is_cuda and self.backend == "gloo"

    def close(self) -> None:
        """Release the halo kernel's windows (every rank of the snap
        column calls it together)."""
        from doa_tpu_torch.ops.cuda.ring import close_windows
        close_windows(self)


def make_mesh(spec: MeshSpec | None = None, device="cuda") -> Mesh:
    """Build this rank's ("snap", "grid") mesh over the initialised
    default process group (parallel.multihost.initialize or
    parallel.launch.spawn_ranks). Default: every rank on the snap axis.
    The rank runs on its card (rank_device) unless `device` is "cpu";
    without a card the default raises."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group "
                           "(parallel.multihost.initialize)")
    world = dist.get_world_size()
    if spec is None:
        spec = MeshSpec(n_snap=world, n_grid=1)
    if spec.n_devices != world:
        raise ValueError(f"mesh {spec} wants {spec.n_devices} ranks, the "
                         f"process group has {world}")
    dev = rank_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return Mesh(spec, dev)
