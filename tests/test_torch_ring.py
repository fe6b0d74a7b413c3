"""The rules of the port's halo exchange (ops/cuda/ring.py) that hold in
one process. Its exchanges between gloo ranks, against the reference's
ppermute rows and for kernel 13's plain version, run in
tests/test_torch_sharded.py, inside that module's one launch a mesh
shape; the kernel itself needs a card and runs in chip_smoke.py (phase
14)."""

import numpy as np
import pytest
import torch

from doa_tpu_torch.ops.cuda.ring import halo_exchange, halo_ring
from torch_world import one_rank_mesh  # noqa: F401  (a fixture)

T, N, OVERLAP = 512, 4, 32


def test_halo_rules(one_rank_mesh):  # noqa: F811
    """overlap 0 or a snap axis of one rank return the plane itself; the
    ring needs two ranks; an unknown impl, a halo longer than the block
    and a plane that is not 2-D raise."""
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (T, N)).astype(np.float32))
    for impl in ("xla", "pallas"):
        assert halo_exchange(x, OVERLAP, one_rank_mesh, impl=impl) is x
        assert halo_exchange(x, 0, one_rank_mesh, impl=impl) is x
    with pytest.raises(ValueError, match="two or more|2 or more"):
        halo_ring(x, OVERLAP, one_rank_mesh)
    with pytest.raises(ValueError, match="impl"):
        halo_exchange(x, OVERLAP, one_rank_mesh, impl="nccl")
    with pytest.raises(ValueError, match="overlap"):
        halo_exchange(x, T + 1, one_rank_mesh)
    with pytest.raises(ValueError, match="plane"):
        halo_exchange(x[0], OVERLAP, one_rank_mesh)
