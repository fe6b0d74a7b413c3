"""A world of one rank for the port's parallel tests (a fixture the test
files import)."""

import pytest
import torch.distributed as dist

from doa_tpu_torch.parallel import MeshSpec, make_mesh


@pytest.fixture
def one_rank_mesh(tmp_path):
    """This process as rank 0 of a gloo group, on a (1, 1) CPU mesh."""
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        yield make_mesh(MeshSpec(1, 1), device="cpu")
    finally:
        dist.destroy_process_group()
