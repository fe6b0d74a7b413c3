"""Multi-rank execution of the narrowband pipeline over torch.distributed
(port of doa_tpu/parallel).

  DP/SP — the capture's time axis is sharded over the "snap" mesh axis;
          each rank owns a contiguous block and the windows that start in
          it, and takes `overlap` halo samples from its right neighbour
          (ops/cuda/ring.py: ppermute, or kernel 13's ring of peer writes).
  TP    — the steering grid is sharded over the "grid" axis; each rank
          scans its angle block, and O(k) peak candidates cross the ranks.
  Covariance partial sums — chunk Grams are associative: one psum over
          the snap axis gives a full-capture covariance without gathering
          samples (distributed_covariance).

One rank is one process: parallel.multihost.initialize joins a process
group, parallel.launch.spawn_ranks starts ranks on one host.
"""

from doa_tpu_torch.parallel.mesh import MeshSpec, make_mesh
from doa_tpu_torch.parallel.sharded import (build_sharded_pipeline,
                                            distributed_covariance)

__all__ = [
    "make_mesh",
    "MeshSpec",
    "build_sharded_pipeline",
    "distributed_covariance",
]
