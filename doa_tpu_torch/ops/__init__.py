"""Core DoA ops of the port (torch tensors; kernels under ops.cuda).

The names below are doa_tpu.ops' public surface, the complex-typed ops
of the complex pipeline (``pipeline.py``), name for name. Importing them
builds no kernel. ``root_music`` here is the function: the module of the
same name is ``sys.modules["doa_tpu_torch.ops.root_music"]``.
"""

from doa_tpu_torch.ops.steering import (
    ula_steering,
    ura_steering,
    ula_grid,
    ura_grid,
)
from doa_tpu_torch.ops.covariance import (
    frame_samples,
    sample_covariance,
    forward_backward,
    spatial_smooth,
    streaming_covariance,
)
from doa_tpu_torch.ops.subspace import (noise_subspace, signal_subspace,
                                        eigh_batched)
from doa_tpu_torch.ops.music import music_spectrum, noise_projector
from doa_tpu_torch.ops.capon import capon_spectrum
from doa_tpu_torch.ops.min_norm import min_norm_spectrum, root_min_norm
from doa_tpu_torch.ops.root_music import root_music
from doa_tpu_torch.ops.peaks import find_local_max
from doa_tpu_torch.ops.crb import crb_ula_deg, crb_ura_deg

__all__ = [
    "ula_steering",
    "ura_steering",
    "ula_grid",
    "ura_grid",
    "frame_samples",
    "sample_covariance",
    "forward_backward",
    "spatial_smooth",
    "streaming_covariance",
    "noise_subspace",
    "signal_subspace",
    "eigh_batched",
    "music_spectrum",
    "min_norm_spectrum",
    "root_min_norm",
    "noise_projector",
    "capon_spectrum",
    "root_music",
    "find_local_max",
    "crb_ula_deg",
    "crb_ura_deg",
]
