"""doa_tpu_torch — the doa_tpu DoA pipeline in PyTorch, with hand-written
CUDA kernels for the NVIDIA H100 (sm_90a).

A port of the JAX package ``doa_tpu``, which stays the reference. Module
names mirror ``doa_tpu``; inside, the code is plain functions on torch
tensors with an explicit ``device``. The configuration system is the
port's own copy, ``doa_tpu_torch.configs`` (the same classes, fields,
validation and ``PRESETS``); ``as_config`` takes a config built with
``doa_tpu.configs`` too. This package imports neither JAX nor anything of
``doa_tpu``.

Covered so far (``build_pipeline_torch``):

* the narrowband fused path — interleaved capture → chunk-Gram kernel
  (K1) → embedded covariance windows → warm-start MGS subspace iteration
  (K4) with the escalation detector → MUSIC scan kernel (K3) or fused
  scan + peaks kernel (K2); on an az/el grid, the 2-D peaks kernel;
* the wideband incoherent path (the c5 flagship) — the front-end ring
  kernel (the DFT channelizer and the subband Grams in one kernel, at any
  subband count on the card) → per-subband warm-start
  subspaces (K4, one init per subband) → fused subband scan + fusion
  kernel → 2-D peaks kernel;
* the coherent wideband fusions "cssm" and "cssm_auto" — the same front
  end → focused covariance mean_f T_f R_f T_fᴴ → FB, smoothing and the
  narrowband estimators;
* the narrowband planes path (c3: calibration correction, forward-backward
  averaging, spatial smoothing; subspace_method="eigh"; (re, im) planes
  input) — planes chunk-Gram kernel (kernel 8) → covariance planes →
  cold MGS subspace (K4) and the scan kernels, or the eigh noise
  projector; Capon and Bartlett on either narrowband path; the public
  ``cov_windows`` entry (window-Gram kernel 12 below gcd 64);
* the calibration stage (``doa_tpu_torch.calib``): chain phase offsets,
  element gains/phases, and the .npz artifact both packages share;
* the fused path's opt-in stages — ``subspace_impl="pallas"`` (the cold
  Newton–Schulz subspace kernel 11), ``subspace_check`` (the subspace
  guard, with ``DoaResult.subspace_residual``), the chunk covariance
  kernel 9 behind ``cov_embedded(variant="chunk")`` (the fused path's
  covariance stage launches it in K1's place where a window is one
  chunk, and its window entry where windows overlap), ``donate_inputs``
  and ``call.scan_capture`` (a capture staged as blocks, framed as one
  stream). These are options and methods of what ``build_pipeline_torch``
  returns, so the package exports nothing new for them;
* DFT beamspace (``BeamspaceSpec``: covariance and steering projected
  onto Nb beams after the covariance stage, the subspace and scans at
  2·Nb), the hierarchical coarse → refine scans (``scan_mode=
  "hierarchical"``: MUSIC and Capon narrowband, incoherent wideband
  MUSIC; ``ops/hierarchical.py``) and source counting by AIC / MDL
  (``ops/model_order.py``).

The public one-shot entry (``estimate_doa``, ``pipeline.build_pipeline``)
is the reference's complex-typed path: complex64 samples → correction →
covariance windows (``ops/covariance.py``: FB, smoothing; beamspace) →
MUSIC, Capon, Bartlett and min-norm spectra with their peaks, root-MUSIC,
ESPRIT and Unitary ESPRIT (``ops/music.py``, ``capon.py``,
``bartlett.py``, ``subspace.py``, ``root_music.py``, ``min_norm.py``),
composed of PyTorch library calls in true FP32 as the reference composes
XLA's; beside it ``ops`` exports the reference's ops surface, the device
steering functions, MVDR beamforming (``ops/beamform.py``) and the
Cramér–Rao bounds (``ops/crb.py``).

The host side: ``python -m doa_tpu_torch <cmd>`` (``cli.py``: simulate,
estimate, calibrate-phase, calibrate-elements, evaluate, track; on the
card unless ``--device cpu``), the sample ingest (``io``: the synthetic
generators, recorded-IQ files, the C++ framer ``csrc/framer.cpp`` built
with g++, the streaming driver, UDP sources), the alpha-beta tracker
(``tracking.py``: its scan in one launch of ``csrc/track.cu`` on the
card), the streaming checkpoint (``checkpoint.py``), the Monte-Carlo
evaluation (``eval.py``) and ``utils`` (timing fence, ``torch.profiler``
traces, the pipeline's named spans, HTML reports). With it the port does
all that ``doa_tpu`` does; ROADMAP.md lists what comes next.
"""

from doa_tpu_torch import configs
from doa_tpu_torch.configs import (
    ArrayGeometry,
    AvgMethod,
    BeamspaceSpec,
    DoaConfig,
    Estimator,
    GridSpec1D,
    GridSpec2D,
    PRESETS,
    SmoothingSpec,
    WidebandSpec,
    as_config,
)


def build_pipeline_torch(*args, **kwargs):
    """Lazy re-export of doa_tpu_torch.pipeline_torch.build_pipeline_torch."""
    from doa_tpu_torch.pipeline_torch import build_pipeline_torch as f

    return f(*args, **kwargs)


def estimate_doa(*args, **kwargs):
    """Lazy re-export of doa_tpu_torch.pipeline.estimate_doa (the
    one-shot complex-typed path; on the card unless device="cpu")."""
    from doa_tpu_torch.pipeline import estimate_doa as f

    return f(*args, **kwargs)


__all__ = [
    "configs",
    "ArrayGeometry",
    "AvgMethod",
    "BeamspaceSpec",
    "DoaConfig",
    "Estimator",
    "GridSpec1D",
    "GridSpec2D",
    "PRESETS",
    "SmoothingSpec",
    "WidebandSpec",
    "as_config",
    "build_pipeline_torch",
    "estimate_doa",
]
