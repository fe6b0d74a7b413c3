"""Calibration (port of doa_tpu.calib): stage 1, receiver-chain phase
offsets from a common tone; stage 2, element gains/phases from a pilot at
a known angle; the composed correction c complex64[N], which the pipeline
folds into its covariance; a versioned .npz artifact that both packages
read and write."""

from doa_tpu_torch.calib.apply import apply_correction, compose_corrections
from doa_tpu_torch.calib.artifacts import (
    CalibrationArtifact, load_calibration, save_calibration)
from doa_tpu_torch.calib.element_cal import (
    average_corrections, element_calibration)
from doa_tpu_torch.calib.phase_offset import (
    phase_correction, phase_offset_est)

__all__ = [
    "phase_offset_est",
    "phase_correction",
    "element_calibration",
    "average_corrections",
    "apply_correction",
    "compose_corrections",
    "CalibrationArtifact",
    "save_calibration",
    "load_calibration",
]
