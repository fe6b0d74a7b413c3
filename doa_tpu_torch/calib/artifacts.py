"""Calibration persistence (reference `save_antenna_calib` P3 + the plain-
text config files consumed by `antenna_correction`/`phase_correct_hier`).

The reference's only persisted state is these files (SURVEY §5
checkpoint/resume). Here: a versioned .npz artifact carrying both stages,
array geometry, and provenance; loadable directly into the pipeline's
`correction` argument.

A copy of doa_tpu/calib/artifacts.py (numpy only; importing it through
``doa_tpu.calib`` would load jax). The .npz format is the same, so an
artifact written by either package loads in the other.
"""

from __future__ import annotations

import dataclasses
import json
import time
from typing import Optional

import numpy as np

ARTIFACT_VERSION = 1


@dataclasses.dataclass
class CalibrationArtifact:
    phase_offsets: Optional[np.ndarray] = None      # f32[N] radians (stage 1)
    element_corrections: Optional[np.ndarray] = None  # c64[N] (stage 2)
    num_elements: int = 0
    norm_spacing: float = 0.5
    pilot_theta_deg: Optional[float] = None
    created_unix: float = 0.0
    version: int = ARTIFACT_VERSION

    def correction_vector(self) -> np.ndarray:
        """The composed c64[N] vector the pipeline consumes."""
        c = np.ones(self.num_elements, dtype=np.complex64)
        if self.phase_offsets is not None:
            c = c * np.exp(-1j * self.phase_offsets).astype(np.complex64)
        if self.element_corrections is not None:
            c = c * self.element_corrections.astype(np.complex64)
        return c


def _norm_path(path: str) -> str:
    """np.savez appends '.npz' to extension-less paths; normalize the same
    way on save AND load so round-trips work with any path spelling."""
    return path if str(path).endswith(".npz") else str(path) + ".npz"


def save_calibration(path: str, art: CalibrationArtifact):
    path = _norm_path(path)
    meta = {
        "version": art.version,
        "num_elements": art.num_elements,
        "norm_spacing": art.norm_spacing,
        "pilot_theta_deg": art.pilot_theta_deg,
        "created_unix": art.created_unix or time.time(),
    }
    arrays = {"meta": json.dumps(meta)}
    if art.phase_offsets is not None:
        arrays["phase_offsets"] = np.asarray(art.phase_offsets, np.float32)
    if art.element_corrections is not None:
        arrays["element_corrections"] = np.asarray(
            art.element_corrections, np.complex64)
    np.savez(path, **arrays)


def load_calibration(path: str) -> CalibrationArtifact:
    with np.load(_norm_path(path)) as z:
        meta = json.loads(str(z["meta"]))
        if meta["version"] > ARTIFACT_VERSION:
            raise ValueError(
                f"calibration artifact version {meta['version']} is newer "
                f"than supported {ARTIFACT_VERSION}")
        return CalibrationArtifact(
            phase_offsets=z["phase_offsets"] if "phase_offsets" in z else None,
            element_corrections=(z["element_corrections"]
                                 if "element_corrections" in z else None),
            num_elements=int(meta["num_elements"]),
            norm_spacing=float(meta["norm_spacing"]),
            pilot_theta_deg=meta.get("pilot_theta_deg"),
            created_unix=float(meta.get("created_unix", 0.0)),
            version=int(meta["version"]),
        )
