"""Steering grids as host numpy (config-static scan matrices).

The same conventions as doa_tpu.ops.steering (pinned by tests/golden.py):
ULA element positions p_k = k·d wavelengths, theta from the array axis,
a(theta)_k = exp(-1j·2π·d·k·cos theta). That module imports jax.numpy at
the top, so its numpy functions are repeated here; grids are built once per
pipeline and copied to the device. ``ula_steering`` and ``ura_steering``
are the device functions: steering at angles given at run time, phases
in FP32 as the reference computes them.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from doa_tpu_torch.configs import ArrayGeometry, GridSpec1D, GridSpec2D


def _angles_rad(deg, device) -> torch.Tensor:
    """Angles in degrees (a tensor keeps its device; anything else goes
    to `device`, the card unless the caller names the CPU) → f32
    radians."""
    if not isinstance(deg, torch.Tensor) or device is not None:
        from doa_tpu_torch.pipeline_torch import _device
        dev = _device("cuda" if device is None else device)
        deg = torch.as_tensor(deg, dtype=torch.float32, device=dev)
    return torch.deg2rad(deg.to(torch.float32))


def ula_phase(theta: torch.Tensor, num_elements: int,
              norm_spacing: float) -> torch.Tensor:
    """f32 radians (...) → the ULA steering phases f32[..., N],
    (−2π·d)·cos θ·k, rounded in the reference's order."""
    k = torch.arange(num_elements, dtype=torch.float32, device=theta.device)
    return (-2.0 * math.pi * norm_spacing * torch.cos(theta))[..., None] * k


def _expj(phase: torch.Tensor, dtype) -> torch.Tensor:
    return torch.complex(torch.cos(phase), torch.sin(phase)).to(dtype)


def ula_steering(theta_deg, num_elements: int, norm_spacing: float,
                 dtype=torch.complex64, *, device=None) -> torch.Tensor:
    """a(θ) (..., N) for a ULA at angles theta_deg of any shape (a tensor
    stays on its device; other input goes to `device`, default the
    card)."""
    return _expj(ula_phase(_angles_rad(theta_deg, device), num_elements,
                           norm_spacing), dtype)


def ura_steering(az_deg, el_deg, shape, norm_spacing: float,
                 dtype=torch.complex64, *, device=None) -> torch.Tensor:
    """Planar-array steering at (az, el) of any one shape, the elements
    on an (nx, ny) grid in the x-y plane, u = (cos el sin az,
    cos el cos az), x-major flattening → (..., nx·ny)."""
    az = _angles_rad(az_deg, device)
    el = _angles_rad(el_deg, device)
    ux = torch.cos(el) * torch.sin(az)
    uy = torch.cos(el) * torch.cos(az)
    nx, ny = shape
    ix = torch.arange(nx, dtype=torch.float32, device=az.device)[:, None]
    iy = torch.arange(ny, dtype=torch.float32, device=az.device)[None, :]
    phase = -2.0 * math.pi * norm_spacing * (
        ux[..., None, None] * ix + uy[..., None, None] * iy)
    return _expj(phase, dtype).reshape(*az.shape, nx * ny)


def grid_angles_1d(grid: GridSpec1D) -> np.ndarray:
    """The G scan angles (degrees) for a 1-D grid."""
    return np.linspace(grid.lo_deg, grid.hi_deg, grid.num_points)


def _ula_steering_np(theta_deg, num_elements: int, norm_spacing: float):
    """ULA steering vectors (..., N) complex64 for angles theta_deg."""
    theta = np.deg2rad(np.asarray(theta_deg, dtype=np.float64))
    k = np.arange(num_elements)
    phase = -2.0 * np.pi * norm_spacing * np.cos(theta)[..., None] * k
    return np.exp(1j * phase).astype(np.complex64)


def ula_grid(geometry: ArrayGeometry, grid: GridSpec1D,
             num_elements: int | None = None) -> np.ndarray:
    """Steering matrix A: (G, N) complex64 over the scan grid.
    `num_elements` overrides the geometry's count (smoothing subarray)."""
    n = num_elements if num_elements is not None else geometry.num_elements
    return _ula_steering_np(grid_angles_1d(grid), n, geometry.norm_spacing)


def grid_angles_2d(grid: GridSpec2D):
    """(az, el) meshgrid (degrees) flattened to (G,) each,
    G = num_az·num_el, az-major."""
    az = np.linspace(grid.az_lo_deg, grid.az_hi_deg, grid.num_az)
    el = np.linspace(grid.el_lo_deg, grid.el_hi_deg, grid.num_el)
    azg, elg = np.meshgrid(az, el, indexing="ij")
    return azg.ravel(), elg.ravel()


def ura_grid(geometry: ArrayGeometry, grid: GridSpec2D) -> np.ndarray:
    """Steering matrix A: (num_az·num_el, N) complex64 over the az/el
    grid; elements on an (nx, ny) grid, x-major flattening."""
    azg, elg = grid_angles_2d(grid)
    az = np.deg2rad(azg)
    el = np.deg2rad(elg)
    ux = np.cos(el) * np.sin(az)
    uy = np.cos(el) * np.cos(az)
    nx, ny = geometry.shape
    ix = np.arange(nx)[:, None]
    iy = np.arange(ny)[None, :]
    phase = -2.0 * np.pi * geometry.norm_spacing * (
        ux[..., None, None] * ix + uy[..., None, None] * iy)
    return np.exp(1j * phase).reshape(len(az), nx * ny).astype(np.complex64)
