"""Synthetic coherent-array IQ generator — the reference's simulation
flowgraph signal model (SURVEY §3.2: per-channel tone × steering phase +
AWGN), extended to multi-source, correlated pairs, per-channel impairments
(for exercising calibration), planar arrays, and wideband sources.

Host-side numpy: generates test/demo data, not a hot path.

A copy of doa_tpu/io/synthetic.py (numpy only; importing it through
``doa_tpu.io`` would load jax): one seed gives the same arrays in both
packages.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class SourceSpec:
    """One emitter: arrival angle(s), normalized frequency, amplitude.

    For ULA scenarios `theta_deg` is the angle from the array axis; for
    planar scenarios use (az_deg, el_deg). `bandwidth_norm > 0` makes the
    source wideband: complex white noise band-limited to
    [freq_norm - bw/2, freq_norm + bw/2] instead of a pure tone.
    """

    theta_deg: float = 90.0
    az_deg: float = 0.0
    el_deg: float = 45.0
    freq_norm: float = 0.1
    amplitude: float = 1.0
    bandwidth_norm: float = 0.0


def _waveforms(sources: Sequence[SourceSpec], num_samples: int,
               rng: np.random.Generator,
               correlated_pairs: Sequence[Tuple[int, int]] = ()):
    """(T, K) complex128 per-source baseband waveforms."""
    t = np.arange(num_samples)
    cols = []
    for s in sources:
        phase0 = rng.uniform(0, 2 * np.pi)
        if s.bandwidth_norm > 0:
            # Band-limited noise: white spectrum masked to the band.
            spec = (rng.standard_normal(num_samples)
                    + 1j * rng.standard_normal(num_samples))
            f = np.fft.fftfreq(num_samples)
            mask = np.abs(f - s.freq_norm) <= s.bandwidth_norm / 2
            spec *= mask
            w = np.fft.ifft(spec)
            w *= 1.0 / (np.sqrt(np.mean(np.abs(w) ** 2)) + 1e-30)
        else:
            w = np.exp(1j * (2 * np.pi * s.freq_norm * t + phase0))
        cols.append(s.amplitude * w)
    wave = np.stack(cols, axis=1)
    for (i, j) in correlated_pairs:
        wave[:, j] = (sources[j].amplitude / max(sources[i].amplitude, 1e-30)
                      ) * wave[:, i]
    return wave


def _add_noise_and_impair(clean, snr_db, rng, channel_gains=None,
                          channel_phases=None):
    T, N = clean.shape
    if channel_gains is not None or channel_phases is not None:
        g = np.ones(N) if channel_gains is None else np.asarray(channel_gains)
        p = np.zeros(N) if channel_phases is None else np.asarray(channel_phases)
        clean = clean * (g * np.exp(1j * p))[None, :]
    npow = 10.0 ** (-snr_db / 10.0)
    noise = rng.standard_normal((T, N)) + 1j * rng.standard_normal((T, N))
    noise *= np.sqrt(npow / 2.0)
    return (clean + noise).astype(np.complex64)


def synth_ula_iq(
    sources: Sequence[SourceSpec],
    num_elements: int,
    norm_spacing: float,
    num_samples: int,
    snr_db: float = 10.0,
    seed: int = 0,
    correlated_pairs: Sequence[Tuple[int, int]] = (),
    channel_gains: Optional[Sequence[float]] = None,
    channel_phases: Optional[Sequence[float]] = None,
) -> np.ndarray:
    """(T, N) complex64 coherent ULA capture.

    a(theta)_k = exp(-j 2π d k cosθ) — same convention as
    doa_tpu_torch.ops.steering / tests/golden.py. `channel_gains` /
    `channel_phases` inject per-channel impairments the calibration stages
    must undo.
    """
    rng = np.random.default_rng(seed)
    wave = _waveforms(sources, num_samples, rng, correlated_pairs)  # (T, K)
    theta = np.deg2rad([s.theta_deg for s in sources])
    k = np.arange(num_elements)
    A = np.exp(-1j * 2 * np.pi * norm_spacing
               * np.cos(theta)[:, None] * k[None, :])  # (K, N)
    clean = wave @ A
    return _add_noise_and_impair(clean, snr_db, rng, channel_gains,
                                 channel_phases)


def synth_moving_ula_iq(
    trajectories,
    num_elements: int,
    norm_spacing: float,
    num_samples: int,
    snr_db: float = 10.0,
    seed: int = 0,
    segment: int = 1024,
) -> np.ndarray:
    """Moving-emitter capture (BASELINE config 4: sliding-window tracking).

    `trajectories`: list of callables t01 ∈ [0, 1] → theta_deg (or
    (theta0, theta1) tuples for linear motion). Steering is updated every
    `segment` samples — valid while motion per segment ≪ beamwidth, which
    holds for any physical emitter at SDR sample rates.
    """
    rng = np.random.default_rng(seed)
    t = np.arange(num_samples)
    k = np.arange(num_elements)
    clean = np.zeros((num_samples, num_elements), dtype=np.complex128)
    for i, traj in enumerate(trajectories):
        if isinstance(traj, tuple):
            th0, th1 = traj
            traj = lambda u, a=th0, b=th1: a + (b - a) * u
        f = 0.05 + 0.09 * i
        wave = np.exp(1j * (2 * np.pi * f * t
                            + rng.uniform(0, 2 * np.pi)))
        for s0 in range(0, num_samples, segment):
            s1 = min(s0 + segment, num_samples)
            u = 0.5 * (s0 + s1) / num_samples
            theta = np.deg2rad(float(traj(u)))
            a = np.exp(-1j * 2 * np.pi * norm_spacing * np.cos(theta) * k)
            clean[s0:s1] += np.outer(wave[s0:s1], a)
    return _add_noise_and_impair(clean, snr_db, rng)


def synth_wideband_ula_iq(
    sources: Sequence[SourceSpec],
    num_elements: int,
    norm_spacing: float,
    num_samples: int,
    fractional_bw: float,
    snr_db: float = 10.0,
    seed: int = 0,
    tones_per_source: int = 12,
) -> np.ndarray:
    """Wideband capture where steering genuinely varies across the band.

    Each source's band [freq_norm ± bandwidth_norm/2] is synthesized as
    `tones_per_source` discrete tones; tone at baseband offset f sees
    effective spacing norm_spacing·(1 + f·fractional_bw) — the model the
    subband channelizer (ops.wideband) inverts. Narrowband MUSIC smears
    these sources; subband fusion should not.
    """
    rng = np.random.default_rng(seed)
    t = np.arange(num_samples)
    k = np.arange(num_elements)
    clean = np.zeros((num_samples, num_elements), dtype=np.complex128)
    for s in sources:
        bw = max(s.bandwidth_norm, 1e-6)
        freqs = s.freq_norm + bw * (
            np.linspace(-0.5, 0.5, tones_per_source))
        amp = s.amplitude / np.sqrt(tones_per_source)
        cos_t = np.cos(np.deg2rad(s.theta_deg))
        for f in freqs:
            d_eff = norm_spacing * (1.0 + f * fractional_bw)
            a = np.exp(-1j * 2 * np.pi * d_eff * cos_t * k)
            w = amp * np.exp(
                1j * (2 * np.pi * f * t + rng.uniform(0, 2 * np.pi)))
            clean += np.outer(w, a)
    return _add_noise_and_impair(clean, snr_db, rng)


def synth_ura_iq(
    sources: Sequence[SourceSpec],
    shape: Tuple[int, int],
    norm_spacing: float,
    num_samples: int,
    snr_db: float = 10.0,
    seed: int = 0,
) -> np.ndarray:
    """(T, nx*ny) complex64 planar-array capture (az/el model matching
    doa_tpu_torch.ops.steering.ura_steering; x-major flattening)."""
    rng = np.random.default_rng(seed)
    wave = _waveforms(sources, num_samples, rng)
    az = np.deg2rad([s.az_deg for s in sources])
    el = np.deg2rad([s.el_deg for s in sources])
    ux = np.cos(el) * np.sin(az)
    uy = np.cos(el) * np.cos(az)
    nx, ny = shape
    ix = np.arange(nx)[:, None]
    iy = np.arange(ny)[None, :]
    phase = -2 * np.pi * norm_spacing * (
        ux[:, None, None] * ix + uy[:, None, None] * iy
    )  # (K, nx, ny)
    A = np.exp(1j * phase).reshape(len(sources), nx * ny)
    clean = wave @ A
    return _add_noise_and_impair(clean, snr_db, rng)


def synth_wideband_ura_iq(
    sources: Sequence[SourceSpec],
    shape: Tuple[int, int],
    norm_spacing: float,
    num_samples: int,
    fractional_bw: float,
    snr_db: float = 10.0,
    seed: int = 0,
) -> np.ndarray:
    """Physically-modeled wideband PLANAR capture (config 5 ground truth).

    FFT-domain synthesis: complex white noise on every length-T FFT bin
    inside each source's band, each bin steered at its own effective
    spacing norm_spacing·(1 + f·fractional_bw) on BOTH array axes — the
    continuous-spectrum model ops.wideband's per-subband steering stack
    inverts, with no off-bin tone-leakage artifacts. (synth_ura_iq with
    bandwidth_norm > 0 generates band-limited noise with
    frequency-INDEPENDENT steering — an unphysical approximation that
    biases wideband estimators by several degrees for sources away from
    band center.)"""
    rng = np.random.default_rng(seed)
    T = num_samples
    nx, ny = shape
    ix = np.arange(nx).reshape(-1)[:, None]
    iy = np.arange(ny).reshape(-1)[None, :]
    freqs = np.fft.fftfreq(T)                        # [-0.5, 0.5)
    spec = np.zeros((T, nx * ny), dtype=np.complex128)
    for s in sources:
        bw = max(s.bandwidth_norm, 1.0 / T)
        lo, hi = s.freq_norm - bw / 2, s.freq_norm + bw / 2
        band = np.where((freqs >= lo) & (freqs < hi))[0]
        az = np.deg2rad(s.az_deg)
        el = np.deg2rad(s.el_deg)
        ux = np.cos(el) * np.sin(az)
        uy = np.cos(el) * np.cos(az)
        w = (rng.standard_normal((band.size, 1))
             + 1j * rng.standard_normal((band.size, 1)))
        w *= s.amplitude * np.sqrt(T / (2.0 * band.size))
        d_eff = norm_spacing * (1.0 + freqs[band] * fractional_bw)
        phase = (-2 * np.pi * d_eff[:, None, None]
                 * (ux * ix + uy * iy)[None, :, :])  # (Tb, nx, ny)
        A = np.exp(1j * phase).reshape(band.size, nx * ny)
        spec[band] += w * A
    clean = np.fft.ifft(spec, axis=0) * np.sqrt(T)
    return _add_noise_and_impair(clean, snr_db, rng)
