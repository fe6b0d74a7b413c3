"""The one traffic generator: a cell's file of parameters → a ring of
capture blocks made on the device from the seed, and the windows whose
answers the run compares.

A block is interleaved float32 samples x[T, 2N] (the bytes of a complex64
(T, N) capture). Noise is complex white Gaussian of unit power on every
element; each source has power 10^(snr_db/10) on every element and a
direction drawn from the seed. Two kinds of source:

* "tone": a complex exponential of `cycles` cycles every `period`
  samples with a phase drawn from the seed, steered at the array's own
  spacing (phases taken at t mod period, exact in float32);
* "band": complex white Gaussian noise on the FFT bins of the block in
  [center − width/2, center + width/2), each bin steered at the spacing
  d·(1 + f·fractional_bw) of its own frequency f, as a wideband emitter
  on an array whose electrical spacing stretches across the band (built
  in float64 and rounded once).

Every seed gives the same sizes and the same kinds of source: only the
directions, phases and noise change with it.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def block_seed(seed: int, *keys: int) -> int:
    """A 63-bit generator seed for (seed, keys): any whole seed, however
    large."""
    ss = np.random.SeedSequence([int(seed) & (2 ** 64 - 1), *keys])
    return int(ss.generate_state(1, np.uint64)[0] & np.uint64(2 ** 63 - 1))


def draw_directions(rng: np.random.Generator, geometry: dict, angles: dict,
                    count: int) -> list:
    """`count` directions, at least min_sep_deg apart: on a ULA θ in the
    theta_deg range, on a URA (az, el) in the az_deg, el_deg ranges with
    their azimuths that far apart."""
    for _ in range(10000):
        if geometry["kind"] == "ula":
            d = sorted(rng.uniform(*angles["theta_deg"], size=count))
            sep = np.diff(d)
        else:
            az = np.sort(rng.uniform(*angles["az_deg"], size=count))
            el = rng.uniform(*angles["el_deg"], size=count)
            d = list(zip(az, el))
            sep = np.diff(az)
        if count < 2 or sep.min() >= angles["min_sep_deg"]:
            return [tuple(np.atleast_1d(v).tolist()) for v in d]
    raise ValueError(f"cannot place {count} sources {angles['min_sep_deg']}° "
                     "apart in the ranges given")


def element_positions(geometry: dict) -> np.ndarray:
    """The element positions [N, 2] in units of the element spacing: (n, 0)
    on a ULA, (ix, iy) on a URA flattened x major."""
    if geometry["kind"] == "ula":
        n = np.arange(geometry["num_elements"], dtype=np.float64)
        return np.stack([n, np.zeros_like(n)], -1)
    nx, ny = geometry["shape"]
    return np.stack([np.repeat(np.arange(nx), ny),
                     np.tile(np.arange(ny), nx)], -1).astype(np.float64)


def direction_cosines(geometry: dict, direction) -> np.ndarray:
    """[2]: the projection of a unit step along each array axis on the
    direction (θ on a ULA, (az, el) on a URA)."""
    if geometry["kind"] == "ula":
        return np.array([math.cos(math.radians(direction[0])), 0.0])
    az, el = (math.radians(v) for v in direction)
    return np.array([math.cos(el) * math.sin(az), math.cos(el) * math.cos(az)])


def element_phase(geometry: dict, spacing: float, direction) -> np.ndarray:
    """The steering phase of every element (radians) towards `direction`
    at element spacing `spacing` (wavelengths) → [N]."""
    return -2.0 * np.pi * spacing * (element_positions(geometry)
                                      @ direction_cosines(geometry, direction))


def make_block(fields: dict, scene: dict, T: int, seed: int, index: int,
               device) -> tuple:
    """Block `index` of the ring → (x f32[T, 2N] on the device, the
    directions of its sources)."""
    geo = fields["geometry"]
    N = geo["num_elements"]
    d = geo["norm_spacing"]
    fbw = fields["wideband"]["fractional_bw"]
    rng = np.random.default_rng(block_seed(seed, index, 0))
    srcs = scene["sources"]
    dirs = draw_directions(rng, geo, scene["angles"], len(srcs))
    gen = torch.Generator(device=device).manual_seed(
        block_seed(seed, index, 1))
    amp = math.sqrt(10.0 ** (scene["snr_db"] / 10.0))
    x = torch.randn((T, 2 * N), generator=gen, device=device)
    x.mul_(math.sqrt(0.5))
    tones = [(s, dv) for s, dv in zip(srcs, dirs) if s["kind"] == "tone"]
    bands = [(s, dv) for s, dv in zip(srcs, dirs) if s["kind"] == "band"]
    if len(tones) + len(bands) != len(srcs):
        raise ValueError(f"unknown source kind in {srcs}")
    if tones:
        basis, mix = [], []
        for s, dv in tones:
            ph = element_phase(geo, d, dv)
            ar, ai = amp * np.cos(ph), amp * np.sin(ph)
            # e^{j(ωt + φ)}·a as [cos, sin] rows against [re, im] columns
            row_c = np.stack([ar, ai], -1).reshape(-1)
            row_s = np.stack([-ai, ar], -1).reshape(-1)
            mix += [row_c, row_s]
            t = (torch.arange(T, device=device) % s["period"]).to(
                torch.float32)
            w = 2.0 * math.pi * s["cycles"] / s["period"]
            phase0 = float(rng.uniform(0.0, 2.0 * math.pi))
            arg = t * w + phase0
            basis += [arg.cos(), arg.sin()]
            del t, arg
        Fm = torch.stack(basis, -1)
        M = torch.from_numpy(np.stack(mix).astype(np.float32)).to(device)
        x.addmm_(Fm, M)
        del Fm
    if bands:
        freqs = torch.fft.fftfreq(T, device=device, dtype=torch.float64)
        spec = torch.zeros((T, N), dtype=torch.complex128, device=device)
        for s, dv in bands:
            lo, hi = s["center"] - s["width"] / 2, s["center"] + s["width"] / 2
            bins = ((freqs >= lo) & (freqs < hi)).nonzero()[:, 0]
            nb = bins.numel()
            coef = torch.complex(
                torch.randn(nb, generator=gen, device=device,
                            dtype=torch.float64),
                torch.randn(nb, generator=gen, device=device,
                            dtype=torch.float64)) * math.sqrt(T / (2.0 * nb))
            u = torch.from_numpy(element_positions(geo)
                                 @ direction_cosines(geo, dv)).to(device)
            sp = d * (1.0 + freqs[bins] * fbw)
            ph = (-2.0 * math.pi) * sp[:, None] * u[None, :]
            spec[bins] += coef[:, None] * torch.polar(torch.ones_like(ph),
                                                      ph) * amp
            del coef, ph
        sig = torch.fft.ifft(spec, dim=0) * math.sqrt(T)
        del spec
        x += torch.view_as_real(sig.to(torch.complex64)).reshape(T, 2 * N)
        del sig
    return x, dirs


def make_ring(fields: dict, traffic: dict, seed: int, device,
              T: int | None = None, blocks: int | None = None) -> list:
    """The cell's ring of distinct blocks → [(x, directions)]."""
    T = traffic["samples_per_call"] if T is None else T
    n = traffic["ring_blocks"] if blocks is None else blocks
    return [make_block(fields, traffic["scene"], T, seed, i, device)
            for i in range(n)]


def check_windows(seed: int, index: int, B: int, count: int,
                  run: int) -> list:
    """The windows of block `index` whose answers are compared: `count` of
    its B windows in runs of `run` consecutive windows, the block's first
    and last runs among them and the others at offsets drawn from the
    seed → sorted, disjoint [(start, stop)]. A run is a contiguous slice
    of a call's answers, so the run copies it out in one piece."""
    run = max(1, min(run, count, B))
    slots = B // run
    n = max(1, min(count // run, slots))
    rng = np.random.default_rng(block_seed(seed, index, 2))
    inner = rng.choice(np.arange(1, slots - 1), size=max(n - 2, 0),
                       replace=False) if slots > 2 else np.array([], int)
    starts = sorted({0, *(int(k) * run for k in inner)})
    runs = [(a, a + run) for a in starts]
    if n > 1:
        runs.append((B - run, B))
    merged = []
    for a, b in sorted(runs):
        if merged and a < merged[-1][1]:
            merged[-1] = (merged[-1][0], max(b, merged[-1][1]))
        else:
            merged.append((a, b))
    return merged
