"""Monte-Carlo accuracy evaluation — the quantitative version of the
reference's by-eye simulation check (SURVEY §4), and the BASELINE
"DoA RMSE (deg)" metric.

Runs trials across SNRs for any estimator set; each trial synthesizes a
fresh capture, runs the fused pipeline, matches estimates to truth by
nearest-neighbor, and accumulates errors. RMSE + bias + resolution
probability per (estimator, SNR).

Port of doa_tpu/eval.py: the pipeline is build_pipeline_torch (on the
card unless device="cpu"), each trial's estimates read to the host with
``.cpu()``; the captures (io.synthetic) and the Cramér–Rao bound
(ops/crb.py) are the port's numpy copies, so one seed gives the trials
of doa_tpu's sweep.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional, Sequence

import numpy as np

from doa_tpu_torch.configs import DoaConfig, as_config
from doa_tpu_torch.io import SourceSpec, synth_ula_iq
from doa_tpu_torch.ops.crb import crb_ula_deg
from doa_tpu_torch.pipeline_torch import build_pipeline_torch


def _crb_rms_deg(cfg: DoaConfig, truth: np.ndarray, snr_db: float,
                 amplitudes=None, correlated: bool = False) -> float:
    """Stochastic CRB std, RMS-combined over sources (degrees) — the
    floor the RMSE column is judged against. One pipeline window = one
    estimate from cfg.snapshot_size array snapshots."""
    if cfg.geometry.kind != "ula":
        return float("nan")
    corr = None
    if correlated:
        amps = (np.ones(len(truth)) if amplitudes is None
                else np.asarray(amplitudes, float))
        # The Stoica-Nehorai unconditional CRB assumes a NONSINGULAR
        # source covariance; the fully coherent P (rank-1) is outside
        # the formula's validity, so the bound column uses correlation
        # 0.999 — within line width of the coherent limit while keeping
        # P invertible.
        corr = np.outer(amps, amps).astype(complex)
        corr = 0.999 * corr + 0.001 * np.diag(np.diag(corr))
    try:
        std = crb_ula_deg(
            truth, cfg.geometry.num_elements, cfg.geometry.norm_spacing,
            snr_db, cfg.snapshot_size, amplitudes=amplitudes,
            correlation=corr)
        return float(np.sqrt(np.mean(std ** 2)))
    except np.linalg.LinAlgError:
        return float("nan")


def _candidates(out) -> Dict[str, np.ndarray]:
    """{estimator: its angles (B, K') on the host} of one DoaResult: the
    grid estimators' peaks and the grid-free angles."""
    cand = {est: a.cpu().numpy() for est, a in out.peak_angles.items()}
    for key, name in (("root_music_angles", "root_music"),
                      ("esprit_angles", "esprit"),
                      ("unitary_esprit_angles", "unitary_esprit")):
        a = getattr(out, key)
        if a is not None:
            cand[name] = a.cpu().numpy()
    return cand


@dataclasses.dataclass
class EvalResult:
    snr_db: float
    estimator: str
    rmse_deg: float
    bias_deg: float
    resolve_prob: float      # fraction of windows resolving ALL sources
    num_windows: int
    crb_deg: float = float("nan")   # stochastic CRB std (RMS over sources)

    def to_dict(self):
        return dataclasses.asdict(self)


def _match_errors(est: np.ndarray, truth: np.ndarray,
                  gate_deg: float = 5.0):
    """est: (B, K') estimates, truth: (K,) → (errors list, resolved bools).

    Greedy nearest matching truth→estimate; a window 'resolves' if every
    true angle has a distinct estimate within gate_deg."""
    B = est.shape[0]
    errs: List[float] = []
    resolved = np.zeros(B, bool)
    for b in range(B):
        cand = list(est[b])
        ok = True
        row = []
        for t in truth:
            if not cand:
                ok = False
                break
            d = np.abs(np.asarray(cand) - t)
            j = int(np.argmin(d))
            if d[j] > gate_deg:
                ok = False
                break
            row.append(cand.pop(j) - t)
        if ok:
            errs.extend(row)
            resolved[b] = True
    return np.asarray(errs), resolved


def evaluate_ula(cfg: DoaConfig, truth_deg: Sequence[float],
                 snrs_db: Sequence[float], trials: int = 6,
                 windows_per_trial: int = 24,
                 seed: int = 0,
                 amplitudes: Optional[Sequence[float]] = None, *,
                 device="cuda") -> List[EvalResult]:
    """Monte-Carlo sweep. Returns one EvalResult per (SNR, estimator).

    Defaults give 144 windows per point — the sample size behind the
    docs/ACCURACY.md tables (RMSE Monte-Carlo error ~6%); lower
    trials/windows_per_trial for a quick smoke run, expecting ~2×
    noisier RMSE.

    `amplitudes` (per-source linear amplitudes, default all-1) exercises
    source POWER IMBALANCE — the regime that sets the power-iteration
    schedule envelope (configs.DoaConfig.power_schedule).

    Runs on `device` (the card unless device="cpu")."""
    cfg = as_config(cfg)
    pipe = build_pipeline_torch(cfg, device=device)
    truth = np.asarray(truth_deg, float)
    K = len(truth)
    amps = ([1.0] * K if amplitudes is None else list(amplitudes))
    T = windows_per_trial * cfg.snapshot_size
    results = []
    for snr in snrs_db:
        per_est: Dict[str, List[np.ndarray]] = {}
        res_count: Dict[str, List[np.ndarray]] = {}
        nwin = 0
        for tr in range(trials):
            srcs = [SourceSpec(theta_deg=t, freq_norm=0.05 + 0.09 * i,
                               amplitude=amps[i])
                    for i, t in enumerate(truth)]
            x = synth_ula_iq(srcs, cfg.geometry.num_elements,
                             cfg.geometry.norm_spacing, T, snr_db=snr,
                             seed=seed * 1000 + tr * 17 + (int(snr * 3) & 0xFFFF))
            cand = _candidates(pipe(x))
            nwin += windows_per_trial
            for est, a in cand.items():
                e, r = _match_errors(a, truth)
                per_est.setdefault(est, []).append(e)
                res_count.setdefault(est, []).append(r)
        crb = _crb_rms_deg(cfg, truth, float(snr), amplitudes=amps)
        for est in per_est:
            errs = np.concatenate(per_est[est]) if per_est[est] else (
                np.asarray([]))
            res = np.concatenate(res_count[est])
            results.append(EvalResult(
                snr_db=float(snr), estimator=est,
                rmse_deg=float(np.sqrt(np.mean(errs ** 2)))
                if errs.size else float("nan"),
                bias_deg=float(np.mean(errs)) if errs.size else float("nan"),
                resolve_prob=float(np.mean(res)),
                num_windows=int(nwin),
                crb_deg=crb))
    return results


def print_table(results: List[EvalResult]):
    for r in results:
        print(json.dumps(r.to_dict()))


@dataclasses.dataclass
class SeparationResult:
    separation_deg: float
    estimator: str
    rmse_deg: float
    resolve_prob: float
    num_windows: int
    crb_deg: float = float("nan")

    def to_dict(self):
        return dataclasses.asdict(self)


def evaluate_separation_sweep(cfg: DoaConfig, center_deg: float,
                              separations_deg: Sequence[float],
                              snr_db: float = 10.0, trials: int = 4,
                              windows_per_trial: int = 8,
                              correlated: bool = False,
                              seed: int = 0, *, device="cuda"
                              ) -> List[SeparationResult]:
    """Resolution vs source separation near the Rayleigh limit
    (VERDICT r1: the accuracy envelope where the power-iteration
    subspace and the estimators actually get stressed). Two equal-power
    sources at center ± sep/2; `correlated=True` makes them coherent
    (the spatial-smoothing / FB-averaging regime). Runs on `device` (the
    card unless device="cpu")."""
    cfg = as_config(cfg)
    pipe = build_pipeline_torch(cfg, device=device)
    T = windows_per_trial * cfg.snapshot_size
    out_rows: List[SeparationResult] = []
    for sep in separations_deg:
        truth = np.asarray([center_deg - sep / 2, center_deg + sep / 2])
        per_est: Dict[str, List[np.ndarray]] = {}
        res_count: Dict[str, List[np.ndarray]] = {}
        nwin = 0
        for tr in range(trials):
            srcs = [SourceSpec(theta_deg=t,
                               freq_norm=0.1 if correlated else
                               0.05 + 0.09 * i)
                    for i, t in enumerate(truth)]
            x = synth_ula_iq(
                srcs, cfg.geometry.num_elements,
                cfg.geometry.norm_spacing, T, snr_db=snr_db,
                seed=seed * 1000 + tr * 13 + int(sep * 7),
                correlated_pairs=[(0, 1)] if correlated else ())
            cand = _candidates(pipe(x))
            nwin += windows_per_trial
            for est, a in cand.items():
                # gate = sep/3: a single MERGED peak (padded into both
                # slots) sits sep/2 from each truth and must NOT count
                # as resolving two sources.
                e, r = _match_errors(a, truth,
                                     gate_deg=max(0.5, sep / 3))
                per_est.setdefault(est, []).append(e)
                res_count.setdefault(est, []).append(r)
        crb = _crb_rms_deg(cfg, truth, snr_db, correlated=correlated)
        for est in per_est:
            errs = np.concatenate(per_est[est]) if per_est[est] else (
                np.asarray([]))
            res = np.concatenate(res_count[est])
            out_rows.append(SeparationResult(
                separation_deg=float(sep), estimator=est,
                crb_deg=crb,
                rmse_deg=float(np.sqrt(np.mean(errs ** 2)))
                if errs.size else float("nan"),
                resolve_prob=float(np.mean(res)),
                num_windows=int(nwin)))
    return out_rows
