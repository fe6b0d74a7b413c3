"""Command-line apps — the reference's `apps/*.grc` flowgraphs as CLI
subcommands (SURVEY §2.4 B3–B5):

  simulate            synthetic multi-channel IQ capture → file (B3)
  estimate            recorded IQ → DoA estimates (B5: estimate_DoA_*)
  calibrate-phase     stage-1 receiver-chain phase offsets (B4)
  calibrate-elements  stage-2 antenna element calibration (B4)
  evaluate            Monte-Carlo RMSE / resolution against SNR
  track               streaming estimate + moving-emitter tracks (config 4)

`python -m doa_tpu_torch <cmd> --help` for each command's parameters.
Every command takes `--device`: "cuda" (the card, the default) or "cpu".
A missing card raises; nothing falls back to the CPU.

Port of doa_tpu/cli.py: the same commands, arguments and JSON lines, on
the port's pipeline (build_pipeline_torch), calibration, tracker and
evaluation. Results stay on the device until the output reads them.
"""

from __future__ import annotations

import argparse
import dataclasses
import json

import numpy as np
import torch

from doa_tpu_torch.cpx import checked_device


def _add_common(p):
    p.add_argument("--preset", default="c1_ula4_tone",
                   help="config preset name (see "
                        "doa_tpu_torch.configs.PRESETS)")
    p.add_argument("--elements", type=int, default=0,
                   help="override number of array elements")
    p.add_argument("--snapshot", type=int, default=0,
                   help="override snapshot size")
    p.add_argument("--scan-mode", default=None,
                   choices=["dense", "hierarchical", "pallas"],
                   help="MUSIC scan strategy override (\"pallas\": the "
                        "scan kernels)")
    p.add_argument("--cov-impl", default=None,
                   choices=["auto", "xla", "pallas"],
                   help="covariance kernel override (kept for doa_tpu's "
                        "configs; the port plans its kernels itself)")
    p.add_argument("--subspace", default=None,
                   choices=["power", "eigh", "jacobi"],
                   help="signal-subspace method override")
    p.add_argument("--subspace-check", action="store_true",
                   help="enable the power-iteration guard "
                        "(residual/orthonormality/capture-gap + eigh "
                        "fallback)")
    p.add_argument("--num-sources", default=None,
                   help="override K, or 'auto' (MDL on the capture's "
                        "leading windows' covariance eigenvalues — "
                        "ops/model_order.py)")
    p.add_argument("--power-schedule", default=None,
                   choices=["e1", "e2", "e4"],
                   help="power-iteration squaring schedule: speed vs "
                        "source-imbalance robustness (configs.DoaConfig)")
    p.add_argument("--wideband-fusion", default=None,
                   choices=["incoherent", "cssm", "cssm_auto", "tops"],
                   help="wideband subband fusion: incoherent spectrum "
                        "mean, coherent CSSM focusing (grid-free "
                        "wideband estimators; cssm_auto picks focusing "
                        "directions at runtime), or focusing-free TOPS")


def _config(args):
    from doa_tpu_torch.configs import PRESETS

    cfg = PRESETS[args.preset]
    if getattr(args, "elements", 0):
        cfg = dataclasses.replace(
            cfg, geometry=dataclasses.replace(
                cfg.geometry, num_elements=args.elements))
    if getattr(args, "snapshot", 0):
        cfg = dataclasses.replace(cfg, snapshot_size=args.snapshot)
    if getattr(args, "scan_mode", None):
        cfg = dataclasses.replace(cfg, scan_mode=args.scan_mode)
    if getattr(args, "cov_impl", None):
        cfg = dataclasses.replace(cfg, cov_impl=args.cov_impl)
    if getattr(args, "subspace", None):
        cfg = dataclasses.replace(cfg, subspace_method=args.subspace)
    if getattr(args, "subspace_check", False):
        cfg = dataclasses.replace(cfg, subspace_check=True)
    if getattr(args, "power_schedule", None):
        cfg = dataclasses.replace(cfg,
                                  power_schedule=args.power_schedule)
    if getattr(args, "wideband_fusion", None):
        cfg = dataclasses.replace(cfg, wideband=dataclasses.replace(
            cfg.wideband, fusion=args.wideband_fusion))
    ns = getattr(args, "num_sources", None)
    if ns and ns != "auto":
        cfg = dataclasses.replace(cfg, num_sources=int(ns))
    return cfg


def _on(x: np.ndarray, dev) -> torch.Tensor:
    """A numpy complex capture → complex64 on the device."""
    return torch.from_numpy(
        np.ascontiguousarray(x, dtype=np.complex64)).to(dev)


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _auto_num_sources(cfg, x, dev, criterion: str = "mdl",
                      max_windows: int = 32):
    """Estimate K from the capture's first windows (AIC/MDL on the
    sample-covariance eigenvalues — ops/model_order.py) on the device,
    and return the config rebuilt with it. K sets the pipeline's shapes,
    so this runs BEFORE the pipeline is built (the reference's
    num_targets is a block constructor arg for the same reason — SURVEY
    §2.1 C2)."""
    from doa_tpu_torch.ops.covariance import cov_from_stream
    from doa_tpu_torch.ops.model_order import estimate_num_sources

    S = cfg.snapshot_size
    T = min(x.shape[0], max_windows * S)
    R = cov_from_stream(_on(x[:T], dev), S, 0)
    k = estimate_num_sources(R.real, R.imag, S, criterion=criterion)
    k_med = max(1, int(np.median(_host(k))))
    return dataclasses.replace(cfg, num_sources=k_med), k_med


def cmd_simulate(args, dev):
    from doa_tpu_torch.io import (SourceSpec, save_iq, synth_ula_iq,
                                  synth_ura_iq)

    cfg = _config(args)
    angles = [float(a) for a in args.angles.split(",")]
    sources = []
    for i, a in enumerate(angles):
        if cfg.geometry.kind == "ura":
            el = [float(e) for e in (args.elevations or "45").split(",")]
            sources.append(SourceSpec(az_deg=a,
                                      el_deg=el[min(i, len(el) - 1)],
                                      freq_norm=0.05 + 0.07 * i))
        else:
            sources.append(SourceSpec(theta_deg=a, freq_norm=0.05 + 0.07 * i))
    n = cfg.geometry.num_elements
    if cfg.geometry.kind == "ura":
        x = synth_ura_iq(sources, cfg.geometry.shape,
                         cfg.geometry.norm_spacing, args.samples,
                         snr_db=args.snr, seed=args.seed)
    else:
        x = synth_ula_iq(sources, n, cfg.geometry.norm_spacing,
                         args.samples, snr_db=args.snr, seed=args.seed)
    save_iq(args.out, x, samp_rate=args.samp_rate,
            metadata={"true_angles_deg": angles, "preset": args.preset})
    print(json.dumps({"written": args.out, "shape": list(x.shape),
                      "true_angles_deg": angles}))


_GRID_FREE = (("root_music_angles", "root_music"),
              ("esprit_angles", "esprit"),
              ("unitary_esprit_angles", "unitary_esprit"))


def cmd_estimate(args, dev):
    from doa_tpu_torch.calib import load_calibration
    from doa_tpu_torch.io import load_iq
    from doa_tpu_torch.pipeline_torch import build_pipeline_torch

    cfg = _config(args)
    x = load_iq(args.input)
    corr = None
    if args.calib:
        corr = load_calibration(args.calib).correction_vector()
    auto_k = None
    if getattr(args, "num_sources", None) == "auto":
        cfg, auto_k = _auto_num_sources(cfg, x, dev)
    res = build_pipeline_torch(cfg, device=dev)(x, correction=corr)
    out = {}
    if auto_k is not None:
        out["num_sources_auto"] = auto_k
    for est, ang in res.peak_angles.items():
        a = _host(ang)
        # Peak ORDER is by spectrum value and varies per window; sort each
        # window's angles before aggregating across windows.
        if a.ndim == 3:  # 2-D scans: (B, k, 2) az/el — sort by azimuth
            order = np.argsort(a[..., 0], axis=1)
            a = np.take_along_axis(a, order[..., None], axis=1)
        else:
            a = np.sort(a, axis=1)
        out[est] = {
            "windows": int(a.shape[0]),
            "median_angles_deg": np.round(
                np.median(a, axis=0), 3).tolist(),
        }
    for key, name in _GRID_FREE:
        a = getattr(res, key)
        if a is not None:
            out[name] = {"median_angles_deg": np.round(
                np.median(_host(a), axis=0), 3).tolist()}
    if args.spectra_out:
        np.savez(args.spectra_out,
                 **{k: _host(v) for k, v in res.spectra.items()})
        out["spectra_written"] = args.spectra_out
    if args.report:
        from doa_tpu_torch.ops.steering import grid_angles_1d
        from doa_tpu_torch.utils.report import html_report

        grid = (grid_angles_1d(cfg.grid)
                if cfg.geometry.kind == "ula" else None)
        html_report(args.report, res, cfg=cfg, grid_angles=grid)
        out["report_written"] = args.report
    print(json.dumps(out))


def cmd_calibrate_phase(args, dev):
    from doa_tpu_torch.calib import (
        CalibrationArtifact, phase_offset_est, save_calibration)
    from doa_tpu_torch.io import load_iq

    x = load_iq(args.input)
    phi = _host(phase_offset_est(_on(x, dev)))
    art = CalibrationArtifact(
        phase_offsets=phi, num_elements=x.shape[1],
        norm_spacing=args.spacing)
    save_calibration(args.out, art)
    print(json.dumps({"written": args.out,
                      "phase_offsets_rad": np.round(phi, 4).tolist()}))


def cmd_calibrate_elements(args, dev):
    from doa_tpu_torch.calib import (
        CalibrationArtifact, average_corrections, element_calibration,
        load_calibration, save_calibration)
    from doa_tpu_torch.io import load_iq
    from doa_tpu_torch.ops import frame_samples, sample_covariance

    x = load_iq(args.input)
    phi = None
    if args.phase_calib:
        prev = load_calibration(args.phase_calib)
        phi = prev.phase_offsets
        if phi is not None:
            x = x * np.exp(-1j * phi)[None, :]
    R = sample_covariance(frame_samples(_on(x, dev), args.snapshot, 0))
    c = element_calibration(R, args.pilot, args.spacing)
    c_avg = _host(average_corrections(c))
    art = CalibrationArtifact(
        phase_offsets=phi, element_corrections=c_avg,
        num_elements=x.shape[1], norm_spacing=args.spacing,
        pilot_theta_deg=args.pilot)
    save_calibration(args.out, art)
    print(json.dumps({
        "written": args.out,
        "gains": np.round(np.abs(c_avg), 4).tolist(),
        "phases_rad": np.round(np.angle(c_avg), 4).tolist()}))


def cmd_evaluate(args, dev):
    from doa_tpu_torch.eval import evaluate_ula

    cfg = _config(args)
    truth = [float(a) for a in args.angles.split(",")]
    snrs = [float(s) for s in args.snrs.split(",")]
    results = evaluate_ula(cfg, truth, snrs, trials=args.trials,
                           windows_per_trial=args.windows, device=dev)
    for r in results:
        print(json.dumps(r.to_dict()))


def cmd_track(args, dev):
    from doa_tpu_torch.io import load_iq
    from doa_tpu_torch.pipeline_torch import build_pipeline_torch
    from doa_tpu_torch.tracking import TrackerConfig, track_batch

    cfg = _config(args)
    x = load_iq(args.input)
    res = build_pipeline_torch(cfg, device=dev)(x)
    est = next(iter(res.peak_angles))
    # the peaks stay on the device into the tracker; only its tracks
    # come to the host
    _, tracks = track_batch(res.peak_angles[est], res.peak_values[est],
                            TrackerConfig(max_tracks=args.max_tracks))
    tracks = _host(tracks)
    active = ~np.all(np.isnan(tracks), axis=0)
    print(json.dumps({
        "windows": int(tracks.shape[0]),
        "active_tracks": int(active.sum()),
        "final_track_angles_deg": [
            None if np.isnan(v) else round(float(v), 2)
            for v in tracks[-1]],
    }))


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="doa_tpu_torch", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    # every command takes --device, after its name
    dev_arg = argparse.ArgumentParser(add_help=False)
    dev_arg.add_argument("--device", default="cuda",
                         help="torch device: cuda (the card, the default; "
                              "none present raises) or cpu")
    sub = p.add_subparsers(dest="cmd", required=True)

    def command(name, **kw):
        return sub.add_parser(name, parents=[dev_arg], **kw)

    ps = command("simulate", help="synthesize a multi-channel capture")
    _add_common(ps)
    ps.add_argument("--angles", default="72.0",
                    help="comma-separated true source angles (deg)")
    ps.add_argument("--elevations", default=None,
                    help="comma-separated elevations for planar arrays")
    ps.add_argument("--samples", type=int, default=1 << 16)
    ps.add_argument("--snr", type=float, default=10.0)
    ps.add_argument("--samp-rate", type=float, default=1e6)
    ps.add_argument("--seed", type=int, default=0)
    ps.add_argument("--out", required=True)
    ps.set_defaults(fn=cmd_simulate)

    pe = command("estimate", help="estimate DoA from recorded IQ")
    _add_common(pe)
    pe.add_argument("--input", required=True)
    pe.add_argument("--calib", default=None,
                    help="calibration artifact (.npz) to apply")
    pe.add_argument("--spectra-out", default=None)
    pe.add_argument("--report", default=None,
                    help="write a self-contained HTML report (plots + table)")
    pe.set_defaults(fn=cmd_estimate)

    pp = command("calibrate-phase",
                 help="stage 1: receiver-chain phase offsets")
    pp.add_argument("--input", required=True,
                    help="common-tone capture (all chains cabled together)")
    pp.add_argument("--spacing", type=float, default=0.5)
    pp.add_argument("--out", required=True)
    pp.set_defaults(fn=cmd_calibrate_phase)

    pc = command("calibrate-elements",
                 help="stage 2: antenna element gain/phase")
    pc.add_argument("--input", required=True,
                    help="pilot-tone capture at a known angle")
    pc.add_argument("--pilot", type=float, required=True,
                    help="pilot angle (deg)")
    pc.add_argument("--spacing", type=float, default=0.5)
    pc.add_argument("--snapshot", type=int, default=1024)
    pc.add_argument("--phase-calib", default=None,
                    help="stage-1 artifact to apply first")
    pc.add_argument("--out", required=True)
    pc.set_defaults(fn=cmd_calibrate_elements)

    pv = command("evaluate", help="Monte-Carlo RMSE/resolution vs SNR")
    _add_common(pv)
    pv.add_argument("--angles", default="60,110")
    pv.add_argument("--snrs", default="0,5,10,20")
    pv.add_argument("--trials", type=int, default=4)
    pv.add_argument("--windows", type=int, default=8)
    pv.set_defaults(fn=cmd_evaluate)

    pt = command("track", help="estimate + track moving emitters")
    _add_common(pt)
    pt.add_argument("--input", required=True)
    pt.add_argument("--max-tracks", type=int, default=4)
    pt.set_defaults(fn=cmd_track)

    args = p.parse_args(argv)
    args.fn(args, checked_device(args.device))


if __name__ == "__main__":
    main()
