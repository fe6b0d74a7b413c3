"""Result reporting (SURVEY §5 observability: the reference's qtgui
pseudospectrum plot, as offline artifacts): matplotlib spectrum/waterfall
plots + a self-contained HTML report.

Port of doa_tpu/utils/report.py: the same figures and HTML from a
DoaResult of the port, its tensors read to the host with ``.cpu()``.
matplotlib is imported when a figure is drawn, not with the module.
"""

from __future__ import annotations

import base64
import html
import io

import numpy as np
import torch


def _np(a) -> np.ndarray:
    """A tensor (any device) or array → numpy."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def spectrum_figure(P, angles=None, title="Pseudospectrum",
                    true_angles=None, window: int = -1):
    """P: (B, G) → matplotlib Figure with the `window`th spectrum (dB)
    and a B×G waterfall."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    P = _np(P)
    B, G = P.shape
    x = np.asarray(angles) if angles is not None else np.arange(G)
    fig, (ax1, ax2) = plt.subplots(2, 1, figsize=(8, 6), sharex=True)
    Pdb = 10 * np.log10(np.maximum(P, 1e-12))
    ax1.plot(x, Pdb[window])
    if true_angles is not None:
        for t in np.atleast_1d(true_angles):
            ax1.axvline(t, color="tab:red", ls="--", lw=1)
    ax1.set_ylabel("P (dB)")
    ax1.set_title(title)
    ax2.imshow(Pdb, aspect="auto", origin="lower",
               extent=[x[0], x[-1], 0, B], cmap="viridis")
    ax2.set_xlabel("angle (deg)")
    ax2.set_ylabel("window")
    fig.tight_layout()
    return fig


def html_report(path: str, result, cfg=None, true_angles=None,
                grid_angles=None):
    """Write a self-contained HTML report for a DoaResult: per-estimator
    spectrum+waterfall plots (inline PNG) and the estimate table."""
    parts = ["<html><head><title>doa_tpu_torch report</title></head><body>",
             "<h1>doa_tpu_torch estimation report</h1>"]
    if cfg is not None:
        parts.append(f"<pre>{html.escape(str(cfg))}</pre>")
    for est, P in result.spectra.items():
        fig = spectrum_figure(_np(P), angles=grid_angles,
                              title=f"{est} pseudospectrum",
                              true_angles=true_angles)
        buf = io.BytesIO()
        fig.savefig(buf, format="png", dpi=110)
        b64 = base64.b64encode(buf.getvalue()).decode()
        parts.append(f"<h2>{est}</h2>"
                     f"<img src='data:image/png;base64,{b64}'/>")
    parts.append("<h2>Estimates (median over windows, deg)</h2><table "
                 "border=1 cellpadding=4><tr><th>estimator</th>"
                 "<th>angles</th></tr>")
    for est, ang in result.peak_angles.items():
        a = _np(ang)
        med = (np.median(np.sort(a, axis=1), axis=0) if a.ndim == 2
               else np.median(a, axis=0))
        parts.append(f"<tr><td>{est}</td>"
                     f"<td>{np.round(med, 3).tolist()}</td></tr>")
    for name in ("root_music_angles", "esprit_angles",
                 "unitary_esprit_angles"):
        arr = getattr(result, name, None)
        if arr is not None:
            med = np.median(_np(arr), axis=0)
            parts.append(f"<tr><td>{name[:-7]}</td>"
                         f"<td>{np.round(med, 3).tolist()}</td></tr>")
    parts.append("</table></body></html>")
    with open(path, "w") as f:
        f.write("\n".join(parts))
    return path
