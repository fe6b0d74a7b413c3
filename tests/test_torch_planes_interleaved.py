"""call.interleaved on the planes path: a config that smooths (c3) reads
the interleaved float32 capture x[T, 2N] as its two stride-2 planes, in
place, and answers as call(x) does on the same complex64 capture; the
route each pipeline names; the spans doa.gram and doa.smoothing inside
doa.covariance on that path alone. The card's tests (``-m card``) hold kernel 8 through
the stride-2 views of a capture of 2^27 samples, 2^32 floats, and the
entry on the card. This file imports no JAX, so it runs on a machine with
the card and without JAX, from the repository root:

    python -m pytest --noconftest -p no:cacheprovider -m card -q \\
        tests/test_torch_planes_interleaved.py
"""

import dataclasses
import glob
import json

import numpy as np
import pytest
import torch

from doa_tpu_torch import _build
from doa_tpu_torch.configs import PRESETS
from doa_tpu_torch.ops import cpx_ops
from doa_tpu_torch.ops.cuda import covariance as cov
from doa_tpu_torch.pipeline_torch import build_pipeline_torch
from doa_tpu_torch.utils.profiling import trace_to

C3 = PRESETS["c3_ula16_calib_smooth"]
S = 1024


def _capture(N=16, B=6, seed=5):
    """An emitter and its coherent reflection (one tone at two angles,
    independent phases) and a third tone, at 10 dB a element, as a
    complex64 (B·S, N) capture."""
    rng = np.random.default_rng(seed)
    n, k = np.arange(B * S)[:, None], np.arange(N)
    x = sum(np.exp(2j * np.pi * f * n + 1j * rng.uniform(0, 2 * np.pi))
            * np.exp(-1j * np.pi * np.cos(np.deg2rad(th)) * k)
            for th, f in ((40.0, 5 / S), (68.0, 5 / S), (121.0, 9 / S)))
    x = x * np.sqrt(10.0) + (rng.standard_normal(x.shape) + 1j
                             * rng.standard_normal(x.shape)) * np.sqrt(0.5)
    return x.astype(np.complex64)


def _equal(a, b, key="music"):
    for field in ("peak_values", "peak_angles"):
        assert torch.equal(getattr(a, field)[key], getattr(b, field)[key])
    assert torch.equal(a.escalation_flagged, b.escalation_flagged)


PLANES_CONFIGS = {
    "c3": C3,
    "c3_correction": C3,
    "c2_eigh": dataclasses.replace(PRESETS["c2_ula8_2src"],
                                   subspace_method="eigh"),
}


@pytest.mark.parametrize("name", sorted(PLANES_CONFIGS))
def test_the_planes_route_answers_as_call(name):
    """Bit-equal to call(x) on the same complex64 capture, numpy or torch,
    with the default correction and with one passed."""
    cfg = PLANES_CONFIGS[name]
    N = cfg.geometry.num_elements
    x = _capture(N, B=4 if N == 16 else 8)
    c = None
    if name.endswith("correction"):
        rng = np.random.default_rng(2)
        c = (1 + 0.1 * rng.standard_normal(N)) * np.exp(
            0.3j * rng.standard_normal(N))
    pipe = build_pipeline_torch(cfg, device="cpu", return_spectra=False)
    want = pipe(x, c)
    keys = [e.value for e in cfg.estimators]
    for xil in (x.view(np.float32), torch.from_numpy(x.view(np.float32))):
        got = pipe.interleaved(xil, c)
        for key in keys:
            _equal(got, want, key)
    assert pipe.interleaved.route == "planes"


def test_the_planes_route_reads_the_capture_in_place(monkeypatch):
    """Kernel 8's stage gets the two stride-2 views of the caller's
    buffer: xr at its address, xi one float on, row stride 2N, element
    stride 2."""
    x = torch.from_numpy(_capture(B=2).view(np.float32))
    seen = []
    real = cpx_ops.cov_from_stream

    def spy(xr, xi, *a, **k):
        seen.append((xr.data_ptr(), xi.data_ptr(), xr.stride(), xi.stride()))
        return real(xr, xi, *a, **k)
    monkeypatch.setattr(cpx_ops, "cov_from_stream", spy)
    build_pipeline_torch(C3, device="cpu").interleaved(x)
    p = x.data_ptr()
    assert seen == [(p, p + 4, (32, 2), (32, 2))]
    # the ring form's layout on the card: one interleaved buffer
    v = x.view(-1, 16, 2)
    assert cov.planes_layout(v[..., 0], v[..., 1]).layout == "interleaved"


def test_the_route_counter():
    """Each pipeline names its interleaved route, fixed when it is
    built, and call.interleaved answers as call does on the same
    complex64 capture, which takes that route too."""
    fused = dataclasses.replace(PRESETS["c4_ula16_streaming"], overlap=0)
    ula, ura = _capture(B=32), _capture(N=64, B=32)
    for cfg, x, route in ((fused, ula, "fused"), (C3, ula, "planes"),
                          (PRESETS["c5_ura64_wideband"], ura, "wideband")):
        pipe = build_pipeline_torch(cfg, device="cpu", return_spectra=False)
        assert pipe.interleaved.route == route
        got = pipe.interleaved(torch.from_numpy(x.view(np.float32)))
        want = pipe(x)
        for field in ("peak_values", "peak_angles"):
            assert torch.equal(getattr(got, field)["music"],
                               getattr(want, field)["music"])


def test_int8_and_scan_capture_keep_their_checks():
    """cov_dtype="int8" on the planes route is refused when the pipeline
    is built; scan_capture still takes the fused and wideband paths
    alone."""
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        build_pipeline_torch(dataclasses.replace(C3, cov_dtype="int8"),
                             device="cpu")
    pipe = build_pipeline_torch(C3, device="cpu")
    blocks = _capture(B=4).view(np.float32).reshape(2, 2 * S, 32)
    with pytest.raises(ValueError, match="fused path"):
        pipe.scan_capture(blocks)


def _spans(tmp_path, fn):
    with trace_to(str(tmp_path)):
        fn()
    (path,) = glob.glob(str(tmp_path / "trace_*.json"))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                  if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                  and e["name"].startswith("doa."))


def _inside(s, outer):
    return outer[0] <= s[0] and s[1] <= outer[1]


def test_the_planes_spans_nest_in_the_covariance(tmp_path):
    """doa.gram then doa.smoothing, once each inside the call's one
    doa.covariance; the subspace and scan after it."""
    x = torch.from_numpy(_capture(B=2).view(np.float32))
    pipe = build_pipeline_torch(C3, device="cpu", return_spectra=False)
    spans = _spans(tmp_path, lambda: pipe.interleaved(x))
    (cov_span,) = [s for s in spans if s[2] == "doa.covariance"]
    (gram,) = [s for s in spans if s[2] == "doa.gram"]
    (smooth,) = [s for s in spans if s[2] == "doa.smoothing"]
    assert _inside(gram, cov_span) and _inside(smooth, cov_span)
    assert gram[1] <= smooth[0]
    assert {"doa.call", "doa.ingest", "doa.subspace", "doa.scan"} <= {
        s[2] for s in spans}


@pytest.mark.parametrize("name", ["fused", "wideband"])
def test_the_planes_spans_never_open_off_the_planes_path(tmp_path, name):
    if name == "fused":
        cfg = dataclasses.replace(PRESETS["c4_ula16_streaming"], overlap=0)
        x = torch.from_numpy(_capture(B=32).view(np.float32))
    else:
        cfg = PRESETS["c5_ura64_wideband"]
        x = torch.from_numpy(_capture(N=64, B=32).view(np.float32))
    pipe = build_pipeline_torch(cfg, device="cpu", return_spectra=False)
    names = {s[2] for s in _spans(tmp_path, lambda: pipe.interleaved(x))}
    assert "doa.call" in names
    assert not names & {"doa.gram", "doa.smoothing"}, names


# ---------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


@pytest.mark.card
def test_kernel8_through_stride2_views_past_2_31_floats(dev):
    """Kernel 8's ring form on the two stride-2 views of a capture of 2^27
    samples of 16 elements (2^32 floats, 17.2 GB; rows past 2^26 lie past
    2^31 floats): the chunks at the start, on both sides of that row and at
    the end are bit-equal to kernel 8 on a copy of their rows alone, and
    within float32 rounding of the float64 Gram."""
    T, N, g = 1 << 27, 16, S
    gen = torch.Generator(device=dev).manual_seed(27)
    x = torch.randn((T, 2 * N), generator=gen, device=dev)
    v = x.view(T, N, 2)
    with _build.counting() as launched:
        rr, ri = cov.chunk_grams(v[..., 0], v[..., 1], g)
    assert launched == {("planes_chunk_gram", "ring_interleaved"): 1}
    n = T // g
    assert rr.shape == (n, N, N)
    edge = (1 << 31) // (2 * N) // g               # the chunk at 2^31 floats
    for c in (0, 1, edge - 1, edge, edge + 1, n - 2, n - 1):
        part = x[c * g:(c + 1) * g].clone().view(g, N, 2)
        pr, pi = cov.chunk_grams(part[..., 0], part[..., 1], g)
        assert torch.equal(rr[c], pr[0]) and torch.equal(ri[c], pi[0]), c
        z = part.double()
        zc = torch.complex(z[..., 0], z[..., 1])
        R = zc.transpose(0, 1) @ zc.conj()
        scale = float(R.abs().max())
        torch.testing.assert_close(rr[c].double(), R.real, rtol=0,
                                   atol=1e-5 * scale)
        torch.testing.assert_close(ri[c].double(), R.imag, rtol=0,
                                   atol=1e-5 * scale)


@pytest.mark.card
def test_the_planes_route_on_the_card(dev):
    """On the card: bit-equal to call(x) on the same complex64 capture,
    kernel 8's ring form on the buffer's own views, on the "planes"
    route."""
    x = _capture(B=64)
    pipe = build_pipeline_torch(C3, device=dev, return_spectra=False)
    want = pipe(x)
    xd = torch.from_numpy(x.view(np.float32)).to(dev)
    with _build.counting() as n:
        got = pipe.interleaved(xd)
    _equal(got, want)
    assert {f: v for (k, f), v in n.items() if k == "planes_chunk_gram"} == {
        "ring_interleaved": 1}
    assert pipe.interleaved.route == "planes"
