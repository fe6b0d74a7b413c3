"""Port parity of the host ingest: doa_tpu_torch.io (synthetic, recorded,
native framer, streaming driver, UDP source) against doa_tpu.io on the
same numpy inputs, on the CPU."""

import queue
import time

import numpy as np
import pytest

from doa_tpu.configs import PRESETS
from doa_tpu.io import recorded as rec_jax
from doa_tpu.io import socket_source as sock_jax
from doa_tpu.io import synthetic as syn_jax
from doa_tpu.io.stream import StreamingDriver as StreamingDriverJax
from doa_tpu.pipeline import build_pipeline as build_pipeline_jax
from doa_tpu_torch.io import native, recorded, socket_source, synthetic
from doa_tpu_torch.io.stream import StreamingDriver, iterate_file_blocks
from doa_tpu_torch.pipeline import build_pipeline
from doa_tpu_torch.pipeline_torch import build_pipeline_torch

_SRCS = (dict(theta_deg=55.0, freq_norm=0.1),
         dict(theta_deg=125.0, freq_norm=0.3, amplitude=0.7))
_PLANAR = (dict(az_deg=-20.0, el_deg=30.0, freq_norm=0.1),
           dict(az_deg=35.0, el_deg=60.0, freq_norm=0.27))
_WB = (dict(theta_deg=62.0, freq_norm=0.0, bandwidth_norm=0.5),
       dict(theta_deg=111.0, freq_norm=0.0, bandwidth_norm=0.5))


def _specs(mod, srcs):
    return [mod.SourceSpec(**s) for s in srcs]


_GENERATORS = {
    "ula": lambda m: m.synth_ula_iq(
        _specs(m, _SRCS), 6, 0.5, 512, snr_db=7, seed=4,
        correlated_pairs=[(0, 1)], channel_gains=np.linspace(0.8, 1.2, 6),
        channel_phases=np.linspace(-0.5, 0.5, 6)),
    "moving_ula": lambda m: m.synth_moving_ula_iq(
        [(50.0, 80.0), (130.0, 100.0)], 8, 0.5, 1024, snr_db=10, seed=5),
    "wideband_ula": lambda m: m.synth_wideband_ula_iq(
        _specs(m, _WB), 8, 0.5, 1024, fractional_bw=0.1, snr_db=15, seed=3),
    "ura": lambda m: m.synth_ura_iq(
        _specs(m, _PLANAR), (4, 3), 0.5, 256, snr_db=12, seed=6),
    "wideband_ura": lambda m: m.synth_wideband_ura_iq(
        [m.SourceSpec(az_deg=-20.0, el_deg=30.0, bandwidth_norm=0.5),
         m.SourceSpec(az_deg=35.0, el_deg=60.0, bandwidth_norm=0.5)],
        (4, 4), 0.5, 1024, fractional_bw=0.2, snr_db=10, seed=7),
}


@pytest.mark.parametrize("name", list(_GENERATORS))
def test_synthetic_generators_equal_the_reference(name):
    """io.synthetic is a copy: one seed gives the same arrays, bit for
    bit, in both packages."""
    got = _GENERATORS[name](synthetic)
    want = _GENERATORS[name](syn_jax)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("ext", [".npz", ".c64"])
@pytest.mark.parametrize("writer", ["port", "reference"])
def test_recorded_files_cross_load(tmp_path, ext, writer):
    """A capture written by either package (.npz with its metadata, raw
    .c64 with its .json sidecar) loads in the other, equal; raw files
    without a sidecar take num_channels."""
    x = synthetic.synth_ula_iq(_specs(synthetic, _SRCS), 5, 0.5, 300, seed=2)
    path = str(tmp_path / f"cap{ext}")
    save, load = ((recorded.save_iq, rec_jax.load_iq) if writer == "port"
                  else (rec_jax.save_iq, recorded.load_iq))
    save(path, x, samp_rate=2e6, metadata={"preset": "c2"})
    np.testing.assert_array_equal(load(path), x)
    if ext == ".c64":
        np.testing.assert_array_equal(
            recorded.load_iq(path, num_channels=5), x)
        chans = []
        for n in range(5):
            p = str(tmp_path / f"ch{n}.c64")
            np.ascontiguousarray(x[: 300 - n, n]).tofile(p)
            chans.append(p)
        np.testing.assert_array_equal(recorded.load_iq_channels(chans),
                                      rec_jax.load_iq_channels(chans))


def test_framer_matches_numpy():
    """The C++ framer (csrc/framer.cpp, built with g++): split, merge and
    the overlap-aware framing equal numpy exactly, threaded or not."""
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((70000, 3))
         + 1j * rng.standard_normal((70000, 3))).astype(np.complex64)
    for threads in (1, 4):
        re, im = native.split_c64(x, threads)
        np.testing.assert_array_equal(re, x.real)
        np.testing.assert_array_equal(im, x.imag)
        np.testing.assert_array_equal(native.merge_c64(re, im, threads), x)
    tail, block = x[:100], x[100:40100]
    re, im = native.frame_block(tail, block)
    both = np.concatenate([tail, block])
    np.testing.assert_array_equal(re, both.real)
    np.testing.assert_array_equal(im, both.imag)
    re, im = native.frame_block(None, block)
    np.testing.assert_array_equal(re + 1j * im, block)


def test_framer_build_failure_raises(tmp_path, monkeypatch):
    """A framer source that does not compile raises RuntimeError with the
    compiler's output; nothing falls back to numpy."""
    bad = tmp_path / "framer.cpp"
    bad.write_text('extern "C" int doa_split_c64( { this is not C++\n')
    monkeypatch.setattr(native, "_SRC", str(bad))
    monkeypatch.setattr(native, "_LIB", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.split_c64(np.zeros((4, 2), np.complex64))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        socket_source.NativeUdpSource(_Capture(), num_channels=2,
                                      block_samples=64)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        socket_source.send_capture_udp(np.zeros((4, 2), np.complex64),
                                       ("127.0.0.1", 9), native=True)


def _c4_capture(T):
    return synthetic.synth_ula_iq(
        [synthetic.SourceSpec(theta_deg=55.0),
         synthetic.SourceSpec(theta_deg=125.0, freq_norm=0.3)],
        16, 0.5, T, snr_db=10, seed=3)


@pytest.fixture(scope="module")
def c4_offline():
    """c4 on 16384 samples: the reference's complex pipeline and the
    port's fast pipeline on the CPU, offline."""
    x = _c4_capture(16384)
    ref = np.asarray(build_pipeline_jax(PRESETS["c4_ula16_streaming"])(x)
                     .peak_angles["music"])
    pipe = build_pipeline_torch(PRESETS["c4_ula16_streaming"], device="cpu")
    return x, ref, pipe, pipe(x).peak_angles["music"].numpy()


def test_run_iter_matches_offline(c4_offline, tmp_path):
    """run_iter on the port's fast pipeline and on its complex pipeline
    (the overlap carried over block to block) equals the offline call
    within 0.01°, and the reference's offline angles; the file reader
    gives the same blocks."""
    x, ref, pipe, offline = c4_offline
    np.testing.assert_allclose(np.sort(offline, 1), np.sort(ref, 1),
                               atol=0.01)
    path = str(tmp_path / "c4.npz")
    recorded.save_iq(path, x)
    for p in (pipe, build_pipeline(PRESETS["c4_ula16_streaming"],
                                   device="cpu")):
        drv = StreamingDriver(p, block_samples=4096)
        streamed = np.concatenate(
            [r.peak_angles["music"].numpy()
             for _, r in drv.run_iter(iterate_file_blocks(path, 4096))])
        assert streamed.shape == offline.shape
        np.testing.assert_allclose(np.sort(streamed, 1),
                                   np.sort(offline, 1), atol=0.01)
        assert drv.stats.blocks_processed == drv.stats.blocks_in == 4
        assert drv.stats.samples_processed == 16384


def test_threaded_driver_matches_offline_and_counts(c4_offline):
    """The threaded driver: every block pushed is processed or dropped
    and counted, results come in block order, escalation counts are
    summed; with a ring that holds every block, the streamed windows
    equal the offline call within 0.01° and the reference's driver gives
    the same counts."""
    x, _, pipe, offline = c4_offline
    for ring, drv_cls in ((8, StreamingDriver), (8, StreamingDriverJax)):
        drv = drv_cls(pipe, block_samples=2048, ring_capacity=ring,
                      max_in_flight=3)
        for j in range(0, 16384, 2048):
            drv.push(x[j:j + 2048])
        drv.start()
        drv.stop(wait=True)
        out = [drv.results.get_nowait() for _ in range(drv.results.qsize())]
        assert [i for i, _ in out] == list(range(8))
        assert drv.stats.blocks_processed == 8
        assert drv.stats.blocks_dropped == 0
        assert drv.stats.windows_emitted == offline.shape[0]
        got = np.concatenate([r.peak_angles["music"].numpy()
                              for _, r in out])
        np.testing.assert_allclose(np.sort(got, 1), np.sort(offline, 1),
                                   atol=0.01)
        assert drv.stats.windows_escalated == sum(
            int(r.escalation_flagged) for _, r in out)
    drv = StreamingDriver(pipe, block_samples=1024, ring_capacity=2).start()
    for j in range(0, 8192, 1024):
        drv.push(x[j:j + 1024])
    drv.stop(wait=True)
    assert drv.stats.blocks_in == 8
    assert (drv.stats.blocks_processed + drv.stats.blocks_dropped
            == drv.stats.blocks_in)
    got = 0
    while True:
        try:
            drv.results.get_nowait()
            got += 1
        except queue.Empty:
            break
    assert got == drv.stats.blocks_processed


class _Capture:
    def __init__(self):
        self.blocks = []

    def push(self, b):
        self.blocks.append(b)
        return True


def _drain(drv, n, seconds=20):
    deadline = time.time() + seconds
    out = []
    while len(out) < n and time.time() < deadline:
        try:
            out.append(drv.results.get(timeout=0.5))
        except queue.Empty:
            pass
    return out


@pytest.mark.parametrize("receiver", ["python", "native"])
def test_udp_to_port_pipeline_end_to_end(receiver):
    """Loopback UDP → the port's UdpSource / NativeUdpSource → driver →
    the port's pipeline on the CPU: no packet lost, the blocks equal the
    capture, the angles within 1° of the tone; the Python sender feeds
    the native receiver."""
    cls = {"python": socket_source.UdpSource,
           "native": socket_source.NativeUdpSource}[receiver]
    pipe = build_pipeline_torch(PRESETS["c1_ula4_tone"], device="cpu")
    drv = StreamingDriver(pipe, block_samples=8 * 256).start()
    src = cls(drv, num_channels=4, block_samples=8 * 256).start()
    x = synthetic.synth_ula_iq([synthetic.SourceSpec(theta_deg=64.0)], 4,
                               0.5, 32 * 256, snr_db=15, seed=5)
    socket_source.send_capture_udp(x, src.addr, datagram_frames=500)
    results = _drain(drv, 4)
    src.stop()
    drv.stop()
    assert len(results) == 4, f"stats: {src.stats} {drv.stats}"
    assert src.stats.packets_lost == 0 and src.stats.blocks_pushed == 4
    angles = np.concatenate([r.peak_angles["music"].numpy().ravel()
                             for _, r in results])
    np.testing.assert_allclose(angles, 64.0, atol=1.0)


@pytest.mark.parametrize("sender", ["port", "port_native", "reference"])
@pytest.mark.parametrize("receiver", ["python", "native"])
def test_udp_wire_format_across_packages(sender, receiver):
    """Either package's sender (the port's Python and native senders,
    doa_tpu's Python sender) feeds the port's receivers: the same
    sequence numbering and payload bytes, zero loss."""
    send = {"port": socket_source.send_capture_udp,
            "port_native": lambda *a, **k: socket_source.send_capture_udp(
                *a, native=True, **k),
            "reference": sock_jax.send_capture_udp}[sender]
    cls = {"python": socket_source.UdpSource,
           "native": socket_source.NativeUdpSource}[receiver]
    sink = _Capture()
    src = cls(sink, num_channels=4, block_samples=512).start()
    rng = np.random.default_rng(11)
    x = (rng.standard_normal((2048, 4))
         + 1j * rng.standard_normal((2048, 4))).astype(np.complex64)
    nxt = send(x, src.addr, datagram_frames=100)
    assert nxt == -(-2048 // 100)
    deadline = time.time() + 10
    while len(sink.blocks) < 4 and time.time() < deadline:
        time.sleep(0.05)
    src.stop()
    assert src.stats.packets_lost == 0 and src.stats.packets_in == nxt
    np.testing.assert_array_equal(np.concatenate(sink.blocks), x)


@pytest.mark.parametrize("receiver", ["python", "native"])
def test_udp_sequence_gap_detection(receiver):
    """Two skipped sequence numbers count as two lost packets."""
    cls = {"python": socket_source.UdpSource,
           "native": socket_source.NativeUdpSource}[receiver]
    src = cls(_Capture(), num_channels=4, block_samples=1024).start()
    x = np.zeros((500, 4), np.complex64)
    seq = socket_source.send_capture_udp(x, src.addr, datagram_frames=100)
    socket_source.send_capture_udp(x, src.addr, datagram_frames=100,
                                   seq0=seq + 2)
    time.sleep(0.3)
    src.stop()
    assert src.stats.packets_lost == 2
    assert src.stats.packets_in == 10


def test_loopback_rate_bench_runs():
    """loopback_rate_bench returns (GB/s in, loss, GB/s delivered): a
    host figure; only its shape is checked here."""
    gbps, loss, delivered = socket_source.loopback_rate_bench(
        num_channels=4, seconds=0.1, native=True, native_sender=True,
        target_gbps=0.05)
    assert gbps > 0 and 0.0 <= loss <= 1.0 and delivered >= 0.0
