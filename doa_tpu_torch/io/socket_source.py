"""UDP sample ingest — the stand-in for the reference's UHD 10 GbE link
(twinrx_usrp_source, SURVEY §2.3 P1).

The reference's only "network" is UHD's UDP sample stream from the
X310; here a `UdpSource` binds a datagram socket, reassembles
sequence-numbered packets of interleaved complex64 frames into
fixed-size blocks, and pushes them into a `StreamingDriver` — losses
are detected from sequence-number gaps and accounted like UHD overflow
'O' indications (SURVEY §5 failure detection), never stalling the
receive loop.

Wire format per datagram (little-endian):
    u32 magic 0x44304141 ("D0AA") | u32 num_samples (frames)
    u64 sequence number            | payload: frames × N complex64

A frame is one time-step across all N channels (interleaved c64: the
layout a complex64 (T, N) capture has, which the fused pipeline reads as
it is).

Port of doa_tpu/io/socket_source.py on the port's ``io.native`` framer,
with the same wire format (MAGIC, the ``<IIQ`` header), so a sender of
either package feeds a receiver of the other. The native receive loop
and sender do not fall back: ``NativeUdpSource`` raises if the framer
cannot be built (doa_tpu's takes the Python loop), and so does
``send_capture_udp(native=True)`` (doa_tpu's sends from Python).
"""

from __future__ import annotations

import socket
import struct
import threading
import time
from dataclasses import dataclass, field

import numpy as np

from doa_tpu_torch.io.native import get_lib

MAGIC = 0x44304141
_HDR = struct.Struct("<IIQ")
HEADER_BYTES = _HDR.size


@dataclass
class UdpStats:
    packets_in: int = 0
    packets_lost: int = 0
    bytes_in: int = 0
    blocks_pushed: int = 0
    seq_last: int = field(default=-1)

    @property
    def loss_fraction(self) -> float:
        total = self.packets_in + self.packets_lost
        return self.packets_lost / max(total, 1)


class UdpSource:
    """Receive datagrams on (host, port) and push (block_samples, N)
    complex64 blocks into `sink` (a StreamingDriver or anything with
    .push(block)). Start with .start(); stop() joins the thread."""

    def __init__(self, sink, num_channels: int, block_samples: int,
                 port: int = 0, host: str = "127.0.0.1",
                 rcvbuf: int = 1 << 24):
        self._sink = sink
        self._N = num_channels
        self._block = block_samples
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, rcvbuf)
        self._sock.bind((host, port))
        self._sock.settimeout(0.2)
        self.addr = self._sock.getsockname()
        self.stats = UdpStats()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def start(self):
        self._thread.start()
        return self

    def stop(self, wait: bool = True):
        self._stop.set()
        if wait:
            self._thread.join()
        self._sock.close()

    def _run(self):
        N = self._N
        acc = np.empty((self._block, N), np.complex64)
        fill = 0
        buf = bytearray(1 << 16)
        view = memoryview(buf)
        while not self._stop.is_set():
            try:
                nbytes = self._sock.recv_into(buf)
            except socket.timeout:
                continue
            except OSError:
                break
            if nbytes < HEADER_BYTES:
                continue
            magic, nsamp, seq = _HDR.unpack_from(view, 0)
            if magic != MAGIC:
                continue
            st = self.stats
            if st.seq_last >= 0 and seq > st.seq_last + 1:
                st.packets_lost += int(seq - st.seq_last - 1)
            st.seq_last = max(st.seq_last, int(seq))
            st.packets_in += 1
            st.bytes_in += nbytes
            payload = np.frombuffer(
                view[HEADER_BYTES:HEADER_BYTES + nsamp * N * 8],
                np.complex64).reshape(nsamp, N)
            off = 0
            while off < nsamp:
                take = min(self._block - fill, nsamp - off)
                acc[fill:fill + take] = payload[off:off + take]
                fill += take
                off += take
                if fill == self._block:
                    self._sink.push(acc.copy())
                    st.blocks_pushed += 1
                    fill = 0


class NativeUdpSource(UdpSource):
    """UdpSource with the receive loop in native C++ (GIL-free,
    csrc/framer.cpp::doa_udp_drain): the pure-Python loop tops out
    below the 1.28 GB/s north-star ingest rate on 2 cores; the native
    drain copies payloads straight into a contiguous block buffer and
    does the sequence-gap accounting in C. The framer is built (or
    loaded) here, before the socket is bound: a failed build raises."""

    def __init__(self, *args, **kwargs):
        self._lib = get_lib()
        super().__init__(*args, **kwargs)

    def _run(self):
        import ctypes

        lib = self._lib
        N = self._N
        # Python's settimeout puts the fd in non-blocking mode, which
        # makes the C recv() fail EAGAIN; the native loop polls, so use
        # a plain blocking socket.
        self._sock.settimeout(None)
        block_bytes = self._block * N * 8
        buf = np.empty(block_bytes, np.uint8)
        buf_ptr = buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
        cstats = np.zeros(4, np.int64)
        cstats[3] = -1                        # last_seq carries across
        cstats_ptr = cstats.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))
        fd = self._sock.fileno()
        fill = 0
        while not self._stop.is_set():
            off_ptr = ctypes.cast(
                ctypes.addressof(buf_ptr.contents) + fill,
                ctypes.POINTER(ctypes.c_uint8))
            w = lib.doa_udp_drain(fd, off_ptr, block_bytes - fill,
                                  block_bytes - fill, 200, cstats_ptr)
            if w < 0:
                break
            fill += int(w)
            st = self.stats
            st.packets_in = int(cstats[0])
            st.packets_lost = int(cstats[1])
            st.bytes_in = int(cstats[2])
            st.seq_last = int(cstats[3])
            if fill == block_bytes:
                self._sink.push(
                    buf.view(np.complex64).reshape(self._block, N).copy())
                st.blocks_pushed += 1
                fill = 0


def send_capture_udp(x: np.ndarray, addr, datagram_frames: int = 0,
                     sock: socket.socket | None = None,
                     seq0: int = 0, native: bool = False) -> int:
    """Send a (T, N) complex64 capture as sequence-numbered datagrams to
    `addr`; → next sequence number. Loopback test/sim transmitter (the
    UHD-side stand-in). native=True batches datagrams through the C++
    sendmmsg sender (csrc/framer.cpp::doa_udp_send — 64 datagrams per
    syscall, zero payload copies; a framer that fails to build raises);
    on a host of few cores the Python per-datagram loop is the loopback
    bottleneck, not the receiver."""
    x = np.ascontiguousarray(x.astype(np.complex64, copy=False))
    T, N = x.shape
    if datagram_frames <= 0:
        datagram_frames = max(1, (65507 - HEADER_BYTES) // (N * 8))
    own = sock is None
    if own:
        sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF, 1 << 24)
    seq = seq0
    try:
        if native:
            import ctypes
            lib = get_lib()
            # doa_udp_send uses plain send(): bind the destination
            # once (connect is idempotent for the same addr).
            sock.connect(addr)
            ptr = x.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
            nxt = lib.doa_udp_send(sock.fileno(), ptr, T, N * 8,
                                   datagram_frames, seq0)
            if nxt < 0:
                raise OSError("doa_udp_send failed")
            return int(nxt)
        raw = x.view(np.uint8).reshape(T, N * 8)
        for i in range(0, T, datagram_frames):
            frames = raw[i:i + datagram_frames]
            hdr = _HDR.pack(MAGIC, frames.shape[0], seq)
            sock.sendto(hdr + frames.tobytes(), addr)
            seq += 1
    finally:
        if own:
            sock.close()
    return seq


def loopback_rate_bench(num_channels: int = 16, seconds: float = 0.5,
                        datagram_frames: int = 0, native: bool = False,
                        native_sender: bool = False,
                        target_gbps: float | None = None):
    """Measure achievable loopback UDP ingest rate into a counting sink
    → (GB/s received, loss_fraction, GB/s delivered-as-blocks): a host
    figure (no device involved). The north-star ingest is 1.28 GB/s
    (16 ch × 10 Msps × 8 B); native=True uses the C++ receive loop,
    native_sender=True the C++ sendmmsg transmitter (the composed
    socket → drain → block-assembly chain, both ends native).

    target_gbps paces the transmitter to a fixed offered rate — the
    sustained-ingest experiment. An unpaced sender (native: 24 GB/s)
    just overruns the 16 MB socket buffer and measures kernel drop
    behavior, not the chain's sustainable rate; a real radio offers
    samples at line rate (1.28 GB/s at the north-star operating point),
    so loss at a paced offered rate IS the meaningful failure signal."""

    class _Count:
        def __init__(self):
            self.blocks = 0

        def push(self, block):
            self.blocks += 1
            return True

    sink = _Count()
    cls = NativeUdpSource if native else UdpSource
    block_samples = 1 << 15
    src = cls(sink, num_channels, block_samples=block_samples).start()
    N = num_channels
    chunk = np.zeros((1 << 15, N), np.complex64)
    sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    sock.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF, 1 << 24)
    t0 = time.perf_counter()
    seq = 0
    sent = 0
    while time.perf_counter() - t0 < seconds:
        seq = send_capture_udp(chunk, src.addr, datagram_frames,
                               sock=sock, seq0=seq, native=native_sender)
        sent += chunk.nbytes
        if target_gbps:
            ahead = sent / (target_gbps * 1e9) - (time.perf_counter() - t0)
            if ahead > 0:
                time.sleep(ahead)
    dt = time.perf_counter() - t0
    time.sleep(0.2)
    src.stop()
    sock.close()
    gbps = src.stats.bytes_in / dt / 1e9
    delivered = sink.blocks * block_samples * N * 8 / dt / 1e9
    return gbps, src.stats.loss_fraction, delivered
