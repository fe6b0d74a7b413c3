// Host-side ingest framer: the one genuinely native-hot path of the
// framework (SURVEY §7.1). At the north-star operating point the host
// must deinterleave ≥1.28 GB/s of complex64 multichannel IQ into the
// f32 re/im planes the TPU pipeline consumes; numpy's .real/.imag copies
// make two extra passes and fight the GIL. This library does the
// split (+ optional overlap-tail prepend) in one multithreaded pass.
//
// Exposed via a C ABI for ctypes (no pybind11 in the image).
//
// Reference analog: the GNU Radio runtime's ring-buffer/ingest layer and
// the fork's host↔accelerator FIFO marshalling (SURVEY §2.2 F3).
//
// The port's copy of doa_tpu's native/framer.cpp, built by
// doa_tpu_torch/io/native.py; it differs in doa_udp_drain (a datagram
// that straddles two blocks is split between them, below).

#include <cerrno>
#include <cstdint>
#include <cstring>
#include <functional>
#include <thread>
#include <vector>

#include <poll.h>
#include <sys/socket.h>
#include <sys/uio.h>

namespace {

void parallel_for(int64_t n, int threads,
                  const std::function<void(int64_t, int64_t)>& fn) {
  if (threads <= 1 || n < (1 << 16)) {
    fn(0, n);
    return;
  }
  std::vector<std::thread> pool;
  int64_t chunk = (n + threads - 1) / threads;
  for (int t = 0; t < threads; ++t) {
    int64_t begin = t * chunk;
    int64_t end = begin + chunk > n ? n : begin + chunk;
    if (begin >= end) break;
    pool.emplace_back([&fn, begin, end] { fn(begin, end); });
  }
  for (auto& th : pool) th.join();
}

}  // namespace

extern "C" {

// src: n interleaved complex64 values (2n floats) → planar re/im.
void doa_split_c64(const float* src, float* re, float* im, int64_t n,
                   int threads) {
  parallel_for(n, threads, [=](int64_t begin, int64_t end) {
    const float* p = src + 2 * begin;
    for (int64_t i = begin; i < end; ++i) {
      re[i] = p[0];
      im[i] = p[1];
      p += 2;
    }
  });
}

// Inverse: planar → interleaved (for writing recorded-IQ output).
void doa_merge_c64(const float* re, const float* im, float* dst, int64_t n,
                   int threads) {
  parallel_for(n, threads, [=](int64_t begin, int64_t end) {
    float* p = dst + 2 * begin;
    for (int64_t i = begin; i < end; ++i) {
      p[0] = re[i];
      p[1] = im[i];
      p += 2;
    }
  });
}

// Overlap-aware block framing: writes [tail ; block] split into planes.
//   tail:   overlap*nch complex64 (previous block's trailing samples)
//   block:  t*nch complex64 (new samples)
//   re/im:  (overlap + t)*nch floats each
// Returns complex samples written per plane.
int64_t doa_frame_block(const float* tail, int64_t overlap,
                        const float* block, int64_t t, int64_t nch,
                        float* re, float* im, int threads) {
  int64_t head = overlap * nch;
  if (head > 0) doa_split_c64(tail, re, im, head, threads);
  doa_split_c64(block, re + head, im + head, t * nch, threads);
  return head + t * nch;
}

// GIL-free UDP drain for the sample-ingest source (io/socket_source
// wire format: 16-byte header {u32 magic, u32 nsamp, u64 seq} +
// nsamp·nch complex64 payload). The pure-Python receive loop tops out
// well under the 1.28 GB/s north-star ingest rate on a host of few
// cores; this loop runs entirely outside the GIL (ctypes releases it
// for the whole call), copying payloads contiguously into `out`.
//
//   fd          bound datagram socket (Python owns/creates it)
//   out         payload destination, `capacity` bytes
//   want_bytes  return once at least this much payload has landed
//   idle_ms     poll timeout per wait; returns early after an idle gap
//   stats       int64[4]: {packets, lost (seq gaps), bytes, last_seq}
//               last_seq carries across calls (pass the same array).
// Returns payload bytes written (>=0) or -1 on socket error.
//
// A datagram whose payload does not fit in what is left of `out` fills
// it, and the rest of its payload is carried to the start of the next
// call's `out` (the calling thread's carry): with blocks that are not a
// multiple of the datagrams, no sample is dropped. (doa_tpu's
// native/framer.cpp drops such a datagram uncounted, and every later one
// that does not fit the block's remainder.)
int64_t doa_udp_drain(int fd, uint8_t* out, int64_t capacity,
                      int64_t want_bytes, int idle_ms, int64_t* stats) {
  static thread_local std::vector<uint8_t> pkt(1 << 16);
  static thread_local int64_t carry_off = 0, carry_len = 0;
  const uint32_t kMagic = 0x44304141u;
  int64_t written = 0;
  if (carry_len > 0) {
    const int64_t take = carry_len < capacity ? carry_len : capacity;
    std::memcpy(out, pkt.data() + carry_off, take);
    carry_off += take;
    carry_len -= take;
    written = take;
  }
  while (written < want_bytes && carry_len == 0) {
    struct pollfd pfd = {fd, POLLIN, 0};
    int pr = poll(&pfd, 1, idle_ms);
    if (pr <= 0) break;                       // idle gap or error
    ssize_t n = recv(fd, pkt.data(), pkt.size(), 0);
    if (n < 0) return -1;
    if (n < 16) continue;
    uint32_t magic, nsamp;
    uint64_t seq;
    std::memcpy(&magic, pkt.data(), 4);
    std::memcpy(&nsamp, pkt.data() + 4, 4);
    std::memcpy(&seq, pkt.data() + 8, 8);
    if (magic != kMagic) continue;
    const int64_t payload = n - 16;
    if (stats[3] >= 0 && (int64_t)seq > stats[3] + 1)
      stats[1] += (int64_t)seq - stats[3] - 1;
    if ((int64_t)seq > stats[3]) stats[3] = (int64_t)seq;
    stats[0] += 1;
    stats[2] += n;
    const int64_t room = capacity - written;
    const int64_t take = payload < room ? payload : room;
    std::memcpy(out + written, pkt.data() + 16, take);
    written += take;
    if (take < payload) {                     // the rest: the next call's
      carry_off = 16 + take;
      carry_len = payload - take;
    }
  }
  return written;
}

// Batched UDP sender (sendmmsg, scatter-gather): the loopback e2e
// ingest proof needs a transmitter that does not burn a whole core on
// per-datagram Python sendto()s — on a 2-core host the pure-Python
// sender IS the bottleneck (measured <0.3 GB/s with 90% loss
// while the native drain sustains >3 GB/s). Headers are built on the
// stack and the payload is referenced in place (iovec), so the capture
// buffer is never copied; up to 64 datagrams per syscall.
//
//   fd              datagram socket, connect()ed to the destination
//   data            frames*frame_bytes contiguous interleaved payload
//   frames          total frames (one frame = one time-step x nch c64)
//   frame_bytes     bytes per frame (nch * 8)
//   datagram_frames frames per datagram (payload <= 65507-16 bytes)
//   seq0            first sequence number
// Returns the next sequence number, or -1 on socket error.
int64_t doa_udp_send(int fd, const uint8_t* data, int64_t frames,
                     int64_t frame_bytes, int64_t datagram_frames,
                     int64_t seq0) {
  const uint32_t kMagic = 0x44304141u;
  constexpr int kBatch = 64;
  struct Hdr {
    uint32_t magic;
    uint32_t nsamp;
    uint64_t seq;
  };
  static_assert(sizeof(Hdr) == 16, "wire header is 16 bytes");
  Hdr hdrs[kBatch];
  struct iovec iov[kBatch][2];
  struct mmsghdr msgs[kBatch];
  int64_t seq = seq0;
  int64_t off = 0;
  while (off < frames) {
    int n = 0;
    for (; n < kBatch && off < frames; ++n) {
      int64_t take =
          frames - off < datagram_frames ? frames - off : datagram_frames;
      hdrs[n] = {kMagic, (uint32_t)take, (uint64_t)seq};
      iov[n][0] = {&hdrs[n], sizeof(Hdr)};
      iov[n][1] = {const_cast<uint8_t*>(data) + off * frame_bytes,
                   (size_t)(take * frame_bytes)};
      std::memset(&msgs[n], 0, sizeof(mmsghdr));
      msgs[n].msg_hdr.msg_iov = iov[n];
      msgs[n].msg_hdr.msg_iovlen = 2;
      ++seq;
      off += take;
    }
    int sent = 0;
    while (sent < n) {
      int r = sendmmsg(fd, msgs + sent, n - sent, 0);
      if (r < 0) {
        if (errno == EINTR || errno == ENOBUFS || errno == EAGAIN) continue;
        return -1;
      }
      sent += r;
    }
  }
  return seq;
}

}  // extern "C"
