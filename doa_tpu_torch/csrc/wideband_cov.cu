// Kernels 4, 7 and 10, the wideband front end: every chunk's embedded
// subband Gram, from the interleaved capture (kernel 4: the F-point DFT
// channelizer in the kernel) or from the channelized stream (kernel 7),
// and every chunk's real interleaved-basis subband Gram of the stream
// (kernel 10). One ring kernel, doa_fft_gram_ring<RT, SRC>, serves all
// three: SRC is where its y-buffer comes from and, for kernel 10, which
// sums an item keeps and how they are stored; the rest is shared.
//
// Kernel 4 (SRC = Src::Frames) replaces the Pallas kernel
// doa_tpu/ops/pallas/wideband_cov.py:162 `_wideband_fft_gram_kernel`
// (variant "fft" of wideband_cov_embedded_pallas, launched at :425). It
// takes any F (the reference's radix-2 FFT takes powers of two only): the
// port's "embedded" variant launches it on the frames at any other F, so
// the card forms no channelized stream there. Frames are
// x f32[M, F*2N]: row m holds F consecutive complex sample vectors (the
// bytes of a complex64 capture). Subband f of frame m is
// y_f[m, c] = sum_t W[f,t] x[m, t, c] with the unnormalised forward DFT
// W[f,t] = exp(-2 pi j f t / F). Chunk c of subband f (g consecutive
// frames) gives
//
//   R = sum_m y_f[m] y_f[m]^H,   E = embed(R o (c c^H)) * scale
//
// with embed(R) = [[Rr, -Ri], [Ri, Rr]] and scale = 1 / S_sub, written
// once per chunk into E f32[F, n_chunks, 2N, 2N].
//
// Kernel 7 (SRC = Src::Stream) replaces
// doa_tpu/ops/pallas/wideband_cov.py:92 `_subband_gram_kernel_embedded`
// (variant "embedded"): the same E from the channelized stream
// Y f32[M, F*2N], whose row m holds subband f's complex samples in
// column block f (Y = frames @ K, the channelizer matrix). The TPU kernel
// planarizes with permute matmuls, runs a radix-2 FFT on whole tiles and
// a bf16 hi/lo Gram; here every product is a true FP32 FMA on the CUDA
// cores (no tensor cores, no TF32) and the DFT is a direct F-term sum.
//
// Kernel 10 (SRC = Src::Uhat) replaces
// doa_tpu/ops/pallas/wideband_cov.py:255 `_subband_gram_kernel` (variant
// "uhat"): per chunk and subband the unnormalised Gram U = sum_m y_m y_m^T
// of the stream's column block in its interleaved basis (2N x 2N, entry
// (2i + a, 2j + b) = sum y_i.a y_j.b, a, b in {re, im}), into
// U f32[F, n_chunks, 2N, 2N]. U is not a function of the complex Gram
// kernels 4 and 7 keep (Re and Im of sum y_i conj(y_j) mix the four
// products), so its item keeps all four sums of each complex entry (rr,
// ri, ir, ii): twice the accumulators, so one item a thread (J_U), up to
// MAXT_U threads and two blocks a SM (P = 2 subbands a group at c5); no
// correction, no scale; a tile's rows 2i + a and their mirror rows 2j + b
// as 2 RT-float pieces (store_utile). It has kernel 7's bytes (at c5,
// F = 16: Y read, 1.07 GB, U written, 2.15 GB: 0.9616 ms). Its first form
// (csrc/subband_gram.cu, one block per (chunk, subband) staging the chunk
// synchronously, the whole square) took 3.04-3.18 ms at c5; this one
// 2.54 (exp_wideband_cov.py on an H100 80GB HBM3 at 700 W; PERF.md). P = 4 in one block a SM (544
// threads) took 2.84: a chunk's epilogue then has no other block's Gram
// beside it. Reading each ring row's group columns in place, with no
// y-buffer and each chunk leaving L2 once, gained nothing at P = 2: the
// Gram and the stores set the pace. Kernels 4 and 7 compile to the code
// they had before kernel 10 joined (if constexpr; exp_wideband_cov.py
// compares their SASS).
//
// What bounds it on an H100 at c5 (M = 131072 frames, F = 16, N = 64,
// g = 64): the capture read once (1.07 GB) and E written once (2.15 GB),
// 0.9616 ms at 3.35 TB/s; the operations (the Grams' Hermitian half, 17 G
// complex MACs' worth of FMAs, and the DFT) about 0.8 ms at 67 TFLOP/s.
// Both fit under the bytes bound when they overlap; torch.cat((x, x), 1)
// moves the same bytes in ~1.5 ms on the card (exp_wideband_cov.py).
// Kernel 7 at c5_f12 (M = 131072, F = 12, N = 64, g = 64): Y read once
// (805 MB) and E written once (1.61 GB), 0.72 ms; its Grams 0.38 ms at
// 67 TFLOP/s.
//
// What held the earlier forms back (one block per (chunk, subband), the
// whole chunk staged synchronously, with no copy in flight while it
// computed; exp_wideband_cov.py, PERF.md): kernel 4 took 7.36 ms at c5,
// of which the 16 reads of each chunk with the DFT beside them ~4.0 ms
// (one subband read: 3.39), the DFT's twiddle loads, modulo and
// 3-operation complex products ~2.2, the whole-square Gram ~3.5, and E's
// stores ~0.7. Kernel 7 (csrc/subband_gram.cu until it moved here) took
// 2.27 ms at c5_f12: the whole square, the row classes summed through
// shared memory, E stored as scalars in four mirrored quadrants.
//
// Design (each part's measured effect: PERF.md, kernel 4's findings):
// - Subband groups: a unit of work is (chunk, group of P subbands, the
//   residue class q mod F/P), so each chunk leaves L2 F/P times, not F
//   (P = 4 at c5). Each block keeps one group and walks a contiguous run
//   of chunks; the F/P blocks of one run are neighbours in launch order.
//   The re-reads come from L2 (the copies alone take the same time with
//   each chunk read once). No atomics: the result does not depend on the
//   grid.
// - A persistent grid and a ring: as many blocks as fit (2 a SM), each
//   filling a ring of STAGES slots in dynamic shared memory with 1-D bulk
//   async copies (cp.async.bulk ... mbarrier::complete_tx, one mbarrier a
//   slot) of TS whole frames; the head and tail of a stage that break the
//   copy's 16-byte rule are plain loads. A slot is refilled as soon as the
//   y-buffer has been filled from it, so the next stage's copy runs under
//   the Gram and the epilogue.
// - The y-buffer, double, of P x TS x N complex values, filled out of the
//   ring. Kernel 7 copies the group's P subband column blocks of each row
//   (no twiddles). Kernel 4 takes the DFT: a thread takes one (frame,
//   element) and four subbands, four FMAs a complex product, the
//   twiddles in shared memory (no modulo, no global load a term). With
//   four subbands a group the sum is split
//   (F + 16 products a point, not 4F, for any G = F / 4); the snapped
//   twiddles of dft_twiddles stay (exactly +-1, +-j at F <= 4, where it
//   is direct). Everything below is the same for both sources.
// - The Hermitian half: each Gram item is (subband, RT x RT register tile
//   with i0 <= j0, row class), J items a thread (RT = 4 where 4 | N <= 64,
//   2 for even N <= 32, 1 for N <= 16). 192 threads with 3 items (168
//   registers, 12 warps a SM) beat 288 with 2 (96 registers and spills).
//   The C row classes of a tile sit in adjacent lanes and are summed by a
//   butterfly of shuffles at each chunk's end (every lane gets the same
//   sum, in a fixed order). The plan (P, C, threads) fills the item slots
//   best.
// - The epilogue, from registers: (i, j) and (j, i) come from one sum
//   (er(j,i) = er(i,j), ei(j,i) = -ei(i,j); a diagonal Ri is 0), with the
//   correction and the scale as explicitly rounded operations (no FMA
//   contraction), as the plain version computes them. E's stores set the
//   pace with the copies: the tiles go by bands of BAND tile rows, so one
//   store instruction writes the tiles' rows in long runs and their mirror
//   rows in 32-byte sectors (row-major tiles wrote the mirror in 16-byte
//   pieces 32 rows apart: "stores only" 2.06 ms against 1.33-1.48). Bands
//   of 2 beat bands of 4 and 8 by ~0.1 ms. Staging E in shared memory for
//   whole-row stores cost more in barriers and registers than it saved.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAXT = 192;           // threads a block, at most
constexpr int J = 3;                // Gram items a thread
constexpr int MAXT_U = 288;         // kernel 10: threads a block, at most
constexpr int J_U = 1;              // kernel 10: Gram items a thread
constexpr int BLOCKS_U = 2;         // kernel 10: blocks a SM, at least
constexpr int STAGES = 2;
constexpr int STAGE_BYTES = 32768;  // a stage's frames, at most (one, least)
constexpr int Y_BYTES = 8192;       // a y-buffer (P x TS x N complex), most
constexpr int MAX_P = 16;
constexpr int HEAD = 128;           // the slots' mbarriers
constexpr int MAX_SMEM = 232448;    // dynamic shared memory a block, most
constexpr int MAX_DEVICES = 64;

__host__ __device__ constexpr int round16(int b) { return (b + 15) & ~15; }

// The shared-memory layout of a launch: the barriers, the group's twiddle
// rows (padded to whole quads of subbands), two y-buffers, the ring.
struct Layout {
  int tw, ybuf, slot, ring, smem;
  __host__ __device__ Layout(int F, int N, int P, int TS) {
    const int rb = F * N * 8;
    tw = HEAD;
    ybuf = tw + round16((((P + 3) / 4) * 4 * F + F + 16) * 8);
    slot = round16(TS * rb) + 16;
    ring = ybuf + 2 * round16(P * TS * N * 8);
    smem = ring + STAGES * slot;
  }
};

// The launch plan: P subbands a group (P | F), C row classes (a power of
// two, at most g), the threads (a multiple of 32) and TS frames a stage.
struct Plan {
  int P = 0, C = 0, threads = 0, items = 0, TS = 0;
};

Plan make_plan(int F, int N, int g, int rt, int j, int maxt) {
  const int nt = N / rt, ntri = nt * (nt + 1) / 2;
  Plan best;
  for (int P = 1; P <= F && P <= MAX_P && P * N * 8 <= Y_BYTES; ++P) {
    if (F % P) continue;
    for (int C = 1; C <= 32 && C <= g; C *= 2) {
      const int items = P * ntri * C;
      if (items > j * maxt) break;
      const int threads = (items + 32 * j - 1) / (32 * j) * 32;
      // more of the item slots used, then more subbands a group (fewer
      // reads of each chunk), then more threads
      const long long l = (long long)items * best.threads;
      const long long r = (long long)best.items * threads;
      if (best.P == 0 || l > r ||
          (l == r && (P > best.P || (P == best.P && items > best.items)))) {
        best.P = P;
        best.C = C;
        best.threads = threads;
        best.items = items;
      }
    }
  }
  const int rb = F * N * 8;
  int ts = STAGE_BYTES / rb;
  if (ts > Y_BYTES / (best.P * N * 8)) ts = Y_BYTES / (best.P * N * 8);
  best.TS = ts < 1 ? 1 : ts;
  return best;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ bool mbar_try(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
      "selp.u32 %0, 1, 0, p;\n\t}"
      : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  return done != 0;
}

// Wait for the stage's copy. One that has not landed after ~2^34 clocks
// (seconds) is lost: trap, so the launch fails instead of hanging.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try(bar, parity))
    if (clock64() - t0 > (1ll << 34)) __trap();
}

template <int RT> struct alignas(RT * 4) Vec { float v[RT]; };

// An RT-vector of E, with the default write-back policy (evict-first
// stores were ~0.08 ms slower at c5).
template <int RT>
__device__ __forceinline__ void put(float* p, const Vec<RT>& v) {
  if constexpr (RT == 4)
    __stwb(reinterpret_cast<float4*>(p), make_float4(v.v[0], v.v[1], v.v[2],
                                                     v.v[3]));
  else if constexpr (RT == 2)
    __stwb(reinterpret_cast<float2*>(p), make_float2(v.v[0], v.v[1]));
  else
    __stwb(p, v.v[0]);
}

// RT complex values of a y row (RT-vector aligned: RT | the offset).
template <int RT>
__device__ __forceinline__ void load_y(const float2* p, float2 (&a)[RT]) {
  if constexpr (RT == 1) {
    a[0] = p[0];
  } else {
#pragma unroll
    for (int h = 0; h < RT / 2; ++h) {
      const float4 q = reinterpret_cast<const float4*>(p)[h];
      a[2 * h] = make_float2(q.x, q.y);
      a[2 * h + 1] = make_float2(q.z, q.w);
    }
  }
}

// Gram item `it` of a block: row class it % C, then upper-triangle tile
// ti and subband s of the group. The tiles go by bands of BAND tile rows:
// in band r0 = BAND a, .. r0 + h - 1, column by column, the tiles
// (r0, jb) .. (min(jb, r0 + h - 1), jb) side by side, so the lanes of one
// column hold its tile rows in order: their mirror rows fill 16 * BAND
// contiguous bytes of E in one store (whole 32-byte sectors), and their
// own rows runs of 16 bytes a column. Bands of 2 beat 1, 4 and 8 at c5.
constexpr int BAND = 2;

__device__ __forceinline__ void decode(int it, int C, int nt, int ntri,
                                       int& s, int& ib, int& jb) {
  const int rest = it / C;
  int rem = rest % ntri;
  s = rest / ntri;
  int r0 = 0, h = min(BAND, nt);
  // tiles of a band: its triangle, then h a column
  while (rem >= h * (h + 1) / 2 + h * (nt - r0 - h)) {
    rem -= h * (h + 1) / 2 + h * (nt - r0 - h);
    r0 += h;
    h = min(BAND, nt - r0);
  }
  if (rem < h * (h + 1) / 2) {                // column r0 + k holds k + 1
    int k = 0;
    while (rem > k) { rem -= k + 1; ++k; }
    jb = r0 + k;
    ib = r0 + rem;
  } else {
    rem -= h * (h + 1) / 2;
    jb = r0 + h + rem / h;
    ib = r0 + rem % h;
  }
}

// E's entries (i, j) of one tile and their mirror, from the tile's sums
// (Re, Im of sum y_i conj(y_j)); a diagonal tile's lower half is the
// mirror of its upper half.
template <int RT>
__device__ __forceinline__ void store_tile(
    float* __restrict__ oc, int N, int i0, int j0, const float (&ar)[RT][RT],
    const float (&ai)[RT][RT], const float* __restrict__ cr,
    const float* __restrict__ ci, float scale) {
  const int n2 = 2 * N;
  float er[RT][RT], ei[RT][RT];
#pragma unroll
  for (int u = 0; u < RT; ++u)
#pragma unroll
    for (int v = 0; v < RT; ++v) {
      const int i = i0 + u, j = j0 + v;
      const bool lower = i0 == j0 && u > v;
      if (lower) continue;
      const float rr = ar[u][v];
      const float ri = i == j ? 0.f : ai[u][v];
      const float cri = __ldg(cr + i), cii = __ldg(ci + i);
      const float crj = __ldg(cr + j), cij = __ldg(ci + j);
      // W = c c^H; R o W; then the scale
      const float wre = __fadd_rn(__fmul_rn(cri, crj), __fmul_rn(cii, cij));
      const float wim = __fsub_rn(__fmul_rn(cii, crj), __fmul_rn(cri, cij));
      er[u][v] = __fmul_rn(
          __fsub_rn(__fmul_rn(rr, wre), __fmul_rn(ri, wim)), scale);
      ei[u][v] = __fmul_rn(
          __fadd_rn(__fmul_rn(rr, wim), __fmul_rn(ri, wre)), scale);
    }
  if (i0 == j0) {
#pragma unroll
    for (int u = 1; u < RT; ++u)
#pragma unroll
      for (int v = 0; v < u; ++v) {
        er[u][v] = er[v][u];
        ei[u][v] = -ei[v][u];
      }
  }
#pragma unroll
  for (int u = 0; u < RT; ++u) {
    Vec<RT> r, m;
#pragma unroll
    for (int v = 0; v < RT; ++v) {
      r.v[v] = er[u][v];
      m.v[v] = ei[u][v];
    }
    float* row = oc + (size_t)(i0 + u) * n2 + j0;
    put<RT>(row, r);
    put<RT>(row + (size_t)N * n2 + N, r);
    put<RT>(row + (size_t)N * n2, m);
#pragma unroll
    for (int v = 0; v < RT; ++v) m.v[v] = -m.v[v];
    put<RT>(row + N, m);
  }
  if (i0 == j0) return;
#pragma unroll
  for (int v = 0; v < RT; ++v) {
    Vec<RT> r, m;
#pragma unroll
    for (int u = 0; u < RT; ++u) {
      r.v[u] = er[u][v];
      m.v[u] = ei[u][v];               // -ei(j, i)
    }
    float* row = oc + (size_t)(j0 + v) * n2 + i0;
    put<RT>(row, r);
    put<RT>(row + (size_t)N * n2 + N, r);
    put<RT>(row + N, m);
#pragma unroll
    for (int u = 0; u < RT; ++u) m.v[u] = -m.v[u];
    put<RT>(row + (size_t)N * n2, m);
  }
}

// 2 RT floats of a U row (8-byte aligned; 16-byte at RT >= 2).
template <int RT>
__device__ __forceinline__ void put_row(float* p, const float (&v)[2 * RT]) {
#pragma unroll
  for (int h = 0; h < (RT + 1) / 2; ++h) {
    Vec<RT == 1 ? 2 : 4> w;
#pragma unroll
    for (int e = 0; e < (RT == 1 ? 2 : 4); ++e) w.v[e] = v[4 * h + e];
    put<RT == 1 ? 2 : 4>(p + 4 * h, w);
  }
}

// Kernel 10: U's rows 2i + a and columns 2j + b of one tile (sums of
// y_i.a y_j.b: rr, ri, ir, ii for (a, b) = (re, re), (re, im), (im, re),
// (im, im)) and, off the diagonal, their mirror U(2j + b, 2i + a) from
// the same sums. A diagonal tile's entries below its diagonal are sums of
// the same products in the same order as their mirrors: it is stored
// whole.
template <int RT>
__device__ __forceinline__ void store_utile(
    float* __restrict__ oc, int N, int i0, int j0, const float (&rr)[RT][RT],
    const float (&ri)[RT][RT], const float (&ir)[RT][RT],
    const float (&ii)[RT][RT]) {
  const int n2 = 2 * N;
#pragma unroll
  for (int u = 0; u < RT; ++u) {
    float re[2 * RT], im[2 * RT];
#pragma unroll
    for (int v = 0; v < RT; ++v) {
      re[2 * v] = rr[u][v];
      re[2 * v + 1] = ri[u][v];
      im[2 * v] = ir[u][v];
      im[2 * v + 1] = ii[u][v];
    }
    float* row = oc + (size_t)(2 * (i0 + u)) * n2 + 2 * j0;
    put_row<RT>(row, re);
    put_row<RT>(row + n2, im);
  }
  if (i0 == j0) return;
#pragma unroll
  for (int v = 0; v < RT; ++v) {
    float re[2 * RT], im[2 * RT];
#pragma unroll
    for (int u = 0; u < RT; ++u) {
      re[2 * u] = rr[u][v];
      re[2 * u + 1] = ir[u][v];
      im[2 * u] = ri[u][v];
      im[2 * u + 1] = ii[u][v];
    }
    float* row = oc + (size_t)(2 * (j0 + v)) * n2 + 2 * i0;
    put_row<RT>(row, re);
    put_row<RT>(row + n2, im);
  }
}

// The source of the y-buffer: the frames (kernel 4, the group's subbands
// by the DFT) or the channelized stream (kernel 7, copied; kernel 10, the
// same copy, with the real Gram items of store_utile).
enum class Src { Frames, Stream, Uhat };

// Kernel 10's items carry four sums a complex entry, not two: one a
// thread, more threads.
__host__ __device__ constexpr int items_of(Src s) {
  return s == Src::Uhat ? J_U : J;
}
__host__ __device__ constexpr int maxt_of(Src s) {
  return s == Src::Uhat ? MAXT_U : MAXT;
}

template <int RT, Src SRC>
__global__ void __launch_bounds__(maxt_of(SRC),
                                  SRC == Src::Uhat ? BLOCKS_U : 2)
doa_fft_gram_ring(const float* __restrict__ x, const float2* __restrict__ tw,
                  const float* __restrict__ cr, const float* __restrict__ ci,
                  float* __restrict__ out, int F, int N, int g, int n_chunks,
                  float scale, int P, int C, int TS) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int JJ = items_of(SRC);
  const Layout lay(F, N, P, TS);
  const int tid = threadIdx.x, nthr = blockDim.x;
  // this block's subband group q and run of chunks [c0, c1)
  const int G = F / P;
  const int q = blockIdx.x % G;        // subbands q, q + G, .. q + (P-1) G
  const int nsets = gridDim.x / G, set = blockIdx.x / G;
  const long long c0 = (long long)n_chunks * set / nsets;
  const long long c1 = (long long)n_chunks * (set + 1) / nsets;
  if (c0 >= c1) return;
  const int rb = F * N * 8;                           // bytes a frame
  const long long R0 = c0 * g, R1 = c1 * g;
  const int nst = (int)((R1 - R0 + TS - 1) / TS);
  const uintptr_t xb = reinterpret_cast<uintptr_t>(x);

  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  float2* twb = reinterpret_cast<float2*>(smem + lay.tw);
  float2* ybuf = reinterpret_cast<float2*>(smem + lay.ybuf);
  const int ystride = (lay.ring - lay.ybuf) / 16;     // float2s a y-buffer
  unsigned char* ring = smem + lay.ring;

  // stage k's frames into slot k % STAGES at their offset mod 16: the
  // aligned middle by one bulk copy, the head and tail (< 16 bytes each)
  // by plain loads
  auto issue = [&](int k) {
    const long long r = R0 + (long long)k * TS;
    const long long rows = min((long long)TS, R1 - r);
    const uintptr_t s = xb + (uintptr_t)(r * rb);
    const uintptr_t e = s + (uintptr_t)(rows * rb);
    const uintptr_t s0 = s & ~(uintptr_t)15;
    const uintptr_t up = (s + 15) & ~(uintptr_t)15, dn = e & ~(uintptr_t)15;
    const uintptr_t a = up < e ? up : e;
    const uintptr_t b = dn > a ? dn : a;
    unsigned char* dst = ring + (k % STAGES) * lay.slot;
    if (a != s || b != e) {
      for (uintptr_t p = s; p < a; ++p)
        dst[p - s0] = *reinterpret_cast<const unsigned char*>(p);
      for (uintptr_t p = b; p < e; ++p)
        dst[p - s0] = *reinterpret_cast<const unsigned char*>(p);
      // these generic writes before any later bulk write to the slot
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    }
    const uint32_t bar = smem_addr(full + k % STAGES);
    const uint32_t bytes = (uint32_t)(b - a);
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 :: "r"(bar), "r"(bytes) : "memory");
    if (bytes)
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
          " [%0], [%1], %2, [%3];"
          :: "r"(smem_addr(dst + (a - s0))),
             "l"(reinterpret_cast<const void*>(a)), "r"(bytes), "r"(bar)
          : "memory");
  };

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
                   :: "r"(smem_addr(full + s)) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int k = 0; k < min(STAGES, nst); ++k) issue(k);
  }
  // the group's twiddle rows, W[q + G s, t] = tw[(q + G s) t mod F], with
  // zero rows up to a whole quad of subbands; then, for the split DFT of
  // four subbands, W_G^(q t2) = tw[q t2 P mod F] (t2 < G) and
  // W[q + G k, t1] (k, t1 < 4)
  const int nq = (P + 3) / 4;
  const bool split = P == 4 && G > 1;
  float2* twz = twb + nq * 4 * F;
  float2* twy = twz + F;
  if constexpr (SRC == Src::Frames) {
    for (int i = tid; i < nq * 4 * F + F + 16; i += nthr) {
      const int s = i / F, e = i - nq * 4 * F;
      long long ft = 0;                        // the power of tw[1]
      if (e < 0)
        ft = (long long)(q + G * s) * (i - s * F);
      else if (e < F)
        ft = (long long)q * e * P;
      else
        ft = (long long)(q + G * ((e - F) / 4)) * ((e - F) % 4);
      twb[i] = e < 0 && s >= P ? make_float2(0.f, 0.f) : tw[(int)(ft % F)];
    }
  }
  __syncthreads();

  // this thread's JJ Gram items: the class cls (the same for each, as
  // nthr is a multiple of 32 and C divides 32) and each item's y offsets
  // (subband s's rows at s * TS * N, tile columns i0, j0); a spare item
  // reads item 0's and is never stored
  const int nt = N / RT, ntri = nt * (nt + 1) / 2;
  const int items = P * ntri * C;
  const int cls = tid & (C - 1);
  int oa[JJ], ob[JJ];
#pragma unroll
  for (int k = 0; k < JJ; ++k) {
    const int it = tid + k * nthr;
    int s, ib, jb;
    decode(it < items ? it : 0, C, nt, ntri, s, ib, jb);
    oa[k] = s * TS * N + ib * RT;
    ob[k] = s * TS * N + jb * RT;
  }

  // the items' sums: Re and Im of sum y_i conj(y_j) (kernels 4 and 7);
  // kernel 10's rr, ri in ar, ai and its ir, ii in br, bi
  constexpr int JB = SRC == Src::Uhat ? JJ : 1;
  float ar[JJ][RT][RT], ai[JJ][RT][RT], br[JB][RT][RT], bi[JB][RT][RT];
#pragma unroll
  for (int k = 0; k < JJ; ++k)
#pragma unroll
    for (int u = 0; u < RT; ++u)
#pragma unroll
      for (int v = 0; v < RT; ++v) ar[k][u][v] = ai[k][u][v] = 0.f;
  if constexpr (SRC == Src::Uhat) {
#pragma unroll
    for (int k = 0; k < JJ; ++k)
#pragma unroll
      for (int u = 0; u < RT; ++u)
#pragma unroll
        for (int v = 0; v < RT; ++v) br[k][u][v] = bi[k][u][v] = 0.f;
  }

  // y of one (frame, element) in the four subbands of a quad, from the
  // frame's F samples src[t N]: with four subbands a group (F = 4G), split
  // as y_k = sum_t1 W[q + G k, t1] z_t1, z_t1 = sum_t2 W_G^(q t2)
  // x_(t1 + 4 t2) (F + 16 products, not 4F); else directly from the quad's
  // twiddle rows tws[s F + t]
  auto dft_point = [&](const float2* src, int rs, const float2* tws,
                       float2 (&yv)[4]) {
#pragma unroll
    for (int s = 0; s < 4; ++s) yv[s] = make_float2(0.f, 0.f);
    if (split) {
      float2 z[4];
#pragma unroll
      for (int t1 = 0; t1 < 4; ++t1) z[t1] = make_float2(0.f, 0.f);
      for (int t2 = 0; t2 < G; ++t2) {
        const float2 w = twz[t2];
#pragma unroll
        for (int t1 = 0; t1 < 4; ++t1) {
          const float2 v = src[(t1 + 4 * t2) * rs];
          z[t1].x = fmaf(w.x, v.x, fmaf(-w.y, v.y, z[t1].x));
          z[t1].y = fmaf(w.x, v.y, fmaf(w.y, v.x, z[t1].y));
        }
      }
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int t1 = 0; t1 < 4; ++t1) {
          const float2 w = twy[k * 4 + t1];
          yv[k].x = fmaf(w.x, z[t1].x, fmaf(-w.y, z[t1].y, yv[k].x));
          yv[k].y = fmaf(w.x, z[t1].y, fmaf(w.y, z[t1].x, yv[k].y));
        }
      return;
    }
    for (int t = 0; t < F; ++t) {
      const float2 v = src[t * rs];
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const float2 w = tws[s * F + t];
        yv[s].x = fmaf(w.x, v.x, fmaf(-w.y, v.y, yv[s].x));
        yv[s].y = fmaf(w.x, v.y, fmaf(w.y, v.x, yv[s].y));
      }
    }
  };

  // this thread's items over y rows m0, m0 + C, ... < m1
  auto gram_rows = [&](const float2* yb, int m0, int m1) {
    for (int m = m0; m < m1; m += C) {
#pragma unroll
      for (int k = 0; k < JJ; ++k) {
        float2 a[RT], b[RT];
        load_y<RT>(yb + oa[k] + m * N, a);
        load_y<RT>(yb + ob[k] + m * N, b);
        if constexpr (SRC == Src::Uhat) {
#pragma unroll
          for (int u = 0; u < RT; ++u)
#pragma unroll
            for (int v = 0; v < RT; ++v) {
              ar[k][u][v] = fmaf(a[u].x, b[v].x, ar[k][u][v]);
              ai[k][u][v] = fmaf(a[u].x, b[v].y, ai[k][u][v]);
              br[k][u][v] = fmaf(a[u].y, b[v].x, br[k][u][v]);
              bi[k][u][v] = fmaf(a[u].y, b[v].y, bi[k][u][v]);
            }
          continue;
        }
#pragma unroll
        for (int u = 0; u < RT; ++u)
#pragma unroll
          for (int v = 0; v < RT; ++v) {
            ar[k][u][v] = fmaf(a[u].y, b[v].y, fmaf(a[u].x, b[v].x,
                                                    ar[k][u][v]));
            ai[k][u][v] = fmaf(a[u].y, b[v].x, fmaf(-a[u].x, b[v].y,
                                                    ai[k][u][v]));
          }
      }
    }
  };

  // chunk c's sums over the classes (a butterfly: every lane of a tile's
  // classes ends with the same sum), class 0's lane stores the tiles
  auto store_tiles = [&](long long c) {
    for (int o = 1; o < C; o <<= 1)
#pragma unroll
      for (int k = 0; k < JJ; ++k)
#pragma unroll
        for (int u = 0; u < RT; ++u)
#pragma unroll
          for (int v = 0; v < RT; ++v) {
            ar[k][u][v] += __shfl_xor_sync(0xffffffffu, ar[k][u][v], o);
            ai[k][u][v] += __shfl_xor_sync(0xffffffffu, ai[k][u][v], o);
            if constexpr (SRC == Src::Uhat) {
              br[k][u][v] += __shfl_xor_sync(0xffffffffu, br[k][u][v], o);
              bi[k][u][v] += __shfl_xor_sync(0xffffffffu, bi[k][u][v], o);
            }
          }
    if (cls == 0) {
#pragma unroll
      for (int k = 0; k < JJ; ++k) {
        const int it = tid + k * nthr;
        if (it >= items) continue;
        int s, ib, jb;
        decode(it, C, nt, ntri, s, ib, jb);
        float* oc = out + ((size_t)(q + G * s) * n_chunks + c) * 4 * N * N;
        if constexpr (SRC == Src::Uhat)
          store_utile<RT>(oc, N, ib * RT, jb * RT, ar[k], ai[k], br[k],
                          bi[k]);
        else
          store_tile<RT>(oc, N, ib * RT, jb * RT, ar[k], ai[k], cr, ci,
                         scale);
      }
    }
#pragma unroll
    for (int k = 0; k < JJ; ++k)
#pragma unroll
      for (int u = 0; u < RT; ++u)
#pragma unroll
        for (int v = 0; v < RT; ++v) {
          ar[k][u][v] = ai[k][u][v] = 0.f;
          if constexpr (SRC == Src::Uhat) br[k][u][v] = bi[k][u][v] = 0.f;
        }
  };

  long long cc = c0;   // the chunk of the next row, and its rows done
  int coff = 0;
  for (int k = 0; k < nst; ++k) {
    const int sl = k % STAGES;
    mbar_wait(smem_addr(full + sl), (uint32_t)((k / STAGES) & 1));
    const long long r = R0 + (long long)k * TS;
    const int rows = (int)min((long long)TS, R1 - r);
    const unsigned char* data =
        ring + sl * lay.slot + ((xb + (uintptr_t)(r * rb)) & 15);
    float2* yb = ybuf + (k & 1) * ystride;
    if constexpr (SRC == Src::Frames) {
      // the DFT: point w is element c of frame m in subband quad
      // w / (rows N)
      for (int w = tid; w < rows * N * nq; w += nthr) {
        const int c = w % N, mq = w / N;
        const int m = mq % rows, qd = mq / rows;
        const float2* src =
            reinterpret_cast<const float2*>(data + m * rb) + c;
        const float2* tws = twb + qd * 4 * F;
        float2 yv[4];
        dft_point(src, N, tws, yv);
#pragma unroll
        for (int s = 0; s < 4; ++s)
          if (qd * 4 + s < P) yb[(qd * 4 + s) * TS * N + m * N + c] = yv[s];
      }
    } else {
      // the copy: point w is element c of row m in the group's P
      // subbands, q + G s (column block q + G s of the row)
      for (int w = tid; w < rows * N; w += nthr) {
        const int c = w % N, m = w / N;
        const float2* src =
            reinterpret_cast<const float2*>(data + m * rb) + q * N + c;
        float2* dst = yb + m * N + c;
        for (int s = 0; s < P; ++s) dst[s * TS * N] = src[s * G * N];
      }
    }
    __syncthreads();
    // every thread is done with slot sl (and with the other y-buffer)
    if (tid == 0 && k + STAGES < nst) issue(k + STAGES);
    // the Gram over the stage's rows, chunk by chunk
    for (int pos = 0; pos < rows;) {
      const int seg = min(rows - pos, g - coff);
      // this class's rows: chunk offsets coff <= o < coff + seg, o = cls
      // mod C
      const int first = pos + ((cls - coff) & (C - 1));
      gram_rows(yb, first, pos + seg);
      pos += seg;
      coff += seg;
      if (coff == g) {
        store_tiles(cc);
        ++cc;
        coff = 0;
      }
    }
  }
}

int sm_count(int dev, int* sms) {
  static int cached[MAX_DEVICES] = {};
  if (dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (cached[dev] == 0) {
    const cudaError_t e = cudaDeviceGetAttribute(
        &cached[dev], cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
  }
  *sms = cached[dev];
  return 0;
}

// The persistent grid: the groups of as many runs as fit on the card at
// once (one run at least), and no more runs than chunks.
template <int RT, Src SRC>
int launch(const void* x, const void* tw, const void* cr, const void* ci,
           void* out, int F, int N, int g, int n_chunks, float scale,
           cudaStream_t stream) {
  static bool attr[MAX_DEVICES] = {};
  const Plan p = make_plan(F, N, g, RT, items_of(SRC), maxt_of(SRC));
  const Layout lay(F, N, p.P, p.TS);
  if (lay.smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  const int se = sm_count(dev, &sms);
  if (se) return se;
  if (!attr[dev]) {
    e = cudaFuncSetAttribute(doa_fft_gram_ring<RT, SRC>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             MAX_SMEM);
    if (e != cudaSuccess) return (int)e;
    attr[dev] = true;
  }
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, doa_fft_gram_ring<RT, SRC>, p.threads, lay.smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int G = F / p.P;
  long long runs = (long long)per_sm * sms / G;
  if (runs > n_chunks) runs = n_chunks;
  if (runs < 1) runs = 1;
  if (runs * G > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  doa_fft_gram_ring<RT, SRC><<<(unsigned)(runs * G), p.threads, lay.smem,
                               stream>>>(
      (const float*)x, (const float2*)tw, (const float*)cr, (const float*)ci,
      (float*)out, F, N, g, n_chunks, scale, p.P, p.C, p.TS);
  return (int)cudaGetLastError();
}

// The checks both entries share, and the register-tile form of N.
template <Src SRC>
int dispatch(const void* x, const void* tw, const void* cr, const void* ci,
             void* out, int F, int N, int g, int n_chunks, float scale,
             void* stream) {
  if (F < 1 || N < 1 || g < 1 || n_chunks < 1 ||
      reinterpret_cast<uintptr_t>(x) % 8 != 0 ||
      (long long)F * N * 8 > 0x7fffffffLL / 4)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (N % 4 == 0 && N <= 64)
    return launch<4, SRC>(x, tw, cr, ci, out, F, N, g, n_chunks, scale, s);
  if (N % 2 == 0 && N <= 32)
    return launch<2, SRC>(x, tw, cr, ci, out, F, N, g, n_chunks, scale, s);
  if (N <= 16)
    return launch<1, SRC>(x, tw, cr, ci, out, F, N, g, n_chunks, scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Both entries: cr, ci f32[N] correction; out f32[F, n_chunks, 2N, 2N].
// N: 4 | N <= 64, 2 | N <= 32, or N <= 16.

// Kernel 4. x: frames f32[n_chunks * g, F * 2N] contiguous, 8-byte
// aligned; tw: f32[F, 2], the twiddles exp(-2 pi j k / F).
extern "C" int doa_wideband_fft_gram(const void* x, const void* tw,
                                     const void* cr, const void* ci,
                                     void* out, int F, int N, int g,
                                     int n_chunks, float scale,
                                     void* stream) {
  return dispatch<Src::Frames>(x, tw, cr, ci, out, F, N, g, n_chunks, scale,
                               stream);
}

// Kernel 7. y: the channelized stream f32[n_chunks * g, F * 2N]
// contiguous, 8-byte aligned.
extern "C" int doa_subband_embedded(const void* y, const void* cr,
                                    const void* ci, void* out, int F, int N,
                                    int g, int n_chunks, float scale,
                                    void* stream) {
  return dispatch<Src::Stream>(y, nullptr, cr, ci, out, F, N, g, n_chunks,
                               scale, stream);
}

// Kernel 10. y: the channelized stream, as kernel 7's; out: the
// unnormalised interleaved-basis Grams U f32[F, n_chunks, 2N, 2N] (no
// correction, no scale).
extern "C" int doa_subband_gram(const void* y, void* out, int F, int N,
                                int g, int n_chunks, void* stream) {
  return dispatch<Src::Uhat>(y, nullptr, nullptr, nullptr, out, F, N, g,
                             n_chunks, 1.f, stream);
}
