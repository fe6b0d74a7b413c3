// K1 and kernel 9: per-chunk Grams of the interleaved capture x[T, n2],
// U_c = sum_t u_t u_t^T over each chunk of g rows, on one mainloop.
//
// K1 (`doa_chunk_gram`) replaces the Pallas kernel
// doa_tpu/ops/pallas/cov_embedded.py:191 `_cov_kernel_uhat` (the stacked
// variant of cov_embedded_pallas) and writes U_c f32[n2, n2]. Kernel 9
// (`doa_chunk_embedded`) replaces `_cov_kernel` of the same file (:99,
// variant="chunk") and writes each chunk's embedded covariance E(R) with
// the 1/S scale, the calibration correction and forward-backward
// averaging applied in its epilogue. The TPU kernels pack TPACK time steps
// into 128 lanes and run the f32 Gram as a bf16 hi/lo split on the MXU;
// here the capture is read in its natural layout (n2 = 2N: re, im
// interleaved per element, the bytes of a C-ordered complex64 (T, N)
// buffer) and every product is a true FP32 FMA on the CUDA cores (int8: an
// exact int32 multiply-add). No tensor cores, no TF32.
//
// What bounds them on an H100 (headline: T = 2^24, n2 = 32, g = 1024;
// 3.35 TB/s, 67 TFLOP/s FP32, 1979 TOP/s int8): the capture read once and
// U or E written once, against the Gram's upper triangle (2^24 * 32 * 33
// operations: 0.26 ms at the FP32 rate, 0.0045 ms at the int8 rate):
//   f32   2 GiB + 64 MiB  0.661 ms  bytes
//   bf16  1 GiB + 64 MiB  0.341 ms  bytes (FP32 FMAs, 0.26 ms, come close)
//   int8  512 MiB + 64 MiB 0.180 ms  bytes; but this kernel's int32
//         multiply-adds on the CUDA cores issue at about half the FP32
//         rate, ~0.5 ms for the triangle, so its arithmetic limits it
// Kernel 9 adds an O(n2^2) epilogue a chunk to K1's O(g n2^2).
//
// Design (one mainloop, `gram_mainloop`, for both entries):
// - Persistent grid: as many blocks as fit on the card (2 a SM), each
//   walking a contiguous run of whole chunks, so a small g does not cost a
//   block a chunk and copies stay in flight across chunk boundaries. One
//   block computes each chunk, in a fixed order: no atomics on the result,
//   which does not depend on the grid.
// - Loads: 1-D bulk async copies (cp.async.bulk ... mbarrier::complete_tx,
//   no tensor map) into a ring of STAGES stages of STAGE_BYTES in dynamic
//   shared memory, one mbarrier a stage carrying its bytes. The last warp
//   to leave a slot refills it (a count a slot), so no warp waits for the
//   slowest one between chunk ends and up to STAGES - 1 copies are in
//   flight while the block computes (2 blocks a SM: ~128 KiB a SM). Bulk
//   copies were taken over cp.async.cg because one thread moves a whole
//   stage with no registers and no per-thread address arithmetic. A bulk
//   copy needs 16-byte-aligned addresses and sizes: a stage is a multiple
//   of 16 rows and a block starts on a chunk whose byte offset is a
//   multiple of 16, so every stage of a launch sits at the same offset
//   (x mod 16) in its slot; the < 16-byte head and tail of a stage that
//   breaks the alignment (int8 or bf16 at n2 = 6 or 30, odd g, a sliced
//   view) are plain loads. Shared-memory reads are RT-vectors where that
//   offset allows (VEC), else element loads.
// - The upper triangle only: each thread owns an RT x RT register tile
//   (RT = 4 when 4 | n2 <= 64, RT = 2 for even n2 <= 30) with i0 <= j0 (36
//   of the 64 tiles at n2 = 32) and a residue class of each chunk's rows;
//   one row costs it 2 vector loads from shared memory for RT^2 FMAs. At a
//   chunk's end the classes' partial tiles go to a reduction buffer of
//   their own (the ring is already taking the next copies), the threads
//   of a tile sum its entries over the classes in order, and K1 writes
//   U[i][j] and U[j][i] from one value, so the mirror is exact.
// - Small chunks (K1, where a stage holds a chunk for every class,
//   g * classes <= rows a stage: g <= 36 at f32 n2 = 32): the classes take
//   whole chunks in turn instead, and each writes its tile and the mirror
//   from registers as RT-vector stores, with no reduction and no barrier
//   at chunk ends (a chunk's reduction and barriers cost about a
//   microsecond a block, and the scattered entry stores, which set the
//   pace at g = 8). Kernel 9's epilogue needs the whole Gram in one
//   place, so it always shares chunks across the classes.
// - What limits it (exp_cov_gram.py times patched copies of this file;
//   PERF.md): f32 runs within ~5% of its copies and chunk-end work
//   without the FMAs (~1.2x the bytes bound); bf16 and int8 are bound by
//   the arithmetic (the widening, and int32 issuing at half the FP32
//   rate); the chunk-end reduction and its barriers cost most of the
//   rest. The reduction buffer is entry-major: stored tile-major, a
//   warp's partial stores and sums hit one bank 16 times over.
//
// int8: entries are at most g*127^2, exact in int32 for g < 133144; the
// per-chunk cast to f32 is exact while g*127^2 < 2^24 (g <= 1040) and
// otherwise rounds once to f32 (relative 2^-24), as the TPU kernel does.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int THREADS = 256;
constexpr int STAGES = 3;
constexpr int STAGE_BYTES = 32768;          // a stage's rows, at most
constexpr int SLOT = STAGE_BYTES + 16;      // + the offset x mod 16
constexpr int OFF_RING = 128;               // barriers and counts first
constexpr int OFF_RED = OFF_RING + STAGES * SLOT;
constexpr int RED_BYTES = THREADS * 16 * 4; // groups*tiles*RT^2 <= this
constexpr int SMEM = OFF_RED + RED_BYTES;

template <typename T> struct Acc { using type = float; };
template <> struct Acc<int8_t> { using type = int; };

__device__ __forceinline__ float to_acc(float v) { return v; }
__device__ __forceinline__ float to_acc(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ int to_acc(int8_t v) { return (int)v; }

template <typename T, int RT> struct alignas(sizeof(T) * RT) Raw {
  T v[RT];
};

// Rows a stage holds (a multiple of 16) at rb bytes a row.
__host__ __device__ constexpr int stage_rows(int rb) {
  return (STAGE_BYTES / rb) & ~15;
}

// Row classes of a block: the copies of the n2/RT tiles' upper triangle.
__host__ __device__ constexpr int row_classes(int n2, int rt) {
  return THREADS / ((n2 / rt) * (n2 / rt + 1) / 2);
}

// Whether each class takes whole chunks (K1 at small g): where a stage
// holds a chunk for every class.
__host__ __device__ constexpr bool whole_chunks(int g, int n2, int rt,
                                                int rb) {
  return (long long)g * row_classes(n2, rt) <= stage_rows(rb);
}

// Chunks a block's run starts on: the least q with q*g*rb = 0 mod 16.
__host__ __device__ __forceinline__ int chunk_unit(int g, int rb) {
  int q = 1;
  while (((long long)q * g * rb) % 16 != 0) q *= 2;
  return q;
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

// RT values of a row from shared memory, widened to the accumulator type.
template <typename T, int RT, bool VEC, typename A>
__device__ __forceinline__ void load_row(const unsigned char* p,
                                         A (&v)[RT]) {
  const T* q = reinterpret_cast<const T*>(p);
  if constexpr (VEC && std::is_same_v<T, __nv_bfloat16>) {
    // a bf16 is the high half of its f32: two values a 32-bit word
    const Raw<uint32_t, RT / 2> r =
        *reinterpret_cast<const Raw<uint32_t, RT / 2>*>(q);
#pragma unroll
    for (int i = 0; i < RT / 2; ++i) {
      v[2 * i] = __uint_as_float(r.v[i] << 16);
      v[2 * i + 1] = __uint_as_float(r.v[i] & 0xffff0000u);
    }
  } else if constexpr (VEC) {
    const Raw<T, RT> r = *reinterpret_cast<const Raw<T, RT>*>(q);
#pragma unroll
    for (int i = 0; i < RT; ++i) v[i] = to_acc(r.v[i]);
  } else {
#pragma unroll
    for (int i = 0; i < RT; ++i) v[i] = to_acc(q[i]);
  }
}

// U[i][j] of the chunk just reduced: class 0's slot of the upper-triangle
// tile entry that holds (i, j) or its mirror (layout: see gram_mainloop).
template <int RT>
__device__ __forceinline__ float u_at(const float* red, int i, int j,
                                      int nt, int width) {
  int ib = i / RT, jb = j / RT, ii = i % RT, jj = j % RT;
  if (ib > jb || (ib == jb && ii > jj)) {
    int t = ib; ib = jb; jb = t;
    t = ii; ii = jj; jj = t;
  }
  const int ti = ib * nt - ib * (ib - 1) / 2 + (jb - ib);
  return red[(ii * RT + jj) * width + ti];
}

// The Grams of the chunks of this block's run. At each chunk's end the
// row classes' tiles land in `red`; the threads of each tile sum its
// upper-triangle entries over the classes in order and hand each to
// epi.entry(c, i, j, sum, class 0's slot), then, where Epi::kFinish,
// epi.finish(c, red, nt, width) runs with every thread of the block. With
// WHOLE (whole_chunks holds; K1 only), each class takes whole chunks and
// each tile goes to epi.tile(c, i0, j0, acc) from its thread's registers
// instead. Every thread must call this.
template <typename T, int RT, bool VEC, bool WHOLE, typename A, typename Epi>
__device__ __forceinline__ void gram_mainloop(const T* __restrict__ x,
                                              long long n_chunks, int g,
                                              int n2, unsigned char* smem,
                                              const Epi& epi) {
  const int tid = threadIdx.x;
  const int rb = n2 * (int)sizeof(T);                  // bytes a row
  const int unit = chunk_unit(g, rb);
  const long long units = (n_chunks + unit - 1) / unit;
  const long long c0 = units * blockIdx.x / gridDim.x * unit;
  const long long c1 =
      min(units * (blockIdx.x + 1) / gridDim.x * unit, n_chunks);
  if (c0 >= c1) return;
  const int TS = stage_rows(rb);
  const long long R0 = c0 * g, R1 = c1 * g;
  const int nst = (int)((R1 - R0 + TS - 1) / TS);
  const uintptr_t xb = reinterpret_cast<uintptr_t>(x);
  const int phase = (int)(xb & 15);                    // the same each stage

  // full[s]: slot s's bytes landed; left[s]: warps done with slot s
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  int* left = reinterpret_cast<int*>(full + STAGES);
  unsigned char* ring = smem + OFF_RING;
  A* red = reinterpret_cast<A*>(smem + OFF_RED);

  // this thread's tile (ib, jb), ib <= jb, and row class rg; red holds
  // entry e of thread (ti, rg)'s partial tile at e * width + rg * ntri +
  // ti, so a warp's stores and loads of one entry hit consecutive banks
  const int nt = n2 / RT, ntri = nt * (nt + 1) / 2;    // ntri <= THREADS
  const int groups = row_classes(n2, RT), width = groups * ntri;
  const int ti = tid % ntri, rg = tid / ntri;
  const bool active = rg < groups;
  int ib = 0, rem = ti;
  while (rem >= nt - ib) { rem -= nt - ib; ++ib; }
  const int i0 = ib * RT, j0 = (ib + rem) * RT;
  const int oi = i0 * (int)sizeof(T), oj = j0 * (int)sizeof(T);
  const int step = groups * rb;                        // a class's row stride

  // stage k's rows into slot k % STAGES: the aligned middle by one bulk
  // copy and the head and tail (< 16 bytes each) by plain loads
  auto issue = [&](int k) {
    const long long r = R0 + (long long)k * TS;
    const long long rows = min((long long)TS, R1 - r);
    const uintptr_t s = xb + (uintptr_t)(r * rb);
    const uintptr_t e = s + (uintptr_t)(rows * rb);
    const uintptr_t s0 = s & ~(uintptr_t)15;
    const uintptr_t up = (s + 15) & ~(uintptr_t)15, dn = e & ~(uintptr_t)15;
    const uintptr_t a = up < e ? up : e;
    const uintptr_t b = dn > a ? dn : a;
    unsigned char* dst = ring + (k % STAGES) * SLOT;
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
    for (int s = 0; s < STAGES; ++s) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
                   :: "r"(smem_addr(full + s)) : "memory");
      left[s] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int k = 0; k < min(STAGES, nst); ++k) issue(k);
  }
  __syncthreads();

  A acc[RT][RT];
#pragma unroll
  for (int r = 0; r < RT; ++r)
#pragma unroll
    for (int s = 0; s < RT; ++s) acc[r][s] = 0;

  // this thread's RT x RT products of cnt rows, stride bytes apart, from
  // pa (its rows' values at i0; those at j0 lie oj - oi bytes on)
  auto fma_rows = [&](const unsigned char* pa, int cnt, int stride) {
    const unsigned char* pb = pa + (oj - oi);
#pragma unroll 4
    for (int it = 0; it < cnt; ++it, pa += stride, pb += stride) {
      A a[RT], bv[RT];
      load_row<T, RT, VEC>(pa, a);
      load_row<T, RT, VEC>(pb, bv);
#pragma unroll
      for (int u = 0; u < RT; ++u)
#pragma unroll
        for (int v = 0; v < RT; ++v) acc[u][v] += a[u] * bv[v];
    }
  };

  // WHOLE: class rg takes chunks c0 + rg, c0 + rg + groups, ... and hands
  // its tile to epi.tile from registers, with no reduction and no
  // barrier. cc is its chunk and nr its next row, relative to R0.
  long long cc = c0 + rg, nr = (long long)rg * g;
  // Otherwise the classes share each chunk: chunk c, the offset coff in it
  // of the stage's next row, and nxt, this thread's next row of chunk c
  // (offsets rg, rg + groups, ...)
  long long c = c0;
  int coff = 0, nxt = rg;
  for (int k = 0; k < nst; ++k) {
    mbar_wait(smem_addr(full + k % STAGES), (uint32_t)((k / STAGES) & 1));
    const int rows = (int)min((long long)TS, R1 - R0 - (long long)k * TS);
    const unsigned char* data = ring + (k % STAGES) * SLOT + phase;
    if constexpr (WHOLE) {
      const long long sb = (long long)k * TS, se = sb + rows;
      while (active && cc < c1 && nr < se) {
        const long long ce = (cc - c0 + 1) * g;
        const long long stop = min(ce, se);
        fma_rows(data + (nr - sb) * rb + oi, (int)(stop - nr), rb);
        nr = stop;
        if (nr == ce) {                                // chunk cc is done
          epi.tile(cc, i0, j0, acc);
#pragma unroll
          for (int u = 0; u < RT; ++u)
#pragma unroll
            for (int v = 0; v < RT; ++v) acc[u][v] = 0;
          cc += groups;
          nr = (cc - c0) * g;
        }
      }
    } else {
      for (int pos = 0; pos < rows;) {
        const int cend = coff + min(rows - pos, g - coff);
        if (active && nxt < cend) {
          const int cnt = (cend - nxt + groups - 1) / groups;
          fma_rows(data + (nxt + pos - coff) * rb + oi, cnt, step);
          nxt += cnt * groups;
        }
        pos += cend - coff;
        coff = cend;
        if (coff == g) {                               // chunk c is done
          if (active) {
            A* p = red + rg * ntri + ti;
#pragma unroll
            for (int u = 0; u < RT; ++u)
#pragma unroll
              for (int v = 0; v < RT; ++v) {
                p[(u * RT + v) * width] = acc[u][v];
                acc[u][v] = 0;
              }
          }
          __syncthreads();
          if (active) {
            // this tile's entries rg, rg + groups, ...: the sum over the
            // classes in order (a diagonal tile's lower half is its
            // mirror)
            for (int e = rg; e < RT * RT; e += groups) {
              const int ii = e / RT, jj = e % RT;
              if (i0 == j0 && ii > jj) continue;
              A* slot = red + e * width + ti;
              A sum = slot[0];
#pragma unroll 4
              for (int q = 1; q < groups; ++q) sum += slot[q * ntri];
              epi.entry(c, i0 + ii, j0 + jj, sum, slot);
            }
          }
          if constexpr (Epi::kFinish) {
            __syncthreads();
            epi.finish(c, red, nt, width);
          }
          __syncthreads();
          ++c;
          coff = 0;
          nxt = rg;
        }
      }
    }
    // the last warp out of slot k refills it with stage k + STAGES
    __syncwarp();
    if ((tid & 31) == 0 && k + STAGES < nst) {
      __threadfence_block();
      if (atomicAdd(left + k % STAGES, 1) == THREADS / 32 - 1) {
        left[k % STAGES] = 0;
        __threadfence_block();
        issue(k + STAGES);
      }
    }
  }
}

// K1's epilogue: U[i][j] and U[j][i] of chunk c from one value.
struct GramEpi {
  static constexpr bool kFinish = false;
  float* out;
  int n2;
  template <typename A>
  __device__ void entry(long long c, int i, int j, A sum, A*) const {
    float* oc = out + c * n2 * n2;
    oc[i * n2 + j] = (float)sum;
    if (i != j) oc[j * n2 + i] = (float)sum;
  }
  // A whole tile at (i0, j0) and its mirror, each row one RT-vector store
  // (RT | n2 and RT | j0, and the output is 16-byte aligned). A diagonal
  // tile is symmetric bit for bit (the same products in the same order).
  template <int RT, typename A>
  __device__ void tile(long long c, int i0, int j0,
                       const A (&acc)[RT][RT]) const {
    float* oc = out + c * n2 * n2;
#pragma unroll
    for (int u = 0; u < RT; ++u) {
      Raw<float, RT> r;
#pragma unroll
      for (int v = 0; v < RT; ++v) r.v[v] = (float)acc[u][v];
      *reinterpret_cast<Raw<float, RT>*>(oc + (i0 + u) * n2 + j0) = r;
    }
    if (i0 == j0) return;
#pragma unroll
    for (int v = 0; v < RT; ++v) {
      Raw<float, RT> r;
#pragma unroll
      for (int u = 0; u < RT; ++u) r.v[u] = (float)acc[u][v];
      *reinterpret_cast<Raw<float, RT>*>(oc + (j0 + v) * n2 + i0) = r;
    }
  }
  __device__ void finish(long long, const float*, int, int) const {}
};

// Kernel 9's epilogue: the chunk's embedded covariance E = [[rr, -ri],
// [ri, rr]] (N = n2/2), in the order of the plain version
// (ops/cuda/cov_embedded.py uhat_windows_to_embedded): the planar fold of
// the interleaved basis, rr = (U[2i][2j] + U[2i+1][2j+1])·scale,
// ri = (U[2i+1][2j] - U[2i][2j+1])·scale; the correction W = c c^H,
// (rr Wre - ri Wim, rr Wim + ri Wre); FB, (rr + flip(rr))/2,
// (ri - flip(ri))/2. Every step is one rounded FP32 operation (__fadd_rn
// and friends: no FMA contraction), as the plain version's elementwise
// torch ops, so the two agree bit for bit wherever the Grams agree. FB
// pairs (i, j) with (N-1-i, N-1-j): the thread folds both.
template <int RT> struct EmbeddedEpi {
  static constexpr bool kFinish = true;
  float* out;
  const float* Wre;
  const float* Wim;
  int n2, fb;
  float scale;
  // the reduced entry stays in class 0's slot for finish()
  __device__ void entry(long long, int, int, float sum, float* slot) const {
    *slot = sum;
  }
  // (rr, ri) at p = i*N + j, folded and corrected
  __device__ void fold(const float* red, int p, int N, int nt, int width,
                       float& rr, float& ri) const {
    const int i = p / N, j = p - i * N;
    const float u00 = u_at<RT>(red, 2 * i, 2 * j, nt, width);
    const float u11 = u_at<RT>(red, 2 * i + 1, 2 * j + 1, nt, width);
    const float u10 = u_at<RT>(red, 2 * i + 1, 2 * j, nt, width);
    const float u01 = u_at<RT>(red, 2 * i, 2 * j + 1, nt, width);
    const float r0 = __fmul_rn(__fadd_rn(u00, u11), scale);
    const float i0 = __fmul_rn(__fsub_rn(u10, u01), scale);
    const float wr = Wre[p], wi = Wim[p];
    rr = __fsub_rn(__fmul_rn(r0, wr), __fmul_rn(i0, wi));
    ri = __fadd_rn(__fmul_rn(r0, wi), __fmul_rn(i0, wr));
  }
  __device__ void finish(long long c, const float* red, int nt,
                         int width) const {
    const int N = n2 / 2, NN = N * N;
    float* oc = out + c * n2 * n2;
    for (int p = threadIdx.x; p < NN; p += THREADS) {
      const int i = p / N, j = p - i * N;
      float rr, ri;
      fold(red, p, N, nt, width, rr, ri);
      if (fb) {
        float rq, iq;                                  // (N-1-i, N-1-j)
        fold(red, NN - 1 - p, N, nt, width, rq, iq);
        rr = __fmul_rn(0.5f, __fadd_rn(rr, rq));
        ri = __fmul_rn(0.5f, __fsub_rn(ri, iq));
      }
      oc[i * n2 + j] = rr;
      oc[i * n2 + N + j] = -ri;
      oc[(N + i) * n2 + j] = ri;
      oc[(N + i) * n2 + N + j] = rr;
    }
  }
};

template <typename T, int RT, bool VEC, bool WHOLE>
__global__ void __launch_bounds__(THREADS, 2)
chunk_gram_kernel(const T* __restrict__ x, float* __restrict__ out,
                  long long n_chunks, int g, int n2) {
  extern __shared__ __align__(128) unsigned char smem[];
  gram_mainloop<T, RT, VEC, WHOLE, typename Acc<T>::type>(
      x, n_chunks, g, n2, smem, GramEpi{out, n2});
}

template <typename T, int RT, bool VEC>
__global__ void __launch_bounds__(THREADS, 2)
chunk_embedded_kernel(const T* __restrict__ x, const float* __restrict__ Wre,
                      const float* __restrict__ Wim, float* __restrict__ out,
                      long long n_chunks, int g, int n2, int fb,
                      float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  gram_mainloop<T, RT, VEC, false, float>(
      x, n_chunks, g, n2, smem, EmbeddedEpi<RT>{out, Wre, Wim, n2, fb, scale});
}

constexpr int MAX_DEVICES = 64;

// The persistent grid: every block that fits on the card at once, and no
// more than there are chunk units to walk. The shared-memory attribute and
// the blocks that fit are set up once a device for each instantiation.
template <auto Kernel, typename... Args>
int launch_grid(long long units, cudaStream_t stream, Args... args) {
  static int fit[MAX_DEVICES] = {};                    // 0: not set up yet
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (fit[dev] == 0) {
    int sms = 0, per_sm = 0;
    e = cudaFuncSetAttribute(Kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM);
    if (e != cudaSuccess) return (int)e;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, Kernel,
                                                      THREADS, SMEM);
    if (e != cudaSuccess) return (int)e;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    fit[dev] = per_sm * sms;
  }
  const long long grid = units < fit[dev] ? units : fit[dev];
  Kernel<<<(unsigned)grid, THREADS, SMEM, stream>>>(args...);
  return (int)cudaGetLastError();
}

template <int RT_, bool VEC_> struct Form {
  static constexpr int RT = RT_;
  static constexpr bool VEC = VEC_;
};

// RT x sizeof(T)-byte vector reads from shared memory need x's address
// mod 16 (every stage's offset in its slot) to be a multiple of that size.
template <typename T, int RT>
bool vec_ok(const void* x) {
  return reinterpret_cast<uintptr_t>(x) % (RT * sizeof(T)) == 0;
}

// go(Form<RT, VEC>{}, units) for n2's register-tile form and x's
// alignment, units being the chunk units of the persistent grid's walk.
template <typename T, typename Go>
int dispatch(const void* x, int n_chunks, int g, int n2, Go go) {
  if (g < 1 || n_chunks < 1 || n2 < 2) return (int)cudaErrorInvalidValue;
  const int q = chunk_unit(g, n2 * (int)sizeof(T));
  const long long units = ((long long)n_chunks + q - 1) / q;
  if (n2 % 4 == 0 && n2 <= 64)
    return vec_ok<T, 4>(x) ? go(Form<4, true>{}, units)
                           : go(Form<4, false>{}, units);
  if (n2 % 2 == 0 && n2 <= 30)
    return vec_ok<T, 2>(x) ? go(Form<2, true>{}, units)
                           : go(Form<2, false>{}, units);
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int launch(const void* x, void* out, int n_chunks, int g, int n2,
           cudaStream_t s) {
  return dispatch<T>(x, n_chunks, g, n2, [&](auto f, long long units) {
    using F = decltype(f);
    if (whole_chunks(g, n2, F::RT, n2 * (int)sizeof(T)))
      return launch_grid<chunk_gram_kernel<T, F::RT, F::VEC, true>>(
          units, s, (const T*)x, (float*)out, (long long)n_chunks, g, n2);
    return launch_grid<chunk_gram_kernel<T, F::RT, F::VEC, false>>(
        units, s, (const T*)x, (float*)out, (long long)n_chunks, g, n2);
  });
}

template <typename T>
int launch_embedded(const void* x, const void* Wre, const void* Wim, void* out,
                    int n_chunks, int g, int n2, int fb, float scale,
                    cudaStream_t s) {
  return dispatch<T>(x, n_chunks, g, n2, [&](auto f, long long units) {
    using F = decltype(f);
    return launch_grid<chunk_embedded_kernel<T, F::RT, F::VEC>>(
        units, s, (const T*)x, (const float*)Wre, (const float*)Wim,
        (float*)out, (long long)n_chunks, g, n2, fb, scale);
  });
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = int8. x: [n_chunks * g, n2]
// contiguous rows (any address aligned to the element); out:
// f32[n_chunks, n2, n2]. n2 = 2N: 4 | n2 <= 64, or n2 <= 30.
extern "C" int doa_chunk_gram(const void* x, void* out, int n_chunks, int g,
                              int n2, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case 0: return launch<float>(x, out, n_chunks, g, n2, s);
    case 1: return launch<__nv_bfloat16>(x, out, n_chunks, g, n2, s);
    case 2: return launch<int8_t>(x, out, n_chunks, g, n2, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Kernel 9. dtype: 0 = float32, 1 = bfloat16. x: [n_chunks * g, n2]
// contiguous; Wre, Wim: f32[N, N], N = n2 / 2, the correction c c^H;
// out: f32[n_chunks, n2, n2], each chunk's embedded covariance (scale,
// correction and, with fb != 0, forward-backward averaging applied). n2 as
// doa_chunk_gram.
extern "C" int doa_chunk_embedded(const void* x, const void* Wre,
                                  const void* Wim, void* out, int n_chunks,
                                  int g, int n2, int dtype, int fb,
                                  float scale, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case 0: return launch_embedded<float>(x, Wre, Wim, out, n_chunks, g, n2,
                                          fb, scale, s);
    case 1: return launch_embedded<__nv_bfloat16>(x, Wre, Wim, out, n_chunks,
                                                  g, n2, fb, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
