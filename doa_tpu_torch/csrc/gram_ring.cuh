// The bulk-copy ring mainloop of the chunk-Gram kernels: per chunk of g
// rows, the upper triangle of U_c = sum_t z_t z_t^T in register tiles,
// handed to an epilogue. Shared by K1 and kernel 9 (cov_gram.cu) and
// kernel 8 (covariance.cu); cov_gram.cu's head describes the design (the
// persistent grid, the ring of 1-D bulk copies, the row classes, the
// chunk-end reduction) and what limits it.
//
// Each kernel gives its own epilogue (an Epi: entry, tile, finish, fold) and
// picks its source and rounding through template arguments; what one
// kernel does not use is cut out at compile time (if constexpr), so the
// others compile to the code they had before they shared it.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

namespace gram_ring {

constexpr int THREADS = 256;
constexpr int STAGES = 3;
constexpr int STAGE_BYTES = 32768;          // a stage's rows, at most
constexpr int SLOT = STAGE_BYTES + 16;      // + the offset x mod 16
constexpr int OFF_RING = 128;               // barriers and counts first
constexpr int OFF_RED = OFF_RING + STAGES * SLOT;
constexpr int RED_BYTES = THREADS * 16 * 4; // groups*tiles*RT^2 <= this
constexpr int SMEM = OFF_RED + RED_BYTES;

// Where a launch's rows come from (gram_mainloop's SRC).
enum Src : int {
  SRC_ROWS = 0,    // one buffer of contiguous rows of n2 values (K1's x,
                   // and the two planes of an interleaved complex64 capture)
  SRC_PLANES = 1   // two planes of contiguous rows of n2/2 values each
};

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

// v rounded to bf16 (round to nearest even) and widened back: the value
// torch's x.to(torch.bfloat16).to(torch.float32) gives
__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// The n f32 values at p rounded to bf16 in place, by the block's threads
// (thread tid takes every THREADS-th float4, or value where p is not
// 16-byte aligned).
__device__ __forceinline__ void round_bf16(unsigned char* p, int n, int tid) {
  if ((reinterpret_cast<uintptr_t>(p) & 15) == 0) {
    float4* v = reinterpret_cast<float4*>(p);
    for (int q = tid; q < n / 4; q += THREADS) {
      float4 a = v[q];
      const float2 lo = __bfloat1622float2(__floats2bfloat162_rn(a.x, a.y));
      const float2 hi = __bfloat1622float2(__floats2bfloat162_rn(a.z, a.w));
      v[q] = make_float4(lo.x, lo.y, hi.x, hi.y);
    }
    float* t = reinterpret_cast<float*>(p);
    for (int q = n / 4 * 4 + tid; q < n; q += THREADS) t[q] = bf16_round(t[q]);
  } else {
    float* t = reinterpret_cast<float*>(p);
    for (int q = tid; q < n; q += THREADS) t[q] = bf16_round(t[q]);
  }
}

// RT values of a row from shared memory, widened to the accumulator type
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
// epi.finish(c, red, nt, width) runs with every thread of the block. Where
// Epi::kFold, epi.fold(c, red, nt, ntri, groups) runs with every thread
// instead of both: it sums what it needs from the classes' partial tiles
// itself (entry e of class q's tile ti at red[e * width + q * ntri + ti],
// width = groups * ntri), so no further barrier is taken. Where
// Epi::kLead (kernel 9's window epilogue), the block's walk starts at
// epi.lead(c0, unit), a unit boundary at or below its first chunk c0, and
// the chunks before c0 reach epi.fold like the others (the epilogue
// stores nothing from them). With WHOLE (whole_chunks holds; K1 only),
// each class takes whole chunks and each tile goes to epi.tile(c, i0, j0,
// acc) from its thread's registers instead. Every thread must call this.
//
// SRC (enum Src) says where the rows come from: SRC_ROWS, x's contiguous
// rows of n2 values; SRC_PLANES, two planes x and xi of contiguous rows of
// n2/2 values (n2/2 a multiple of RT, the planes' addresses equal mod 16),
// whose stage lands as its x rows, then its xi rows, `half` bytes on, so
// that row t of Z = [x | xi] is read in two pieces with one stride.
// BF16 rounds f32 rows to bf16 once a stage, in place after its copy
// lands.
template <typename T, int RT, bool VEC, bool WHOLE, typename A, typename Epi,
          int SRC = SRC_ROWS, bool BF16 = false>
__device__ __forceinline__ void gram_mainloop(const T* __restrict__ x,
                                              long long n_chunks, int g,
                                              int n2, unsigned char* smem,
                                              const Epi& epi,
                                              const T* __restrict__ xi =
                                                  nullptr) {
  static_assert(!BF16 || std::is_same_v<T, float>, "f32 rows only");
  static_assert(!(WHOLE && Epi::kLead), "a lead-in shares its chunks");
  const int tid = threadIdx.x;
  // bytes a row (of one plane, for planes)
  const int rb = (SRC == SRC_PLANES ? n2 / 2 : n2) * (int)sizeof(T);
  const int unit = chunk_unit(g, rb);
  const long long units = (n_chunks + unit - 1) / unit;
  const long long c0 = units * blockIdx.x / gridDim.x * unit;
  const long long c1 =
      min(units * (blockIdx.x + 1) / gridDim.x * unit, n_chunks);
  if (c0 >= c1) return;
  long long cw = c0;                        // the walk's first chunk
  if constexpr (Epi::kLead) cw = epi.lead(c0, unit);
  // planes: a stage's xi rows start one row past its x rows' room, so that
  // xi's column i lies in the banks of column n2/2 + i of one contiguous
  // row of Z (a stage's x rows span a multiple of 128 bytes)
  const int TS = SRC == SRC_PLANES ? ((STAGE_BYTES - rb) / (2 * rb)) & ~15
                                   : stage_rows(rb);
  const int half = SRC == SRC_PLANES ? (TS + 1) * rb : 0;
  const long long R0 = cw * g, R1 = c1 * g;
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
  // the byte offset of Z's column i in a staged row
  auto col = [&](int i) {
    if constexpr (SRC == SRC_PLANES)
      return i < n2 / 2 ? i * (int)sizeof(T)
                        : half + (i - n2 / 2) * (int)sizeof(T);
    else
      return i * (int)sizeof(T);
  };
  const int oi = col(i0), oj = col(j0);
  const int step = groups * rb;                        // a class's row stride

  // stage k's rows into slot k % STAGES: the aligned middle by one bulk
  // copy and the head and tail (< 16 bytes each) by plain loads
  auto issue_rows = [&](int k) {
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

  // planes: the stage's x rows at the slot's start and its xi rows `half`
  // bytes on (the planes share their offset mod 16), each plane's aligned
  // middle by its own bulk copy, both under one expect_tx
  auto issue_planes = [&](int k) {
    const long long r = R0 + (long long)k * TS;
    const long long rows = min((long long)TS, R1 - r);
    unsigned char* slot = ring + (k % STAGES) * SLOT;
    const uintptr_t xib = reinterpret_cast<uintptr_t>(xi);
    uintptr_t a[2], b[2], s0[2];
    bool plain = false;
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const uintptr_t s = (p ? xib : xb) + (uintptr_t)(r * rb);
      const uintptr_t e = s + (uintptr_t)(rows * rb);
      s0[p] = s & ~(uintptr_t)15;
      const uintptr_t up = (s + 15) & ~(uintptr_t)15,
                      dn = e & ~(uintptr_t)15;
      a[p] = up < e ? up : e;
      b[p] = dn > a[p] ? dn : a[p];
      unsigned char* dst = slot + p * half;
      if (a[p] != s || b[p] != e) {
        for (uintptr_t q = s; q < a[p]; ++q)
          dst[q - s0[p]] = *reinterpret_cast<const unsigned char*>(q);
        for (uintptr_t q = b[p]; q < e; ++q)
          dst[q - s0[p]] = *reinterpret_cast<const unsigned char*>(q);
        plain = true;
      }
    }
    if (plain)
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    const uint32_t bar = smem_addr(full + k % STAGES);
    const uint32_t bytes = (uint32_t)(b[0] - a[0] + b[1] - a[1]);
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 :: "r"(bar), "r"(bytes) : "memory");
#pragma unroll
    for (int p = 0; p < 2; ++p)
      if (b[p] > a[p])
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::"
            "bytes [%0], [%1], %2, [%3];"
            :: "r"(smem_addr(slot + p * half + (a[p] - s0[p]))),
               "l"(reinterpret_cast<const void*>(a[p])),
               "r"((uint32_t)(b[p] - a[p])), "r"(bar)
            : "memory");
  };
  auto issue = [&](int k) {
    if constexpr (SRC == SRC_PLANES)
      issue_planes(k);
    else
      issue_rows(k);
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
      load_row<T, RT, VEC, A>(pa, a);
      load_row<T, RT, VEC, A>(pb, bv);
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
  long long c = cw;
  int coff = 0, nxt = rg;
  for (int k = 0; k < nst; ++k) {
    mbar_wait(smem_addr(full + k % STAGES), (uint32_t)((k / STAGES) & 1));
    const int rows = (int)min((long long)TS, R1 - R0 - (long long)k * TS);
    const unsigned char* data = ring + (k % STAGES) * SLOT + phase;
    if constexpr (BF16) {
      // the stage's values rounded to bf16 in place, once, each thread a
      // share; the proxy fence orders these writes before the slot's next
      // bulk copy, the barrier before any thread reads them
      unsigned char* st = ring + (k % STAGES) * SLOT + phase;
#pragma unroll
      for (int p = 0; p < (SRC == SRC_PLANES ? 2 : 1); ++p)
        round_bf16(st + p * half, rows * rb / (int)sizeof(float), tid);
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      __syncthreads();
    }
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
          if constexpr (Epi::kFold) {
            epi.fold(c, red, nt, ntri, groups);
          } else if (active) {
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
          // no thread writes `red` again before its next chunk end, in a
          // stage STAGES or more on when g >= STAGES * TS: a warp reaches
          // that stage only once every warp has left this one (its slot's
          // refill), so the barrier that keeps a slow thread's reads
          // before the next partial stores is needed only below that
          if (g < STAGES * TS) __syncthreads();
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

}  // namespace gram_ring
