// Kernels 8 and 12: covariance planes from sample planes (the planes path).
//
// Replaces the two Pallas kernels of doa_tpu/ops/pallas/covariance.py:
//
//   kernel 8, `_chunk_kernel` (chunk_grams_pallas): per chunk of g rows,
//     the Gram of Z = [Xr | Xi] (g x 2N), folded to the unnormalised planes
//     Rr = XrT Xr + XiT Xi = TL + BR and Ri = XiT Xr - XrT Xi = BL - TR
//     (f32[n, N, N] each); f32 products, or bf16-rounded inputs with f32
//     accumulation;
//   kernel 12, `_cov_kernel` (cov_windows_pallas, gcd(S, hop) < 64): the
//     Gram of each window of S rows starting at b*hop, divided by S and
//     folded the same way. Every window's Gram is a sum of its own
//     products, as on the TPU (no running sums and no sliding update:
//     those are other computations with other rounding).
//
// Inputs are two f32 plane pointers with a row stride and an element
// stride: separate planes have element stride 1; the planes of an
// interleaved complex64 capture are the views x[..., 0] and x[..., 1] of
// x f32[T, N, 2], element stride 2.
//
// Kernel 8 has two forms, each its own entry; the wrapper
// (ops/cuda/covariance.py, chunk_form) picks one by the planes' layout:
// - the ring form (`doa_planes_chunk_grams_ring`): the bulk-copy ring
//   mainloop of K1 and kernel 9 (gram_ring.cuh) with a planar-fold
//   epilogue. Its sources: the two views of one interleaved buffer with
//   contiguous rows are K1's x itself (rows of n2 = 2N values, in the
//   interleaved basis u = (re0, im0, re1, im1, ...)); two separate planes
//   of contiguous rows (4 | N, their addresses equal mod 16) land in a
//   stage as its Xr rows, then its Xi rows (the Z basis). At the chunk's
//   end the epilogue folds the reduced upper triangle, every (i, j) from
//   the same two entries as (j, i): Rr = U[re i][re j] + U[im i][im j],
//   Ri = U[im i][re j] - U[re i][im j], one rounded add each, so Rr is
//   symmetric, Ri antisymmetric and its diagonal 0, bit for bit. bf16
//   rounds the f32 rows once a stage, in place in shared memory.
// - the staged form (`doa_planes_chunk_grams`, planes_gram_kernel<...,
//   false>): any other strides. A block owns a chunk; its rows pass
//   through shared memory as Z, synchronously (interleaved rows two (re,
//   im) pairs a thread as one float4, or one pair as a float2, split into
//   Z; planes of contiguous rows as float4 of one plane; any other strides
//   one value a thread), into an RT x RT register tile a thread of the
//   full 2N x 2N Gram.
//
// Kernel 12 has two forms, picked by (N, S, hop) (windows_form):
// - the chunk-sum form (`doa_planes_window_sums`): with g = gcd(S, hop),
//   every window is the union of m = S/g whole chunks of g rows, hop/g
//   = h chunks apart, so its Gram is the ordered sum of those chunks'
//   Grams. A block walks a contiguous run of windows chunk by chunk, a
//   slab of chunks at a time: the slab's rows arrive by async copies
//   (cp.async, issued while the previous slab was summed; an interleaved
//   buffer's rows as they lie, in the interleaved basis, others as Z); it
//   computes each chunk's Gram upper triangle once (RT = 4 register tiles
//   over the chunk's g rows, in row order) into shared memory, and adds
//   it, in chunk order, into every window open at that chunk. An open window
//   lives in registers: NS = ceil(m/h) slots, window b in slot
//   (b - b0) % NS, each thread holding one 4-entry row of a tile (a
//   "quad") for W slots; a slot is zeroed when its window opens and
//   written (each entry / S) when its last chunk has been added; the slab
//   then folds its closed windows through a table of each (i, j)'s four
//   entries. Only the chunks of a run's first
//   window that the previous run also read are computed twice; the sum
//   order does not depend on the grid. Work: the chunk Grams (the upper
//   triangle's tiles, 576 products a row at N = 16) and m adds a window
//   entry, against S products a window entry for one Gram a window.
// - the per-window form (`doa_planes_cov_windows`, planes_gram_kernel<...,
//   true>): a block a window, its full Gram over the S rows; where the
//   open windows' slots do not fit a block's registers (e.g. hop = 1),
//   2N > 32 or N odd.
//
// What bounds them on an H100: kernel 8 at c3 (T = 2^24, N = 16, g = 1024)
// reads 2 GiB once (0.64 ms at 3.35 TB/s) for 2^24 * 528 FMAs of the
// Hermitian half (0.26 ms at the 67 TFLOP/s FP32 peak): memory. Kernel 12
// at T = 2^20, N = 16, S = 1024, hop 24 reads 128 MiB and writes 89 MB
// (0.067 ms); its chunk-sum form adds B * 128 * 576 values (~0.1 ms of
// FP32 adds at the peak issue rate), where one Gram a window would take
// B * S * 528 FMAs (~0.7 ms at the peak). True FP32 FMAs on the CUDA cores
// (no TF32); bf16 rounds on load (round to nearest even), and a product
// of two bf16 values is exact in FP32.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "gram_ring.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int STAGE = 4096;     // staged values (16 KiB); also the
                                // reduction buffer: THREADS * RT^2 <= STAGE

template <bool BF16>
__device__ __forceinline__ float load_cvt(float v) {
  if (BF16) return __bfloat162float(__float2bfloat16_rn(v));
  return v;
}

struct alignas(16) Vec4 { float v[4]; };
struct alignas(8) Vec2 { float v[2]; };
template <int RT> struct VecT;
template <> struct VecT<4> { using type = Vec4; };
template <> struct VecT<2> { using type = Vec2; };

// How a block stages rows into Z = [Xr | Xi] (host-chosen, see the entries)
enum Load : int {
  LOAD_ILV4 = 0,    // interleaved rows, float4 = two (re, im) pairs
  LOAD_ILV2 = 1,    // interleaved rows, float2 = one pair
  LOAD_PLANAR4 = 2, // planes with contiguous rows, float4 of one plane
  LOAD_GENERIC = 3  // any strides, one value a thread
};

// Block b: Gram of rows [b*step, b*step + rows) of Z = [Xr | Xi], folded.
// WIN: divide each Gram entry by S before the fold (kernel 12). Each
// thread's place in a stage (row offset, column) is fixed; a stage's rows
// advance by `rstep`, so the loads carry no division.
template <int RT, int LOAD, bool BF16, bool WIN>
__global__ void __launch_bounds__(THREADS)
planes_gram_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                   long long rs, long long es, float* __restrict__ rr_out,
                   float* __restrict__ ri_out, long long step, int rows,
                   int N, float S) {
  using V = typename VecT<RT>::type;
  __shared__ __align__(16) float tile[STAGE];
  const int n2 = 2 * N;
  const int tid = threadIdx.x;
  const int nt = n2 / RT;                 // register tiles per side
  const int ntiles = nt * nt;             // <= THREADS (host-checked)
  const int groups = THREADS / ntiles;    // residue classes of rows
  const int ti = tid % ntiles, rg = tid / ntiles;
  const bool active = rg < groups;
  const int i0 = (ti / nt) * RT, j0 = (ti % nt) * RT;
  const int TS = STAGE / n2;              // rows per stage
  const long long r0 = (long long)blockIdx.x * step;
  // loads a row takes: ILV4 N/2, ILV2 N, PLANAR4 2 * N/4, GENERIC 2N
  const int per_row = LOAD == LOAD_ILV4 ? N / 2
                      : LOAD == LOAD_ILV2 ? N
                      : LOAD == LOAD_PLANAR4 ? N / 2 : n2;
  const int rstep = THREADS / per_row;    // rows a pass of the block loads
  const int lt = tid / per_row, lc = tid - lt * per_row;
  const bool loader = lt < rstep;

  float acc[RT][RT];
#pragma unroll
  for (int r = 0; r < RT; ++r)
#pragma unroll
    for (int s = 0; s < RT; ++s) acc[r][s] = 0.f;

  for (int t0 = 0; t0 < rows; t0 += TS) {
    const int nr = min(TS, rows - t0);
    if (loader) {
      for (int t = lt; t < nr; t += rstep) {
        const long long row = (r0 + t0 + t) * rs;
        float* z = tile + t * n2;
        if (LOAD == LOAD_ILV4) {          // pairs 2lc, 2lc + 1
          const float4 v = *reinterpret_cast<const float4*>(xr + row + 4 * lc);
          z[2 * lc] = load_cvt<BF16>(v.x);
          z[2 * lc + 1] = load_cvt<BF16>(v.z);
          z[N + 2 * lc] = load_cvt<BF16>(v.y);
          z[N + 2 * lc + 1] = load_cvt<BF16>(v.w);
        } else if (LOAD == LOAD_ILV2) {   // pair lc
          const float2 v = *reinterpret_cast<const float2*>(xr + row + 2 * lc);
          z[lc] = load_cvt<BF16>(v.x);
          z[N + lc] = load_cvt<BF16>(v.y);
        } else if (LOAD == LOAD_PLANAR4) {  // 4 values of one plane
          const int q = N / 4;
          const bool im = lc >= q;
          const int c = 4 * (im ? lc - q : lc);
          const float4 v = *reinterpret_cast<const float4*>(
              (im ? xi : xr) + row + c);
          float4 w;
          w.x = load_cvt<BF16>(v.x);
          w.y = load_cvt<BF16>(v.y);
          w.z = load_cvt<BF16>(v.z);
          w.w = load_cvt<BF16>(v.w);
          *reinterpret_cast<float4*>(z + (im ? N : 0) + c) = w;
        } else {                          // column lc of Z
          const float v = lc < N ? xr[row + lc * es] : xi[row + (lc - N) * es];
          z[lc] = load_cvt<BF16>(v);
        }
      }
    }
    __syncthreads();
    if (active) {
      for (int t = rg; t < nr; t += groups) {
        const V a = *reinterpret_cast<const V*>(tile + t * n2 + i0);
        const V b = *reinterpret_cast<const V*>(tile + t * n2 + j0);
#pragma unroll
        for (int r = 0; r < RT; ++r)
#pragma unroll
          for (int s = 0; s < RT; ++s) acc[r][s] += a.v[r] * b.v[s];
      }
    }
    __syncthreads();
  }

  // the row classes' partial Grams, summed in a fixed order into tile[0:n2^2]
  if (active) {
#pragma unroll
    for (int r = 0; r < RT; ++r)
#pragma unroll
      for (int s = 0; s < RT; ++s)
        tile[(rg * n2 + i0 + r) * n2 + j0 + s] = acc[r][s];
  }
  __syncthreads();
  for (int idx = tid; idx < n2 * n2; idx += THREADS) {
    float sum = tile[idx];
    for (int q = 1; q < groups; ++q) sum += tile[q * n2 * n2 + idx];
    tile[idx] = sum;
  }
  __syncthreads();

  // fold: Rr = TL + BR, Ri = BL - TR (each entry / S first for windows)
  const long long ob = (long long)blockIdx.x * N * N;
  for (int idx = tid; idx < N * N; idx += THREADS) {
    const int i = idx / N, j = idx - i * N;
    float tl = tile[i * n2 + j], br = tile[(N + i) * n2 + N + j];
    float bl = tile[(N + i) * n2 + j], tr = tile[i * n2 + N + j];
    if (WIN) {
      tl = __fdiv_rn(tl, S);
      br = __fdiv_rn(br, S);
      bl = __fdiv_rn(bl, S);
      tr = __fdiv_rn(tr, S);
    }
    rr_out[ob + idx] = tl + br;
    ri_out[ob + idx] = bl - tr;
  }
}

template <bool BF16, bool WIN>
int launch(const float* xr, const float* xi, long long rs, long long es,
           int load, float* rr, float* ri, int n_blocks, long long step,
           int rows, int N, float S, cudaStream_t stream) {
  const int n2 = 2 * N;
  if (n_blocks < 1 || rows < 1 || N < 1 || load < 0 || load > 3)
    return (int)cudaErrorInvalidValue;
#define DOA_PLANES_LAUNCH(RT, L)                                             \
  planes_gram_kernel<RT, L, BF16, WIN><<<n_blocks, THREADS, 0, stream>>>(    \
      xr, xi, rs, es, rr, ri, step, rows, N, S)
  if (n2 % 4 == 0 && n2 <= 64) {          // N even: every load form
    switch (load) {
      case LOAD_ILV4: DOA_PLANES_LAUNCH(4, LOAD_ILV4); break;
      case LOAD_ILV2: DOA_PLANES_LAUNCH(4, LOAD_ILV2); break;
      case LOAD_PLANAR4:
        if (N % 4) return (int)cudaErrorInvalidValue;
        DOA_PLANES_LAUNCH(4, LOAD_PLANAR4);
        break;
      default: DOA_PLANES_LAUNCH(4, LOAD_GENERIC); break;
    }
  } else if (n2 <= 30) {                  // N odd: no pair of pairs
    switch (load) {
      case LOAD_ILV2: DOA_PLANES_LAUNCH(2, LOAD_ILV2); break;
      case LOAD_GENERIC: DOA_PLANES_LAUNCH(2, LOAD_GENERIC); break;
      default: return (int)cudaErrorInvalidValue;
    }
  } else {
    return (int)cudaErrorInvalidValue;
  }
#undef DOA_PLANES_LAUNCH
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------
// Kernel 8's ring form
// ---------------------------------------------------------------------

// The planar fold of the chunk's reduced Gram (the class-0 slots of the
// upper triangle, read through u_at) into (Rr, Ri) f32[n, N, N]. Z's row
// of Re/Im of element i: 2i/2i + 1 in the interleaved basis (SRC_ROWS),
// i/N + i in the Z basis (SRC_PLANES). Every (i, j) reads the same two
// slots as (j, i), so the mirror is exact.
template <int RT, int SRC> struct PlanesEpi {
  static constexpr bool kFinish = true, kFold = false, kLead = false;
  float* rr;
  float* ri;
  int N;
  // the reduced entry stays in class 0's slot for finish()
  __device__ void entry(long long, int, int, float sum, float* slot) const {
    *slot = sum;
  }
  __device__ int re(int i) const {
    return SRC == gram_ring::SRC_PLANES ? i : 2 * i;
  }
  __device__ int im(int i) const {
    return SRC == gram_ring::SRC_PLANES ? N + i : 2 * i + 1;
  }
  __device__ void finish(long long c, const float* red, int nt,
                         int width) const {
    const int NN = N * N;
    float* oc_r = rr + c * NN;
    float* oc_i = ri + c * NN;
    for (int p = threadIdx.x; p < NN; p += gram_ring::THREADS) {
      const int i = p / N, j = p - i * N;
      const float tl = gram_ring::u_at<RT>(red, re(i), re(j), nt, width);
      const float br = gram_ring::u_at<RT>(red, im(i), im(j), nt, width);
      const float bl = gram_ring::u_at<RT>(red, im(i), re(j), nt, width);
      const float tr = gram_ring::u_at<RT>(red, re(i), im(j), nt, width);
      oc_r[p] = __fadd_rn(tl, br);
      oc_i[p] = __fsub_rn(bl, tr);
    }
  }
};

template <int RT, bool VEC, int SRC, bool BF16>
__global__ void __launch_bounds__(gram_ring::THREADS, 2)
planes_ring_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                   float* __restrict__ rr, float* __restrict__ ri,
                   long long n_chunks, int g, int n2) {
  extern __shared__ __align__(128) unsigned char smem[];
  gram_ring::gram_mainloop<float, RT, VEC, false, float, PlanesEpi<RT, SRC>,
                           SRC, BF16>(
      xr, n_chunks, g, n2, smem, PlanesEpi<RT, SRC>{rr, ri, n2 / 2}, xi);
}

template <int SRC, bool BF16>
int launch_ring(const float* xr, const float* xi, float* rr, float* ri,
                int n_chunks, int g, int N, cudaStream_t s) {
  using gram_ring::Form;
  const int n2 = 2 * N;
  if (g < 1 || n_chunks < 1 || N < 1) return (int)cudaErrorInvalidValue;
  if (SRC == gram_ring::SRC_PLANES &&
      (N % 4 || n2 > 64 ||
       (reinterpret_cast<uintptr_t>(xr) - reinterpret_cast<uintptr_t>(xi)) %
           16))
    return (int)cudaErrorInvalidValue;
  const int q = gram_ring::chunk_unit(
      g, (SRC == gram_ring::SRC_PLANES ? N : n2) * (int)sizeof(float));
  const long long units = ((long long)n_chunks + q - 1) / q;
  auto go = [&](auto f) {
    using F = decltype(f);
    return gram_ring::launch_grid<
        planes_ring_kernel<F::RT, F::VEC, SRC, BF16>>(
        units, s, xr, xi, rr, ri, (long long)n_chunks, g, n2);
  };
  if (n2 % 4 == 0 && n2 <= 64)
    return gram_ring::vec_ok<float, 4>(xr) ? go(Form<4, true>{})
                                           : go(Form<4, false>{});
  if constexpr (SRC == gram_ring::SRC_ROWS) {     // N odd: rows only
    if (n2 <= 30)
      return gram_ring::vec_ok<float, 2>(xr) ? go(Form<2, true>{})
                                             : go(Form<2, false>{});
  }
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------
// Kernel 12's chunk-sum form
// ---------------------------------------------------------------------

constexpr int WS_ZBYTES = 32768;   // a slab's rows of Z, at most
constexpr int WS_CHUNKS = 32;      // a slab's chunks, at most
constexpr int WS_MAX_DEVICES = 64;

// Slots a thread holds -> the block's thread cap (W * 4 accumulators a
// thread: 64 at W = 16, 16 at W = 4; the caps leave 146 and 85 registers
// a thread).
__host__ __device__ constexpr int ws_max_threads(int W) {
  return W == 16 ? 448 : 768;
}

// The slab's sizes: chunks a slab (cs), windows that close in one (ko) and
// the shared memory (bytes: the slab's rows, its chunk Grams, the closed
// windows, the fold's table) at 2N = n2, tiles ntri, chunk rows g, hop h.
struct WsShape {
  int cs, ko, smem;
};
__host__ __device__ inline WsShape ws_shape(int n2, int ntri, int g, int h) {
  WsShape w;
  w.cs = WS_ZBYTES / (g * n2 * 4);
  if (w.cs > WS_CHUNKS) w.cs = WS_CHUNKS;
  w.ko = (w.cs + h - 1) / h;
  w.smem = w.cs * g * n2 * 4 + (w.cs + w.ko) * ntri * 64 + n2 * n2 / 4 * 16;
  return w;
}

// One async copy of BYTES (16, 8 or 4) from global to shared memory.
template <int BYTES>
__device__ __forceinline__ void cp_async(float* dst, const float* src) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
                 :: "r"(d), "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;"
                 :: "r"(d), "l"(src), "n"(BYTES) : "memory");
}

// Whether a load form's rows keep the interleaved basis (re, im of each
// element side by side) when staged as they lie; else Z = [Xr | Xi].
__host__ __device__ constexpr bool interleaved_basis(int load) {
  return load == LOAD_ILV4 || load == LOAD_ILV2;
}

// Rows [r0, r0 + nr) into z (n2 values a row) by async copies, each
// thread at a fixed place: the interleaved forms copy each row as it lies
// (16 or 8 bytes a copy), the planar and one-value forms into Z = [Xr |
// Xi] (16 or 4 bytes). The caller waits (cp.async.wait_all) and
// synchronises before reading z.
template <int LOAD>
__device__ __forceinline__ void stage_async(const float* __restrict__ xr,
                                            const float* __restrict__ xi,
                                            long long rs, long long es,
                                            long long r0, int nr, int N,
                                            int nthreads, float* z) {
  const int n2 = 2 * N;
  const int per_row = LOAD == LOAD_ILV4 ? N / 2
                      : LOAD == LOAD_ILV2 ? N
                      : LOAD == LOAD_PLANAR4 ? N / 2 : n2;
  const int rstep = nthreads / per_row;
  const int lt = threadIdx.x / per_row, lc = threadIdx.x - lt * per_row;
  if (lt < rstep) {
    const int q = N / 4;
    const bool im = LOAD == LOAD_PLANAR4 ? lc >= q : lc >= N;
    const int c = LOAD == LOAD_PLANAR4 ? 4 * (im ? lc - q : lc)
                                       : (im ? lc - N : lc);
    for (int t = lt; t < nr; t += rstep) {
      const long long row = (r0 + t) * rs;
      float* zr = z + t * n2;
      if constexpr (LOAD == LOAD_ILV4)
        cp_async<16>(zr + 4 * lc, xr + row + 4 * lc);
      else if constexpr (LOAD == LOAD_ILV2)
        cp_async<8>(zr + 2 * lc, xr + row + 2 * lc);
      else if constexpr (LOAD == LOAD_PLANAR4)
        cp_async<16>(zr + (im ? N : 0) + c, (im ? xi : xr) + row + c);
      else
        cp_async<4>(zr + lc, (im ? xi : xr) + row + c * es);
    }
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// Block: windows [b0, b1) of B, window b = chunks [b*h, b*h + m) of g
// rows. Threads: quads x groups, quad q = (tile q / 4, its row q % 4) of
// the ntri = nt(nt + 1)/2 upper-triangle tiles (RT = 4, nt = 2N/4), group
// gp holding slots gp*W .. gp*W + W - 1 of NS.
template <int LOAD, int W>
__global__ void __launch_bounds__(ws_max_threads(W))
window_sums_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                   long long rs, long long es, float* __restrict__ rr_out,
                   float* __restrict__ ri_out, int B, int g, int m, int h,
                   int NS, int N, float S) {
  extern __shared__ __align__(16) float wsm[];
  const int n2 = 2 * N, nt = n2 / 4, ntri = nt * (nt + 1) / 2;
  const int quads = 4 * ntri, tstride = 16 * ntri;   // a Gram's floats
  const int nth = blockDim.x, tid = threadIdx.x;
  const WsShape sh = ws_shape(n2, ntri, g, h);
  float* z = wsm;                                    // cs*g staged rows
  float* gs = z + sh.cs * g * n2;                    // cs chunk Grams
  float* out = gs + sh.cs * tstride;                 // ko closed windows
  int4* fidx = reinterpret_cast<int4*>(out + sh.ko * tstride);

  const long long b0 = (long long)B * blockIdx.x / gridDim.x;
  const long long b1 = (long long)B * (blockIdx.x + 1) / gridDim.x;
  if (b0 >= b1) return;
  const long long C0 = b0 * h, C1 = (b1 - 1) * h + m;

  // this thread's quad and slots
  const int q = tid % quads, gp = tid / quads;
  const int wbase = gp * W;

  float acc[W][4];
#pragma unroll
  for (int w = 0; w < W; ++w)
#pragma unroll
    for (int v = 0; v < 4; ++v) acc[w][v] = 0.f;

  // the next window to open (bo, at chunk co) and to close (bc, after
  // chunk cc); slot s of a window is (b - b0) % NS, this thread's w = s -
  // wbase when 0 <= w < W
  long long bo = b0, bc = b0, co = b0 * h, cc = b0 * h + m - 1;
  int so = 0, sc = 0;
  const int NN = N * N;
  // the fold's four entries of (i, j), each through its upper-triangle
  // tile: Re and Im of element i are rows 2i, 2i + 1 of the staged basis
  // (interleaved) or i, N + i (Z)
  for (int p = tid; p < NN; p += nth) {
    const int i = p / N, j = p - i * N;
    auto re = [&](int a) { return interleaved_basis(LOAD) ? 2 * a : a; };
    auto im = [&](int a) {
      return interleaved_basis(LOAD) ? 2 * a + 1 : N + a;
    };
    auto at = [&](int r, int s) {
      if (r > s) { const int x = r; r = s; s = x; }
      const int rb = r / 4, sb = s / 4;
      return (rb * nt - rb * (rb - 1) / 2 + (sb - rb)) * 16 + (r % 4) * 4 +
             s % 4;
    };
    fidx[p] = make_int4(at(re(i), re(j)), at(im(i), im(j)),
                        at(im(i), re(j)), at(re(i), im(j)));
  }
  stage_async<LOAD>(xr, xi, rs, es, C0 * g,
                    (int)min((long long)sh.cs, C1 - C0) * g, N, nth, z);
  for (long long cA = C0; cA < C1; cA += sh.cs) {
    const int ncs = (int)min((long long)sh.cs, C1 - cA);
    // 1. the slab's rows, copied while the previous slab was summed
    asm volatile("cp.async.wait_all;" ::: "memory");
    __syncthreads();
    // 2. each chunk's Gram, upper-triangle tiles, rows in order
    for (int it = tid; it < ntri * ncs; it += nth) {
      const int t = it % ntri, k = it / ntri;
      int ib = 0, rem = t;
      while (rem >= nt - ib) { rem -= nt - ib; ++ib; }
      const int i0 = ib * 4, j0 = (ib + rem) * 4;
      float a4[4][4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v) a4[u][v] = 0.f;
      const float* zr = z + (long long)k * g * n2;
      for (int r = 0; r < g; ++r, zr += n2) {
        const float4 a = *reinterpret_cast<const float4*>(zr + i0);
        const float4 b = *reinterpret_cast<const float4*>(zr + j0);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int v = 0; v < 4; ++v) a4[u][v] += av[u] * bv[v];
      }
      float* gt = gs + k * tstride + t * 16;
#pragma unroll
      for (int u = 0; u < 4; ++u)
        *reinterpret_cast<float4*>(gt + 4 * u) =
            make_float4(a4[u][0], a4[u][1], a4[u][2], a4[u][3]);
    }
    __syncthreads();
    // the next slab's rows into z, under steps 3 and 4
    if (cA + sh.cs < C1)
      stage_async<LOAD>(xr, xi, rs, es, (cA + sh.cs) * g,
                        (int)min((long long)sh.cs, C1 - cA - sh.cs) * g, N,
                        nth, z);
    // 3. the chunks in order into the open windows: a window's slot is
    // zeroed as it opens and written (/ S) into out after its last chunk
    const long long bc_slab = bc;
    for (int k = 0; k < ncs; ++k) {
      const long long c = cA + k;
      const float4 G = *reinterpret_cast<const float4*>(gs + k * tstride +
                                                        4 * q);
      if (c == co && bo < b1) {
        const int wo = so - wbase;
        if (wo >= 0 && wo < W) {
#pragma unroll
          for (int w = 0; w < W; ++w)
            if (w == wo)
#pragma unroll
              for (int v = 0; v < 4; ++v) acc[w][v] = 0.f;
        }
        ++bo;
        co += h;
        so = so + 1 == NS ? 0 : so + 1;
      }
#pragma unroll
      for (int w = 0; w < W; ++w) {
        acc[w][0] += G.x;
        acc[w][1] += G.y;
        acc[w][2] += G.z;
        acc[w][3] += G.w;
      }
      if (c == cc && bc < b1) {
        const int wc = sc - wbase;
        if (wc >= 0 && wc < W) {
          float o[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int w = 0; w < W; ++w)
            if (w == wc)
#pragma unroll
              for (int v = 0; v < 4; ++v) o[v] = acc[w][v];
          *reinterpret_cast<float4*>(out + (bc - bc_slab) * tstride + 4 * q) =
              make_float4(__fdiv_rn(o[0], S), __fdiv_rn(o[1], S),
                          __fdiv_rn(o[2], S), __fdiv_rn(o[3], S));
        }
        ++bc;
        cc += h;
        sc = sc + 1 == NS ? 0 : sc + 1;
      }
    }
    __syncthreads();
    // 4. fold the slab's closed windows: Rr = TL/S + BR/S, Ri = BL/S - TR/S
    const int nclosed = (int)(bc - bc_slab);
    for (int idx = tid; idx < nclosed * NN; idx += nth) {
      const int kc = idx / NN, p = idx - kc * NN;
      const float* ow = out + kc * tstride;
      const int4 f = fidx[p];
      const float tl = ow[f.x], br = ow[f.y], bl = ow[f.z], tr = ow[f.w];
      const long long o = (bc_slab + kc) * NN + p;
      rr_out[o] = __fadd_rn(tl, br);
      ri_out[o] = __fsub_rn(bl, tr);
    }
    // out is next written after the next slab's two barriers
  }
}

template <int LOAD, int W>
int launch_sums(const float* xr, const float* xi, long long rs, long long es,
                float* rr, float* ri, int B, int g, int m, int h, int NS,
                int N, float S, cudaStream_t stream) {
  const int n2 = 2 * N, nt = n2 / 4, ntri = nt * (nt + 1) / 2;
  const int threads = 4 * ntri * ((NS + W - 1) / W);
  if (threads > ws_max_threads(W)) return (int)cudaErrorInvalidValue;
  const WsShape sh = ws_shape(n2, ntri, g, h);
  auto kernel = window_sums_kernel<LOAD, W>;
  static bool set_up[WS_MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= WS_MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (!set_up[dev]) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             232448);
    if (e != cudaSuccess) return (int)e;
    set_up[dev] = true;
  }
  int sms = 0, per_sm = 0;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                    sh.smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long fit = (long long)per_sm * sms;
  const int grid = (int)(B < fit ? B : fit);
  kernel<<<grid, threads, sh.smem, stream>>>(xr, xi, rs, es, rr, ri, B, g,
                                             m, h, NS, N, S);
  return (int)cudaGetLastError();
}

}  // namespace

// Kernel 8, the staged form. Planes xr, xi: element (t, c) at
// x[t*rs + c*es]. load (the host checks its conditions): 0 interleaved
// (xi == xr + 1, es == 2), N even, rows 16-byte aligned; 1 interleaved,
// rows 8-byte aligned; 2 es == 1, 4 | N, rows of both planes 16-byte
// aligned; 3 any strides. rr, ri: f32[n_chunks, N, N]. dtype 0 = float32,
// 1 = bfloat16 inputs. N: 2N a multiple of 4 up to 64, or N <= 15.
extern "C" int doa_planes_chunk_grams(const void* xr, const void* xi,
                                      long long rs, long long es,
                                      int load, void* rr, void* ri,
                                      int n_chunks, int g, int N, int dtype,
                                      void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (g < 1) return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case 0:
      return launch<false, false>((const float*)xr, (const float*)xi, rs, es,
                                  load, (float*)rr, (float*)ri, n_chunks,
                                  g, g, N, 1.f, s);
    case 1:
      return launch<true, false>((const float*)xr, (const float*)xi, rs, es,
                                 load, (float*)rr, (float*)ri, n_chunks,
                                 g, g, N, 1.f, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Kernel 8, the ring form. planar 0: xr is an interleaved buffer of rows
// of 2N values (re, im per element; xi is not read), 2N a multiple of 4 up
// to 64 or 2N <= 30; planar 1: xr, xi are planes of contiguous rows of N
// values, 4 | N <= 32, their addresses equal mod 16. rr, ri:
// f32[n_chunks, N, N]. dtype 0 = float32, 1 = bfloat16-rounded inputs.
extern "C" int doa_planes_chunk_grams_ring(const void* xr, const void* xi,
                                           int planar, void* rr, void* ri,
                                           int n_chunks, int g, int N,
                                           int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const float* a = (const float*)xr;
  const float* b = (const float*)xi;
  float* o = (float*)rr;
  float* p = (float*)ri;
  if (planar != 0 && planar != 1) return (int)cudaErrorInvalidValue;
  switch (dtype * 2 + planar) {
    case 0:
      return launch_ring<gram_ring::SRC_ROWS, false>(a, b, o, p, n_chunks,
                                                     g, N, s);
    case 1:
      return launch_ring<gram_ring::SRC_PLANES, false>(a, b, o, p, n_chunks,
                                                       g, N, s);
    case 2:
      return launch_ring<gram_ring::SRC_ROWS, true>(a, b, o, p, n_chunks, g,
                                                    N, s);
    case 3:
      return launch_ring<gram_ring::SRC_PLANES, true>(a, b, o, p, n_chunks,
                                                      g, N, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Kernel 12, the per-window form. Window b: rows [b*hop, b*hop + S); rr,
// ri: f32[B, N, N] = the folded Gram / S. Same plane layout and N rule as
// doa_planes_chunk_grams.
extern "C" int doa_planes_cov_windows(const void* xr, const void* xi,
                                      long long rs, long long es,
                                      int load, void* rr, void* ri,
                                      int B, int S, int hop, int N,
                                      void* stream) {
  if (S < 1 || hop < 1) return (int)cudaErrorInvalidValue;
  return launch<false, true>((const float*)xr, (const float*)xi, rs, es,
                             load, (float*)rr, (float*)ri, B, hop, S, N,
                             (float)S, (cudaStream_t)stream);
}

// Kernel 12, the chunk-sum form: the same windows and outputs, from the
// Grams of chunks of g = gcd(S, hop) rows (the caller passes g). N even,
// 2N <= 32; NS = ceil(S/hop) slots within a block's threads (the
// wrapper's windows_form); planes and load as doa_planes_chunk_grams.
extern "C" int doa_planes_window_sums(const void* xr, const void* xi,
                                      long long rs, long long es,
                                      int load, void* rr, void* ri,
                                      int B, int S, int hop, int g, int N,
                                      void* stream) {
  if (B < 1 || S < 1 || hop < 1 || g < 1 || S % g || hop % g || N < 2 ||
      N % 2 || N > 16 || load < 0 || load > 3 || (load == 2 && N % 4))
    return (int)cudaErrorInvalidValue;
  const int m = S / g, h = hop / g, NS = (m + h - 1) / h;
  cudaStream_t s = (cudaStream_t)stream;
  const float* a = (const float*)xr;
  const float* b = (const float*)xi;
  float* o = (float*)rr;
  float* p = (float*)ri;
  const float Sf = (float)S;
#define DOA_SUMS(L)                                                       \
  (NS <= 16 ? launch_sums<L, 4>(a, b, rs, es, o, p, B, g, m, h, NS, N, Sf, \
                                s)                                        \
            : launch_sums<L, 16>(a, b, rs, es, o, p, B, g, m, h, NS, N,   \
                                 Sf, s))
  switch (load) {
    case LOAD_ILV4: return DOA_SUMS(LOAD_ILV4);
    case LOAD_ILV2: return DOA_SUMS(LOAD_ILV2);
    case LOAD_PLANAR4: return DOA_SUMS(LOAD_PLANAR4);
    default: return DOA_SUMS(LOAD_GENERIC);
  }
#undef DOA_SUMS
}
