// K1: per-chunk Gram of the interleaved capture, U_c = sum_t u_t u_t^T.
//
// Replaces the Pallas kernel doa_tpu/ops/pallas/cov_embedded.py
// `_cov_kernel_uhat` (stacked variant of cov_embedded_pallas). The TPU
// kernel packs TPACK time steps into 128 lanes and runs the f32 Gram as a
// bf16 hi/lo split on the MXU; here the capture is read in its natural
// layout x[T, n2] (n2 = 2N: re, im interleaved per element, the same bytes
// as a C-ordered complex64 (T, N) buffer) and every product is a true FP32
// FMA on the CUDA cores (int8: an exact int32 multiply-add).
//
// What bounds it on an H100: at the headline shape (T = 2^24, n2 = 32,
// chunk g = 1024) it reads 2 GiB once (0.64 ms at 3.35 TB/s) and does
// 17.2 G FMAs over the full n2 x n2 square (0.51 ms at 67 TFLOP/s FP32).
// Design: one block per chunk; the chunk's rows pass through shared
// memory STAGE values at a time with coalesced loads; each thread owns an
// RT x RT register tile of U (RT = 4 when 4 | n2, else 2) and a residue
// class of rows, so one row costs it 2 vector loads from shared memory
// for RT^2 FMAs (a one-entry-per-thread form spent two shared loads per
// FMA and measured 3x slower than cuBLAS). The row classes are summed in
// a fixed order at the end, so the result is deterministic.
//
// int8: entries are at most g*127^2, exact in int32 for g < 133144; the
// per-chunk cast to f32 is exact while g*127^2 < 2^24 (g <= 1040) and
// otherwise rounds once to f32 (relative 2^-24), as the TPU kernel does.
//
// Kernel 9 (`doa_chunk_embedded`, below K1) replaces the Pallas kernel
// `_cov_kernel` of the same file (cov_embedded_pallas variant="chunk"): the
// same staging and register tiles (f32 and bf16 inputs), then an epilogue
// that writes each chunk's embedded covariance E(R) f32[n2, n2] with the
// 1/S scale, the calibration correction and forward-backward averaging
// applied. It is bound by the same capture read as K1 (2 GiB at the
// headline, 0.64 ms) plus the per-chunk E written (64 MiB, 0.02 ms); the
// epilogue is O(n2^2) a chunk against K1's O(g n2^2).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int STAGE = 4096;     // staged values (16 KiB); also the
                                // reduction buffer: THREADS * RT^2 <= STAGE

template <typename T> struct Acc { using type = float; };
template <> struct Acc<int8_t> { using type = int; };

__device__ __forceinline__ float to_acc(float v) { return v; }
__device__ __forceinline__ float to_acc(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ int to_acc(int8_t v) { return (int)v; }

template <typename A, int RT> struct alignas(sizeof(A) * RT) Vec {
  A v[RT];
};

// The chunk's Gram in registers: this thread's RT x RT tile of U at
// (i0, j0), summed over its residue class rg of the chunk's rows. `tile`
// stages STAGE values at a time; every thread of the block must call this.
template <typename T, int RT, typename A>
__device__ __forceinline__ void accumulate(const T* __restrict__ xc, int g,
                                           int n2, int i0, int j0, int rg,
                                           int groups, bool active, A* tile,
                                           A (&acc)[RT][RT]) {
  const int tid = threadIdx.x;
  const int TS = STAGE / n2;              // rows per stage
#pragma unroll
  for (int r = 0; r < RT; ++r)
#pragma unroll
    for (int s = 0; s < RT; ++s) acc[r][s] = 0;

  for (int t0 = 0; t0 < g; t0 += TS) {
    const int rows = min(TS, g - t0);
    const int cnt = rows * n2;
    const T* src = xc + (size_t)t0 * n2;   // rows are contiguous
    for (int k = tid; k < cnt; k += THREADS) tile[k] = to_acc(src[k]);
    __syncthreads();
    if (active) {
      for (int t = rg; t < rows; t += groups) {
        const Vec<A, RT> a = *reinterpret_cast<const Vec<A, RT>*>(
            tile + t * n2 + i0);
        const Vec<A, RT> b = *reinterpret_cast<const Vec<A, RT>*>(
            tile + t * n2 + j0);
#pragma unroll
        for (int r = 0; r < RT; ++r)
#pragma unroll
          for (int s = 0; s < RT; ++s) acc[r][s] += a.v[r] * b.v[s];
      }
    }
    __syncthreads();
  }
  // the row classes' partial tiles, class rg at tile[rg * n2 * n2 ...]
  if (active) {
#pragma unroll
    for (int r = 0; r < RT; ++r)
#pragma unroll
      for (int s = 0; s < RT; ++s)
        tile[(rg * n2 + i0 + r) * n2 + j0 + s] = acc[r][s];
  }
  __syncthreads();
}

template <typename T, int RT>
__global__ void __launch_bounds__(THREADS)
chunk_gram_kernel(const T* __restrict__ x, float* __restrict__ out, int g,
                  int n2) {
  using A = typename Acc<T>::type;
  __shared__ __align__(16) A tile[STAGE];
  const int tid = threadIdx.x;
  const int nt = n2 / RT;                 // register tiles per side
  const int ntiles = nt * nt;             // <= THREADS (host-checked)
  const int groups = THREADS / ntiles;    // residue classes of rows
  const int ti = tid % ntiles, rg = tid / ntiles;
  const int i0 = (ti / nt) * RT, j0 = (ti % nt) * RT;
  A acc[RT][RT];
  accumulate<T, RT, A>(x + (size_t)blockIdx.x * g * n2, g, n2, i0, j0, rg,
                       groups, rg < groups, tile, acc);

  // sum the row classes in a fixed order
  float* oc = out + (size_t)blockIdx.x * n2 * n2;
  for (int idx = tid; idx < n2 * n2; idx += THREADS) {
    A sum = tile[idx];
    for (int q = 1; q < groups; ++q) sum += tile[q * n2 * n2 + idx];
    oc[idx] = (float)sum;
  }
}

// Kernel 9: the chunk's Gram as K1, then the chunk's embedded covariance
// E = [[rr, -ri], [ri, rr]] (N = n2/2) in the epilogue, in the order of
// the plain version (ops/cuda/cov_embedded.py uhat_windows_to_embedded):
// the planar fold of the interleaved basis, rr = (U[2i][2j] +
// U[2i+1][2j+1])·scale, ri = (U[2i+1][2j] - U[2i][2j+1])·scale; the
// correction W = c c^H, (rr Wre - ri Wim, rr Wim + ri Wre); FB,
// (rr + flip(rr))/2, (ri - flip(ri))/2. Every step is one rounded FP32
// operation (__fadd_rn and friends: no FMA contraction), as the plain
// version's elementwise torch ops, so the two agree bit for bit wherever
// the Grams agree. FB pairs (i, j) with (N-1-i, N-1-j), which another
// thread computes: (rr, ri) pass through shared memory first.
template <typename T, int RT>
__global__ void __launch_bounds__(THREADS)
chunk_embedded_kernel(const T* __restrict__ x, const float* __restrict__ Wre,
                      const float* __restrict__ Wim, float* __restrict__ out,
                      int g, int n2, int fb, float scale) {
  __shared__ __align__(16) float tile[STAGE];
  __shared__ float rbuf[2 * (STAGE / 4)];   // rr, ri: N^2 <= STAGE / 4 each
  const int tid = threadIdx.x;
  const int nt = n2 / RT;
  const int ntiles = nt * nt;
  const int groups = THREADS / ntiles;
  const int ti = tid % ntiles, rg = tid / ntiles;
  const int i0 = (ti / nt) * RT, j0 = (ti % nt) * RT;
  float acc[RT][RT];
  accumulate<T, RT, float>(x + (size_t)blockIdx.x * g * n2, g, n2, i0, j0,
                           rg, groups, rg < groups, tile, acc);

  // U = the row classes summed in K1's order, in place in class 0's slot
  for (int idx = tid; idx < n2 * n2; idx += THREADS) {
    float sum = tile[idx];
    for (int q = 1; q < groups; ++q) sum += tile[q * n2 * n2 + idx];
    tile[idx] = sum;
  }
  __syncthreads();

  const int N = n2 / 2, NN = N * N;
  float* rrs = rbuf;
  float* ris = rbuf + NN;
  for (int p = tid; p < NN; p += THREADS) {
    const int i = p / N, j = p - i * N;
    const float* u0 = tile + (2 * i) * n2 + 2 * j;       // row 2i
    const float* u1 = u0 + n2;                            // row 2i + 1
    const float rr = __fmul_rn(__fadd_rn(u0[0], u1[1]), scale);
    const float ri = __fmul_rn(__fsub_rn(u1[0], u0[1]), scale);
    const float wr = Wre[p], wi = Wim[p];
    rrs[p] = __fsub_rn(__fmul_rn(rr, wr), __fmul_rn(ri, wi));
    ris[p] = __fadd_rn(__fmul_rn(rr, wi), __fmul_rn(ri, wr));
  }
  __syncthreads();

  float* oc = out + (size_t)blockIdx.x * n2 * n2;
  for (int p = tid; p < NN; p += THREADS) {
    const int i = p / N, j = p - i * N;
    float rr = rrs[p], ri = ris[p];
    if (fb) {
      const int q = NN - 1 - p;                           // (N-1-i, N-1-j)
      rr = __fmul_rn(0.5f, __fadd_rn(rr, rrs[q]));
      ri = __fmul_rn(0.5f, __fsub_rn(ri, ris[q]));
    }
    oc[i * n2 + j] = rr;
    oc[i * n2 + N + j] = -ri;
    oc[(N + i) * n2 + j] = ri;
    oc[(N + i) * n2 + N + j] = rr;
  }
}

template <typename T>
int launch(const void* x, void* out, int n_chunks, int g, int n2,
           cudaStream_t stream) {
  if (g < 1 || n_chunks < 1 || n2 < 2) return (int)cudaErrorInvalidValue;
  if (n2 % 4 == 0 && n2 <= 64) {
    chunk_gram_kernel<T, 4><<<n_chunks, THREADS, 0, stream>>>(
        (const T*)x, (float*)out, g, n2);
  } else if (n2 % 2 == 0 && n2 <= 30) {
    chunk_gram_kernel<T, 2><<<n_chunks, THREADS, 0, stream>>>(
        (const T*)x, (float*)out, g, n2);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch_embedded(const void* x, const void* Wre, const void* Wim, void* out,
                    int n_chunks, int g, int n2, int fb, float scale,
                    cudaStream_t stream) {
  if (g < 1 || n_chunks < 1 || n2 < 2) return (int)cudaErrorInvalidValue;
  if (n2 % 4 == 0 && n2 <= 64) {
    chunk_embedded_kernel<T, 4><<<n_chunks, THREADS, 0, stream>>>(
        (const T*)x, (const float*)Wre, (const float*)Wim, (float*)out, g,
        n2, fb, scale);
  } else if (n2 % 2 == 0 && n2 <= 30) {
    chunk_embedded_kernel<T, 2><<<n_chunks, THREADS, 0, stream>>>(
        (const T*)x, (const float*)Wre, (const float*)Wim, (float*)out, g,
        n2, fb, scale);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = int8. x: [n_chunks * g, n2]
// contiguous; out: f32[n_chunks, n2, n2]. n2 = 2N: 4 | n2 <= 64, or
// n2 <= 30.
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
