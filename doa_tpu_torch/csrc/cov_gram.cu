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
  const bool active = rg < groups;
  const int i0 = (ti / nt) * RT, j0 = (ti % nt) * RT;
  const int TS = STAGE / n2;              // rows per stage
  const T* xc = x + (size_t)blockIdx.x * g * n2;

  A acc[RT][RT];
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

  // sum the row classes in a fixed order
  if (active) {
#pragma unroll
    for (int r = 0; r < RT; ++r)
#pragma unroll
      for (int s = 0; s < RT; ++s)
        tile[(rg * n2 + i0 + r) * n2 + j0 + s] = acc[r][s];
  }
  __syncthreads();
  float* oc = out + (size_t)blockIdx.x * n2 * n2;
  for (int idx = tid; idx < n2 * n2; idx += THREADS) {
    A sum = tile[idx];
    for (int q = 1; q < groups; ++q) sum += tile[q * n2 * n2 + idx];
    oc[idx] = (float)sum;
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
