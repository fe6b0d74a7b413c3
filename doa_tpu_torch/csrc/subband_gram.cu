// Kernel 10, the wideband front end's "uhat" variant after the dense
// channelizer: per-(chunk, subband) Grams of the channelized stream
// Y f32[M, F*2N] (row m holds subband f's interleaved sample vector
// [re0, im0, re1, im1, ...] in columns f*2N ... f*2N + 2N - 1;
// Y = frames @ K, the channelizer matrix).
//
// doa_subband_gram replaces `_subband_gram_kernel` of
// doa_tpu/ops/pallas/wideband_cov.py:255 (variant "uhat"): the
// interleaved-basis Gram U = sum_m y_m y_m^T (2N x 2N) of every chunk of
// g rows and every subband, unnormalised, into U f32[F, n, 2N, 2N].
// Kernel 7 (`_subband_gram_kernel_embedded`, variant "embedded") is the
// ring kernel's stream source in csrc/wideband_cov.cu.
//
// The TPU kernel runs the f32 Gram as a bf16 hi/lo split on the MXU;
// here every product and sum is a true FP32 FMA on the CUDA cores.
//
// What bounds it on an H100 (c5: F = 16, T = 2^21, N = 64, g = 64): it
// reads 1.07 GB and writes 2.15 GB (0.96 ms at 3.35 TB/s); its
// symmetric Gram needs g*2N*(2N+1) FLOP per (chunk, subband), 3.5e10
// (0.52 ms at 67 TFLOP/s). It is bound by its bytes.
//
// Design: one block per (chunk, subband). The block stages its g x 2N
// slice in shared memory, STAGE floats at a time, as 16-byte loads along
// the rows (8-byte loads when N is odd). Each thread owns an RT x RT
// register tile of the Gram (RT = 8 at 2N = 128) and a residue class of
// rows, as K1 and kernel 4 (a 4x4 tile cut K1 from 3.22 to 1.26 ms). The
// row classes are summed in a fixed order through shared memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int STAGE = 8192;     // floats staged (32 KiB); also the
                                // reduction buffer of the row classes

template <int R> struct alignas(sizeof(float) * R) Vec {
  float v[R];
};

// Stage `rows` rows of a slice of width n2 floats into tile[rows][n2]; y
// points at the slice's first row, rows are `ld` floats apart. Each thread
// keeps one column of vectors and steps over rows (no division per value);
// the threads past the last whole set of rows stay idle.
__device__ __forceinline__ void stage_rows(const float* __restrict__ y,
                                           size_t ld, int n2, int rows,
                                           float* __restrict__ tile,
                                           bool vec4) {
  const int tid = threadIdx.x;
  if (vec4) {
    const int q = n2 / 4;                 // float4 a row, <= 32
    const int c = tid % q, step = THREADS / q;
    float4* t4 = reinterpret_cast<float4*>(tile);
    for (int m = tid < step * q ? tid / q : rows; m < rows; m += step)
      t4[m * q + c] = __ldg(reinterpret_cast<const float4*>(y + m * ld) + c);
  } else {
    const int q = n2 / 2;                 // float2 a row, <= 64
    const int c = tid % q, step = THREADS / q;
    float2* t2 = reinterpret_cast<float2*>(tile);
    for (int m = tid < step * q ? tid / q : rows; m < rows; m += step)
      t2[m * q + c] = __ldg(reinterpret_cast<const float2*>(y + m * ld) + c);
  }
}

// Kernel 10: U[f, chunk] = sum over the chunk's rows of y y^T (real, in
// the interleaved basis).
template <int RT>
__global__ void __launch_bounds__(THREADS)
subband_gram_kernel(const float* __restrict__ y, float* __restrict__ out,
                    int F, int n2, int g, int n_chunks, bool vec4) {
  __shared__ __align__(32) float tile[STAGE];
  const int f = blockIdx.x % F;
  const int chunk = blockIdx.x / F;
  const int tid = threadIdx.x;
  const int nt = n2 / RT;                 // register tiles per side, <= 16
  const int ntiles = nt * nt;
  // RT = 8 (2N > 64) leaves no room to reduce row classes in STAGE
  const int groups = RT == 8 ? 1 : THREADS / ntiles;
  const int ti = tid % ntiles, rg = tid / ntiles;
  const bool active = rg < groups;
  const int i0 = (ti / nt) * RT, j0 = (ti % nt) * RT;
  const int TS = STAGE / n2;              // rows per stage
  const size_t ld = (size_t)F * n2;
  const float* yc = y + (size_t)chunk * g * ld + (size_t)f * n2;

  float acc[RT][RT];
#pragma unroll
  for (int r = 0; r < RT; ++r)
#pragma unroll
    for (int c = 0; c < RT; ++c) acc[r][c] = 0.f;

  for (int m0 = 0; m0 < g; m0 += TS) {
    const int rows = min(TS, g - m0);
    stage_rows(yc + (size_t)m0 * ld, ld, n2, rows, tile, vec4);
    __syncthreads();
    if (active) {
      for (int m = rg; m < rows; m += groups) {
        const Vec<RT> a = *reinterpret_cast<const Vec<RT>*>(
            tile + m * n2 + i0);
        const Vec<RT> b = *reinterpret_cast<const Vec<RT>*>(
            tile + m * n2 + j0);
#pragma unroll
        for (int r = 0; r < RT; ++r)
#pragma unroll
          for (int c = 0; c < RT; ++c) acc[r][c] += a.v[r] * b.v[c];
      }
    }
    __syncthreads();
  }

  float* oc = out + ((size_t)f * n_chunks + chunk) * n2 * n2;
  if (groups == 1) {
    if (active) {
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        Vec<RT> o;
#pragma unroll
        for (int c = 0; c < RT; ++c) o.v[c] = acc[r][c];
        *reinterpret_cast<Vec<RT>*>(oc + (i0 + r) * n2 + j0) = o;
      }
    }
  } else {
    // sum the row classes in a fixed order
    if (active) {
#pragma unroll
      for (int r = 0; r < RT; ++r)
#pragma unroll
        for (int c = 0; c < RT; ++c)
          tile[(rg * n2 + i0 + r) * n2 + j0 + c] = acc[r][c];
    }
    __syncthreads();
    for (int idx = tid; idx < n2 * n2; idx += THREADS) {
      float sum = tile[idx];
      for (int q = 1; q < groups; ++q) sum += tile[q * n2 * n2 + idx];
      oc[idx] = sum;
    }
  }
}

bool bad_sizes(int F, int N, int g, int n_chunks) {
  return F < 1 || N < 1 || g < 1 || n_chunks < 1 ||
         (long long)F * n_chunks > 0x7fffffffLL;
}

bool aligned16(const void* p, int N) {
  return N % 2 == 0 && reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <int RT>
int launch_gram(const void* y, void* out, int F, int N, int g, int n_chunks,
                cudaStream_t stream) {
  subband_gram_kernel<RT><<<F * n_chunks, THREADS, 0, stream>>>(
      (const float*)y, (float*)out, F, 2 * N, g, n_chunks, aligned16(y, N));
  return (int)cudaGetLastError();
}

}  // namespace

// y f32[n_chunks * g, F * 2N] contiguous (the channelized stream); out
// f32[F, n_chunks, 2N, 2N]. N: 4 | N <= 64, 2 | N <= 32, or N <= 16
// (the ring kernel's rule, csrc/wideband_cov.cu).
extern "C" int doa_subband_gram(const void* y, void* out, int F, int N,
                                int g, int n_chunks, void* stream) {
  if (bad_sizes(F, N, g, n_chunks)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (N % 4 == 0 && N <= 64) {
    if (N > 32) return launch_gram<8>(y, out, F, N, g, n_chunks, s);
    return launch_gram<4>(y, out, F, N, g, n_chunks, s);
  }
  if (N % 2 == 0 && N <= 32)
    return launch_gram<4>(y, out, F, N, g, n_chunks, s);
  if (N <= 16) return launch_gram<2>(y, out, F, N, g, n_chunks, s);
  return (int)cudaErrorInvalidValue;
}
