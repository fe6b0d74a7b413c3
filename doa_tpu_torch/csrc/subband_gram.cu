// Wideband front end after the dense channelizer: per-(chunk, subband)
// Grams of the channelized stream Y f32[M, F*2N] (row m holds subband f's
// interleaved sample vector [re0, im0, re1, im1, ...] in columns
// f*2N ... f*2N + 2N - 1; Y = frames @ K, the channelizer matrix).
//
// Two entries, one per Pallas kernel of doa_tpu/ops/pallas/wideband_cov.py:
//
// * doa_subband_gram replaces `_subband_gram_kernel` (variant "uhat"): the
//   interleaved-basis Gram U = sum_m y_m y_m^T (2N x 2N) of every chunk of
//   g rows and every subband, unnormalised, into U f32[F, n, 2N, 2N].
// * doa_subband_embedded replaces `_subband_gram_kernel_embedded` (variant
//   "embedded"): the embedded covariance E = embed(R o (c c^H)) * scale,
//   R = sum_m y_m y_m^H taken as complex pairs, embed(R) = [[Rr, -Ri],
//   [Ri, Rr]] in the planar basis, into E f32[F, n, 2N, 2N]. The TPU kernel
//   reaches the planar basis by signed-permutation matmuls (P~, M~ = Jp P~)
//   and folds the correction as (U o T1 + rowswap(U) o T2) * scale; here
//   the permutation is the index map of the epilogue and the fold the same
//   arithmetic as kernel 4 (csrc/wideband_cov.cu).
//
// The TPU kernels run the f32 Gram as a bf16 hi/lo split on the MXU; here
// every product and sum is a true FP32 FMA on the CUDA cores.
//
// What bounds them on an H100 (c5_f12: M = 131072 frames, F = 12, N = 64,
// g = 64, n = 2048 chunks): kernel 7 reads Y (805 MB) and writes E
// (1.61 GB), 0.72 ms at 3.35 TB/s; its Hermitian Gram needs 4*g*N^2 FLOP
// per (chunk, subband), 2.6e10 in all, 0.38 ms at 67 TFLOP/s. Kernel 10 at
// c5 (F = 16, T = 2^21) reads 1.07 GB and writes 2.15 GB (0.96 ms); its
// symmetric Gram needs g*2N*(2N+1) FLOP per (chunk, subband), 3.5e10
// (0.52 ms). Both are bound by their bytes.
//
// Design: one block per (chunk, subband). The block stages its g x 2N
// slice in shared memory, STAGE floats at a time, as 16-byte loads along
// the rows (8-byte loads when N is odd). Each thread owns a register tile of the Gram and a
// residue class of rows, as K1 and kernel 4 (a 4x4 tile cut K1 from 3.22
// to 1.26 ms): kernel 10 an RT x RT real tile (RT = 8 at 2N = 128),
// kernel 7 a TI x TI complex tile (TI = 4 at N = 64). The row classes are
// summed in a fixed order through shared memory; kernel 7's epilogue
// applies the correction and scale with explicitly rounded operations (no
// FMA contraction), in the plain version's order.

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

// Kernel 7: E[f, chunk] = embed(R o (c c^H)) * scale, R = sum y y^H over
// the chunk's rows of subband f (complex pairs of the interleaved slice).
template <int TI>
__global__ void __launch_bounds__(THREADS)
subband_embedded_kernel(const float* __restrict__ y,
                        const float* __restrict__ cr,
                        const float* __restrict__ ci,
                        float* __restrict__ out, int F, int N, int g,
                        int n_chunks, float scale, bool vec4) {
  __shared__ __align__(16) float2 ys[STAGE / 2];
  const int f = blockIdx.x % F;
  const int chunk = blockIdx.x / F;
  const int tid = threadIdx.x;
  const int nt = N / TI;                  // register tiles per side
  const int ntiles = nt * nt;             // <= THREADS (host-checked)
  const int groups = THREADS / ntiles;    // residue classes of rows
  const int ti = tid % ntiles, rg = tid / ntiles;
  const bool active = rg < groups;
  const int i0 = (ti / nt) * TI, j0 = (ti % nt) * TI;
  const int n2 = 2 * N;
  const int TS = (STAGE / 2) / N;         // rows per stage
  const size_t ld = (size_t)F * n2;
  const float* yc = y + (size_t)chunk * g * ld + (size_t)f * n2;

  float ar[TI][TI], ai[TI][TI];           // Re, Im of sum y_i conj(y_j)
#pragma unroll
  for (int r = 0; r < TI; ++r)
#pragma unroll
    for (int s = 0; s < TI; ++s) ar[r][s] = ai[r][s] = 0.f;

  for (int m0 = 0; m0 < g; m0 += TS) {
    const int rows = min(TS, g - m0);
    stage_rows(yc + (size_t)m0 * ld, ld, n2, rows,
               reinterpret_cast<float*>(ys), vec4);
    __syncthreads();
    if (active) {
      for (int m = rg; m < rows; m += groups) {
        float2 a[TI], b[TI];
#pragma unroll
        for (int r = 0; r < TI; ++r) {
          a[r] = ys[m * N + i0 + r];
          b[r] = ys[m * N + j0 + r];
        }
#pragma unroll
        for (int r = 0; r < TI; ++r)
#pragma unroll
          for (int s = 0; s < TI; ++s) {
            ar[r][s] += a[r].x * b[s].x + a[r].y * b[s].y;
            ai[r][s] += a[r].y * b[s].x - a[r].x * b[s].y;
          }
      }
    }
    __syncthreads();
  }

  // sum the row classes in a fixed order (groups * N^2 <= STAGE / 2)
  if (active) {
#pragma unroll
    for (int r = 0; r < TI; ++r)
#pragma unroll
      for (int s = 0; s < TI; ++s)
        ys[(rg * N + i0 + r) * N + j0 + s] = make_float2(ar[r][s], ai[r][s]);
  }
  __syncthreads();
  float* oc = out + ((size_t)f * n_chunks + chunk) * n2 * n2;
  for (int idx = tid; idx < N * N; idx += THREADS) {
    const int i = idx / N, j = idx % N;
    float rr = ys[idx].x, ri = ys[idx].y;
    for (int q = 1; q < groups; ++q) {
      rr += ys[q * N * N + idx].x;
      ri += ys[q * N * N + idx].y;
    }
    // W = c c^H; R o W; then the scale
    const float wre = __fadd_rn(__fmul_rn(cr[i], cr[j]),
                                __fmul_rn(ci[i], ci[j]));
    const float wim = __fsub_rn(__fmul_rn(ci[i], cr[j]),
                                __fmul_rn(cr[i], ci[j]));
    const float er = __fmul_rn(
        __fsub_rn(__fmul_rn(rr, wre), __fmul_rn(ri, wim)), scale);
    const float ei = __fmul_rn(
        __fadd_rn(__fmul_rn(rr, wim), __fmul_rn(ri, wre)), scale);
    oc[i * n2 + j] = er;
    oc[i * n2 + N + j] = -ei;
    oc[(N + i) * n2 + j] = ei;
    oc[(N + i) * n2 + N + j] = er;
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

template <int TI>
int launch_embedded(const void* y, const void* cr, const void* ci,
                    void* out, int F, int N, int g, int n_chunks,
                    float scale, cudaStream_t stream) {
  subband_embedded_kernel<TI><<<F * n_chunks, THREADS, 0, stream>>>(
      (const float*)y, (const float*)cr, (const float*)ci, (float*)out, F,
      N, g, n_chunks, scale, aligned16(y, N));
  return (int)cudaGetLastError();
}

}  // namespace

// Both entries: y f32[n_chunks * g, F * 2N] contiguous (the channelized
// stream); out f32[F, n_chunks, 2N, 2N]. N: 4 | N <= 64, 2 | N <= 32, or
// N <= 16 (kernel 4's rule).

// Kernel 10.
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

// Kernel 7. cr, ci: f32[N] correction; scale: 1 / S_sub.
extern "C" int doa_subband_embedded(const void* y, const void* cr,
                                    const void* ci, void* out, int F, int N,
                                    int g, int n_chunks, float scale,
                                    void* stream) {
  if (bad_sizes(F, N, g, n_chunks)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (N % 4 == 0 && N <= 64)
    return launch_embedded<4>(y, cr, ci, out, F, N, g, n_chunks, scale, s);
  if (N % 2 == 0 && N <= 32)
    return launch_embedded<2>(y, cr, ci, out, F, N, g, n_chunks, scale, s);
  if (N <= 16)
    return launch_embedded<1>(y, cr, ci, out, F, N, g, n_chunks, scale, s);
  return (int)cudaErrorInvalidValue;
}
