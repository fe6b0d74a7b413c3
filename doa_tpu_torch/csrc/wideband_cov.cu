// Wideband front end: F-point DFT channelizer + per-chunk embedded Gram of
// every subband, straight from the interleaved capture.
//
// Replaces the Pallas kernel doa_tpu/ops/pallas/wideband_cov.py
// `_wideband_fft_gram_kernel` (variant "fft" of
// wideband_cov_embedded_pallas). Frames are x f32[M, F*2N]: row m holds F
// consecutive complex sample vectors (the bytes of a complex64 capture).
// Subband f of frame m is y_f[m, c] = sum_t W[f,t] x[m, t, c] with the
// unnormalised forward DFT W[f,t] = exp(-2 pi j f t / F). Chunk c of
// subband f (g consecutive frames) gives
//
//   R = sum_m y_f[m] y_f[m]^H,   E = embed(R o (c c^H)) * scale
//
// with embed(R) = [[Rr, -Ri], [Ri, Rr]] and scale = 1 / S_sub: the
// reference's T1/T2 correction fold and scale, written once per chunk
// into E f32[F, n_chunks, 2N, 2N].
//
// The TPU kernel planarizes with permute matmuls, runs a radix-2 DIF FFT
// on whole tiles and a bf16 hi/lo Gram; here every product is a true FP32
// FMA on the CUDA cores and the DFT is direct: a block owns one
// (chunk, subband) pair, so it needs only its own subband's samples.
//
// What bounds it at c5 (M = 131072 frames, F = 16, N = 64, g = 64): the
// capture is 1 GiB and E 2 GiB (0.96 ms at 3.35 TB/s), the Grams
// 34 G FMAs (1.0 ms at 67 TFLOP/s). Each of the F blocks of a chunk reads
// the whole chunk (512 KiB) for its DFT, so L2 serves F times the
// capture; blocks of one chunk are adjacent in launch order, so HBM
// serves it about once. Design: the chunk's frames pass through shared
// memory STAGE complex samples at a time, as subband f's samples
// (thread (m, c) takes the F-term DFT of element c of frame m, coalesced
// across c); each thread owns a TI x TI complex register tile of R and a
// residue class of rows (K1's scheme), so one row costs it 2*TI complex
// loads for TI^2 complex MACs; the row classes are summed in a fixed
// order, then the correction, scale and embedding are written with
// explicitly rounded operations (no FMA contraction), as the plain
// version computes them.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int STAGE = 4096;     // complex values staged (32 KiB); also the
                                // reduction buffer: THREADS * TI^2 <= STAGE

template <int TI>
__global__ void __launch_bounds__(THREADS)
fft_gram_kernel(const float* __restrict__ x, const float* __restrict__ tw,
                const float* __restrict__ cr, const float* __restrict__ ci,
                float* __restrict__ out, int F, int N, int g, int n_chunks,
                float scale) {
  __shared__ __align__(16) float2 ys[STAGE];
  const int f = blockIdx.x % F;
  const int chunk = blockIdx.x / F;
  const int tid = threadIdx.x;
  const int nt = N / TI;                  // register tiles per side
  const int ntiles = nt * nt;             // <= THREADS (host-checked)
  const int groups = THREADS / ntiles;    // residue classes of rows
  const int ti = tid % ntiles, rg = tid / ntiles;
  const bool active = rg < groups;
  const int i0 = (ti / nt) * TI, j0 = (ti % nt) * TI;
  const int RS = STAGE / N;               // frames per stage
  const size_t frame = (size_t)F * N;     // complex values per frame
  const float2* xc =
      reinterpret_cast<const float2*>(x) + (size_t)chunk * g * frame;

  float ar[TI][TI], ai[TI][TI];           // Re, Im of sum y_i conj(y_j)
#pragma unroll
  for (int r = 0; r < TI; ++r)
#pragma unroll
    for (int s = 0; s < TI; ++s) ar[r][s] = ai[r][s] = 0.f;

  for (int m0 = 0; m0 < g; m0 += RS) {
    const int rows = min(RS, g - m0);
    for (int idx = tid; idx < rows * N; idx += THREADS) {
      const int m = idx / N, c = idx % N;
      const float2* xm = xc + (size_t)(m0 + m) * frame + c;
      float yr = 0.f, yi = 0.f;
      for (int t = 0; t < F; ++t) {
        const int k = (f * t) % F;        // W[f, t] = tw[k]
        const float wr = __ldg(tw + 2 * k), wi = __ldg(tw + 2 * k + 1);
        const float2 v = xm[(size_t)t * N];
        yr += wr * v.x - wi * v.y;
        yi += wr * v.y + wi * v.x;
      }
      ys[idx] = make_float2(yr, yi);
    }
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

  // sum the row classes in a fixed order
  if (active) {
#pragma unroll
    for (int r = 0; r < TI; ++r)
#pragma unroll
      for (int s = 0; s < TI; ++s)
        ys[(rg * N + i0 + r) * N + j0 + s] = make_float2(ar[r][s], ai[r][s]);
  }
  __syncthreads();
  const int n2 = 2 * N;
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

template <int TI>
int launch(const void* x, const void* tw, const void* cr, const void* ci,
           void* out, int F, int N, int g, int n_chunks, float scale,
           cudaStream_t stream) {
  fft_gram_kernel<TI><<<F * n_chunks, THREADS, 0, stream>>>(
      (const float*)x, (const float*)tw, (const float*)cr, (const float*)ci,
      (float*)out, F, N, g, n_chunks, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// x: frames f32[n_chunks * g, F * 2N] contiguous; tw: f32[F, 2], the
// twiddles exp(-2 pi j k / F); cr, ci: f32[N] correction; out: f32[F,
// n_chunks, 2N, 2N]. N: 4 | N <= 64, 2 | N <= 32, or N <= 16.
extern "C" int doa_wideband_fft_gram(const void* x, const void* tw,
                                     const void* cr, const void* ci,
                                     void* out, int F, int N, int g,
                                     int n_chunks, float scale,
                                     void* stream) {
  if (F < 1 || N < 1 || g < 1 || n_chunks < 1 ||
      (long long)F * n_chunks > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (N % 4 == 0 && N <= 64)
    return launch<4>(x, tw, cr, ci, out, F, N, g, n_chunks, scale, s);
  if (N % 2 == 0 && N <= 32)
    return launch<2>(x, tw, cr, ci, out, F, N, g, n_chunks, scale, s);
  if (N <= 16)
    return launch<1>(x, tw, cr, ci, out, F, N, g, n_chunks, scale, s);
  return (int)cudaErrorInvalidValue;
}
