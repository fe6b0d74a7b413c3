// Kernel 11: the cold Newton-Schulz signal subspace, one window per block.
//
// Replaces the Pallas kernel doa_tpu/ops/pallas/subspace.py
// `_subspace_kernel` (subspace_packed_pallas, the fused path's
// subspace_impl="pallas" route). Per window of E f32[n2, n2] (n2 = 2N):
//
//   Ep = E / max(tr(E)/n2, 1e-30); `squarings` times Ep = Ep Ep followed
//   by Ep = (Ep + Ep^T)/2; Vt = rows 0..K2-1 of Ep; then `rounds` rounds of
//   [Vt = Vt Ep (not in round 0); Jacobi-preconditioned Newton-Schulz:
//    G = Vt Vt^T, d = 1/sqrt(max(diag G, 1e-30)), G~ = G o d d^T,
//    fro = ||G~||_F, Y = G~/max(fro, 1e-30), Z = I, n times
//    T = 1.5 I - 0.5 Z Y, Y = Y T, Z = T Z (n = ns_iters in the first and
//    last rounds, ns_iters_mid between), Vt = Z^T (d o Vt)/sqrt(max(fro,
//    1e-30))].
//
// The TPU kernel packs 128/n2 windows into one block-diagonal tile for the
// MXU and consolidates W windows' chains into one; block-diagonal algebra
// is closed, so each window's result is the per-window chain computed here.
//
// What bounds it on an H100: at the headline (B = 16384, n2 = 32, K2 = 4,
// 8 rounds) E is read once (64 MiB, 0.02 ms at 3.35 TB/s) and the chain is
// ~1e5 FP32 FLOP a window (0.025 ms at 67 TFLOP/s); but the chain is a
// sequence of dependent 2K x 2K products, so a window's time is the
// latency of ~150 block-wide steps. Design: the window's E, its square
// (squarings > 0; opt-in dynamic shared memory, up to 128 KiB at
// n2 = 128), Vt and the 2K x 2K chain live in shared memory; each product
// gives one output entry a thread, summed in index order with FP32 FMAs
// (no TF32, no fast math: 1.0f / sqrtf); many small blocks in flight on
// each SM hide the steps' latency. No device-memory round trip between
// the read of E and the write of Vt.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;
constexpr int MAX_N2 = 128;
constexpr int MAX_K2 = 16;
constexpr size_t SMEM_LIMIT = 232448;   // bytes a block may use (H100)

// the sum over the block of one value a thread, returned to every thread;
// red: 32 floats of shared memory
__device__ float block_sum(float v, float* red) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();                       // red is free again
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float s = 0.f;
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) s += red[w];
  return s;
}

// C[r][c] = sum_m A[r][m] B[m][c] (R x Cc, depth Kd), one entry a thread
__device__ void matmul(const float* A, int lda, const float* B, int ldb,
                       float* C, int ldc, int R, int Cc, int Kd) {
  for (int idx = threadIdx.x; idx < R * Cc; idx += blockDim.x) {
    const int r = idx / Cc, c = idx - r * Cc;
    float s = 0.f;
    for (int m = 0; m < Kd; ++m) s = fmaf(A[r * lda + m], B[m * ldb + c], s);
    C[r * ldc + c] = s;
  }
}

__global__ void __launch_bounds__(THREADS)
subspace_ns_kernel(const float* __restrict__ E, float* __restrict__ Vt_out,
                   int n2, int K2, int rounds, int ns_iters, int ns_iters_mid,
                   int squarings) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int nn = n2 * n2, kn = K2 * n2, kk = K2 * K2;
  float* A = smem;                              // Ep
  float* Sq = A + nn;                           // the square (squarings > 0)
  float* V = Sq + (squarings > 0 ? nn : 0);     // Vt, K2 x n2
  float* W = V + kn;
  float* G = W + kn;                            // the 2K x 2K chain
  float* Y = G + kk;
  float* Z = Y + kk;
  float* T = Z + kk;
  float* Yn = T + kk;
  float* Zn = Yn + kk;
  float* d = Zn + kk;
  float* red = d + K2;                          // 32 floats

  // E in, 16 bytes a load (n2 even: n2^2 a multiple of 4)
  const float4* E4 =
      reinterpret_cast<const float4*>(E + (size_t)blockIdx.x * nn);
  float4* A4 = reinterpret_cast<float4*>(A);
  for (int i = tid; i < nn / 4; i += blockDim.x) A4[i] = E4[i];
  __syncthreads();

  // trace normalisation
  const float tr = block_sum(tid < n2 ? A[tid * n2 + tid] : 0.f, red);
  const float inv_tr = 1.0f / fmaxf(tr / (float)n2, 1e-30f);
  for (int i = tid; i < nn; i += blockDim.x) A[i] *= inv_tr;
  __syncthreads();

  // E^(2^squarings), symmetrised after each squaring
  for (int s = 0; s < squarings; ++s) {
    matmul(A, n2, A, n2, Sq, n2, n2, n2, n2);
    __syncthreads();
    for (int i = tid; i < nn; i += blockDim.x) {
      const int r = i / n2, c = i - r * n2;
      A[i] = 0.5f * (Sq[i] + Sq[c * n2 + r]);
    }
    __syncthreads();
  }

  for (int i = tid; i < kn; i += blockDim.x) V[i] = A[i];   // rows 0..K2-1
  __syncthreads();

  for (int r = 0; r < rounds; ++r) {
    if (r > 0) {                                  // apply: Vt = Vt Ep
      matmul(V, n2, A, n2, W, n2, K2, n2, n2);
      __syncthreads();
      float* t = V; V = W; W = t;
    }
    // Gram of the rows
    for (int idx = tid; idx < kk; idx += blockDim.x) {
      const int k = idx / K2, l = idx - k * K2;
      float s = 0.f;
      for (int n = 0; n < n2; ++n) s = fmaf(V[k * n2 + n], V[l * n2 + n], s);
      G[idx] = s;
    }
    __syncthreads();
    if (tid < K2) d[tid] = 1.0f / sqrtf(fmaxf(G[tid * K2 + tid], 1e-30f));
    __syncthreads();
    // Jacobi preconditioning, then the Frobenius norm of the result
    float part = 0.f;
    for (int idx = tid; idx < kk; idx += blockDim.x) {
      const int k = idx / K2, l = idx - k * K2;
      const float g = G[idx] * d[l] * d[k];
      G[idx] = g;
      part += g * g;
    }
    const float fro = sqrtf(block_sum(part, red));
    const float inv = 1.0f / fmaxf(fro, 1e-30f);
    for (int idx = tid; idx < kk; idx += blockDim.x) {
      const int k = idx / K2, l = idx - k * K2;
      Y[idx] = G[idx] * inv;
      Z[idx] = k == l ? 1.f : 0.f;
    }
    __syncthreads();
    const int n_ns = (r == 0 || r == rounds - 1) ? ns_iters : ns_iters_mid;
    for (int it = 0; it < n_ns; ++it) {
      for (int idx = tid; idx < kk; idx += blockDim.x) {
        const int k = idx / K2, l = idx - k * K2;
        float s = 0.f;
        for (int m = 0; m < K2; ++m) s = fmaf(Z[k * K2 + m], Y[m * K2 + l], s);
        T[idx] = (k == l ? 1.5f : 0.f) - 0.5f * s;
      }
      __syncthreads();
      matmul(Y, K2, T, K2, Yn, K2, K2, K2, K2);
      matmul(T, K2, Z, K2, Zn, K2, K2, K2, K2);
      __syncthreads();
      float* t = Y; Y = Yn; Yn = t;
      t = Z; Z = Zn; Zn = t;
    }
    // Vt = Z^T (d o Vt) / sqrt(max(fro, 1e-30))
    const float sc = 1.0f / sqrtf(fmaxf(fro, 1e-30f));
    for (int idx = tid; idx < kn; idx += blockDim.x) {
      const int l = idx / n2, n = idx - l * n2;
      float s = 0.f;
      for (int k = 0; k < K2; ++k)
        s = fmaf(Z[k * K2 + l], V[k * n2 + n] * d[k], s);
      W[idx] = s * sc;
    }
    __syncthreads();
    float* t = V; V = W; W = t;
  }

  float* out = Vt_out + (size_t)blockIdx.x * kn;
  for (int i = tid; i < kn; i += blockDim.x) out[i] = V[i];
}

}  // namespace

// E f32[B, n2, n2] (16-byte aligned) → Vt f32[B, K2, n2]. n2 even, at
// most 128; K2 even, at most min(16, n2); rounds >= 1.
extern "C" int doa_subspace_ns(const void* E, void* Vt, int B, int n2, int K2,
                               int rounds, int ns_iters, int ns_iters_mid,
                               int squarings, void* stream) {
  if (B < 1 || n2 < 2 || n2 > MAX_N2 || n2 % 2 || K2 < 2 || K2 > MAX_K2 ||
      K2 % 2 || K2 > n2 || rounds < 1 || ns_iters < 0 || ns_iters_mid < 0 ||
      squarings < 0)
    return (int)cudaErrorInvalidValue;
  const size_t floats = (size_t)n2 * n2 * (squarings > 0 ? 2 : 1) +
                        2 * (size_t)K2 * n2 + 6 * (size_t)K2 * K2 + K2 + 32;
  const size_t smem = floats * sizeof(float);
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        subspace_ns_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  subspace_ns_kernel<<<B, THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)E, (float*)Vt, n2, K2, rounds, ns_iters, ns_iters_mid,
      squarings);
  return (int)cudaGetLastError();
}
