// K4: the MGS subspace iteration of one window per warp.
//
// Replaces no Pallas kernel: doa_tpu runs this stage as XLA
// (doa_tpu/ops/cpx_ops.py `_subspace_E_T_mgs`), and the port's first form,
// torch ops, issued some 50 small launches per round; at the headline
// (B = 16384, n2 = 32, K2 = 4) the stage was bound by those launches on the
// host, not by the card. This kernel runs every round of a window in one
// launch:
//
//   cold:  Vt = MGS(rows 0..K2-1 of E), then rounds-1 applies;
//   warm:  Vt = init, then rounds-1 applies;
//   apply: W = Vt E, Vt_prev = Vt, Vt = MGS(W) (two passes in the last
//          round, one before), exactly the reference's schedule;
//   out:   Vt, and W, Vt_prev of the last apply (the escalation detector's
//          inputs; one extra apply when no round ran).
//
// What bounds it: reading E once (64 MiB at the headline, 0.02 ms at
// 3.35 TB/s); the arithmetic is 4 K FMAs a window per round. Design: E,
// Vt and W of a window live in its warp's slice of shared memory; the
// apply has lane j produce W[k][j] (E rows read across lanes, Vt
// broadcast), and each MGS dot product is a warp shuffle reduction. FP32
// throughout.

#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 4;
constexpr int MAX_N2 = 64;        // 2 elements of a row per lane
constexpr int CPL = MAX_N2 / 32;

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// W[k][j] = sum_n V[k][n] * E[n][j]
__device__ void apply(const float* V, const float* Es, float* W, int n2,
                      int K2, int lane) {
  for (int idx = lane; idx < K2 * n2; idx += 32) {
    const int k = idx / n2, j = idx % n2;
    float s = 0.f;
    for (int n = 0; n < n2; ++n) s += V[k * n2 + n] * Es[n * n2 + j];
    W[idx] = s;
  }
  __syncwarp();
}

// rows of W, modified Gram-Schmidt → V (orthonormal rows)
__device__ void mgs(const float* W, float* V, int n2, int K2, int passes,
                    int lane) {
  for (int i = 0; i < K2; ++i) {
    float v[CPL];
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      const int j = lane + 32 * c;
      v[c] = j < n2 ? W[i * n2 + j] : 0.f;
    }
    for (int p = 0; p < passes; ++p) {
      for (int u = 0; u < i; ++u) {
        float d = 0.f;
#pragma unroll
        for (int c = 0; c < CPL; ++c) {
          const int j = lane + 32 * c;
          if (j < n2) d += V[u * n2 + j] * v[c];
        }
        d = warp_sum(d);
#pragma unroll
        for (int c = 0; c < CPL; ++c) {
          const int j = lane + 32 * c;
          if (j < n2) v[c] = v[c] - d * V[u * n2 + j];
        }
      }
    }
    float s = 0.f;
#pragma unroll
    for (int c = 0; c < CPL; ++c) s += v[c] * v[c];
    const float r = rsqrtf(fmaxf(warp_sum(s), 1e-30f));
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      const int j = lane + 32 * c;
      if (j < n2) V[i * n2 + j] = v[c] * r;
    }
    __syncwarp();
  }
}

__global__ void __launch_bounds__(WARPS * 32)
mgs_iterate_kernel(const float* __restrict__ E,
                   const float* __restrict__ init, int init_stride,
                   float* __restrict__ Vt_out, float* __restrict__ W_out,
                   float* __restrict__ Vprev_out, int B, int n2, int K2,
                   int rounds) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x * WARPS + warp;
  if (b >= B) return;               // warps are independent: no block sync
  const int kn = K2 * n2;
  float* Es = smem + warp * (n2 * n2 + 3 * kn);
  float* V = Es + n2 * n2;          // current Vt
  float* W = V + kn;                // apply product
  float* P = W + kn;                // Vt before the last apply
  const float* Eb = E + (size_t)b * n2 * n2;
  for (int idx = lane; idx < n2 * n2; idx += 32) Es[idx] = Eb[idx];
  if (init != nullptr) {
    const float* Ib = init + (size_t)b * init_stride;
    for (int idx = lane; idx < kn; idx += 32) V[idx] = Ib[idx];
    __syncwarp();
  } else {
    __syncwarp();
    mgs(Es, V, n2, K2, 1, lane);    // rows 0..K2-1 of E
  }
  for (int r = 0; r + 1 < rounds; ++r) {
    apply(V, Es, W, n2, K2, lane);
    for (int idx = lane; idx < kn; idx += 32) P[idx] = V[idx];
    __syncwarp();
    mgs(W, V, n2, K2, r == rounds - 2 ? 2 : 1, lane);
  }
  if (rounds < 2) {                 // no apply ran: one for the detector
    apply(V, Es, W, n2, K2, lane);
    for (int idx = lane; idx < kn; idx += 32) P[idx] = V[idx];
    __syncwarp();
  }
  const size_t o = (size_t)b * kn;
  for (int idx = lane; idx < kn; idx += 32) {
    Vt_out[o + idx] = V[idx];
    W_out[o + idx] = W[idx];
    Vprev_out[o + idx] = P[idx];
  }
}

}  // namespace

// E f32[B, n2, n2]; init f32 rows of K2*n2 at init_stride (0: one init for
// every window; nullptr: cold start) → Vt, W, Vt_prev f32[B, K2, n2].
extern "C" int doa_mgs_iterate(const void* E, const void* init,
                               int init_stride, void* Vt, void* W,
                               void* Vprev, int B, int n2, int K2, int rounds,
                               void* stream) {
  if (B < 1 || n2 < 1 || n2 > MAX_N2 || K2 < 1 || K2 > n2 || rounds < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * WARPS * (n2 * n2 + 3 * K2 * n2);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        mgs_iterate_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = (B + WARPS - 1) / WARPS;
  mgs_iterate_kernel<<<blocks, WARPS * 32, smem, (cudaStream_t)stream>>>(
      (const float*)E, (const float*)init, init_stride, (float*)Vt,
      (float*)W, (float*)Vprev, B, n2, K2, rounds);
  return (int)cudaGetLastError();
}
