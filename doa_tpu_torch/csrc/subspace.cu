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
//   warm:  Vt = init of the window's group, then rounds-1 applies;
//   apply: W = Vt E, Vt_prev = Vt, Vt = MGS(W) (two passes in the last
//          round, one before), exactly the reference's schedule;
//   out:   Vt, and W, Vt_prev of the last apply (the escalation detector's
//          inputs; one extra apply when no round ran).
//
// Warm starts share an init across a group of consecutive windows: one
// init for all (the narrowband capture mean), one per subband (the
// wideband per-subband capture means, windows subband-major), or one per
// window.
//
// What bounds it: reading E once (64 MiB at the narrowband headline, 2 GiB
// at c5: F*B = 32768 windows of 2N = 128), and at 2N = 128 the apply's
// 64 K FMAs a window per round. Design: Vt, W and Vt_prev of a window
// live in its warp's slice of shared memory, and so does E up to
// 2N = 64 (16 KiB, entering with 16-byte loads). At 2N = 128 E is 64 KiB
// a window: staged, it held a block to 3 warps, an SM to 3 windows in
// flight, and the stage ran slower than its plain version; there E is
// read in place through L1/L2 (the second apply finds it in L2), and
// shared memory no longer bounds the warps in flight. In the apply each
// lane owns the columns j = lane + 32c of every row of W in registers (E
// rows read across lanes, Vt broadcast), and each MGS dot product is a
// warp shuffle reduction. FP32 throughout.

#include <cuda_runtime.h>

namespace {

constexpr int MAX_WARPS = 4;
constexpr int MAX_N2 = 128;       // up to 4 elements of a row per lane
constexpr int MAX_K2 = 8;
constexpr int STAGE_E_MAX_N2 = 64;      // larger E stay in device memory
constexpr size_t SMEM_LIMIT = 232448;   // bytes a block may use (H100)

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// W[k][j] = sum_n V[k][n] * E[n][j], summed in n order; CPL = columns
// of a row per lane (ceil(n2 / 32))
template <int CPL>
__device__ void apply(const float* V, const float* Es, float* W, int n2,
                      int K2, int lane) {
  float acc[MAX_K2][CPL];
#pragma unroll
  for (int k = 0; k < MAX_K2; ++k)
#pragma unroll
    for (int c = 0; c < CPL; ++c) acc[k][c] = 0.f;
  for (int n = 0; n < n2; ++n) {
    float e[CPL];
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      const int j = lane + 32 * c;
      e[c] = j < n2 ? Es[n * n2 + j] : 0.f;
    }
#pragma unroll
    for (int k = 0; k < MAX_K2; ++k) {
      if (k < K2) {
        const float v = V[k * n2 + n];
#pragma unroll
        for (int c = 0; c < CPL; ++c) acc[k][c] += v * e[c];
      }
    }
  }
#pragma unroll
  for (int k = 0; k < MAX_K2; ++k) {
    if (k < K2) {
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        const int j = lane + 32 * c;
        if (j < n2) W[k * n2 + j] = acc[k][c];
      }
    }
  }
  __syncwarp();
}

// rows of W, modified Gram-Schmidt → V (orthonormal rows)
template <int CPL>
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

template <int CPL>
__global__ void __launch_bounds__(MAX_WARPS * 32)
mgs_iterate_kernel(const float* __restrict__ E,
                   const float* __restrict__ init, int init_group,
                   float* __restrict__ Vt_out, float* __restrict__ W_out,
                   float* __restrict__ Vprev_out, int B, int n2, int K2,
                   int rounds, int stage_e) {
  extern __shared__ __align__(16) float smem[];
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x * warps + warp;
  if (b >= B) return;               // warps are independent: no block sync
  const int kn = K2 * n2;
  const int e_sz = stage_e ? n2 * n2 : 0;
  // n2 and K2 even: every slice starts 16-byte aligned
  float* S = smem + warp * (e_sz + 3 * kn);
  float* V = S + e_sz;              // current Vt
  float* W = V + kn;                // apply product
  float* P = W + kn;                // Vt before the last apply
  const float* Eb = E + (size_t)b * n2 * n2;
  const float* Es = Eb;             // E in place, read through L1/L2
  if (stage_e) {                    // E in the warp's shared slice
    const float4* Eb4 = reinterpret_cast<const float4*>(Eb);
    float4* S4 = reinterpret_cast<float4*>(S);
#pragma unroll 4
    for (int idx = lane; idx < n2 * n2 / 4; idx += 32) S4[idx] = Eb4[idx];
    Es = S;
  }
  if (init != nullptr) {
    const float* Ib = init + (size_t)(b / init_group) * kn;
    for (int idx = lane; idx < kn; idx += 32) V[idx] = Ib[idx];
    __syncwarp();
  } else {
    __syncwarp();
    mgs<CPL>(Es, V, n2, K2, 1, lane);   // rows 0..K2-1 of E
  }
  for (int r = 0; r + 1 < rounds; ++r) {
    apply<CPL>(V, Es, W, n2, K2, lane);
    for (int idx = lane; idx < kn; idx += 32) P[idx] = V[idx];
    __syncwarp();
    mgs<CPL>(W, V, n2, K2, r == rounds - 2 ? 2 : 1, lane);
  }
  if (rounds < 2) {                 // no apply ran: one for the detector
    apply<CPL>(V, Es, W, n2, K2, lane);
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

template <int CPL>
int launch(const float* E, const float* init, int init_group, float* Vt,
           float* W, float* Vprev, int B, int n2, int K2, int rounds,
           int stage_e, int blocks, int warps, size_t smem,
           cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        mgs_iterate_kernel<CPL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  mgs_iterate_kernel<CPL><<<blocks, warps * 32, smem, stream>>>(
      E, init, init_group, Vt, W, Vprev, B, n2, K2, rounds, stage_e);
  return (int)cudaGetLastError();
}

}  // namespace

// E f32[B, n2, n2]; init f32[B / init_group, K2, n2], window b starting
// from init row b / init_group (nullptr: cold start) → Vt, W, Vt_prev
// f32[B, K2, n2]. n2 even, K2 even.
extern "C" int doa_mgs_iterate(const void* E, const void* init,
                               int init_group, void* Vt, void* W,
                               void* Vprev, int B, int n2, int K2, int rounds,
                               void* stream) {
  if (B < 1 || n2 < 2 || n2 > MAX_N2 || n2 % 2 || K2 < 2 || K2 > MAX_K2 ||
      K2 % 2 || K2 > n2 || rounds < 1 || (init && init_group < 1))
    return (int)cudaErrorInvalidValue;
  const int stage_e = n2 <= STAGE_E_MAX_N2;
  const size_t per_warp =
      sizeof(float) * ((stage_e ? n2 * n2 : 0) + 3 * K2 * n2);
  int warps = (int)(SMEM_LIMIT / per_warp);
  warps = warps > MAX_WARPS ? MAX_WARPS : warps;
  if (warps < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = per_warp * warps;
  const int blocks = (B + warps - 1) / warps;
  cudaStream_t st = (cudaStream_t)stream;
  const float* e = (const float*)E;
  const float* in = (const float*)init;
  if (n2 <= 32)
    return launch<1>(e, in, init_group, (float*)Vt, (float*)W, (float*)Vprev,
                     B, n2, K2, rounds, stage_e, blocks, warps, smem, st);
  if (n2 <= 64)
    return launch<2>(e, in, init_group, (float*)Vt, (float*)W, (float*)Vprev,
                     B, n2, K2, rounds, stage_e, blocks, warps, smem, st);
  return launch<4>(e, in, init_group, (float*)Vt, (float*)W, (float*)Vprev,
                   B, n2, K2, rounds, stage_e, blocks, warps, smem, st);
}
