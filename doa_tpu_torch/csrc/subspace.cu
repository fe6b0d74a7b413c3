// K4: the MGS subspace iteration, every round of a window in one launch.
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
// at c5: F*B = 32768 windows of 2N = 128); the arithmetic is small (two
// applies at c5 are 8.6 GFLOP, 0.13 ms at the FP32 rate). FP32 throughout.
// Two forms, chosen by n2 alone (`block_form`; cpx_ops.mgs_form is the
// same rule):
//
// Warp form, n2 <= WARP_MAX_N2 = 64 (the narrowband and planes paths): one
// warp a window, MAX_WARPS warps a block. E (16 KiB at n2 = 64), Vt, W and
// Vt_prev live in the warp's slice of shared memory, E entering with
// 16-byte loads. In the apply each lane owns the columns j = lane + 32c of
// every row of W in registers (E rows read across lanes, Vt broadcast);
// each MGS dot product is a warp shuffle reduction.
//
// Block form, 64 < n2 <= 128 (c5, c5_f12, cssm, cssm_auto; ULA-48's 96):
// one window at a time per block of BLOCK_THREADS = 256 threads, E read
// from device memory once and held in shared memory for every apply of
// every round. One warp a window cannot do this: E is 64 KiB at n2 = 128,
// so staging it a warp held an SM to 3 windows, and reading it in place
// for each apply read it from device memory once an apply (the windows in
// flight, ~300 MB, far exceed the 50 MB L2).
// - Copy: one 1-D bulk async copy a window (cp.async.bulk with an
//   mbarrier carrying its bytes; n2^2 * 4 bytes and every window's start
//   are multiples of 16 for even n2, and the wrapper hands an aligned E).
// - Walk: a persistent grid of every block that fits (BLOCKS_PER_SM a SM)
//   and no more than B; block k takes windows k, k + grid, k + 2 grid, ...
//   The next window's copy is issued as soon as the last apply has read
//   E, so it flies during the last (two-pass) MGS and the stores.
// - Apply W = Vt E: thread (warp w, lane l) owns column j = 32 (w % 4) + l
//   of W and the rows of E of half h = w / 4 (pairs [0, P/2) or [P/2, P),
//   P = n2 / 2): K2 FP32 accumulators summed in row order, E read across
//   lanes (conflict-free), Vt two rows at a time as float2 broadcasts.
//   Half 1 leaves its partials in X; half 0 adds them: W = part0 + part1.
// - MGS on one warp, in place over W, the rows in registers (lane:
//   columns lane + 32c, c < 4; at K2 = 8 only the current row); the other
//   warps wait at the barrier while the SM's other blocks run. Each dot
//   product: the lane's 4 products in c order, then the xor shuffle tree,
//   as the warp form.
// - Shared memory a block: E n2^2 + Vt/W K2 n2 + X K2 n2 floats:
//   65536 + 4096 + 4096 = 73728 bytes at n2 = 128, K2 = 8 (+ 8 bytes of
//   mbarrier, + 1 KiB the SM reserves a block): 3 blocks in 228 KiB.
// - Registers: __launch_bounds__(256, 3) caps a thread at 80 (65536 / 768
//   rounded down to 8): K2 accumulators in the apply, 4 K2 floats of rows
//   in the MGS warp up to K2 = 6 (at K2 = 8 only the current row: see
//   block_mgs). No entry spills.
// - Measured (exp_mgs_iterate.py on an H100 80GB HBM3 at 700 W; PERF.md):
//   at c5 warm the kernel runs within ~10% of its copies alone (0.90
//   against 0.83 ms; bound 0.70). Vt read four rows at a time (float4,
//   rows padded) instead of two moved nothing, so the apply is not bound
//   by its shared-memory loads; the MGS rows read back from shared memory
//   (the warp form's mgs) cost 14% at c5 cold 8 rounds, so up to K2 = 6
//   they stay in registers.
//
// Exact inputs give the plain version's outputs bit for bit in both forms
// (every sum exact in any order); otherwise the sums' order and rsqrtf
// differ from the plain version's (chip_smoke.py holds projectors and W to
// 1e-5).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_WARPS = 4;
constexpr int MAX_N2 = 128;             // up to 4 elements of a row per lane
constexpr int MAX_K2 = 8;
constexpr int WARP_MAX_N2 = 64;         // the warp form's n2; above: blocks
constexpr size_t SMEM_LIMIT = 232448;   // bytes a block may use (H100)
constexpr int BLOCK_THREADS = 256;      // block form: 4 column groups x 2
constexpr int BLOCKS_PER_SM = 3;        //   row halves; blocks an SM holds
constexpr int MAX_DEVICES = 64;

__host__ __device__ constexpr bool block_form(int n2) {
  return n2 > WARP_MAX_N2;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
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

// Wait for a window's copy. One that has not landed after ~2^34 clocks
// (seconds) is lost: trap, so the launch fails instead of hanging.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try(bar, parity))
    if (clock64() - t0 > (1ll << 34)) __trap();
}

// ---------------------------------------------------------------- warp form

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
mgs_warp_kernel(const float* __restrict__ E, const float* __restrict__ init,
                int init_group, float* __restrict__ Vt_out,
                float* __restrict__ W_out, float* __restrict__ Vprev_out,
                int B, int n2, int K2, int rounds) {
  extern __shared__ __align__(16) float smem[];
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x * warps + warp;
  if (b >= B) return;               // warps are independent: no block sync
  const int kn = K2 * n2;
  // n2 and K2 even: every slice starts 16-byte aligned
  float* S = smem + warp * (n2 * n2 + 3 * kn);    // E
  float* V = S + n2 * n2;           // current Vt
  float* W = V + kn;                // apply product
  float* P = W + kn;                // Vt before the last apply
  const float4* Eb4 = reinterpret_cast<const float4*>(E + (size_t)b * n2 * n2);
  float4* S4 = reinterpret_cast<float4*>(S);
#pragma unroll 4
  for (int idx = lane; idx < n2 * n2 / 4; idx += 32) S4[idx] = Eb4[idx];
  // E's staged copy through a pointer the compiler cannot place in shared
  // memory (a select on n2, which is > 0), as the first form's (whose E
  // could also lie in device memory): knowing it shared, ptxas spilled at
  // CPL = 2 and the headline ran 5-10% slower (exp_mgs_iterate.py; hiding
  // it behind an asm mov did not help)
  const float* Es = n2 > 0 ? S : E;
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
int launch_warp(const float* E, const float* init, int init_group, float* Vt,
                float* W, float* Vprev, int B, int n2, int K2, int rounds,
                cudaStream_t stream) {
  const size_t per_warp = sizeof(float) * (n2 * n2 + 3 * K2 * n2);
  int warps = (int)(SMEM_LIMIT / per_warp);
  warps = warps > MAX_WARPS ? MAX_WARPS : warps;
  const size_t smem = per_warp * warps;
  const int blocks = (B + warps - 1) / warps;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        mgs_warp_kernel<CPL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  mgs_warp_kernel<CPL><<<blocks, warps * 32, smem, stream>>>(
      E, init, init_group, Vt, W, Vprev, B, n2, K2, rounds);
  return (int)cudaGetLastError();
}

// --------------------------------------------------------------- block form

// One window's E (bytes, a multiple of 16) into Es by one bulk copy whose
// bytes complete the barrier's phase.
__device__ __forceinline__ void load_window(float* Es, const float* src,
                                            uint32_t bytes, uint32_t bar) {
  // the block's reads of Es are done (a barrier before): order them
  // before the async proxy's writes
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(bar), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];"
      :: "r"(smem_addr(Es)), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// This thread's column j of W over rows [2 p0, 2 p1) of E, summed in row
// order: acc[k] = sum_n V[k][n] E[n][j].
template <int K2>
__device__ __forceinline__ void apply_rows(const float* Es, const float* V,
                                           int n2, int j, int p0, int p1,
                                           float (&acc)[K2]) {
  const float2* V2 = reinterpret_cast<const float2*>(V);
  const int h2 = n2 / 2;
#pragma unroll
  for (int k = 0; k < K2; ++k) acc[k] = 0.f;
#pragma unroll 4
  for (int p = p0; p < p1; ++p) {
    const float e0 = Es[(2 * p) * n2 + j];
    const float e1 = Es[(2 * p + 1) * n2 + j];
#pragma unroll
    for (int k = 0; k < K2; ++k) {
      const float2 v = V2[k * h2 + p];
      acc[k] += v.x * e0;
      acc[k] += v.y * e1;
    }
  }
}

// One warp: modified Gram-Schmidt over the K2 rows of W (stride n2) →
// orthonormal rows in V (may be W), and in out (device memory) unless
// null. The rows stay in registers: lane holds columns lane + 32c.
template <int K2>
__device__ __forceinline__ void mgs_rows(const float* W, float* V, int n2,
                                         int passes, int lane, float* out) {
  float v[K2][4];
#pragma unroll
  for (int k = 0; k < K2; ++k)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = lane + 32 * c;
      v[k][c] = j < n2 ? W[k * n2 + j] : 0.f;
    }
#pragma unroll
  for (int i = 0; i < K2; ++i) {
    for (int p = 0; p < passes; ++p) {
#pragma unroll
      for (int u = 0; u < i; ++u) {
        float d = 0.f;
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (lane + 32 * c < n2) d += v[u][c] * v[i][c];
        d = warp_sum(d);
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (lane + 32 * c < n2) v[i][c] = v[i][c] - d * v[u][c];
      }
    }
    float s = 0.f;
#pragma unroll
    for (int c = 0; c < 4; ++c) s += v[i][c] * v[i][c];
    const float r = rsqrtf(fmaxf(warp_sum(s), 1e-30f));
#pragma unroll
    for (int c = 0; c < 4; ++c) v[i][c] *= r;
  }
#pragma unroll
  for (int k = 0; k < K2; ++k)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = lane + 32 * c;
      if (j < n2) {
        V[k * n2 + j] = v[k][c];
        if (out != nullptr) out[k * n2 + j] = v[k][c];
      }
    }
}

// The block form's MGS on one warp: the rows in registers (mgs_rows) up to
// K2 = 6; at K2 = 8 those 32 floats a lane spilled at 80 registers, so the
// warp form's mgs<4> (only row i in registers, the rows before it read
// back from V), its rows then copied to out unless null.
template <int K2>
__device__ __forceinline__ void block_mgs(const float* W, float* V, int n2,
                                          int passes, int lane, float* out) {
  if constexpr (K2 <= 6) {
    mgs_rows<K2>(W, V, n2, passes, lane, out);
  } else {
    mgs<4>(W, V, n2, K2, passes, lane);
    if (out != nullptr)
      for (int idx = lane; idx < K2 * n2; idx += 32) out[idx] = V[idx];
  }
}

template <int K2>
__global__ void __launch_bounds__(BLOCK_THREADS, BLOCKS_PER_SM)
mgs_block_kernel(const float* __restrict__ E,
                 const float* __restrict__ init, int init_group,
                 float* __restrict__ Vt_out, float* __restrict__ W_out,
                 float* __restrict__ Vprev_out, int B, int n2, int rounds) {
  extern __shared__ __align__(16) float smem[];
  __shared__ __align__(8) unsigned long long full;
  float* Es = smem;                      // E of the current window
  float* VW = Es + n2 * n2;              // Vt; the apply's W; MGS in place
  float* X = VW + K2 * n2;               // half 1's partial W
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int j = (warp & 3) * 32 + lane;  // this thread's column of W
  const int half = warp >> 2;            // and half of E's rows (in pairs)
  const int P = n2 / 2;
  const int p0 = half ? P / 2 : 0, p1 = half ? P : P / 2;
  const bool col = j < n2;
  const int kn = K2 * n2;
  const uint32_t bar = smem_addr(&full);
  const uint32_t bytes = (uint32_t)(n2 * n2 * sizeof(float));
  // every round of every window: rounds - 1 applies each followed by MGS,
  // or one apply for the detector alone
  const int applies = rounds > 1 ? rounds - 1 : 1;
  const bool orth = rounds > 1;
  if (tid == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" :: "r"(bar)
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    load_window(Es, E + (size_t)blockIdx.x * n2 * n2, bytes, bar);
  }
  __syncthreads();
  uint32_t parity = 0;
  for (int b = blockIdx.x; b < B; b += gridDim.x, parity ^= 1) {
    const size_t o = (size_t)b * kn;
    const int next = b + gridDim.x;
    if (init != nullptr) {
      const float* Ib = init + (size_t)(b / init_group) * kn;
      for (int idx = tid; idx < kn; idx += BLOCK_THREADS) VW[idx] = Ib[idx];
    }
    mbar_wait(bar, parity);
    if (init == nullptr && warp == 0)
      block_mgs<K2>(Es, VW, n2, 1, lane, nullptr);  // rows 0..K2-1 of E
    __syncthreads();
    for (int r = 0; r < applies; ++r) {
      const bool last = r == applies - 1;
      float acc[K2];
      if (col) apply_rows<K2>(Es, VW, n2, j, p0, p1, acc);
      if (half == 1 && col) {
#pragma unroll
        for (int k = 0; k < K2; ++k) {
          X[k * n2 + j] = acc[k];
          if (last) {
            Vprev_out[o + k * n2 + j] = VW[k * n2 + j];
            if (!orth) Vt_out[o + k * n2 + j] = VW[k * n2 + j];
          }
        }
      }
      __syncthreads();                   // E and Vt read; X written
      if (last && tid == 0 && next < B)  // E is free: the next window's
        load_window(Es, E + (size_t)next * n2 * n2, bytes, bar);
      if (half == 0 && col) {
#pragma unroll
        for (int k = 0; k < K2; ++k) {
          const float w = acc[k] + X[k * n2 + j];
          if (last) W_out[o + k * n2 + j] = w;
          if (orth) VW[k * n2 + j] = w;
        }
      }
      if (orth) {
        __syncthreads();
        if (warp == 0)
          block_mgs<K2>(VW, VW, n2, last ? 2 : 1, lane,
                        last ? Vt_out + o : nullptr);
        __syncthreads();
      }
    }
  }
}

template <int K2>
int launch_block(const float* E, const float* init, int init_group,
                 float* Vt, float* W, float* Vprev, int B, int n2,
                 int rounds, cudaStream_t stream) {
  static int sms[MAX_DEVICES] = {};                 // 0: not read yet
  const size_t smem = sizeof(float) * ((size_t)n2 * n2 + 2 * K2 * n2);
  int dev = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (sms[dev] == 0) {
    e = cudaDeviceGetAttribute(sms + dev, cudaDevAttrMultiProcessorCount,
                               dev);
    if (e != cudaSuccess) return (int)e;
  }
  e = cudaFuncSetAttribute(mgs_block_kernel<K2>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, mgs_block_kernel<K2>, BLOCK_THREADS, smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long fit = (long long)per_sm * sms[dev];
  const int grid = (int)(B < fit ? B : fit);
  mgs_block_kernel<K2><<<grid, BLOCK_THREADS, smem, stream>>>(
      E, init, init_group, Vt, W, Vprev, B, n2, rounds);
  return (int)cudaGetLastError();
}

}  // namespace

// E f32[B, n2, n2] (16-byte aligned); init f32[B / init_group, K2, n2],
// window b starting from init row b / init_group (nullptr: cold start) →
// Vt, W, Vt_prev f32[B, K2, n2]. n2 even, K2 even.
extern "C" int doa_mgs_iterate(const void* E, const void* init,
                               int init_group, void* Vt, void* W,
                               void* Vprev, int B, int n2, int K2, int rounds,
                               void* stream) {
  if (B < 1 || n2 < 2 || n2 > MAX_N2 || n2 % 2 || K2 < 2 || K2 > MAX_K2 ||
      K2 % 2 || K2 > n2 || rounds < 1 || (init && init_group < 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const float* e = (const float*)E;
  const float* in = (const float*)init;
  float *vt = (float*)Vt, *w = (float*)W, *vp = (float*)Vprev;
  if (block_form(n2)) {
    switch (K2) {
      case 2: return launch_block<2>(e, in, init_group, vt, w, vp, B, n2,
                                     rounds, st);
      case 4: return launch_block<4>(e, in, init_group, vt, w, vp, B, n2,
                                     rounds, st);
      case 6: return launch_block<6>(e, in, init_group, vt, w, vp, B, n2,
                                     rounds, st);
      default: return launch_block<8>(e, in, init_group, vt, w, vp, B, n2,
                                      rounds, st);
    }
  }
  if (n2 <= 32)
    return launch_warp<1>(e, in, init_group, vt, w, vp, B, n2, K2, rounds,
                          st);
  return launch_warp<2>(e, in, init_group, vt, w, vp, B, n2, K2, rounds, st);
}
