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
// Group form, n2 <= GROUP_MAX_N2 = 64 (every narrowband and planes path:
// 2N = 8, 16, 24, 32): a window per group of L lanes, L = group_width(n2)
// (4 for n2 <= 16, 8 for n2 <= 32, 16 for n2 <= 64), 32 / L windows a warp,
// GROUP_THREADS = 64 threads a block. What held the first form (a warp a
// window) back was each window's dependent chain: a lane a column, so every
// MGS dot product was one FMA and a five-level shuffle tree, the rows read
// back from shared memory, K2 a runtime loop bound, E staged by the warp's
// own loads before any round. Here:
// - Columns: lane gl of a group holds columns gl + L c (c < C = ceil(n2 /
//   L) <= 4) of every row of Vt and W in registers; K2, L and C are
//   template arguments.
// - MGS: mgs_rows<K2, L, C>, shared with the block form (L = 32, C = 4):
//   each dot product the lane's C products, then a log2(L)-level xor tree
//   inside the group (3 levels at the headline against 5).
// - Apply W = Vt E: after each MGS the group writes its rows to its Vt
//   area in shared memory, transposed (column n's K2 values together);
//   each row n of the apply reads E[n][j] from the slot (C floats a lane)
//   and Vt[.][n] as float4 broadcasts, summed in row order. Taking
//   Vt[k][n] by a shuffle from the lane that holds column n instead (one
//   shuffle a k and row) was 13-18 % slower at the headline and c3.
// - Copy and walk: a persistent grid; group q takes windows q, q + groups,
//   ...; each window's E arrives in the group's slot by one bulk copy with
//   the group's mbarrier (load_window), the next window's issued as soon as
//   the last apply has read E, so it lands during the last (two-pass) MGS
//   and the stores. The slots are n2^2 rounded up to 32 words plus L, so a
//   warp's groups read their rows L banks apart, without conflicts.
// - Measured (exp_mgs_iterate.py on an H100 80GB HBM3 at 700 W, device ms
//   a launch, the warp form's in the same call in parentheses; PERF.md):
//   headline 0.047 (0.092; bound 0.0275), c3 0.082 (0.283), c2 0.011
//   (0.030), the headline's B = 1 capture mean 0.013 (0.036). A second E
//   slot a group (the next copy under a window's whole chain) and blocks
//   of 32 or 128 threads moved nothing. Registers: 80 at the headline, 72
//   at c3, 64 at c2; the (K2, n2) = (8, 34..48) entry spills 24 bytes (no
//   path runs it).
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
//   product: the lane's 4 products in c order, then the xor shuffle tree
//   (mgs_rows<K2, 32, 4>).
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
//   (mgs<4>) cost 14% at c5 cold 8 rounds, so up to K2 = 6
//   they stay in registers.
//
// Exact inputs give the plain version's outputs bit for bit in both forms
// (every sum exact in any order); otherwise the sums' order and rsqrtf
// differ from the plain version's (chip_smoke.py holds projectors and W to
// 1e-5).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_N2 = 128;             // up to 4 elements of a row per lane
constexpr int MAX_K2 = 8;
constexpr int GROUP_MAX_N2 = 64;        // the group form's n2; above: blocks
constexpr int BLOCK_THREADS = 256;      // block form: 4 column groups x 2
constexpr int BLOCKS_PER_SM = 3;        //   row halves; blocks an SM holds
constexpr int MAX_DEVICES = 64;
constexpr int GROUP_THREADS = 64;       // group form: 2 warps a block
constexpr int MAX_GROUPS = GROUP_THREADS / 4;

__host__ __device__ constexpr bool block_form(int n2) {
  return n2 > GROUP_MAX_N2;
}

// The group form's lanes a window: 4 for n2 <= 16, 8 for n2 <= 32, 16 for
// n2 <= 64, so that a lane holds at most 4 columns of a row
__host__ __device__ constexpr int group_width(int n2) {
  return n2 <= 16 ? 4 : n2 <= 32 ? 8 : 16;
}

// A group's E slot in floats: n2^2 rounded up to 32 words, plus L, so that
// the slots of a warp's 32 / L groups start L banks apart
__host__ __device__ constexpr int group_slot(int n2, int L) {
  return (n2 * n2 + 31) / 32 * 32 + L;
}

// A column's K2 values of Vt in the group's Vt area, padded for float4
__host__ __device__ constexpr int vt_pad(int K2) { return (K2 + 3) / 4 * 4; }

// A group's Vt area in floats: L C columns of vt_pad(K2), plus 4, so that
// (L C vt_pad a multiple of 16) the areas of a warp's groups start an odd
// number of float4s apart: their broadcasts fall in distinct bank quads
__host__ __device__ constexpr int group_vt(int K2, int L, int C) {
  return L * C * vt_pad(K2) + 4;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// The lanes of this lane's group of L (all 32 for L = 32)
template <int L>
__device__ __forceinline__ unsigned group_mask(int lane) {
  if constexpr (L == 32) return 0xffffffffu;
  else return ((1u << L) - 1) << (lane & ~(L - 1));
}

// Sum over a group of L lanes: the xor tree, offsets L/2 ... 1 in order
// (L = 32: warp_sum's)
template <int L>
__device__ __forceinline__ float group_sum(float v, unsigned mask) {
#pragma unroll
  for (int off = L / 2; off > 0; off >>= 1)
    v += __shfl_xor_sync(mask, v, off);
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

// ---------------------------------------------------------------- shared

// Rows of W, modified Gram-Schmidt → V (orthonormal rows), on one warp:
// only row i in registers, the rows before it read back from V (the block
// form's MGS at K2 = 8; CPL = columns of a row per lane)
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

// Modified Gram-Schmidt over K2 rows held in registers by a group of L
// lanes (mask: the group's), each lane C columns of every row (ok[c]: the
// column lies in the window) → orthonormal rows, in place. Each dot
// product: the lane's products in c order, then the group's xor tree.
template <int K2, int L, int C>
__device__ __forceinline__ void mgs_rows(float (&v)[K2][C],
                                         const bool (&ok)[C], int passes,
                                         unsigned mask) {
#pragma unroll
  for (int i = 0; i < K2; ++i) {
    for (int p = 0; p < passes; ++p) {
#pragma unroll
      for (int u = 0; u < i; ++u) {
        float d = 0.f;
#pragma unroll
        for (int c = 0; c < C; ++c)
          if (ok[c]) d += v[u][c] * v[i][c];
        d = group_sum<L>(d, mask);
#pragma unroll
        for (int c = 0; c < C; ++c)
          if (ok[c]) v[i][c] = v[i][c] - d * v[u][c];
      }
    }
    float s = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) s += v[i][c] * v[i][c];
    const float r = rsqrtf(fmaxf(group_sum<L>(s, mask), 1e-30f));
#pragma unroll
    for (int c = 0; c < C; ++c) v[i][c] *= r;
  }
}

// The block form's MGS on one warp over the K2 rows of W (stride n2) →
// orthonormal rows in V (may be W), and in out (device memory) unless
// null. Up to K2 = 6 the rows stay in registers (mgs_rows, lane: columns
// lane + 32c, c < 4); at K2 = 8 those 32 floats a lane spilled at 80
// registers, so mgs<4> (only row i in registers, the rows
// before it read back from V), its rows then copied to out unless null.
template <int K2>
__device__ __forceinline__ void block_mgs(const float* W, float* V, int n2,
                                          int passes, int lane, float* out) {
  if constexpr (K2 <= 6) {
    float v[K2][4];
    bool ok[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) ok[c] = lane + 32 * c < n2;
#pragma unroll
    for (int k = 0; k < K2; ++k)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        v[k][c] = ok[c] ? W[k * n2 + lane + 32 * c] : 0.f;
    mgs_rows<K2, 32, 4>(v, ok, passes, 0xffffffffu);
#pragma unroll
    for (int k = 0; k < K2; ++k)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = lane + 32 * c;
        if (ok[c]) {
          V[k * n2 + j] = v[k][c];
          if (out != nullptr) out[k * n2 + j] = v[k][c];
        }
      }
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

// --------------------------------------------------------------- group form

// W = Vt E over the window's rows in order: lane gl of the group holds
// columns j = gl + L c (c < C) of each row of W; E[n][j] comes from the
// group's slot, Vt[.][n] from the group's Vt area as float4 broadcasts
template <int K2, int L, int C>
__device__ __forceinline__ void group_apply(const float* Es, const float* Vs,
                                            const bool (&ok)[C],
                                            float (&w)[K2][C], int n2,
                                            int gl) {
  constexpr int KP = vt_pad(K2);
#pragma unroll
  for (int k = 0; k < K2; ++k)
#pragma unroll
    for (int c = 0; c < C; ++c) w[k][c] = 0.f;
#pragma unroll
  for (int cn = 0; cn < C; ++cn) {
#pragma unroll
    for (int s = 0; s < L; ++s) {
      const int n = s + L * cn;
      if (cn == C - 1 && n >= n2) break;   // the window's rows end
      const float* row = Es + n * n2 + gl;
      float e[C];
#pragma unroll
      for (int c = 0; c < C; ++c) e[c] = ok[c] ? row[L * c] : 0.f;
      float vk[KP];
#pragma unroll
      for (int q = 0; q < KP / 4; ++q) {
        const float4 t = reinterpret_cast<const float4*>(Vs + n * KP)[q];
        vk[4 * q] = t.x;
        vk[4 * q + 1] = t.y;
        vk[4 * q + 2] = t.z;
        vk[4 * q + 3] = t.w;
      }
#pragma unroll
      for (int k = 0; k < K2; ++k)
#pragma unroll
        for (int c = 0; c < C; ++c) w[k][c] += vk[k] * e[c];
    }
  }
}

// The group's Vt rows (registers) into its Vt area, transposed: column n's
// K2 values at n vt_pad(K2), for the next apply
template <int K2, int L, int C>
__device__ __forceinline__ void vt_out(const float (&v)[K2][C], float* Vs,
                                       const bool (&ok)[C], int gl,
                                       unsigned mask) {
  __syncwarp(mask);                        // the last apply has read it
#pragma unroll
  for (int c = 0; c < C; ++c)
    if (ok[c])
#pragma unroll
      for (int k = 0; k < K2; ++k) Vs[(gl + L * c) * vt_pad(K2) + k] = v[k][c];
  __syncwarp(mask);
}

// K2 rows of this lane's columns from src (stride n2; zero outside the
// window) into registers, or from registers to dst
template <int K2, int L, int C>
__device__ __forceinline__ void rows_in(float (&v)[K2][C], const float* src,
                                        const bool (&ok)[C], int n2) {
#pragma unroll
  for (int k = 0; k < K2; ++k)
#pragma unroll
    for (int c = 0; c < C; ++c) v[k][c] = ok[c] ? src[k * n2 + L * c] : 0.f;
}

template <int K2, int L, int C>
__device__ __forceinline__ void rows_out(const float (&v)[K2][C], float* dst,
                                         const bool (&ok)[C], int n2) {
#pragma unroll
  for (int k = 0; k < K2; ++k)
#pragma unroll
    for (int c = 0; c < C; ++c)
      if (ok[c]) dst[k * n2 + L * c] = v[k][c];
}

// A window per group of L lanes, GROUP_THREADS / L groups a block, on a
// persistent grid: group q of the grid takes windows q, q + groups, ...;
// its window's E arrives in its slot by one bulk copy, issued as soon as
// the last apply of the window before has read E.
template <int K2, int L, int C>
__global__ void __launch_bounds__(GROUP_THREADS)
mgs_group_kernel(const float* __restrict__ E,
                 const float* __restrict__ init, int init_group,
                 float* __restrict__ Vt_out, float* __restrict__ W_out,
                 float* __restrict__ Vprev_out, int B, int n2, int rounds) {
  extern __shared__ __align__(16) float smem[];
  __shared__ __align__(8) unsigned long long bars[MAX_GROUPS];
  constexpr int G = GROUP_THREADS / L;     // groups a block
  const int tid = threadIdx.x, grp = tid / L, gl = tid % L;
  const unsigned mask = group_mask<L>(tid & 31);
  float* Es = smem + grp * group_slot(n2, L);
  float* Vs = smem + G * group_slot(n2, L) + grp * group_vt(K2, L, C);
  const uint32_t bar = smem_addr(&bars[grp]);
  const uint32_t bytes = (uint32_t)(n2 * n2 * sizeof(float));
  const int kn = K2 * n2;
  const int stride = gridDim.x * G;
  bool ok[C];                              // columns gl + L c of the window
#pragma unroll
  for (int c = 0; c < C; ++c) ok[c] = c < C - 1 || gl + L * c < n2;
  const int applies = rounds > 1 ? rounds - 1 : 1;
  const bool orth = rounds > 1;
  int b = blockIdx.x * G + grp;
  if (gl == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" :: "r"(bar)
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    if (b < B) load_window(Es, E + (size_t)b * n2 * n2, bytes, bar);
  }
  __syncthreads();
  uint32_t parity = 0;
  for (; b < B; b += stride, parity ^= 1) {
    const size_t o = (size_t)b * kn + gl;
    float v[K2][C], w[K2][C];
    if (init != nullptr)
      rows_in<K2, L, C>(v, init + (size_t)(b / init_group) * kn + gl, ok,
                        n2);
    mbar_wait(bar, parity);
    __syncwarp(mask);
    if (init == nullptr) {                 // rows 0..K2-1 of E
      rows_in<K2, L, C>(v, Es + gl, ok, n2);
      mgs_rows<K2, L, C>(v, ok, 1, mask);
    }
    vt_out<K2, L, C>(v, Vs, ok, gl, mask);
    for (int r = 0; r < applies; ++r) {
      group_apply<K2, L, C>(Es, Vs, ok, w, n2, gl);
      if (r == applies - 1) {
        __syncwarp(mask);                  // the group has read E: the
        if (gl == 0 && b + stride < B)     // next window's copy flies
          load_window(Es, E + (size_t)(b + stride) * n2 * n2, bytes, bar);
        rows_out<K2, L, C>(v, Vprev_out + o, ok, n2);
        rows_out<K2, L, C>(w, W_out + o, ok, n2);
      }
      if (orth) {
#pragma unroll
        for (int k = 0; k < K2; ++k)
#pragma unroll
          for (int c = 0; c < C; ++c) v[k][c] = w[k][c];
        mgs_rows<K2, L, C>(v, ok, r == applies - 1 ? 2 : 1, mask);
        if (r < applies - 1) vt_out<K2, L, C>(v, Vs, ok, gl, mask);
      }
    }
    rows_out<K2, L, C>(v, Vt_out + o, ok, n2);
  }
}

template <int K2, int L, int C>
int launch_group(const float* E, const float* init, int init_group,
                 float* Vt, float* W, float* Vprev, int B, int n2,
                 int rounds, cudaStream_t stream) {
  if constexpr (K2 > L * C) {
    return (int)cudaErrorInvalidValue;     // K2 > n2: refused before
  } else {
    static int sms[MAX_DEVICES] = {};               // 0: not read yet
    constexpr int G = GROUP_THREADS / L;
    const size_t smem =
        sizeof(float) * (size_t)G * (group_slot(n2, L) + group_vt(K2, L, C));
    int dev = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    if (dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
    if (sms[dev] == 0) {
      e = cudaDeviceGetAttribute(sms + dev, cudaDevAttrMultiProcessorCount,
                                 dev);
      if (e != cudaSuccess) return (int)e;
    }
    e = cudaFuncSetAttribute(mgs_group_kernel<K2, L, C>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, mgs_group_kernel<K2, L, C>, GROUP_THREADS, smem);
    if (e != cudaSuccess) return (int)e;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    const long long need = (B + G - 1) / G;
    const long long fit = (long long)per_sm * sms[dev];
    const int grid = (int)(need < fit ? need : fit);
    mgs_group_kernel<K2, L, C><<<grid, GROUP_THREADS, smem, stream>>>(
        E, init, init_group, Vt, W, Vprev, B, n2, rounds);
    return (int)cudaGetLastError();
  }
}

// The group form's entry of a K2: L = group_width(n2), C = ceil(n2 / L)
template <int K2>
int launch_group_k(const float* E, const float* init, int init_group,
                   float* Vt, float* W, float* Vprev, int B, int n2,
                   int rounds, cudaStream_t st) {
#define DOA_GROUP(L, C) \
  launch_group<K2, L, C>(E, init, init_group, Vt, W, Vprev, B, n2, rounds, st)
  switch (group_width(n2)) {
    case 4:
      switch ((n2 + 3) / 4) {
        case 1: return DOA_GROUP(4, 1);
        case 2: return DOA_GROUP(4, 2);
        case 3: return DOA_GROUP(4, 3);
        default: return DOA_GROUP(4, 4);
      }
    case 8: return n2 <= 24 ? DOA_GROUP(8, 3) : DOA_GROUP(8, 4);
    default: return n2 <= 48 ? DOA_GROUP(16, 3) : DOA_GROUP(16, 4);
  }
#undef DOA_GROUP
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
  switch (K2) {
    case 2: return launch_group_k<2>(e, in, init_group, vt, w, vp, B, n2,
                                     rounds, st);
    case 4: return launch_group_k<4>(e, in, init_group, vt, w, vp, B, n2,
                                     rounds, st);
    case 6: return launch_group_k<6>(e, in, init_group, vt, w, vp, B, n2,
                                     rounds, st);
    default: return launch_group_k<8>(e, in, init_group, vt, w, vp, B, n2,
                                      rounds, st);
  }
}
