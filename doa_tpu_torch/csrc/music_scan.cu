// K3 and K2: the MUSIC subspace scan,
//   den[b, g] = nrm[g] - sum_k (Vt[b,k,:] . a_g)^2.
//
// K3 `music_scan` replaces doa_tpu/ops/pallas/music_scan.py `_scan_kernel`
// and writes P = 1 / max(den, FLT_MIN), f32[B, G].
// K2 `music_scan_peaks` replaces `_scan_peaks_kernel` in the same file: the
// spectrum stays in shared memory and only the (B, k) peak list is written.
//
// K3 is one product with a reduction in its epilogue, Y[g, (b, k)] =
// sum_n A[g, n] Vt[b, k, n], and runs on the tensor cores: the mainloop of
// scan_tc.cuh (3xTF32 wgmma, hi.hi and the two correction terms in two
// FP32 accumulator sets; its note gives the A' and V' layouts), the one
// kernel 5 runs per subband, with an epilogue that takes each thread's
// 2K rows of one window in registers, sums their squares in k order and
// stores P = 1 / den (IEEE division) evict-first, a float2 where the pair
// is 8-byte aligned (rows of an odd G alternate). The wrapper lays out
// A' once per steering grid and V' every call; 2N is padded to KP, a
// multiple of 16, with zero columns.
//
// Shapes the mainloop does not take (2K of 10 to 16, or 2N past its
// shared-memory cap) run K3's CUDA-core form `music_scan_fma_kernel`
// (the kernel's first form): a block of FMA_GT bins x FMA_BT windows
// stages A^T's tile and the windows' Vt in shared memory and each thread
// sums its bin's (Vt_k . a_g)^2 in FP32 FMAs, for any 2K and 2N with
// 4 n2 (FMA_GT + FMA_BT K2) bytes <= 227 KiB.
//
// Grid (stretch of GB = 2 NT bins, window group): kernel 5 fills the card
// with its F subbands, K3 has one, so the window axis is split too. A
// block holds one stretch (one bulk copy) and walks `tpg` consecutive
// window tiles of 32. The sizing rule (ops/cuda/music_scan.py
// `window_groups`): about SCAN_WAVES = 4 blocks for each SM, groups =
// min(tiles, ceil(4 SMs / stretches)), then tpg = ceil(tiles / groups)
// and groups = ceil(tiles / tpg) -- one block an SM at ~210 registers a
// thread, so four waves, of which the last is nearly full. c5 cssm (G =
// 16471, 129 stretches, 64 tiles): 5 groups of 13 tiles; the headline
// (G = 1024, 8 stretches, 512 tiles): 64 groups of 8.
//
// What bounds K3 on an H100: at c5 cssm (B = 2048, 2K = 4, 2N = 128,
// G = 16471) the products, 3 x 2 B 2K 2N G = 1.04e11 TF32 operations,
// 0.21 ms at the dense 495 TFLOP/s (one FP32 pass: 0.52 ms at
// 67 TFLOP/s), and the P store, 134.9 MB, 0.04 ms at 3.35 TB/s; at the
// headline (B = 16384, 2N = 32, G = 1024) 0.067 ms at the FP32 rate, a
// 64 MiB store.
//
// K2: one block per window covers the whole grid with FP32 FMAs on the
// CUDA cores: den for all G bins is kept in shared memory (G <= 8192),
// then the peak rule of doa_tpu/ops/peaks.py::find_local_max runs as
// block reductions:
//   Pn = dmin / den; peaks are interior bins with Pn > left and
//   Pn >= right; k rounds of argmax with the lowest index on ties;
//   missing peaks pad with the best peak, a row without peaks falls back
//   to the global argmax with value exactly 1; the sub-bin refine is the
//   reciprocal-space parabola on raw den, clipped to +-0.5, 0 at the
//   edges. A^T is read from L2 by every window (128 KiB at the headline).
// den cancels at the MUSIC nulls, so no single-pass TF32 or bf16 anywhere.

#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

#include <type_traits>

#include "scan_tc.cuh"

namespace {

constexpr float NEG = -1e30f;     // "no peak" sentinel (_NEG)

constexpr int PEAK_THREADS = 256;
constexpr int MAX_K = 4;
constexpr int FMA_GT = 128;       // K3's CUDA-core form: bins a block
constexpr int FMA_BT = 16;        // (= threads), windows a block

// K3. Grid (stretches of GB bins, window groups of tpg tiles); see
// scan_tc.cuh for the layouts. The epilogue stores P = 1 / den into the
// row of the thread's window, evict first, a float2 where the pair is
// 8-byte aligned.
template <int K2>
__global__ void __launch_bounds__(scan_tc::THREADS, 1)
music_scan_kernel(const float4* __restrict__ Vf,
                  const float* __restrict__ Af,
                  const float* __restrict__ nrm, float* __restrict__ P,
                  int B, int KP, int G, int tpg) {
  using namespace scan_tc;
  constexpr int MT = K2 / 2, NT = bins_of(K2), GB = 2 * NT, NA = NT / 2;
  // (K2's kernel declares its dynamic shared memory as floats)
  extern __shared__ __align__(1024) unsigned char tc_smem[];
  float* nrm_s = reinterpret_cast<float*>(tc_smem + 16);
  const int g0 = blockIdx.x * GB;
  const uint32_t lbo = GB / 8 * 128;               // bytes a k-column
  const uint32_t tile_bytes = 8u * KP * GB;        // both planes
  const uint32_t bar = smem_addr(tc_smem);
  const uint32_t tile = smem_addr(tc_smem + TILE_OFF);
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" :: "r"(bar)
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 :: "r"(bar), "r"(tile_bytes) : "memory");
    const float* src = Af + (size_t)blockIdx.x * (tile_bytes / 4);
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1], %2, [%3];"
        :: "r"(tile), "l"(src), "r"(tile_bytes), "r"(bar) : "memory");
  }
  for (int i = threadIdx.x; i < GB; i += THREADS)
    nrm_s[i] = g0 + i < G ? nrm[g0 + i] : 0.f;
  __syncthreads();
  mbar_wait(bar, 0);

  const int wg = threadIdx.x >> 7, t = threadIdx.x & 127;
  const int warp = t >> 5, lane = t & 31, tq = lane & 3;
  const int S = KP / 8;                            // k-steps, even
  const int gw = g0 + wg * NT;                     // the warpgroup's bins
  const float* nr = nrm_s + wg * NT;
  const uint64_t d0 = make_desc(tile + wg * (NT / 8) * 128, lbo);
  const uint64_t d_step = (2 * lbo) >> 4;          // descriptor units
  const uint64_t d_plane = ((uint64_t)(KP / 4) * lbo) >> 4;
  // V' is read by every block of its window group: keep it in L2 past
  // the P stores (evict first) and the A' stretches
  const uint64_t v_pol = l2_evict_last();
  const int T0 = blockIdx.y * tpg;
  for (int T = T0; T < T0 + tpg && T * WT < B; ++T) {
    float hh[MT][NA], cr[MT][NA];
    tile_products<K2>(Vf + (size_t)T * S * MT * 128 + t, S, v_pol, d0,
                      d_step, d_plane, hh, cr);

    // P of window b at the thread's NT/4 bins: 8j + 2tq + c
    const int b = T * WT + 8 * warp + (lane >> 2);
    const bool b_ok = b < B;
    float* row = P + (size_t)b * G;
#pragma unroll
    for (int j = 0; j < NT / 8; ++j) {
      float d[2];
      den_pair<K2>(hh, cr, nr, j, tq, d);
      const int g = gw + 8 * j + 2 * tq;
      if (!b_ok || g >= G) continue;
      const float p0 = __fdiv_rn(1.0f, d[0]), p1 = __fdiv_rn(1.0f, d[1]);
      float* p = row + g;
      if (g + 1 < G && (reinterpret_cast<uintptr_t>(p) & 7) == 0) {
        __stcs(reinterpret_cast<float2*>(p), make_float2(p0, p1));
      } else {
        __stcs(p, p0);
        if (g + 1 < G) __stcs(p + 1, p1);
      }
    }
  }
}

// K3's CUDA-core form: Vt f32[B, K2, n2], At = A^T f32[n2, G].
__global__ void __launch_bounds__(FMA_GT)
music_scan_fma_kernel(const float* __restrict__ Vt,
                      const float* __restrict__ At,
                      const float* __restrict__ nrm, float* __restrict__ P,
                      int B, int K2, int n2, int G) {
  extern __shared__ float fma_smem[];
  float* at_s = fma_smem;                   // [n2, FMA_GT]
  float* v_s = fma_smem + n2 * FMA_GT;      // [FMA_BT, K2, n2]
  const int tid = threadIdx.x;
  const int g0 = blockIdx.x * FMA_GT;
  const int b0 = blockIdx.y * FMA_BT;
  for (int idx = tid; idx < n2 * FMA_GT; idx += FMA_GT) {
    const int n = idx / FMA_GT, gl = idx % FMA_GT;
    at_s[idx] = (g0 + gl < G) ? At[(size_t)n * G + g0 + gl] : 0.f;
  }
  const int per_w = K2 * n2;
  const int nb = min(FMA_BT, B - b0);
  for (int idx = tid; idx < nb * per_w; idx += FMA_GT)
    v_s[idx] = Vt[(size_t)b0 * per_w + idx];
  __syncthreads();
  const int g = g0 + tid;
  if (g >= G) return;
  const float nr = nrm[g];
  for (int bl = 0; bl < nb; ++bl) {
    float part = 0.f;
    for (int k = 0; k < K2; ++k) {
      const float* v = v_s + (bl * K2 + k) * n2;
      float y = 0.f;
      for (int n = 0; n < n2; ++n) y += v[n] * at_s[n * FMA_GT + tid];
      part += y * y;
    }
    const float den = fmaxf(nr - part, FLT_MIN);
    P[(size_t)(b0 + bl) * G + g] = 1.0f / den;
  }
}

template <int K2>
int launch_scan(const void* Vf, const void* Af, const void* nrm, void* P,
                int B, int KP, int G, int tpg, cudaStream_t stream) {
  constexpr int GB = 2 * scan_tc::bins_of(K2);
  const int smem = scan_tc::smem_of(K2, KP);
  if (smem > scan_tc::SMEM_MAX) return (int)cudaErrorInvalidValue;
  const int nT = (B + scan_tc::WT - 1) / scan_tc::WT;
  const int groups = (nT + tpg - 1) / tpg;
  if (groups > 65535) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      music_scan_kernel<K2>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((G + GB - 1) / GB, groups);
  music_scan_kernel<K2><<<grid, scan_tc::THREADS, smem, stream>>>(
      (const float4*)Vf, (const float*)Af, (const float*)nrm, (float*)P, B,
      KP, G, tpg);
  return (int)cudaGetLastError();
}

// (value, index) pair order of one argmax round: larger value wins, the
// lower index on equal values (the reference's first-index tie-break).
__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

__device__ void block_argmax(float& v, int& i, float* red_v, int* red_i) {
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, v, off);
    const int oi = __shfl_down_sync(0xffffffffu, i, off);
    if (better(ov, oi, v, i)) { v = ov; i = oi; }
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) { red_v[warp] = v; red_i[warp] = i; }
  __syncthreads();
  if (warp == 0) {
    v = lane < PEAK_THREADS / 32 ? red_v[lane] : NEG;
    i = lane < PEAK_THREADS / 32 ? red_i[lane] : 0x7fffffff;
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_down_sync(0xffffffffu, v, off);
      const int oi = __shfl_down_sync(0xffffffffu, i, off);
      if (better(ov, oi, v, i)) { v = ov; i = oi; }
    }
    if (lane == 0) { red_v[0] = v; red_i[0] = i; }
  }
  __syncthreads();
  v = red_v[0];
  i = red_i[0];
  __syncthreads();
}

__global__ void __launch_bounds__(PEAK_THREADS)
music_scan_peaks_kernel(const float* __restrict__ Vt,
                        const float* __restrict__ At,
                        const float* __restrict__ nrm,
                        float* __restrict__ vals, float* __restrict__ locs,
                        int K2, int n2, int G, int k, float x_min, float dx,
                        int refine) {
  extern __shared__ float smem[];
  float* den = smem;                        // [G]
  float* masked = smem + G;                 // [G]
  float* v_s = smem + 2 * G;                // [K2, n2]
  __shared__ float red_v[32];
  __shared__ int red_i[32];
  const int tid = threadIdx.x;
  const int b = blockIdx.x;
  const int per_w = K2 * n2;
  for (int idx = tid; idx < per_w; idx += PEAK_THREADS)
    v_s[idx] = Vt[(size_t)b * per_w + idx];
  __syncthreads();

  // den and its minimum (= the global max of P)
  float dmin = FLT_MAX;
  for (int g = tid; g < G; g += PEAK_THREADS) {
    float part = 0.f;
    for (int kk = 0; kk < K2; ++kk) {
      const float* v = v_s + kk * n2;
      float y = 0.f;
      for (int n = 0; n < n2; ++n) y += v[n] * At[(size_t)n * G + g];
      part += y * y;
    }
    const float d = fmaxf(nrm[g] - part, FLT_MIN);
    den[g] = d;
    dmin = fminf(dmin, d);
  }
  {
    // block min via the argmax reduction on -den (index unused)
    float v = -dmin;
    int i = 0;
    block_argmax(v, i, red_v, red_i);
    dmin = -v;
  }

  // interior peaks of Pn = dmin / den, and the first index with den == dmin
  int gfirst = 0x7fffffff;
  for (int g = tid; g < G; g += PEAK_THREADS) {
    const float p = dmin / den[g];
    float m = NEG;
    if (g >= 1 && g <= G - 2) {
      const float pl = dmin / den[g - 1];
      const float pr = dmin / den[g + 1];
      if (p > pl && p >= pr) m = p;
    }
    masked[g] = m;
    if (den[g] == dmin && g < gfirst) gfirst = g;
  }
  {
    float v = 0.f;
    int i = gfirst;
    block_argmax(v, i, red_v, red_i);       // equal values: lowest index
    gfirst = i;
  }

  float pv[MAX_K];
  int pi[MAX_K];
  for (int r = 0; r < k; ++r) {
    float v = NEG;
    int i = 0x7fffffff;
    for (int g = tid; g < G; g += PEAK_THREADS)
      if (better(masked[g], g, v, i)) { v = masked[g]; i = g; }
    block_argmax(v, i, red_v, red_i);       // syncs: masked reads are done
    if (tid == 0) masked[i] = NEG;
    __syncthreads();
    pv[r] = v;
    pi[r] = i;
  }

  if (tid != 0) return;
  const bool have_any = pv[0] > 0.5f * NEG;
  const float best_v = have_any ? pv[0] : 1.0f;
  const int best_i = have_any ? pi[0] : gfirst;
  for (int r = 0; r < k; ++r) {
    const bool valid = pv[r] > 0.5f * NEG;
    const float v = valid ? pv[r] : best_v;
    const int i = valid ? pi[r] : best_i;
    float delta = 0.f;
    if (refine && i > 0 && i < G - 1) {
      const float q0 = den[i], qm = den[i - 1], qp = den[i + 1];
      const float dd = __fadd_rn(__fsub_rn(qm, 2.0f * q0), qp);
      float d = fabsf(dd) > 0.f ? __fdiv_rn(0.5f * __fsub_rn(qm, qp), dd)
                                : 0.f;
      delta = fminf(fmaxf(d, -0.5f), 0.5f);
    }
    const float frac = __fadd_rn((float)i, delta);
    vals[(size_t)b * k + r] = v;
    locs[(size_t)b * k + r] = __fadd_rn(x_min, __fmul_rn(frac, dx));
  }
}

int set_smem(const void* fn, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace

// K3. Vf: V' (scan_tc.cuh) of the B windows, f32[ceil(B/32), KP/8,
// 2K/2, 4, 32, 4]; Af: A' f32[ceil(G/GB), 2, KP/4, GB/8, 8, 4] with GB =
// 2 NT; nrm f32[G] -> P f32[B, G]. 2K in {2, 4, 6, 8}, NT the bins a
// warpgroup (64 at 2K <= 4, else 32: the caller's layout must agree), KP
// a multiple of 16; each block walks tpg window tiles.
extern "C" int doa_music_scan(const void* Vf, const void* Af, const void* nrm,
                              void* P, int B, int K2, int NT, int KP, int G,
                              int tpg, void* stream) {
  if (B < 1 || G < 1 || KP < 16 || KP % 16 != 0 || tpg < 1 || K2 < 2 ||
      K2 > 8 || K2 % 2 != 0 || NT != scan_tc::bins_of(K2))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  auto run = [&](auto k2) {
    return launch_scan<decltype(k2)::value>(Vf, Af, nrm, P, B, KP, G, tpg,
                                            s);
  };
  switch (K2) {
    case 2: return run(std::integral_constant<int, 2>());
    case 4: return run(std::integral_constant<int, 4>());
    case 6: return run(std::integral_constant<int, 6>());
    default: return run(std::integral_constant<int, 8>());
  }
}

// K3's CUDA-core form. Vt f32[B, K2, n2], At = A^T f32[n2, G], nrm f32[G]
// -> P f32[B, G].
extern "C" int doa_music_scan_fma(const void* Vt, const void* At,
                                  const void* nrm, void* P, int B, int K2,
                                  int n2, int G, void* stream) {
  if (B < 1 || G < 1 || K2 < 1 || n2 < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * ((size_t)n2 * FMA_GT +
                                       (size_t)FMA_BT * K2 * n2);
  int err = set_smem((const void*)music_scan_fma_kernel, smem);
  if (err) return err;
  dim3 grid((G + FMA_GT - 1) / FMA_GT, (B + FMA_BT - 1) / FMA_BT);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  music_scan_fma_kernel<<<grid, FMA_GT, smem, (cudaStream_t)stream>>>(
      (const float*)Vt, (const float*)At, (const float*)nrm, (float*)P, B,
      K2, n2, G);
  return (int)cudaGetLastError();
}

// -> vals f32[B, k], locs f32[B, k] (degrees: x_min + (idx + delta) * dx).
extern "C" int doa_music_scan_peaks(const void* Vt, const void* At,
                                    const void* nrm, void* vals, void* locs,
                                    int B, int K2, int n2, int G, int k,
                                    float x_min, float dx, int refine,
                                    void* stream) {
  if (B < 1 || G < 3 || K2 < 1 || n2 < 1 || k < 1 || k > MAX_K)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (2 * (size_t)G + K2 * n2);
  int err = set_smem((const void*)music_scan_peaks_kernel, smem);
  if (err) return err;
  music_scan_peaks_kernel<<<B, PEAK_THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)Vt, (const float*)At, (const float*)nrm, (float*)vals,
      (float*)locs, K2, n2, G, k, x_min, dx, refine);
  return (int)cudaGetLastError();
}
