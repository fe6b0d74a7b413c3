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
// K2 runs on the same mainloop (`music_scan_peaks_tc_kernel`): a
// persistent grid of one block an SM walks window tiles of 32; for each
// tile the block walks every stretch of the grid in order, each stretch
// one bulk copy of A' into a two-stretch ring (issued two stretches
// ahead, so a tile's last stretches bring the next tile's first ones in
// under its peak phase), and writes den of the tile's 32 windows x G bins
// into shared memory, never to device memory: rows of nJ GB + DEN_PAD
// floats (a stride of 8 mod 32 banks, so the float2 stores of a warp's 8
// windows fall in different banks), 128 KiB at G = 1024. The tile's V'
// is staged in shared memory by the kernel from Vt read in place (4-byte
// cp.async under the last tile's peak phase; no layout copy on the host):
// with the ring (2 x 32 KiB at the headline) and nrm ~214 KiB, one block
// an SM as K3. Each thread keeps the least den of its bins and its first
// index on the way; after the tile's last stretch each warp takes 4 of
// its windows and runs the peak rule of doa_tpu/ops/peaks.py::
// find_local_max on their rows, with no block-wide barrier:
//   Pn = dmin / den (IEEE division; P/max P = dmin/den); peaks are
//   interior bins with Pn > left and Pn >= right; k rounds of argmax with
//   the lowest index on ties; missing peaks pad with the best peak, a row
//   without peaks falls back to the first index of dmin with value exactly
//   1; the sub-bin refine is the reciprocal-space parabola on raw den,
//   clipped to +-0.5, 0 at the edges.
// A lane takes 4 consecutive bins of each of the 4 rows a step, marks the
// bins that an exact test in den cannot rule out (the local minima of
// den), then divides at its marked bins, all lanes at once (warp_peaks),
// and keeps each row's best MAX_K peaks in registers; a round is one warp
// (value, index) merge of the lanes' heads. Bound at the headline: the
// three TF32 products, 1.29e10 operations, 0.026 ms at 495 TFLOP/s
// (0.067 ms at the FP32 rate); the bytes, 8.4 MB, 0.0025 ms. On an H100
// the kernel takes ~0.14 ms there: the products ~0.04, den's epilogue
// ~0.05 and the peak phase ~0.04 (PERF.md), one after another with one
// block an SM. V' from shared memory is read in its own k-step and its
// split held ahead of the wgmma fence (scan_tc.cuh): else ptxas waited on
// every wgmma.
//
// K2's CUDA-core form `music_scan_peaks_kernel` (its first form) takes
// the shapes the tensor-core form does not (2K of 10 to 16, a den tile
// past shared memory: G > 1024 at 2K = 4, 2N = 32): one block per
// window, FP32 FMAs reading A^T from L2, den and the masked row in shared
// memory (G <= 8192), the peak rule as block reductions.
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
constexpr int DEN_PAD = 8;        // K2's den rows: nJ GB + 8 floats
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

// K2's tensor-core form, the bytes of its dynamic shared memory at 2K =
// k2, contraction KP and G bins: barriers and the dmin merge (TILE_OFF),
// the ring of two A' stretches, the tile's V', nrm and the den tile of WT
// rows.
__host__ __device__ constexpr int peaks_smem_of(int k2, int KP, int G) {
  const int GB = 2 * scan_tc::bins_of(k2);
  const int Gp = (G + GB - 1) / GB * GB;          // whole stretches
  return scan_tc::TILE_OFF + 2 * 8 * KP * GB + 4 * scan_tc::WT * k2 * KP +
         4 * Gp + 4 * scan_tc::WT * (Gp + DEN_PAD);
}

// The peak rule on R den rows (stride LD in shared memory, G <= 2048 bins
// each, 16-byte aligned) by one warp, each row's dmin and gfirst (its
// first index) given: lane takes bins 4 (lane + 32m) to 4 (lane + 32m) + 3
// of every row (one float4, with the bins either side); lane R' k + r' <
// R k writes peak r' of row R' (rows from nrows on are not written).
//
// A bin is a peak when Pn = dmin / den is > its left and >= its right
// neighbour's, IEEE quotients. The quotient is monotone in den, so den[g]
// >= den[g - 1] rules a bin out exactly; and den[g] > den[g + 1] (1 +
// 2^-20) does too while the quotient is normal (den[g] <= dmin 2^100):
// the two exact quotients then differ by more than 2^-21 of themselves,
// which rounding to 24 bits cannot close. The bins left (the local minima
// of den: a few a row on a scene, more where rounding ripples a flat top)
// are marked in a bit mask a row (bit 4m + e: bin 4 (lane + 32m) + e) in
// the first pass; in the second every lane takes its own marked bins in
// order, all lanes at once, with the three divisions and the exact test.
template <int R>
__device__ __forceinline__ void warp_peaks(
    const float* den, int LD, int G, const float (&dmin)[R],
    const int (&gfirst)[R], int nrows, int k, float x_min, float dx,
    int refine, float* vals, float* locs) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  float dnormal[R];                      // quotients stay normal below
  unsigned long long cand[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    dnormal[r] = dmin[r] * 0x1p100f;
    cand[r] = 0;
  }
  for (int m = 0, g0 = 4 * lane; g0 < G; ++m, g0 += 128) {
    float d[R][6];                       // den[g0 - 1] to den[g0 + 4]
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float* row = den + r * LD + g0;
      const float4 c = *reinterpret_cast<const float4*>(row);
      d[r][0] = row[-1];
      d[r][1] = c.x;
      d[r][2] = c.y;
      d[r][3] = c.z;
      d[r][4] = c.w;
      d[r][5] = row[4];
    }
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = d[r][e + 1];
        const bool c = g0 + e >= 1 && g0 + e <= G - 2 && x < d[r][e] &&
                       !(x > d[r][e + 2] * 0x1.00001p+0f && x <= dnormal[r]);
        cand[r] |= (unsigned long long)c << (4 * m + e);
      }
  }
  // each row's best MAX_K interior peaks in the lane, best first
  float lv[R][MAX_K];
  int li[R][MAX_K];
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int s = 0; s < MAX_K; ++s) {
      lv[r][s] = NEG;
      li[r][s] = 0x7fffffff;
    }
    const float* row = den + r * LD;
    for (unsigned long long c = cand[r]; c; c &= c - 1) {
      const int bit = __ffsll(c) - 1;
      const int g = 4 * (lane + 32 * (bit >> 2)) + (bit & 3);
      const float pc = __fdiv_rn(dmin[r], row[g]);
      if (!(pc > __fdiv_rn(dmin[r], row[g - 1]) &&
            pc >= __fdiv_rn(dmin[r], row[g + 1])))
        continue;
      float cv = pc;
      int ci = g;
#pragma unroll
      for (int s = 0; s < MAX_K; ++s)
        if (better(cv, ci, lv[r][s], li[r][s])) {
          const float tv = lv[r][s];
          const int ti = li[r][s];
          lv[r][s] = cv; li[r][s] = ci; cv = tv; ci = ti;
        }
    }
  }
  // k rounds: each row's best of the lanes' heads; its lane moves its
  // list up
  float pv[R][MAX_K];
  int pi[R][MAX_K];
#pragma unroll
  for (int q = 0; q < MAX_K; ++q) {
    float v[R];
    int i[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      pv[r][q] = NEG;
      pi[r][q] = 0x7fffffff;
      v[r] = lv[r][0];
      i[r] = li[r][0];
    }
    if (q >= k) continue;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float ov = __shfl_xor_sync(full, v[r], off);
        const int oi = __shfl_xor_sync(full, i[r], off);
        if (better(ov, oi, v[r], i[r])) { v[r] = ov; i[r] = oi; }
      }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      pv[r][q] = v[r];
      pi[r][q] = i[r];
      if (li[r][0] == i[r]) {
#pragma unroll
        for (int s = 0; s + 1 < MAX_K; ++s) {
          lv[r][s] = lv[r][s + 1];
          li[r][s] = li[r][s + 1];
        }
        lv[r][MAX_K - 1] = NEG;
        li[r][MAX_K - 1] = 0x7fffffff;
      }
    }
  }
  // lane rr k + q writes peak q of row rr
  const int rr = lane / k, q = lane - rr * k;
  if (rr >= R || rr >= nrows) return;
  float p0 = NEG, pq = NEG;
  int i0 = 0, iq = 0, gf = 0;
#pragma unroll
  for (int r = 0; r < R; ++r)
    if (r == rr) {
      p0 = pv[r][0];
      i0 = pi[r][0];
      gf = gfirst[r];
#pragma unroll
      for (int s = 0; s < MAX_K; ++s)
        if (s == q) { pq = pv[r][s]; iq = pi[r][s]; }
    }
  const bool have_any = p0 > 0.5f * NEG;
  const bool valid = pq > 0.5f * NEG;
  const float v = valid ? pq : have_any ? p0 : 1.0f;
  const int i = valid ? iq : have_any ? i0 : gf;
  const float* row = den + rr * LD;
  float delta = 0.f;
  if (refine && i > 0 && i < G - 1) {
    const float q0 = row[i], qm = row[i - 1], qp = row[i + 1];
    const float dd = __fadd_rn(__fsub_rn(qm, 2.0f * q0), qp);
    float d = fabsf(dd) > 0.f ? __fdiv_rn(0.5f * __fsub_rn(qm, qp), dd)
                              : 0.f;
    delta = fminf(fmaxf(d, -0.5f), 0.5f);
  }
  const float frac = __fadd_rn((float)i, delta);
  vals[rr * k + q] = v;
  locs[rr * k + q] = __fadd_rn(x_min, __fmul_rn(frac, dx));
}

// K2's tensor-core form. Block x walks window tiles T = x, x + gridDim.x,
// ...; unit u of its walk is (its tile u / nJ, stretch u % nJ), whose A'
// stretch lands in ring slot u & 1 (mbarrier at byte 8 (u & 1), phase
// u >> 1). The tile's V' (the mainloop's A fragments, scan_tc.cuh) is
// staged in shared memory from Vt f32[B, K2, n2] read in place, zero past
// B and n2, by asynchronous copies issued once the last tile's products
// are done. Layouts as K3's otherwise; see the note at the top.
template <int K2>
__global__ void __launch_bounds__(scan_tc::THREADS, 1)
music_scan_peaks_tc_kernel(const float* __restrict__ Vt,
                           const float* __restrict__ Af,
                           const float* __restrict__ nrm,
                           float* __restrict__ vals, float* __restrict__ locs,
                           int B, int n2, int KP, int G, int k, float x_min,
                           float dx, int refine) {
  using namespace scan_tc;
  constexpr int MT = K2 / 2, NT = bins_of(K2), GB = 2 * NT, NA = NT / 2;
  constexpr int ROWS = WT / (THREADS / 32);        // a warp's windows
  extern __shared__ __align__(1024) unsigned char tc_smem[];
  const int nJ = (G + GB - 1) / GB;
  const int LD = nJ * GB + DEN_PAD;
  const uint32_t slot_bytes = 8u * KP * GB;        // a stretch, both planes
  float* red_v = reinterpret_cast<float*>(tc_smem + 16);     // [2][WT]
  int* red_i = reinterpret_cast<int*>(tc_smem + 16 + 8 * WT);
  float* v_s = reinterpret_cast<float*>(tc_smem + TILE_OFF +
                                        2 * slot_bytes);  // the tile's V'
  float* nrm_s = v_s + WT * K2 * KP;
  float* den_s = nrm_s + nJ * GB;                  // [WT][LD]
  const uint32_t bar = smem_addr(tc_smem);
  const uint32_t ring = smem_addr(tc_smem + TILE_OFF);
  const int nT = (B + WT - 1) / WT;
  const int bx = blockIdx.x, nb = gridDim.x;
  const int units = bx < nT ? ((nT - 1 - bx) / nb + 1) * nJ : 0;
  auto issue = [&](int u) {
    const uint32_t b = bar + 8 * (u & 1);
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 :: "r"(b), "r"(slot_bytes) : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1], %2, [%3];"
        :: "r"(ring + (u & 1) * slot_bytes),
           "l"(Af + (size_t)(u % nJ) * (slot_bytes / 4)), "r"(slot_bytes),
           "r"(b) : "memory");
  };
  // V' of tile T: element (window wl, k, n) of Vt to fragment
  // [n / 8][k / 2][32 (wl / 8) + 4 (wl % 8) + n % 4][k % 2 + 2 (n / 4 % 2)]
  // by 4-byte asynchronous copies (zero past B and n2), one commit group
  auto stage = [&](int T) {
    for (int e = threadIdx.x; e < WT * K2 * KP; e += THREADS) {
      const int n = e % KP, kk = e / KP % K2, wl = e / (KP * K2);
      const int b = T * WT + wl;
      const bool ok = b < B && n < n2;
      const int tt = 32 * (wl >> 3) + 4 * (wl & 7) + (n & 3);
      const float* dst = v_s + (((n >> 3) * MT + (kk >> 1)) * 128 + tt) * 4 +
                         (kk & 1) + 2 * ((n >> 2) & 1);
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;"
                   :: "r"(smem_addr(dst)),
                      "l"(Vt + (ok ? ((size_t)b * K2 + kk) * n2 + n : 0)),
                      "r"(ok ? 4 : 0) : "memory");
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < 2; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
                   :: "r"(bar + 8 * s) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int u = 0; u < 2 && u < units; ++u) issue(u);
  }
  if (units > 0) stage(bx);
  for (int i = threadIdx.x; i < nJ * GB; i += THREADS)
    nrm_s[i] = i < G ? nrm[i] : 0.f;

  const int wg = threadIdx.x >> 7, t = threadIdx.x & 127;
  const int warp = t >> 5, lane = t & 31, tq = lane & 3;
  const int wrow = 8 * warp + (lane >> 2);         // the thread's window
  const int S = KP / 8;                            // k-steps, even
  const uint32_t lbo = GB / 8 * 128;               // bytes a k-column
  const uint64_t d_step = (2 * lbo) >> 4;          // descriptor units
  const uint64_t d_plane = ((uint64_t)(KP / 4) * lbo) >> 4;
  const scan_tc::SharedV vp{reinterpret_cast<const float4*>(v_s) + t};
  float dmin = FLT_MAX;                  // the thread's least den of the
  int gmin = 0x7fffffff;                 // tile and its first bin
  for (int u = 0; u < units; ++u) {
    const int j = u % nJ;
    const int T = bx + (u / nJ) * nb;
    if (j == 0) {                        // the tile's V' has landed
      asm volatile("cp.async.wait_all;" ::: "memory");
      __syncthreads();
    }
    mbar_wait(bar + 8 * (u & 1), (u >> 1) & 1);
    const uint64_t dk = make_desc(
        ring + (u & 1) * slot_bytes + wg * (NT / 8) * 128, lbo);
    float hh[MT][NA], cr[MT][NA];
    tile_products<K2>(vp, S, 0, dk, d_step, d_plane, hh, cr);
    // both warpgroups' wgmma have read the slot (and every warp is past
    // the last tile's peak phase): refill it, two units ahead
    __syncthreads();
    if (threadIdx.x == 0 && u + 2 < units) issue(u + 2);
    // the tile's last products are done: the next tile's V' comes in
    // under this tile's peak phase
    if (j == nJ - 1 && u + 1 < units) stage(T + nb);

    // den of the thread's window at its bins 8jj + 2tq + c of the stretch
    const int g0 = j * GB + wg * NT;
    float* row = den_s + wrow * LD + g0 + 2 * tq;
#pragma unroll
    for (int jj = 0; jj < NT / 8; ++jj) {
      float d[2];
      den_pair<K2>(hh, cr, nrm_s + g0, jj, tq, d);
      *reinterpret_cast<float2*>(row + 8 * jj) = make_float2(d[0], d[1]);
      const int g = g0 + 8 * jj + 2 * tq;
#pragma unroll
      for (int c = 0; c < 2; ++c)
        if (g + c < G && d[c] < dmin) { dmin = d[c]; gmin = g + c; }
    }
    if (j < nJ - 1) continue;

    // the tile's den is whole: (dmin, its first bin) of each window over
    // its 4 lanes, then over the two warpgroups in shared memory
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, dmin, off);
      const int oi = __shfl_xor_sync(0xffffffffu, gmin, off);
      if (ov < dmin || (ov == dmin && oi < gmin)) { dmin = ov; gmin = oi; }
    }
    if (tq == 0) {
      red_v[wg * WT + wrow] = dmin;
      red_i[wg * WT + wrow] = gmin;
    }
    dmin = FLT_MAX;
    gmin = 0x7fffffff;
    __syncthreads();
    // the peak phase: warp w of the block takes windows ROWS w on
    const int r0 = ROWS * (threadIdx.x >> 5);
    const int nrows = B - (T * WT + r0);
    if (nrows <= 0) continue;
    float dm[ROWS];
    int gf[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      dm[r] = red_v[r0 + r];
      gf[r] = red_i[r0 + r];
      const float v1 = red_v[WT + r0 + r];
      const int i1 = red_i[WT + r0 + r];
      if (v1 < dm[r] || (v1 == dm[r] && i1 < gf[r])) {
        dm[r] = v1;
        gf[r] = i1;
      }
    }
    const size_t out = (size_t)(T * WT + r0) * k;
    warp_peaks<ROWS>(den_s + r0 * LD, LD, G, dm, gf, nrows, k, x_min, dx,
                     refine, vals + out, locs + out);
  }
}

template <int K2>
int launch_peaks_tc(const void* Vt, const void* Af, const void* nrm,
                    void* vals, void* locs, int B, int n2, int KP, int G,
                    int k, float x_min, float dx, int refine, int grid,
                    cudaStream_t stream) {
  const int smem = peaks_smem_of(K2, KP, G);
  if (smem > scan_tc::SMEM_MAX) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      music_scan_peaks_tc_kernel<K2>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  music_scan_peaks_tc_kernel<K2><<<grid, scan_tc::THREADS, smem, stream>>>(
      (const float*)Vt, (const float*)Af, (const float*)nrm, (float*)vals,
      (float*)locs, B, n2, KP, G, k, x_min, dx, refine);
  return (int)cudaGetLastError();
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

// K2's tensor-core form. Vt f32[B, K2, n2] (read in place); Af: A' of
// the grid (as K3's, every stretch); nrm f32[G] -> vals f32[B, k], locs
// f32[B, k] (degrees: x_min + (idx + delta) * dx). 2K in {2, 4, 6, 8}, NT
// as K3's, KP = n2 rounded up to 16; `grid` persistent blocks (at most one
// a window tile).
extern "C" int doa_music_scan_peaks_tc(const void* Vt, const void* Af,
                                       const void* nrm, void* vals,
                                       void* locs, int B, int K2, int NT,
                                       int n2, int KP, int G, int k,
                                       float x_min, float dx, int refine,
                                       int grid, void* stream) {
  if (B < 1 || G < 3 || G > 2048 || n2 < 1 || KP < n2 || KP % 16 != 0 ||
      k < 1 || k > MAX_K || grid < 1 ||
      grid > (B + scan_tc::WT - 1) / scan_tc::WT ||
      K2 < 2 || K2 > 8 || K2 % 2 != 0 || NT != scan_tc::bins_of(K2))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  auto run = [&](auto k2) {
    return launch_peaks_tc<decltype(k2)::value>(
        Vt, Af, nrm, vals, locs, B, n2, KP, G, k, x_min, dx, refine, grid,
        s);
  };
  switch (K2) {
    case 2: return run(std::integral_constant<int, 2>());
    case 4: return run(std::integral_constant<int, 4>());
    case 6: return run(std::integral_constant<int, 6>());
    default: return run(std::integral_constant<int, 8>());
  }
}

// K2's CUDA-core form. Vt f32[B, K2, n2], At = A^T f32[n2, G], nrm f32[G]
// -> vals f32[B, k], locs f32[B, k].
extern "C" int doa_music_scan_peaks_fma(const void* Vt, const void* At,
                                        const void* nrm, void* vals,
                                        void* locs, int B, int K2, int n2,
                                        int G, int k, float x_min, float dx,
                                        int refine, void* stream) {
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
