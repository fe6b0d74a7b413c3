// K3 and K2: the MUSIC subspace scan,
//   den[b, g] = nrm[g] - sum_k (Vt[b,k,:] . a_g)^2.
//
// K3 `music_scan` replaces doa_tpu/ops/pallas/music_scan.py `_scan_kernel`
// and writes P = 1 / max(den, FLT_MIN), f32[B, G].
// K2 `music_scan_peaks` replaces `_scan_peaks_kernel` in the same file: the
// spectrum stays in shared memory and only the (B, k) peak list is written.
//
// The TPU kernels pack BT windows into the 128 lanes and reduce over k
// with a 0/1 matmul; here a window's Vt [K2, n2] is read in its natural
// layout and the products are FP32 FMAs on the CUDA cores. den cancels at
// the MUSIC nulls, so no TF32 or bf16 anywhere.
//
// What bounds them on an H100 at the headline (B = 16384, K2 = 4,
// n2 = 32, G = 1024): 2.1 G FMAs, and for K3 a 64 MiB output write
// (0.02 ms at 3.35 TB/s) — both small; launch shape and shared-memory
// traffic set the time. K3: a block is GT grid bins x BT windows, with
// the tile of A^T (n2 x GT) and the BT windows' Vt staged in shared memory.
// K2: one block per window covers the whole grid: den for all G bins is
// kept in shared memory (G <= 8192), then the peak rule of
// doa_tpu/ops/peaks.py::find_local_max runs as block reductions:
//   Pn = dmin / den; peaks are interior bins with Pn > left and
//   Pn >= right; k rounds of argmax with the lowest index on ties;
//   missing peaks pad with the best peak, a row without peaks falls back
//   to the global argmax with value exactly 1; the sub-bin refine is the
//   reciprocal-space parabola on raw den, clipped to +-0.5, 0 at the
//   edges. A^T is read from L2 by every window (128 KiB at the headline).

#include <cuda_runtime.h>
#include <float.h>

namespace {

constexpr float NEG = -1e30f;     // "no peak" sentinel (_NEG)

constexpr int SCAN_GT = 128;      // K3 grid bins per block (= threads)
constexpr int SCAN_BT = 16;       // K3 windows per block
constexpr int PEAK_THREADS = 256;
constexpr int MAX_K = 4;

__global__ void __launch_bounds__(SCAN_GT)
music_scan_kernel(const float* __restrict__ Vt, const float* __restrict__ At,
                  const float* __restrict__ nrm, float* __restrict__ P,
                  int B, int K2, int n2, int G) {
  extern __shared__ float smem[];
  float* at_s = smem;                       // [n2, SCAN_GT]
  float* v_s = smem + n2 * SCAN_GT;         // [SCAN_BT, K2, n2]
  const int tid = threadIdx.x;
  const int g0 = blockIdx.x * SCAN_GT;
  const int b0 = blockIdx.y * SCAN_BT;
  for (int idx = tid; idx < n2 * SCAN_GT; idx += SCAN_GT) {
    const int n = idx / SCAN_GT, gl = idx % SCAN_GT;
    at_s[idx] = (g0 + gl < G) ? At[(size_t)n * G + g0 + gl] : 0.f;
  }
  const int per_w = K2 * n2;
  const int nb = min(SCAN_BT, B - b0);
  for (int idx = tid; idx < nb * per_w; idx += SCAN_GT)
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
      for (int n = 0; n < n2; ++n) y += v[n] * at_s[n * SCAN_GT + tid];
      part += y * y;
    }
    const float den = fmaxf(nr - part, FLT_MIN);
    P[(size_t)(b0 + bl) * G + g] = 1.0f / den;
  }
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

// Vt f32[B, K2, n2], At f32[n2, G] (A^T of the embedded steering),
// nrm f32[G] -> P f32[B, G].
extern "C" int doa_music_scan(const void* Vt, const void* At, const void* nrm,
                              void* P, int B, int K2, int n2, int G,
                              void* stream) {
  if (B < 1 || G < 1 || K2 < 1 || n2 < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (n2 * SCAN_GT + SCAN_BT * K2 * n2);
  int err = set_smem((const void*)music_scan_kernel, smem);
  if (err) return err;
  dim3 grid((G + SCAN_GT - 1) / SCAN_GT, (B + SCAN_BT - 1) / SCAN_BT);
  music_scan_kernel<<<grid, SCAN_GT, smem, (cudaStream_t)stream>>>(
      (const float*)Vt, (const float*)At, (const float*)nrm, (float*)P, B, K2,
      n2, G);
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
