// 2-D peak extraction over az/el pseudospectra.
//
// Replaces the Pallas kernel doa_tpu/ops/pallas/peaks2d.py `_peaks2d_kernel`
// and reproduces doa_tpu/ops/peaks.py::find_local_max_2d (the port's
// ops/peaks.py::find_local_max_2d) bit for bit. P f32[B, Ga*Ge] is the
// row-major flattened (az, el) spectrum of each window:
//
//   * a bin is a peak iff it is interior on both axes, strictly above its
//     up (az - 1) and left (el - 1) neighbours and at least its down and
//     right ones;
//   * the k best peaks by value, the first flat index on equal values;
//   * fewer than k peaks pad with the best one; none fall back to the
//     global argmax (first index);
//   * refine: separable 3-point parabolas in reciprocal space, q = 1/P,
//     along the az column and the el row through the peak, clipped to
//     +-0.5 bin, interior peaks only; angles lo + (index + delta) * step.
//
// What bounds it at c5 (B = 2048, G = 181 * 91 = 16471): reading P once,
// 135 MB (0.04 ms at 3.35 TB/s). Design: one block per window; each thread
// walks its stride of bins (neighbours come from L1), keeps the global
// argmax and a sorted top-k of its own peaks in registers; k rounds of a
// block (value, index) reduction merge the threads' lists, the owner of
// each winner popping it. Thread 0 then pads and refines, with IEEE
// division and explicitly rounded adds and multiplies, so nvcc contracts
// nothing the reference rounds twice.

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>

namespace {

constexpr int THREADS = 512;
constexpr int MAX_K = 4;
constexpr int BIG = 0x7fffffff;

// larger value first, then the lower index
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
    v = lane < THREADS / 32 ? red_v[lane] : -INFINITY;
    i = lane < THREADS / 32 ? red_i[lane] : BIG;
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

__device__ __forceinline__ float recip(float v) {
  return __fdiv_rn(1.0f, fmaxf(v, FLT_MIN));
}

// index + sub-bin offset of the parabola through q = 1/P at the bins
// before and after (clamped to the axis), 0 offset at the axis ends
__device__ float refine_frac(const float* row, int at, int pos, int len,
                             int step) {
  const int pm = pos > 0 ? pos - 1 : 0;
  const int pp = pos < len - 1 ? pos + 1 : len - 1;
  const float qm = recip(row[at + (pm - pos) * step]);
  const float q0 = recip(row[at]);
  const float qp = recip(row[at + (pp - pos) * step]);
  const float dd = __fadd_rn(__fsub_rn(qm, __fmul_rn(2.0f, q0)), qp);
  float d = fabsf(dd) > 0.f
      ? __fdiv_rn(__fmul_rn(0.5f, __fsub_rn(qm, qp)), dd) : 0.f;
  d = fminf(fmaxf(d, -0.5f), 0.5f);
  return __fadd_rn((float)pos, (pos > 0 && pos < len - 1) ? d : 0.f);
}

__global__ void __launch_bounds__(THREADS)
peaks2d_kernel(const float* __restrict__ P, float* __restrict__ vals,
               float* __restrict__ az, float* __restrict__ el, int Ga,
               int Ge, int k, float az0, float daz, float el0, float del,
               int refine) {
  __shared__ float red_v[32];
  __shared__ int red_i[32];
  const int tid = threadIdx.x;
  const int b = blockIdx.x;
  const int G = Ga * Ge;
  const float* row = P + (size_t)b * G;

  float tv[MAX_K];
  int ti[MAX_K];
#pragma unroll
  for (int q = 0; q < MAX_K; ++q) { tv[q] = -INFINITY; ti[q] = BIG; }
  float gv = -INFINITY;
  int gi = BIG;
  for (int g = tid; g < G; g += THREADS) {
    const float p = row[g];
    if (better(p, g, gv, gi)) { gv = p; gi = g; }
    const int ia = g / Ge, ie = g - ia * Ge;
    if (ia < 1 || ia > Ga - 2 || ie < 1 || ie > Ge - 2) continue;
    if (!(p > row[g - Ge] && p >= row[g + Ge] && p > row[g - 1] &&
          p >= row[g + 1]))
      continue;
    float cv = p;                 // insert into the sorted top-k
    int cidx = g;
#pragma unroll
    for (int q = 0; q < MAX_K; ++q) {
      if (q < k && better(cv, cidx, tv[q], ti[q])) {
        const float sv = tv[q];
        const int si = ti[q];
        tv[q] = cv; ti[q] = cidx;
        cv = sv; cidx = si;
      }
    }
  }
  block_argmax(gv, gi, red_v, red_i);

  float pv[MAX_K];
  int pi[MAX_K];
  int head = 0;                   // this thread's first unmerged entry
  for (int r = 0; r < k; ++r) {
    float v = -INFINITY;
    int i = BIG;
#pragma unroll
    for (int q = 0; q < MAX_K; ++q)
      if (q == head) { v = tv[q]; i = ti[q]; }
    const int mine = i;
    block_argmax(v, i, red_v, red_i);
    if (mine == i && i != BIG) ++head;
    pv[r] = v;
    pi[r] = i;
  }

  if (tid != 0) return;
  const bool have_any = isfinite(pv[0]);
  const float best_v = have_any ? pv[0] : gv;
  const int best_i = have_any ? pi[0] : gi;
  for (int r = 0; r < k; ++r) {
    const bool valid = isfinite(pv[r]);
    const float v = valid ? pv[r] : best_v;
    const int i = valid ? pi[r] : best_i;
    const int ia = i / Ge, ie = i - ia * Ge;
    float fa = (float)ia, fe = (float)ie;
    if (refine) {
      fa = refine_frac(row, i, ia, Ga, Ge);
      fe = refine_frac(row, i, ie, Ge, 1);
    }
    vals[(size_t)b * k + r] = v;
    az[(size_t)b * k + r] = __fadd_rn(az0, __fmul_rn(fa, daz));
    el[(size_t)b * k + r] = __fadd_rn(el0, __fmul_rn(fe, del));
  }
}

}  // namespace

// P f32[B, Ga*Ge] → vals, az, el f32[B, k] (degrees), k <= 4.
extern "C" int doa_peaks2d(const void* P, void* vals, void* az, void* el,
                           int B, int Ga, int Ge, int k, float az0,
                           float daz, float el0, float del, int refine,
                           void* stream) {
  if (B < 1 || Ga < 2 || Ge < 2 || k < 1 || k > MAX_K ||
      (long long)Ga * Ge > 0x7fffffffLL - THREADS)
    return (int)cudaErrorInvalidValue;
  peaks2d_kernel<<<B, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)P, (float*)vals, (float*)az, (float*)el, Ga, Ge, k, az0,
      daz, el0, del, refine);
  return (int)cudaGetLastError();
}
