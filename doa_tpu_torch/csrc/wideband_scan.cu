// Fused wideband subband scan + incoherent fusion.
//
// Replaces the Pallas kernel doa_tpu/ops/pallas/wideband_scan.py
// `_fusion_kernel`. For F subbands, windows b and grid bins g:
//
//   den_f[b, g] = max(nrm_f[g] - sum_k (Vt_fb[k] . a_fg)^2, FLT_MIN)
//   dmin_f[b]   = min_g den_f[b, g]                     (pass 0)
//   P[b, g]     = (1/F) sum_f dmin_f[b] / den_f[b, g]   (pass 1)
//
// Two launches of one kernel; den never reaches device memory. Pass 0
// min-accumulates each block's partial minimum into dmin with an atomic
// min on the float's bits, which orders like the floats because den > 0
// (dmin starts at +inf). Pass 1 recomputes den and writes P once. Bins
// and windows past the edge are masked, never padded: no padded value can
// reach dmin or P.
//
// The TPU kernel runs each den product as a 3-pass bf16 hi/lo split on
// the MXU; here every product is a true FP32 FMA (den cancels at the
// MUSIC nulls, so no TF32 or bf16).
//
// What bounds it at c5 (F = 16, B = 2048, K2 = 4, n2 = 128, G = 16471):
// 2.8e11 FMAs a pass, 5.5e11 in all: 16.5 ms at 67 TFLOP/s FP32. Design:
// per subband the y products are a (B*K2 x n2) . (n2 x G) matrix product,
// register-tiled: a block covers WB = 32 windows x GB = 128 bins, each
// thread RW = 2 windows x RG = 8 bins x K2 rows of y (64 accumulators at
// K2 = 4). A^T and Vt pass through shared memory KC = 16 rows of n2 at a
// time, double-buffered: the next step's tile is loaded into registers
// while the current one is multiplied, so one barrier a step and no wait
// on device memory. A warp spans 4 window groups x 8 bin groups, so per
// row of n2 it reads 128 B of bins and 128 B of Vt (one shared-memory
// wavefront each, float4 loads) for 64 FMAs a lane; staged Vt rows are
// padded so the transposing stores conflict at most 2-way. (Measured at
// c5 on an H100 SXM at 700 W: the first form, single-buffered, 90.9 ms;
// double-buffered with a warp across all 256 bins of a block, reading
// 512 B of bins a row and storing Vt with 16-way conflicts, 44.0 ms; this
// form 39.3 ms, 42 % of the FP32 peak. The plain version, which computes
// den once and writes it to device memory, 33.9 ms.) The per-window min
// reduces across the 8 lanes of a window group with shuffles. Blocks of
// consecutive windows run together over one stretch of bins, so A^T
// (135 MB at c5) is read from L2, not HBM, by all but the first of them.

#include <cuda_runtime.h>
#include <float.h>

namespace {

constexpr int THREADS = 256;     // 8 warps
constexpr int RW = 2;            // windows per thread
constexpr int RG = 8;            // bins per thread: 4 at 4*bg, 4 at 64+4*bg
constexpr int WB = 16 * RW;      // 32 windows per block (16 window groups)
constexpr int GB = 16 * 8;       // 128 bins per block (16 bin groups)
constexpr int KC = 16;           // rows of n2 staged per step
constexpr int VPAD = 4;          // staged Vt row padding: 2-way stores

template <int K2>
constexpr size_t smem_bytes() {               // [2][KC][GB] + [2][KC][VWP]
  return sizeof(float) * 2 * KC * (GB + WB * K2 + VPAD);
}

template <int K2>
__global__ void __launch_bounds__(THREADS)
fusion_kernel(const float* __restrict__ Vt, const float* __restrict__ AtT,
              const float* __restrict__ nrm, float* __restrict__ dmin,
              float* __restrict__ P, int F, int B, int n2, int G,
              int pass) {
  constexpr int VW = WB * K2;                      // staged Vt rows
  constexpr int VWP = VW + VPAD;
  constexpr int A_PER = KC * GB / THREADS;         // staged values a thread
  constexpr int V_PER = KC * VW / THREADS;
  static_assert(KC * GB % THREADS == 0 && KC * VW % THREADS == 0, "");
  extern __shared__ __align__(16) float smem[];
  float* a_s = smem;                               // [2][KC][GB]
  float* v_s = smem + 2 * KC * GB;                 // [2][KC][VWP]
  // lane = 8 * (window group in the warp) + (bin group in the warp);
  // warps: 4 along windows x 2 along bins
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = (warp >> 1) * 4 + (lane >> 3);    // 0..15
  const int bg = (warp & 1) * 8 + (lane & 7);      // 0..15
  const int b0 = blockIdx.x * WB;
  const int g0 = blockIdx.y * GB;
  int gq[RG];                     // the thread's bins
#pragma unroll
  for (int q = 0; q < RG; ++q)
    gq[q] = g0 + (q < 4 ? 4 * bg + q : 64 + 4 * bg + q - 4);
  float acc[RW][RG];              // pass 1: sum_f dmin_f / den_f
#pragma unroll
  for (int r = 0; r < RW; ++r)
#pragma unroll
    for (int q = 0; q < RG; ++q) acc[r][q] = 0.f;

  // the steps (f, n0) run as one sequence; step s + 1 is loaded into
  // registers while step s is computed from the other shared buffer
  const int ns = (n2 + KC - 1) / KC;
  float ra[A_PER], rv[V_PER];
  auto load = [&](int s) {
    const int f = s / ns, n0 = (s % ns) * KC;
    const float* At_f = AtT + (size_t)f * n2 * G;
#pragma unroll
    for (int i = 0; i < A_PER; ++i) {
      const int idx = tid + THREADS * i;
      const int n = n0 + idx / GB, g = g0 + idx % GB;
      ra[i] = (g < G && n < n2) ? At_f[(size_t)n * G + g] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < V_PER; ++i) {
      const int idx = tid + THREADS * i;
      const int kc = idx % KC, wk = idx / KC;
      const int b = b0 + wk / K2, n = n0 + kc;
      rv[i] = (b < B && n < n2)
          ? Vt[(((size_t)f * B + b) * K2 + wk % K2) * n2 + n] : 0.f;
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int i = 0; i < A_PER; ++i)
      a_s[buf * KC * GB + tid + THREADS * i] = ra[i];
#pragma unroll
    for (int i = 0; i < V_PER; ++i) {
      const int idx = tid + THREADS * i;
      v_s[(buf * KC + idx % KC) * VWP + idx / KC] = rv[i];
    }
  };

  float y[RW][K2][RG];
#pragma unroll
  for (int r = 0; r < RW; ++r)
#pragma unroll
    for (int k = 0; k < K2; ++k)
#pragma unroll
      for (int q = 0; q < RG; ++q) y[r][k][q] = 0.f;
  const int steps = F * ns;
  load(0);
  store(0);
  __syncthreads();
  for (int s = 0; s < steps; ++s) {
    const int buf = s & 1;
    if (s + 1 < steps) load(s + 1);
#pragma unroll 4
    for (int kc = 0; kc < KC; ++kc) {
      const float* ar = a_s + (buf * KC + kc) * GB;
      const float4 lo = *reinterpret_cast<const float4*>(ar + 4 * bg);
      const float4 hi = *reinterpret_cast<const float4*>(ar + 64 + 4 * bg);
      const float a[RG] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
      const float* vr = v_s + (buf * KC + kc) * VWP + wg * RW * K2;
      float v[RW * K2];
#pragma unroll
      for (int i = 0; i < RW * K2 / 4; ++i) {
        const float4 t = *reinterpret_cast<const float4*>(vr + 4 * i);
        v[4 * i] = t.x; v[4 * i + 1] = t.y;
        v[4 * i + 2] = t.z; v[4 * i + 3] = t.w;
      }
#pragma unroll
      for (int r = 0; r < RW; ++r)
#pragma unroll
        for (int k = 0; k < K2; ++k)
#pragma unroll
          for (int q = 0; q < RG; ++q) y[r][k][q] += v[r * K2 + k] * a[q];
    }
    if (s + 1 < steps) store(buf ^ 1);

    if (s % ns == ns - 1) {       // subband f complete: den of its bins
      const int f = s / ns;
      float nr[RG];
#pragma unroll
      for (int q = 0; q < RG; ++q)
        nr[q] = gq[q] < G ? nrm[(size_t)f * G + gq[q]] : 0.f;
#pragma unroll
      for (int r = 0; r < RW; ++r) {
        const int b = b0 + wg * RW + r;
        float den[RG];
#pragma unroll
        for (int q = 0; q < RG; ++q) {
          float part = 0.f;
#pragma unroll
          for (int k = 0; k < K2; ++k) {
            part = __fadd_rn(part, __fmul_rn(y[r][k][q], y[r][k][q]));
            y[r][k][q] = 0.f;
          }
          den[q] = fmaxf(__fsub_rn(nr[q], part), FLT_MIN);
        }
        if (pass == 0) {          // min over the 8 lanes of this window
          float m = FLT_MAX;
#pragma unroll
          for (int q = 0; q < RG; ++q)
            if (gq[q] < G) m = fminf(m, den[q]);
          for (int off = 4; off > 0; off >>= 1)
            m = fminf(m, __shfl_xor_sync(0xffffffffu, m, off));
          if ((lane & 7) == 0 && b < B)
            atomicMin(reinterpret_cast<int*>(dmin) + (size_t)f * B + b,
                      __float_as_int(m));
        } else if (b < B) {
          const float dm = dmin[(size_t)f * B + b];
#pragma unroll
          for (int q = 0; q < RG; ++q) acc[r][q] += dm / den[q];
        }
      }
    }
    __syncthreads();
  }
  if (pass == 0) return;
  const float inv_f = 1.0f / (float)F;
#pragma unroll
  for (int r = 0; r < RW; ++r) {
    const int b = b0 + wg * RW + r;
    if (b >= B) continue;
#pragma unroll
    for (int q = 0; q < RG; ++q)
      if (gq[q] < G) P[(size_t)b * G + gq[q]] = acc[r][q] * inv_f;
  }
}

template <int K2>
int launch(const void* Vt, const void* AtT, const void* nrm, void* dmin,
           void* P, int F, int B, int n2, int G, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<K2>();
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fusion_kernel<K2>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((B + WB - 1) / WB, (G + GB - 1) / GB);
  for (int pass = 0; pass < 2; ++pass) {
    fusion_kernel<K2><<<grid, THREADS, smem, stream>>>(
        (const float*)Vt, (const float*)AtT, (const float*)nrm,
        (float*)dmin, (float*)P, F, B, n2, G, pass);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

}  // namespace

// Vt f32[F, B, K2, n2] (rows orthonormal), AtT f32[F, n2, G] (the embedded
// per-subband steering, transposed), nrm f32[F, G]; dmin f32[F, B] filled
// with +inf by the caller → dmin, P f32[B, G]. K2 in {2, 4, 6, 8}.
extern "C" int doa_wideband_fusion(const void* Vt, const void* AtT,
                                   const void* nrm, void* dmin, void* P,
                                   int F, int B, int K2, int n2, int G,
                                   void* stream) {
  if (F < 1 || B < 1 || n2 < 1 || G < 1 || (G + GB - 1) / GB > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (K2) {
    case 2: return launch<2>(Vt, AtT, nrm, dmin, P, F, B, n2, G, s);
    case 4: return launch<4>(Vt, AtT, nrm, dmin, P, F, B, n2, G, s);
    case 6: return launch<6>(Vt, AtT, nrm, dmin, P, F, B, n2, G, s);
    case 8: return launch<8>(Vt, AtT, nrm, dmin, P, F, B, n2, G, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
