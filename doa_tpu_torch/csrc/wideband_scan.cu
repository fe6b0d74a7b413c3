// Fused wideband subband scan + incoherent fusion, on the tensor cores.
//
// Replaces the Pallas kernel doa_tpu/ops/pallas/wideband_scan.py:51
// `_fusion_kernel`. For F subbands, windows b and grid bins g:
//
//   den_f[b, g] = max(nrm_f[g] - sum_k (Vt_fb[k] . a_fg)^2, FLT_MIN)
//   dmin_f[b]   = min_g den_f[b, g]
//   P[b, g]     = (1/F) sum_f dmin_f[b] / den_f[b, g]
//
// Two kernels, each den computed once. Pass A (`doa_fusion_den`,
// `den_kernel`) runs the products on the tensor cores, writes den to a
// workspace den f32[F, nb, Gs] (Gs = G rounded up to 4) and
// min-accumulates dmin with an atomic min on the float's bits (den > 0,
// so the bits order like the floats; dmin starts at +inf). Pass B
// (`doa_fusion_sum`, `sum_kernel`) streams the workspace once: P = (1/F)
// sum_f dmin_f / den_f in the order f = 0..F-1 with IEEE division, each P
// written once. The TPU kernel keeps den in VMEM and computes it twice, a
// pass for dmin and a pass for P; here den costs 8 bytes of HBM traffic
// instead of a second product. Bins past G and windows past nb are masked,
// never padded into dmin, den or P.
//
// Pass A's mainloop is the shared tensor-core scan of scan_tc.cuh (its
// note gives the 3xTF32 split, the two accumulator sets and the A' and V'
// layouts; K3 in music_scan.cu runs the same pieces with another walk and
// epilogue). Here A' holds the F subbands' stacks one after the other and
// V' the F subbands' tiles; a block of pass A holds one stretch of one
// subband and walks every window tile of the launch. Blocks run subband
// by subband (blockIdx.x is the stretch), so A' is read from HBM once and
// one subband's V' (4 MiB at c5), read by each of its blocks, is loaded
// under an L2 evict-last policy and the workspace is stored evict-first:
// without them the 2.16 GB of den stores pushed V' out of L2 and pass A
// lost 1.45 ms to its loads (H100 80GB HBM3, 700 W; PERF.md).
//
// What bounds it at c5 (F = 16, B = 2048, 2K = 4, 2N = 128, G = 16471):
// 3 x 2 x F x B x 2K x 2N x G = 1.66e12 TF32 operations, 3.36 ms at the
// card's dense 495 TFLOP/s (one FP32 pass, the plain version's
// arithmetic: 8.35 ms at 67 TFLOP/s); the workspace (2.16 GB) is written
// and read back, 1.3 ms at 3.35 TB/s. What holds it back, measured at c5
// on an H100 80GB HBM3 at 700 W (exp_wideband_scan.py times copies of
// this file with parts cut out; PERF.md): pass A takes 5.7 ms, its
// products alone 4.6 (72% of the TF32 rate: 8 warps an SM, as the two
// accumulator sets and the fragments take ~210 registers a thread), the
// V' loads 0.7 more and the den stores 0.4 (bulk copies from shared
// memory instead cost more); pass B, 0.8 ms, streams at HBM rate.

#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

#include <type_traits>

#include "scan_tc.cuh"

namespace {

using namespace scan_tc;

constexpr int SUM_THREADS = 256;    // pass B: 4 bins a thread

// Pass A. Grid (stretches of GB bins, F); see scan_tc.cuh for the layouts.
// A block stages one stretch of one subband and walks every window tile
// of the launch; its epilogue writes den to the window's workspace row
// (evict first) and min-accumulates each window's den over the block's
// bins into dmin.
template <int K2>
__global__ void __launch_bounds__(THREADS, 1)
den_kernel(const float4* __restrict__ Vf, const float* __restrict__ Af,
           const float* __restrict__ nrm, float* __restrict__ den,
           float* __restrict__ dmin, int B, int b0, int nb, int KP, int G,
           int Gs) {
  constexpr int MT = K2 / 2, NT = bins_of(K2), GB = 2 * NT, NA = NT / 2;
  extern __shared__ __align__(1024) unsigned char smem[];
  float* nrm_s = reinterpret_cast<float*>(smem + 16);
  const int f = blockIdx.y, g0 = blockIdx.x * GB;
  const uint32_t lbo = GB / 8 * 128;               // bytes a k-column
  const uint32_t tile_bytes = 8u * KP * GB;        // both planes
  const uint32_t bar = smem_addr(smem), tile = smem_addr(smem + TILE_OFF);
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" :: "r"(bar)
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 :: "r"(bar), "r"(tile_bytes) : "memory");
    const float* src =
        Af + ((size_t)f * gridDim.x + blockIdx.x) * (tile_bytes / 4);
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1], %2, [%3];"
        :: "r"(tile), "l"(src), "r"(tile_bytes), "r"(bar) : "memory");
  }
  for (int i = threadIdx.x; i < GB; i += THREADS)
    nrm_s[i] = g0 + i < G ? nrm[(size_t)f * G + g0 + i] : 0.f;
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
  const int nT = (B + WT - 1) / WT;                // V' tiles a subband
  // V' is read by every block of its subband: keep it in L2 past the
  // workspace stores (evict first) and the A' stretches
  const uint64_t v_pol = l2_evict_last();
  for (int T = b0 / WT; T * WT < b0 + nb; ++T) {
    const float4* vp = Vf + ((size_t)f * nT + T) * S * MT * 128 + t;
    float hh[MT][NA], cr[MT][NA];
    tile_products<K2>(vp, S, v_pol, d0, d_step, d_plane, hh, cr);

    // den of window b at the thread's NT/4 bins: 8j + 2tq + c
    const int b = T * WT + 8 * warp + (lane >> 2);
    const bool b_ok = b < b0 + nb;
    float* row = den + ((size_t)f * nb + (b - b0)) * Gs;
    float m = FLT_MAX;
#pragma unroll
    for (int j = 0; j < NT / 8; ++j) {
      float d[2];
      den_pair<K2>(hh, cr, nr, j, tq, d);
      const int g = gw + 8 * j + 2 * tq;
      if (g < G) {
        m = fminf(m, d[0]);
        if (g + 1 < G) m = fminf(m, d[1]);
        if (b_ok)
          __stcs(reinterpret_cast<float2*>(row + g), make_float2(d[0], d[1]));
      }
    }
    m = fminf(m, __shfl_xor_sync(0xffffffffu, m, 1));
    m = fminf(m, __shfl_xor_sync(0xffffffffu, m, 2));
    if (tq == 0 && b_ok && gw < G)
      atomicMin(reinterpret_cast<int*>(dmin) + (size_t)f * B + b,
                __float_as_int(m));
  }
}

// Pass B. Grid (nb windows, bins / (4 SUM_THREADS)).
__global__ void __launch_bounds__(SUM_THREADS)
sum_kernel(const float* __restrict__ den, const float* __restrict__ dmin,
           float* __restrict__ P, int F, int B, int b0, int nb, int G,
           int Gs) {
  const int b = blockIdx.x;
  const int g = 4 * (blockIdx.y * SUM_THREADS + threadIdx.x);
  if (g >= G) return;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int f = 0; f < F; ++f) {
    const float dm = __ldg(dmin + (size_t)f * B + b0 + b);
    const float4 d = __ldcs(reinterpret_cast<const float4*>(
        den + ((size_t)f * nb + b) * Gs + g));
    acc[0] = __fadd_rn(acc[0], __fdiv_rn(dm, d.x));
    acc[1] = __fadd_rn(acc[1], __fdiv_rn(dm, d.y));
    acc[2] = __fadd_rn(acc[2], __fdiv_rn(dm, d.z));
    acc[3] = __fadd_rn(acc[3], __fdiv_rn(dm, d.w));
  }
  const float inv_f = 1.0f / (float)F;
  float* out = P + (size_t)(b0 + b) * G;
#pragma unroll
  for (int q = 0; q < 4; ++q)
    if (g + q < G) out[g + q] = __fmul_rn(acc[q], inv_f);
}

template <int K2>
int launch_den(const void* Vf, const void* Af, const void* nrm, void* den,
               void* dmin, int F, int B, int b0, int nb, int KP, int G,
               int Gs, cudaStream_t stream) {
  constexpr int GB = 2 * bins_of(K2);
  const int smem = smem_of(K2, KP);
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      den_kernel<K2>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((G + GB - 1) / GB, F);
  den_kernel<K2><<<grid, THREADS, smem, stream>>>(
      (const float4*)Vf, (const float*)Af, (const float*)nrm, (float*)den,
      (float*)dmin, B, b0, nb, KP, G, Gs);
  return (int)cudaGetLastError();
}

}  // namespace

// Pass A on windows [b0, b0 + nb) of B. Vf: V' (scan_tc.cuh) of all B
// windows, f32[F, ceil(B/32), KP/8, 2K/2, 4, 32, 4]; Af: A' f32[F,
// ceil(G/GB), 2, KP/4, GB/8, 8, 4] with GB = 2 NT; nrm f32[F, G]; den
// f32[F, nb, Gs] (written at every bin below G); dmin f32[F, B] filled
// with +inf by the caller (min-accumulated). 2K in {2, 4, 6, 8}, NT the
// bins a warpgroup (64 at 2K <= 4, else 32: the caller's layout must
// agree), KP a multiple of 16, b0 a multiple of 32, Gs >= G a multiple of 4.
extern "C" int doa_fusion_den(const void* Vf, const void* Af,
                              const void* nrm, void* den, void* dmin, int F,
                              int B, int b0, int nb, int K2, int NT, int KP,
                              int G, int Gs, void* stream) {
  if (F < 1 || F > 65535 || B < 1 || nb < 1 || b0 < 0 || b0 % WT != 0 ||
      b0 + nb > B || KP < 16 || KP % 16 != 0 || G < 1 || Gs < G ||
      Gs % 4 != 0 || K2 < 2 || K2 > 8 || K2 % 2 != 0 || NT != bins_of(K2))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  auto run = [&](auto k2) {
    return launch_den<decltype(k2)::value>(Vf, Af, nrm, den, dmin, F, B, b0,
                                           nb, KP, G, Gs, s);
  };
  switch (K2) {
    case 2: return run(std::integral_constant<int, 2>());
    case 4: return run(std::integral_constant<int, 4>());
    case 6: return run(std::integral_constant<int, 6>());
    default: return run(std::integral_constant<int, 8>());
  }
}

// Pass B: P[b0 + b, g] for b < nb, g < G from den f32[F, nb, Gs] and dmin
// f32[F, B]; P f32[B, G].
extern "C" int doa_fusion_sum(const void* den, const void* dmin, void* P,
                              int F, int B, int b0, int nb, int G, int Gs,
                              void* stream) {
  const int gy = (G + 4 * SUM_THREADS - 1) / (4 * SUM_THREADS);
  if (F < 1 || B < 1 || nb < 1 || b0 < 0 || b0 + nb > B || G < 1 ||
      Gs < G || Gs % 4 != 0 || gy > 65535)
    return (int)cudaErrorInvalidValue;
  sum_kernel<<<dim3(nb, gy), SUM_THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)den, (const float*)dmin, (float*)P, F, B, b0, nb, G, Gs);
  return (int)cudaGetLastError();
}
