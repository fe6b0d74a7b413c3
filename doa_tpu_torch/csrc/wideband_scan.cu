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
// Precision, 3xTF32: each operand x splits as hi = rna(x), lo = rna(x -
// hi), where rna keeps the top 10 mantissa bits rounding half away from
// zero (cvt.rna.tf32.f32, written on the bits so that it equals the plain
// helper `tf32_split` of ops/cuda/wideband_scan.py bit for bit; wgmma then
// reads every bit it is given), and y = hi.hi + (hi.lo + lo.hi): about
// 2^-21 of |v||a| a product is dropped. The tensor cores' FP32
// accumulation is coarser than an FMA's round-to-nearest, and what it
// loses grows with each k-step added into a large sum. On the c5 scene
// one accumulator for all three terms missed chip_smoke's 2e-4 +
// 2e-4 |P| check by 1.5x (cuBLAS TF32 products as a stand-in); hi.hi in
// one accumulator and the two correction terms in a second, added in FP32
// at the end, held it at 0.79 of the limit, with a max abs error against
// float64 (1.8e-4) close to the FP32 plain version's (1.7e-4; PERF.md).
// So each m64 tile has two accumulator sets.
//
// Layouts, both built by the wrapper:
// - The steering stack A' (once per stack): per subband and stretch of GB
//   = 2 NT bins, [plane hi, lo][KP/4 k-columns][GB/8 row groups][8 rows]
//   [4] floats, KP = 2N rounded up to 16. Each 8 x 4 core matrix of
//   wgmma's K-major layout without swizzle is 128 contiguous bytes (no bank
//   conflict), so one bulk copy lands a stretch in shared memory as the
//   descriptors read it: LBO = GB/8 * 128 bytes from one k-column to the
//   next, SBO = 128 bytes from one row group to the next. Bins past G and
//   columns past 2N are zero.
// - The subspaces V' (every call; one torch copy): per subband and tile of
//   WT = 32 windows, [k-step s][m64 tile i][warp][lane][4] floats, the A
//   fragment of wgmma's register layout: lane (g, t) of warp w holds rows
//   16w + g and 16w + g + 8 at columns 8s + t and 8s + t + 4. Row 16w + g
//   (+ 8) of tile i is window 8w + g at k = 2i (2i + 1), so a thread's
//   accumulators hold all 2K rows of one window and its sum over k (in k
//   order, as the plain version) is in registers. V' is split in registers,
//   so it crosses memory once, unsplit.
//
// Pass A: a block holds one stretch of GB bins of one subband in shared
// memory (one bulk copy of 8 KP GB bytes: 128 KiB at c5) and walks every
// window tile of the launch. Its two warpgroups take a half of the bins
// each and the same windows (the second one's V' loads hit L1). Each
// k-step a thread loads its fragments (one float4 a m64 tile, two steps
// ahead), splits them and issues 3 K2/2 wgmma; the fragment registers
// alternate by step, with wgmma.wait_group 1 before a set is rewritten.
// The two accumulator sets take NT = 64 bins a warpgroup at 2K <= 4 and
// 32 at 2K = 6, 8 (128 registers a thread at 2K = 4, 8). Blocks run
// subband by subband (blockIdx.x is the stretch), so A' is read from HBM
// once and one subband's V' (4 MiB at c5), read by each of its blocks,
// is loaded under an L2 evict-last policy and the workspace is stored
// evict-first: without them the 2.16 GB of den stores pushed V' out of L2
// and pass A lost 1.45 ms to its loads (H100 80GB HBM3, 700 W; PERF.md).
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

namespace {

constexpr int THREADS = 256;        // pass A: two warpgroups
constexpr int WT = 32;              // windows a tile (4 warps x 8)
constexpr int TILE_OFF = 1024;      // shared memory: barrier, nrm, A'
constexpr int SMEM_MAX = 232448;    // a block's shared memory on sm_90
constexpr int SUM_THREADS = 256;    // pass B: 4 bins a thread

// Bins a warpgroup covers at subspace rank 2K = k2.
__host__ __device__ constexpr int bins_of(int k2) {
  return k2 <= 4 ? 64 : 32;
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

// Wait for the copy. One that has not landed after ~2^34 clocks (seconds)
// is lost: trap, so the launch fails instead of hanging.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try(bar, parity))
    if (clock64() - t0 > (1ll << 34)) __trap();
}

// An L2 policy that keeps lines past streaming traffic (evict last).
__device__ __forceinline__ uint64_t l2_evict_last() {
  uint64_t pol;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;"
               : "=l"(pol));
  return pol;
}

// A read-only float4 load under L2 policy `pol`.
__device__ __forceinline__ float4 ld_policy(const float4* p, uint64_t pol) {
  float4 v;
  asm volatile(
      "ld.global.nc.L2::cache_hint.v4.f32 {%0, %1, %2, %3}, [%4], %5;"
      : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "l"(p), "l"(pol));
  return v;
}

// x rounded to TF32 (10 mantissa bits), half away from zero.
__device__ __forceinline__ uint32_t rna_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// A shared-memory matrix descriptor: no swizzle, base offset 0, the
// leading (k-column) byte offset `lbo`, the stride (row group) 128 bytes.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo) {
  return (uint64_t)((addr & 0x3ffff) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(128 >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Pin accumulators in program order around the asynchronous wgmma (the
// compiler must not read them before the wait, nor move zeroing after the
// first wgmma).
template <int N>
__device__ __forceinline__ void keep(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// d += a . B^T over k8: wgmma m64n64k8, A (tf32) from registers in the
// fragment order of the note, B (n64 x k8, K-major) at descriptor `desc`
__device__ __forceinline__ void wgmma_n64(float (&d)[32],
                                          const uint32_t (&a)[4],
                                          uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// d += a . B^T over k8: wgmma m64n32k8, A (tf32) from registers in the
// fragment order of the note, B (n32 x k8, K-major) at descriptor `desc`
__device__ __forceinline__ void wgmma_n32(float (&d)[16],
                                          const uint32_t (&a)[4],
                                          uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <int NT>
__device__ __forceinline__ void mma(float (&d)[NT / 2],
                                    const uint32_t (&a)[4], uint64_t desc) {
  if constexpr (NT == 64) wgmma_n64(d, a, desc);
  else wgmma_n32(d, a, desc);
}

// One k-step s of a window tile, with fragment register set P (= s & 1):
// split the fragments loaded two steps ago, load step s + 2's, issue
// hi.hi into hh and hi.lo, lo.hi into cr.
template <int K2, int P>
__device__ __forceinline__ void k_step(
    int s, int S, const float4* vp, uint64_t pol, float4 (&raw)[2][K2 / 2],
    uint32_t (&ah)[2][K2 / 2][4], uint32_t (&al)[2][K2 / 2][4],
    float (&hh)[K2 / 2][bins_of(K2) / 2],
    float (&cr)[K2 / 2][bins_of(K2) / 2], uint64_t d_hi, uint64_t d_lo) {
  constexpr int MT = K2 / 2, NT = bins_of(K2);
  wgmma_wait<1>();                  // step s - 2, which read set P, is done
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const float v[4] = {raw[P][i].x, raw[P][i].y, raw[P][i].z, raw[P][i].w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      ah[P][i][e] = rna_tf32(v[e]);
      al[P][i][e] = rna_tf32(v[e] - __uint_as_float(ah[P][i][e]));
    }
  }
  if (s + 2 < S) {
#pragma unroll
    for (int i = 0; i < MT; ++i)
      raw[P][i] = ld_policy(vp + ((s + 2) * MT + i) * 128, pol);
  }
  wgmma_fence();
#pragma unroll
  for (int i = 0; i < MT; ++i) mma<NT>(hh[i], ah[P][i], d_hi);
#pragma unroll
  for (int i = 0; i < MT; ++i) mma<NT>(cr[i], ah[P][i], d_lo);
#pragma unroll
  for (int i = 0; i < MT; ++i) mma<NT>(cr[i], al[P][i], d_hi);
  wgmma_commit();
}

// Pass A. Grid (stretches of GB bins, F); see the note for the layouts.
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
#pragma unroll
    for (int i = 0; i < MT; ++i) {
#pragma unroll
      for (int q = 0; q < NA; ++q) hh[i][q] = cr[i][q] = 0.f;
      keep(hh[i]);
      keep(cr[i]);
    }
    float4 raw[2][MT];
    uint32_t ah[2][MT][4], al[2][MT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      raw[0][i] = ld_policy(vp + i * 128, v_pol);
      raw[1][i] = ld_policy(vp + (MT + i) * 128, v_pol);
    }
    for (int s = 0; s < S; s += 2) {
      const uint64_t dh = d0 + s * d_step;
      k_step<K2, 0>(s, S, vp, v_pol, raw, ah, al, hh, cr, dh, dh + d_plane);
      k_step<K2, 1>(s + 1, S, vp, v_pol, raw, ah, al, hh, cr, dh + d_step,
                    dh + d_step + d_plane);
    }
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      keep(hh[i]);
      keep(cr[i]);
    }

    // den of window b at the thread's NT/4 bins: 8j + 2tq + c
    const int b = T * WT + 8 * warp + (lane >> 2);
    const bool b_ok = b < b0 + nb;
    float* row = den + ((size_t)f * nb + (b - b0)) * Gs;
    float m = FLT_MAX;
#pragma unroll
    for (int j = 0; j < NT / 8; ++j) {
      float d[2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        float part = 0.f;                          // k = 2i + h, in order
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int q = 4 * j + 2 * h + c;
            const float y = __fadd_rn(hh[i][q], cr[i][q]);
            part = __fadd_rn(part, __fmul_rn(y, y));
          }
        d[c] = fmaxf(__fsub_rn(nr[8 * j + 2 * tq + c], part), FLT_MIN);
      }
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
  const int smem = TILE_OFF + 8 * KP * GB;
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

// Pass A on windows [b0, b0 + nb) of B. Vf: V' (see the note) of all B
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
