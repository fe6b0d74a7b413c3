// The MUSIC scan's product on the tensor cores, shared by the wideband
// fusion kernel 5 (wideband_scan.cu) and the spectrum kernel K3
// (music_scan.cu). For windows b, grid bins g and one steering stack:
//
//   den[b, g] = max(nrm[g] - sum_k (Vt_b[k] . a_g)^2, FLT_MIN)
//
// The header gives the pieces of a block's mainloop (the end of the file
// describes them): each window tile's products on the tensor cores from a
// stretch of GB = 2 NT bins of A' staged in shared memory, and each bin
// pair's den. Each kernel writes its own staging, walk over window tiles
// and epilogue: kernel 5 stores den to a workspace and min-accumulates
// dmin, K3 stores P = 1 / den.
//
// Precision, 3xTF32: each operand x splits as hi = rna(x), lo = rna(x -
// hi), where rna keeps the top 10 mantissa bits rounding half away from
// zero (cvt.rna.tf32.f32, written on the bits so that it equals the plain
// helper `tf32_split` of ops/cuda/scan_tc.py bit for bit; wgmma then
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
// Layouts, both built by the wrapper (ops/cuda/scan_tc.py):
// - The steering stack A' (once per stack): per stretch of GB = 2 NT
//   bins, [plane hi, lo][KP/4 k-columns][GB/8 row groups][8 rows][4]
//   floats, KP = 2N rounded up to 16. Each 8 x 4 core matrix of wgmma's
//   K-major layout without swizzle is 128 contiguous bytes (no bank
//   conflict), so one bulk copy lands a stretch in shared memory as the
//   descriptors read it: LBO = GB/8 * 128 bytes from one k-column to the
//   next, SBO = 128 bytes from one row group to the next. Bins past G and
//   columns past 2N are zero (a zero column adds 0 to every product, so
//   exact inputs stay exact).
// - The subspaces V' (every call; one torch copy): per tile of WT = 32
//   windows, [k-step s][m64 tile i][warp][lane][4] floats, the A
//   fragment of wgmma's register layout: lane (g, t) of warp w holds rows
//   16w + g and 16w + g + 8 at columns 8s + t and 8s + t + 4. Row 16w + g
//   (+ 8) of tile i is window 8w + g at k = 2i (2i + 1), so a thread's
//   accumulators hold all 2K rows of one window and its sum over k (in k
//   order, as the plain version) is in registers. V' is split in registers,
//   so it crosses memory once, unsplit.
//
// A block holds one stretch of A' in shared memory (one bulk copy of
// 8 KP GB bytes: 128 KiB at 2N = 128) and walks its window tiles. Its two
// warpgroups take a half of the bins each and the same windows (the
// second one's V' loads hit L1). Each k-step a thread loads its fragments
// (one float4 a m64 tile, two steps ahead), splits them and issues 3 K2/2
// wgmma; the fragment registers alternate by step, with wgmma.wait_group 1
// before a set is rewritten. The two accumulator sets take NT = 64 bins a
// warpgroup at 2K <= 4 and 32 at 2K = 6, 8 (128 registers a thread at
// 2K = 4, 8): about 210 registers a thread in all, so one block an SM.
// V' is read by every block of its bins, so it is loaded under an L2
// evict-last policy; the epilogues store evict-first.

#pragma once

#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

#include <type_traits>

namespace scan_tc {

constexpr int THREADS = 256;        // two warpgroups
constexpr int WT = 32;              // windows a tile (4 warps x 8)
constexpr int TILE_OFF = 1024;      // shared memory: barrier, nrm, A'
constexpr int SMEM_MAX = 232448;    // a block's shared memory on sm_90

// Bins a warpgroup covers at subspace rank 2K = k2.
__host__ __device__ constexpr int bins_of(int k2) {
  return k2 <= 4 ? 64 : 32;
}

// A block's dynamic shared memory at 2K = k2 and contraction KP.
__host__ __device__ constexpr int smem_of(int k2, int KP) {
  return TILE_OFF + 8 * KP * 2 * bins_of(k2);
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

// V' staged in shared memory (K2 stages each window tile's fragments
// there): its "policy load" is a plain shared-memory load.
struct SharedV {
  const float4* p;
  __device__ __forceinline__ SharedV operator+(int i) const {
    return {p + i};
  }
};
__device__ __forceinline__ float4 ld_policy(SharedV v, uint64_t) {
  return *v.p;
}

// Have a fragment set computed by here: an empty volatile use, which
// the asm statements around it keep in order. The split is plain
// arithmetic, free to move past wgmma_fence into the stage of wgmma it
// feeds; with V' from shared memory the compiler did that (a lo half
// computed in its hi half's registers after the hi wgmma had issued),
// and ptxas then waited on every wgmma (C7513). K2 uses it before the
// fence; K3 and kernel 5 (V' from global memory) keep their code.
template <int MT>
__device__ __forceinline__ void hold(const uint32_t (&ah)[MT][4],
                                     const uint32_t (&al)[MT][4]) {
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      asm volatile("" :: "r"(ah[i][e]), "r"(al[i][e]));
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
// split the fragments loaded two steps ago (a SharedV's: loaded now),
// load step s + 2's, issue hi.hi into hh and hi.lo, lo.hi into cr.
template <int K2, int P, class VP>
__device__ __forceinline__ void k_step(
    int s, int S, VP vp, uint64_t pol, float4 (&raw)[2][K2 / 2],
    uint32_t (&ah)[2][K2 / 2][4], uint32_t (&al)[2][K2 / 2][4],
    float (&hh)[K2 / 2][bins_of(K2) / 2],
    float (&cr)[K2 / 2][bins_of(K2) / 2], uint64_t d_hi, uint64_t d_lo) {
  constexpr int MT = K2 / 2, NT = bins_of(K2);
  constexpr bool shared_v = std::is_same<VP, SharedV>::value;
  wgmma_wait<1>();                  // step s - 2, which read set P, is done
  if constexpr (shared_v) {
#pragma unroll
    for (int i = 0; i < MT; ++i)
      raw[P][i] = ld_policy(vp + (s * MT + i) * 128, pol);
  }
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const float v[4] = {raw[P][i].x, raw[P][i].y, raw[P][i].z, raw[P][i].w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      ah[P][i][e] = rna_tf32(v[e]);
      al[P][i][e] = rna_tf32(v[e] - __uint_as_float(ah[P][i][e]));
    }
  }
  if (!shared_v && s + 2 < S) {
#pragma unroll
    for (int i = 0; i < MT; ++i)
      raw[P][i] = ld_policy(vp + ((s + 2) * MT + i) * 128, pol);
  }
  if constexpr (shared_v) hold(ah[P], al[P]);
  wgmma_fence();
#pragma unroll
  for (int i = 0; i < MT; ++i) mma<NT>(hh[i], ah[P][i], d_hi);
#pragma unroll
  for (int i = 0; i < MT; ++i) mma<NT>(cr[i], ah[P][i], d_lo);
#pragma unroll
  for (int i = 0; i < MT; ++i) mma<NT>(cr[i], al[P][i], d_hi);
  wgmma_commit();
}

// The mainloop's shared pieces: tile_products (one window tile's two
// accumulator sets) and den_pair (a bin pair's den). Each kernel stages
// its stretch (one bulk copy of 8 KP GB bytes of A' to TILE_OFF, the GB
// bins' nrm to byte 16, an mbarrier at 0; smem_of(K2, KP) bytes of
// dynamic shared memory, THREADS threads), builds its warpgroup's
// descriptors (make_desc at TILE_OFF + wg (NT/8) 128 with LBO = GB/8 128;
// a k-step on is 2 LBO, the lo plane KP/4 LBO on) and writes its walk
// over window tiles and its epilogue around them (pass A in
// wideband_scan.cu, K3 in music_scan.cu): the staging as a shared
// function cost kernel 5 a register in two of its forms (ptxas for
// sm_90a; PERF.md).
// The thread of warpgroup wg, lane t of it (warp t >> 5, lane t & 31,
// tq = lane & 3), owns window 8 warp + (lane >> 2) of each tile and the
// bins gw + 8j + 2tq + c, gw = g0 + wg NT, c = 0, 1.

// One window tile: hi.hi into hh, hi.lo + lo.hi into cr, over the S =
// KP/8 k-steps, from the thread's V' fragments at vp (a global pointer,
// loaded under the L2 policy pol, or a SharedV); returns when every wgmma
// of the tile is done.
template <int K2, class VP>
__device__ __forceinline__ void tile_products(
    VP vp, int S, uint64_t pol, uint64_t d0, uint64_t d_step,
    uint64_t d_plane, float (&hh)[K2 / 2][bins_of(K2) / 2],
    float (&cr)[K2 / 2][bins_of(K2) / 2]) {
  constexpr int MT = K2 / 2, NA = bins_of(K2) / 2;
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int q = 0; q < NA; ++q) hh[i][q] = cr[i][q] = 0.f;
    keep(hh[i]);
    keep(cr[i]);
  }
  float4 raw[2][MT];
  uint32_t ah[2][MT][4], al[2][MT][4];
  if constexpr (!std::is_same<VP, SharedV>::value) {
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      raw[0][i] = ld_policy(vp + i * 128, pol);
      raw[1][i] = ld_policy(vp + (MT + i) * 128, pol);
    }
  }
  for (int s = 0; s < S; s += 2) {
    const uint64_t dh = d0 + s * d_step;
    k_step<K2, 0>(s, S, vp, pol, raw, ah, al, hh, cr, dh, dh + d_plane);
    k_step<K2, 1>(s + 1, S, vp, pol, raw, ah, al, hh, cr, dh + d_step,
                  dh + d_step + d_plane);
  }
  wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    keep(hh[i]);
    keep(cr[i]);
  }
}

// den = max(nrm - sum_k y^2, FLT_MIN) at bins 8j + 2tq + c (c = 0, 1) of
// the thread's window, y = hh + cr, k = 2i + h in order (the plain
// version's order); nr is the warpgroup's nrm in shared memory.
template <int K2>
__device__ __forceinline__ void den_pair(
    const float (&hh)[K2 / 2][bins_of(K2) / 2],
    const float (&cr)[K2 / 2][bins_of(K2) / 2], const float* nr, int j,
    int tq, float (&d)[2]) {
  constexpr int MT = K2 / 2;
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    float part = 0.f;                              // k = 2i + h, in order
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
}

}  // namespace scan_tc
