// K1 and kernel 9: per-chunk Grams of the interleaved capture x[T, n2],
// U_c = sum_t u_t u_t^T over each chunk of g rows, on one mainloop.
//
// K1 (`doa_chunk_gram`) replaces the Pallas kernel
// doa_tpu/ops/pallas/cov_embedded.py:191 `_cov_kernel_uhat` (the stacked
// variant of cov_embedded_pallas) and writes U_c f32[n2, n2]. Kernel 9
// (`doa_chunk_embedded`) replaces `_cov_kernel` of the same file (:99,
// variant="chunk") and writes each chunk's embedded covariance E(R) with
// the 1/S scale, the calibration correction and forward-backward
// averaging applied in its epilogue. The TPU kernels pack TPACK time steps
// into 128 lanes and run the f32 Gram as a bf16 hi/lo split on the MXU;
// here the capture is read in its natural layout (n2 = 2N: re, im
// interleaved per element, the bytes of a C-ordered complex64 (T, N)
// buffer) and every product is a true FP32 FMA on the CUDA cores (int8: an
// exact int32 multiply-add). No tensor cores, no TF32.
//
// What bounds them on an H100 (headline: T = 2^24, n2 = 32, g = 1024;
// 3.35 TB/s, 67 TFLOP/s FP32, 1979 TOP/s int8): the capture read once and
// U or E written once, against the Gram's upper triangle (2^24 * 32 * 33
// operations: 0.26 ms at the FP32 rate, 0.0045 ms at the int8 rate):
//   f32   2 GiB + 64 MiB  0.661 ms  bytes
//   bf16  1 GiB + 64 MiB  0.341 ms  bytes (FP32 FMAs, 0.26 ms, come close)
//   int8  512 MiB + 64 MiB 0.180 ms  bytes; but this kernel's int32
//         multiply-adds on the CUDA cores issue at about half the FP32
//         rate, ~0.5 ms for the triangle, so its arithmetic limits it
// Kernel 9 adds an O(n2^2) epilogue a chunk to K1's O(g n2^2).
//
// Design (one mainloop, `gram_mainloop`, for both entries):
// - Persistent grid: as many blocks as fit on the card (2 a SM), each
//   walking a contiguous run of whole chunks, so a small g does not cost a
//   block a chunk and copies stay in flight across chunk boundaries. One
//   block computes each chunk, in a fixed order: no atomics on the result,
//   which does not depend on the grid.
// - Loads: 1-D bulk async copies (cp.async.bulk ... mbarrier::complete_tx,
//   no tensor map) into a ring of STAGES stages of STAGE_BYTES in dynamic
//   shared memory, one mbarrier a stage carrying its bytes. The last warp
//   to leave a slot refills it (a count a slot), so no warp waits for the
//   slowest one between chunk ends and up to STAGES - 1 copies are in
//   flight while the block computes (2 blocks a SM: ~128 KiB a SM). Bulk
//   copies were taken over cp.async.cg because one thread moves a whole
//   stage with no registers and no per-thread address arithmetic. A bulk
//   copy needs 16-byte-aligned addresses and sizes: a stage is a multiple
//   of 16 rows and a block starts on a chunk whose byte offset is a
//   multiple of 16, so every stage of a launch sits at the same offset
//   (x mod 16) in its slot; the < 16-byte head and tail of a stage that
//   breaks the alignment (int8 or bf16 at n2 = 6 or 30, odd g, a sliced
//   view) are plain loads. Shared-memory reads are RT-vectors where that
//   offset allows (VEC), else element loads.
// - The upper triangle only: each thread owns an RT x RT register tile
//   (RT = 4 when 4 | n2 <= 64, RT = 2 for even n2 <= 30) with i0 <= j0 (36
//   of the 64 tiles at n2 = 32) and a residue class of each chunk's rows;
//   one row costs it 2 vector loads from shared memory for RT^2 FMAs. At a
//   chunk's end the classes' partial tiles go to a reduction buffer of
//   their own (the ring is already taking the next copies), the threads
//   of a tile sum its entries over the classes in order, and K1 writes
//   U[i][j] and U[j][i] from one value, so the mirror is exact.
// - Small chunks (K1, where a stage holds a chunk for every class,
//   g * classes <= rows a stage: g <= 36 at f32 n2 = 32): the classes take
//   whole chunks in turn instead, and each writes its tile and the mirror
//   from registers as RT-vector stores, with no reduction and no barrier
//   at chunk ends (a chunk's reduction and barriers cost about a
//   microsecond a block, and the scattered entry stores, which set the
//   pace at g = 8). Kernel 9's epilogue needs the whole Gram in one
//   place, so it always shares chunks across the classes.
// - What limits it (exp_cov_gram.py times patched copies of this file;
//   PERF.md): f32 runs within ~5% of its copies and chunk-end work
//   without the FMAs (~1.2x the bytes bound); bf16 and int8 are bound by
//   the arithmetic (the widening, and int32 issuing at half the FP32
//   rate); the chunk-end reduction and its barriers cost most of the
//   rest. The reduction buffer is entry-major: stored tile-major, a
//   warp's partial stores and sums hit one bank 16 times over.
//
// int8: entries are at most g*127^2, exact in int32 for g < 133144; the
// per-chunk cast to f32 is exact while g*127^2 < 2^24 (g <= 1040) and
// otherwise rounds once to f32 (relative 2^-24), as the TPU kernel does.

#include "gram_ring.cuh"

namespace {

using namespace gram_ring;

// K1's epilogue: U[i][j] and U[j][i] of chunk c from one value.
struct GramEpi {
  static constexpr bool kFinish = false;
  float* out;
  int n2;
  template <typename A>
  __device__ void entry(long long c, int i, int j, A sum, A*) const {
    float* oc = out + c * n2 * n2;
    oc[i * n2 + j] = (float)sum;
    if (i != j) oc[j * n2 + i] = (float)sum;
  }
  // A whole tile at (i0, j0) and its mirror, each row one RT-vector store
  // (RT | n2 and RT | j0, and the output is 16-byte aligned). A diagonal
  // tile is symmetric bit for bit (the same products in the same order).
  template <int RT, typename A>
  __device__ void tile(long long c, int i0, int j0,
                       const A (&acc)[RT][RT]) const {
    float* oc = out + c * n2 * n2;
#pragma unroll
    for (int u = 0; u < RT; ++u) {
      Raw<float, RT> r;
#pragma unroll
      for (int v = 0; v < RT; ++v) r.v[v] = (float)acc[u][v];
      *reinterpret_cast<Raw<float, RT>*>(oc + (i0 + u) * n2 + j0) = r;
    }
    if (i0 == j0) return;
#pragma unroll
    for (int v = 0; v < RT; ++v) {
      Raw<float, RT> r;
#pragma unroll
      for (int u = 0; u < RT; ++u) r.v[u] = (float)acc[u][v];
      *reinterpret_cast<Raw<float, RT>*>(oc + (j0 + v) * n2 + i0) = r;
    }
  }
  __device__ void finish(long long, const float*, int, int) const {}
};

// Kernel 9's epilogue: the chunk's embedded covariance E = [[rr, -ri],
// [ri, rr]] (N = n2/2), in the order of the plain version
// (ops/cuda/cov_embedded.py uhat_windows_to_embedded): the planar fold of
// the interleaved basis, rr = (U[2i][2j] + U[2i+1][2j+1])·scale,
// ri = (U[2i+1][2j] - U[2i][2j+1])·scale; the correction W = c c^H,
// (rr Wre - ri Wim, rr Wim + ri Wre); FB, (rr + flip(rr))/2,
// (ri - flip(ri))/2. Every step is one rounded FP32 operation (__fadd_rn
// and friends: no FMA contraction), as the plain version's elementwise
// torch ops, so the two agree bit for bit wherever the Grams agree. FB
// pairs (i, j) with (N-1-i, N-1-j): the thread folds both.
template <int RT> struct EmbeddedEpi {
  static constexpr bool kFinish = true;
  float* out;
  const float* Wre;
  const float* Wim;
  int n2, fb;
  float scale;
  // the reduced entry stays in class 0's slot for finish()
  __device__ void entry(long long, int, int, float sum, float* slot) const {
    *slot = sum;
  }
  // (rr, ri) at p = i*N + j, folded and corrected
  __device__ void fold(const float* red, int p, int N, int nt, int width,
                       float& rr, float& ri) const {
    const int i = p / N, j = p - i * N;
    const float u00 = u_at<RT>(red, 2 * i, 2 * j, nt, width);
    const float u11 = u_at<RT>(red, 2 * i + 1, 2 * j + 1, nt, width);
    const float u10 = u_at<RT>(red, 2 * i + 1, 2 * j, nt, width);
    const float u01 = u_at<RT>(red, 2 * i, 2 * j + 1, nt, width);
    const float r0 = __fmul_rn(__fadd_rn(u00, u11), scale);
    const float i0 = __fmul_rn(__fsub_rn(u10, u01), scale);
    const float wr = Wre[p], wi = Wim[p];
    rr = __fsub_rn(__fmul_rn(r0, wr), __fmul_rn(i0, wi));
    ri = __fadd_rn(__fmul_rn(r0, wi), __fmul_rn(i0, wr));
  }
  __device__ void finish(long long c, const float* red, int nt,
                         int width) const {
    const int N = n2 / 2, NN = N * N;
    float* oc = out + c * n2 * n2;
    for (int p = threadIdx.x; p < NN; p += THREADS) {
      const int i = p / N, j = p - i * N;
      float rr, ri;
      fold(red, p, N, nt, width, rr, ri);
      if (fb) {
        float rq, iq;                                  // (N-1-i, N-1-j)
        fold(red, NN - 1 - p, N, nt, width, rq, iq);
        rr = __fmul_rn(0.5f, __fadd_rn(rr, rq));
        ri = __fmul_rn(0.5f, __fsub_rn(ri, iq));
      }
      oc[i * n2 + j] = rr;
      oc[i * n2 + N + j] = -ri;
      oc[(N + i) * n2 + j] = ri;
      oc[(N + i) * n2 + N + j] = rr;
    }
  }
};

template <typename T, int RT, bool VEC, bool WHOLE>
__global__ void __launch_bounds__(THREADS, 2)
chunk_gram_kernel(const T* __restrict__ x, float* __restrict__ out,
                  long long n_chunks, int g, int n2) {
  extern __shared__ __align__(128) unsigned char smem[];
  gram_mainloop<T, RT, VEC, WHOLE, typename Acc<T>::type>(
      x, n_chunks, g, n2, smem, GramEpi{out, n2});
}

template <typename T, int RT, bool VEC>
__global__ void __launch_bounds__(THREADS, 2)
chunk_embedded_kernel(const T* __restrict__ x, const float* __restrict__ Wre,
                      const float* __restrict__ Wim, float* __restrict__ out,
                      long long n_chunks, int g, int n2, int fb,
                      float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  gram_mainloop<T, RT, VEC, false, float>(
      x, n_chunks, g, n2, smem, EmbeddedEpi<RT>{out, Wre, Wim, n2, fb, scale});
}

template <typename T>
int launch(const void* x, void* out, int n_chunks, int g, int n2,
           cudaStream_t s) {
  return dispatch<T>(x, n_chunks, g, n2, [&](auto f, long long units) {
    using F = decltype(f);
    if (whole_chunks(g, n2, F::RT, n2 * (int)sizeof(T)))
      return launch_grid<chunk_gram_kernel<T, F::RT, F::VEC, true>>(
          units, s, (const T*)x, (float*)out, (long long)n_chunks, g, n2);
    return launch_grid<chunk_gram_kernel<T, F::RT, F::VEC, false>>(
        units, s, (const T*)x, (float*)out, (long long)n_chunks, g, n2);
  });
}

template <typename T>
int launch_embedded(const void* x, const void* Wre, const void* Wim, void* out,
                    int n_chunks, int g, int n2, int fb, float scale,
                    cudaStream_t s) {
  return dispatch<T>(x, n_chunks, g, n2, [&](auto f, long long units) {
    using F = decltype(f);
    return launch_grid<chunk_embedded_kernel<T, F::RT, F::VEC>>(
        units, s, (const T*)x, (const float*)Wre, (const float*)Wim,
        (float*)out, (long long)n_chunks, g, n2, fb, scale);
  });
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = int8. x: [n_chunks * g, n2]
// contiguous rows (any address aligned to the element); out:
// f32[n_chunks, n2, n2]. n2 = 2N: 4 | n2 <= 64, or n2 <= 30.
extern "C" int doa_chunk_gram(const void* x, void* out, int n_chunks, int g,
                              int n2, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case 0: return launch<float>(x, out, n_chunks, g, n2, s);
    case 1: return launch<__nv_bfloat16>(x, out, n_chunks, g, n2, s);
    case 2: return launch<int8_t>(x, out, n_chunks, g, n2, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Kernel 9. dtype: 0 = float32, 1 = bfloat16. x: [n_chunks * g, n2]
// contiguous; Wre, Wim: f32[N, N], N = n2 / 2, the correction c c^H;
// out: f32[n_chunks, n2, n2], each chunk's embedded covariance (scale,
// correction and, with fb != 0, forward-backward averaging applied). n2 as
// doa_chunk_gram.
extern "C" int doa_chunk_embedded(const void* x, const void* Wre,
                                  const void* Wim, void* out, int n_chunks,
                                  int g, int n2, int dtype, int fb,
                                  float scale, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case 0: return launch_embedded<float>(x, Wre, Wim, out, n_chunks, g, n2,
                                          fb, scale, s);
    case 1: return launch_embedded<__nv_bfloat16>(x, Wre, Wim, out, n_chunks,
                                                  g, n2, fb, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
