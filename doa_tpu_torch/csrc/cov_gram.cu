// K1 and kernel 9: per-chunk Grams of the interleaved capture x[T, n2],
// U_c = sum_t u_t u_t^T over each chunk of g rows, on one mainloop.
//
// K1 (`doa_chunk_gram`) replaces the Pallas kernel
// doa_tpu/ops/pallas/cov_embedded.py:191 `_cov_kernel_uhat` (the stacked
// variant of cov_embedded_pallas) and writes U_c f32[n2, n2]. Kernel 9
// (`doa_chunk_embedded`) replaces `_cov_kernel` of the same file (:99,
// variant="chunk") and writes each chunk's embedded covariance E(R) with
// the 1/S scale, the calibration correction and forward-backward
// averaging applied in its epilogue. Where a window is one chunk (g = S)
// the pipelines' covariance stage launches it in K1's place
// (chunk_grams_uhat's `embed`): its E is K1's U folded by the plain
// version, bit for bit, with no torch pass over the chunk stack. The TPU
// kernels pack TPACK time steps into 128 lanes and run the f32 Gram as a
// bf16 hi/lo split on the MXU;
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
// Kernel 9 adds an O(n2^2) epilogue a chunk to K1's O(g n2^2), folded
// where K1's chunk-end reduction is (EmbeddedEpi).
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
//   pace at g = 8). Kernel 9's epilogue reads other tiles' sums (FB's
//   partner), so it shares chunks across the classes; where K1 takes
//   whole chunks its entry runs K1's form and then folds each chunk's U in
//   place (fold_kernel, the same arithmetic). Either way its sums, and E,
//   are K1's bit for bit at every g, so the stage can launch it in K1's
//   place wherever a window is one chunk.
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
  static constexpr bool kFinish = false, kFold = false;
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
// (ri - flip(ri))/2, flip pairing (i, j) with (N-1-i, N-1-j). Every step
// is one rounded FP32 operation (__fadd_rn and friends: no FMA
// contraction), as the plain version's elementwise torch ops, so the two
// agree bit for bit wherever the Grams agree.
//
// Folded where the reduction is, with no pass and no barrier of its own
// (fold(), called by every thread after the classes' partial tiles land):
// an item is one entry (i, j), i <= j, of the N x N complex R. Its 2x2
// interleaved block (rows 2i, 2i+1; columns 2j, 2j+1) lies inside one
// register tile (RT is even and 2i, 2j are even), so the item's thread sums
// the block's four entries over the row classes itself, each in K1's order
// (U is K1's bit for bit), folds and corrects them for (i, j) and for its
// mirror (j, i) (each with its own W entry and its own ri difference, as
// the plain version computes it), and stores both. Items come in lane
// pairs (e, Q(e)), Q(i, j) = (N-1-j, N-1-i): e's FB partner
// (N-1-i, N-1-j) is the mirror of Q(e), and the mirror's partner is Q(e),
// so one exchange of four values by shuffle gives both FB averages. The
// even lane of pair k holds the k-th entry with i + j <= N-1 (row by row),
// the odd lane its Q; where Q(e) = e (i + j = N-1) the odd lane idles and
// the even lane is its own partner.
template <int RT> struct EmbeddedEpi {
  static constexpr bool kFinish = false, kFold = true;
  // an item: R's entry (i, j), its block's first class-0 entry in `red`
  // (b) and the step to (2i+1, 2j) (w10), whether the lane holds one
  // (mine) and is its own FB partner (self), and W at (i, j) and (j, i)
  struct Item {
    int i, j, b, w10;
    bool mine, self;
    float wr, wi, wrm, wim;
  };
  float* out;
  const float* Wre;
  const float* Wim;
  int n2, fb;
  float scale;
  Item first;             // this thread's item in a chunk end's first round

  __device__ int slots() const {
    const int N = n2 / 2, h = (N + 1) / 2;
    return 2 * h * (N - h + 1);
  }
  __device__ Item item(int slot) const {
    const int N = n2 / 2, nt = n2 / RT;
    const int width = row_classes(n2, RT) * (nt * (nt + 1) / 2);
    Item it{};
    it.mine = slot < slots();
    if (!it.mine) return it;
    int k = slot >> 1, i = 0;
    while (k >= N - 2 * i) {                           // row i holds N - 2i
      k -= N - 2 * i;
      ++i;
    }
    int j = i + k;
    it.self = i + j == N - 1;
    if (slot & 1) {
      const int t = i;
      i = N - 1 - j;
      j = N - 1 - t;
      it.mine = !it.self;
    }
    // the block's tile and its entries (2i, 2j), (2i, 2j+1), (2i+1, 2j),
    // (2i+1, 2j+1); on the diagonal (2i+1, 2i) is the mirror of
    // (2i, 2i+1), which holds it
    const int ib = 2 * i / RT, jb = 2 * j / RT;
    it.i = i;
    it.j = j;
    it.b = ((2 * i % RT) * RT + 2 * j % RT) * width + ib * nt -
           ib * (ib - 1) / 2 + (jb - ib);
    it.w10 = (i == j ? 1 : RT) * width;
    it.wr = __ldg(Wre + i * N + j);
    it.wi = __ldg(Wim + i * N + j);
    it.wrm = __ldg(Wre + j * N + i);
    it.wim = __ldg(Wim + j * N + i);
    return it;
  }
  __device__ void fold(long long c, const float* red, int, int ntri,
                       int groups) const {
    const int N = n2 / 2, width = groups * ntri, w11 = (RT + 1) * width;
    const int lane = threadIdx.x & 31;
    float* oc = out + c * n2 * n2;
    // a warp's lanes take slots s + lane together (the shuffle needs them)
    for (int s = threadIdx.x - lane; s < slots(); s += THREADS) {
      const Item it = s + lane == (int)threadIdx.x ? first : item(s + lane);
      float rr = 0.f, ri = 0.f, mr = 0.f, mi = 0.f;
      if (it.mine) {
        const float* b = red + it.b;
        float u00 = b[0], u01 = b[width], u10 = b[it.w10], u11 = b[w11];
#pragma unroll 4
        for (int q = 1; q < groups; ++q) {
          const float* p = b + q * ntri;
          u00 += p[0];
          u01 += p[width];
          u10 += p[it.w10];
          u11 += p[w11];
        }
        const float r0 = __fmul_rn(__fadd_rn(u00, u11), scale);
        const float i0 = __fmul_rn(__fsub_rn(u10, u01), scale);
        const float i1 = __fmul_rn(__fsub_rn(u01, u10), scale);  // (j, i)'s
        rr = __fsub_rn(__fmul_rn(r0, it.wr), __fmul_rn(i0, it.wi));
        ri = __fadd_rn(__fmul_rn(r0, it.wi), __fmul_rn(i0, it.wr));
        mr = __fsub_rn(__fmul_rn(r0, it.wrm), __fmul_rn(i1, it.wim));
        mi = __fadd_rn(__fmul_rn(r0, it.wim), __fmul_rn(i1, it.wrm));
      }
      if (fb) {
        const int src = it.self ? lane : lane ^ 1;
        const float qr = __shfl_sync(0xffffffffu, rr, src);
        const float qi = __shfl_sync(0xffffffffu, ri, src);
        const float qmr = __shfl_sync(0xffffffffu, mr, src);
        const float qmi = __shfl_sync(0xffffffffu, mi, src);
        rr = __fmul_rn(0.5f, __fadd_rn(rr, qmr));
        ri = __fmul_rn(0.5f, __fsub_rn(ri, qmi));
        mr = __fmul_rn(0.5f, __fadd_rn(mr, qr));
        mi = __fmul_rn(0.5f, __fsub_rn(mi, qi));
      }
      if (it.mine) {
        const int i = it.i, j = it.j;
        oc[i * n2 + j] = rr;
        oc[i * n2 + N + j] = -ri;
        oc[(N + i) * n2 + j] = ri;
        oc[(N + i) * n2 + N + j] = rr;
        if (i != j) {
          oc[j * n2 + i] = mr;
          oc[j * n2 + N + i] = -mi;
          oc[(N + j) * n2 + i] = mi;
          oc[(N + j) * n2 + N + i] = mr;
        }
      }
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
  EmbeddedEpi<RT> epi{out, Wre, Wim, n2, fb, scale, {}};
  epi.first = epi.item(threadIdx.x);       // decoded once, held in registers
  gram_mainloop<T, RT, VEC, false, float>(x, n_chunks, g, n2, smem, epi);
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

// One entry (i, j) of R from a chunk's U in shared memory (u, row stride
// n2): the planar fold, the scale and the correction, each step one
// rounded FP32 operation in EmbeddedEpi::fold's order.
__device__ __forceinline__ void fold_entry(const float* u, int n2, int i,
                                           int j, const float* Wre,
                                           const float* Wim, float scale,
                                           float& rr, float& ri) {
  const int N = n2 / 2;
  const float* a = u + 2 * i * n2 + 2 * j;
  const float r0 = __fmul_rn(__fadd_rn(a[0], a[n2 + 1]), scale);
  const float i0 = __fmul_rn(__fsub_rn(a[n2], a[1]), scale);
  const float wr = __ldg(Wre + i * N + j), wi = __ldg(Wim + i * N + j);
  rr = __fsub_rn(__fmul_rn(r0, wr), __fmul_rn(i0, wi));
  ri = __fadd_rn(__fmul_rn(r0, wi), __fmul_rn(i0, wr));
}

// Kernel 9 after K1's whole-chunk form: each chunk's U in `out` folded
// into its E in place, a block a chunk at a time (U to shared memory, a
// barrier, then every entry of R and, with fb, its FB partner from there).
__global__ void __launch_bounds__(THREADS)
fold_kernel(float* __restrict__ out, const float* __restrict__ Wre,
            const float* __restrict__ Wim, long long n_chunks, int n2,
            int fb, float scale) {
  __shared__ float u[64 * 64];
  const int N = n2 / 2, nn = n2 * n2;
  for (long long c = blockIdx.x; c < n_chunks; c += gridDim.x) {
    float* oc = out + c * nn;
    for (int e = threadIdx.x; e < nn; e += THREADS) u[e] = oc[e];
    __syncthreads();
    for (int e = threadIdx.x; e < N * N; e += THREADS) {
      const int i = e / N, j = e - i * N;
      float rr, ri;
      fold_entry(u, n2, i, j, Wre, Wim, scale, rr, ri);
      if (fb) {
        float pr, pi;
        fold_entry(u, n2, N - 1 - i, N - 1 - j, Wre, Wim, scale, pr, pi);
        rr = __fmul_rn(0.5f, __fadd_rn(rr, pr));
        ri = __fmul_rn(0.5f, __fsub_rn(ri, pi));
      }
      oc[i * n2 + j] = rr;
      oc[i * n2 + N + j] = -ri;
      oc[(N + i) * n2 + j] = ri;
      oc[(N + i) * n2 + N + j] = rr;
    }
    __syncthreads();
  }
}

template <typename T>
int launch_embedded(const void* x, const void* Wre, const void* Wim, void* out,
                    int n_chunks, int g, int n2, int fb, float scale,
                    cudaStream_t s) {
  return dispatch<T>(x, n_chunks, g, n2, [&](auto f, long long units) {
    using F = decltype(f);
    if (whole_chunks(g, n2, F::RT, n2 * (int)sizeof(T))) {
      const int e = launch_grid<chunk_gram_kernel<T, F::RT, F::VEC, true>>(
          units, s, (const T*)x, (float*)out, (long long)n_chunks, g, n2);
      if (e != 0) return e;
      const int grid = n_chunks < 4096 ? n_chunks : 4096;
      fold_kernel<<<grid, THREADS, 0, s>>>((float*)out, (const float*)Wre,
                                           (const float*)Wim,
                                           (long long)n_chunks, n2, fb,
                                           scale);
      return (int)cudaGetLastError();
    }
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
