// 2-D peak extraction over az/el pseudospectra, in two forms.
//
// Replaces the Pallas kernel doa_tpu/ops/pallas/peaks2d.py:42
// `_peaks2d_kernel` and reproduces doa_tpu/ops/peaks.py::find_local_max_2d
// (the port's ops/peaks.py::find_local_max_2d) bit for bit. P f32[B, Ga*Ge]
// is the row-major flattened (az, el) spectrum of each window:
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
// 135 MB (0.04 ms at 3.35 TB/s). The peaks, the global argmax and their
// (value, index) order are a function of the set of bins alone, so any
// walk and merge order gives the same bits; the refine uses IEEE division
// and explicitly rounded adds and multiplies, so nvcc contracts nothing
// the reference rounds twice. Two forms, chosen by ring_form(G):
//
// Ring form, a window that fits a slot of the ring (HEAD_BYTES +
// RING_SLOTS slots of slot_bytes(G) within SMEM_LIMIT; c5's 65,884-byte
// windows): a persistent grid, each block a run of consecutive windows.
// - Copy: each window's G*4 bytes by one 1-D cp.async.bulk into a slot,
//   an mbarrier a slot; the head and tail that break the copy's 16-byte
//   rule by plain loads. The next RING_SLOTS - 1 windows' copies are in
//   flight while a window is worked.
// - Stencil from shared memory, no division: warp 0 merges, refines and
//   refills; warps 1..W-1 own the rows [(w-1) Ga / (W-1), w Ga / (W-1)),
//   their lanes the interior el columns e = 1 + lane + 32c; a lane walks
//   its column down the warp's interior rows with the up and centre
//   values carried in registers, the down, left and right read from
//   shared memory, and keeps a sorted top-k of its peaks (k a template
//   argument).
// - Merge: an xor shuffle butterfly merges the lanes' lists in each warp
//   (skipped by a warp with no peak); lane 0 puts the warp's list in a
//   shared list (two, by window parity); one block barrier a window;
//   warp 0 merges the W-1 lists by the same butterfly.
// - Pad and refine: only a window with no finite peak needs the global
//   argmax, and there warp 0 finds it by a strided walk and a butterfly.
//   Lane r < k of warp 0 takes peak r, from the window still in its slot,
//   while warps 1.. walk the next window; then warp 0 refills the slot
//   with the window RING_SLOTS on, its head and tail fetched a window
//   ahead.
// What sets its pace (exp_peaks2d.py on an H100 80GB HBM3 at 700 W): the
// copies. At c5, 0.055 ms a launch against the copies alone's 0.046 (the
// bytes bound 0.040): the stencil (0.039 alone) and the merges and refine
// (0.023 alone) hide under them, and what is left is the ring's fill and
// drain. 768 and 1024 threads a block gained nothing. Before the stencil
// lost its argmax and border tests and took k as a template argument, it
// set the pace (0.097 ms); before warp 0 fetched the refill's head and
// tail a window ahead, their dependent loads did (0.109 ms).
//
// Block form, any other grid: the first kernel, one block a window; each
// thread walks its stride of bins (neighbours from L1) with an integer
// division a bin; k rounds of a block (value, index) reduction merge the
// threads' lists; thread 0 pads and refines.

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 512;             // block form: threads a block
constexpr int MAX_K = 4;
constexpr int BIG = 0x7fffffff;
constexpr int RING_THREADS = 512;        // ring form: threads a block
constexpr int RING_WARPS = RING_THREADS / 32;
constexpr int RING_SLOTS = 3;            // ring form: windows in the ring
constexpr int HEAD_BYTES = 2048;         // ring form: barriers and lists
static_assert(64 + 2 * 2 * RING_WARPS * MAX_K * 4 <= HEAD_BYTES,
              "the lists fit the head");
constexpr int SMEM_LIMIT = 232448;       // bytes a block may use (H100)
constexpr unsigned FULL = 0xffffffffu;

// A slot: a window's G floats at its address mod 16 (0, 4, 8 or 12 bytes
// in), rounded up to 16 bytes.
__host__ __device__ constexpr int slot_bytes(int G) {
  return (4 * G + 12 + 15) & ~15;
}

__host__ __device__ constexpr long long ring_bytes(int G) {
  return HEAD_BYTES + (long long)RING_SLOTS * slot_bytes(G);
}

__host__ __device__ constexpr bool ring_form(long long G) {
  return G <= (SMEM_LIMIT - HEAD_BYTES) / RING_SLOTS / 4 &&
         ring_bytes((int)G) <= SMEM_LIMIT;
}

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

// ------------------------------------------------------------ ring form

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

// Wait for a slot's copy. One that has not landed after ~2^34 clocks
// (seconds) is lost: trap, so the launch fails instead of hanging.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try(bar, parity))
    if (clock64() - t0 > (1ll << 34)) __trap();
}

// (v, i) into the sorted list tv/ti of K entries
template <int K>
__device__ __forceinline__ void insert(float* tv, int* ti, float v, int i) {
#pragma unroll
  for (int q = 0; q < K; ++q) {
    if (better(v, i, tv[q], ti[q])) {
      const float sv = tv[q];
      const int si = ti[q];
      tv[q] = v; ti[q] = i;
      v = sv; i = si;
    }
  }
}

// The warp's lists merged into every lane's: at each xor step a lane
// inserts its partner's list, whose bins are disjoint from its own, into
// its own. A warp none of whose lanes holds an entry skips it.
template <int K>
__device__ __forceinline__ void warp_merge(float* tv, int* ti) {
  if (!__any_sync(FULL, ti[0] != BIG)) return;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    float ov[K];
    int oi[K];
#pragma unroll
    for (int q = 0; q < K; ++q) {
      ov[q] = __shfl_xor_sync(FULL, tv[q], off);
      oi[q] = __shfl_xor_sync(FULL, ti[q], off);
    }
#pragma unroll
    for (int q = 0; q < K; ++q) insert<K>(tv, ti, ov[q], oi[q]);
  }
}

// The window's global argmax (the first flat index on equal values) on
// every lane of a warp: lane l walks bins l, l + 32, ..., then an xor
// shuffle butterfly.
__device__ __forceinline__ void warp_argmax(const float* W, int G, int lane,
                                            float& gv, int& gi) {
  gv = -INFINITY;
  gi = BIG;
  for (int g = lane; g < G; g += 32)
    if (better(W[g], g, gv, gi)) { gv = W[g]; gi = g; }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(FULL, gv, off);
    const int oi = __shfl_xor_sync(FULL, gi, off);
    if (better(ov, oi, gv, gi)) { gv = ov; gi = oi; }
  }
}

template <int K>
__global__ void __launch_bounds__(RING_THREADS)
peaks2d_ring(const float* __restrict__ P, float* __restrict__ vals,
             float* __restrict__ az, float* __restrict__ el, int B, int Ga,
             int Ge, float az0, float daz, float el0, float del,
             int refine) {
  extern __shared__ __align__(128) unsigned char smem[];
  // full[s]: slot s's window landed; the warps' lists, two by window
  // parity: entry q of warp w's at [par][w][q]
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  float* lv = reinterpret_cast<float*>(smem + 64);
  int* li = reinterpret_cast<int*>(smem + 64 + 2 * RING_WARPS * MAX_K * 4);
  unsigned char* ring = smem + HEAD_BYTES;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int G = Ga * Ge, SB = slot_bytes(G);
  const long long w0 = (long long)B * blockIdx.x / gridDim.x;
  const int nw = (int)((long long)B * (blockIdx.x + 1) / gridDim.x - w0);
  const uintptr_t pb = reinterpret_cast<uintptr_t>(P);

  // window w0 + j into slot j % RING_SLOTS: the aligned middle [a, b) by
  // one bulk copy, the head [s, a) and tail [b, e) (< 16 bytes each) by
  // plain loads. Warp 0 fetches the head and tail a window ahead (lanes
  // 0-2 the head's floats, 4-6 the tail's: off = their byte offsets in the
  // slot, -1 on the other lanes), then puts them and issues the copy.
  auto span = [&](int j, uintptr_t& s, uintptr_t& a, uintptr_t& b,
                  uintptr_t& e) {
    s = pb + (uintptr_t)(w0 + j) * G * 4;
    e = s + (uintptr_t)G * 4;
    const uintptr_t up = (s + 15) & ~(uintptr_t)15, dn = e & ~(uintptr_t)15;
    a = up < e ? up : e;
    b = dn > a ? dn : a;
  };
  auto fetch = [&](int j, float& v, int& off) {
    uintptr_t s, a, b, e;
    span(j, s, a, b, e);
    const uintptr_t p = lane < 4 ? s + 4 * lane : b + 4 * (lane - 4);
    off = -1;
    if (lane < 8 && p < (lane < 4 ? a : e)) {
      v = *reinterpret_cast<const float*>(p);
      off = (int)(p - (s & ~(uintptr_t)15));
    }
  };
  auto issue = [&](int j, float v, int off) {
    uintptr_t s, a, b, e;
    span(j, s, a, b, e);
    unsigned char* dst = ring + (j % RING_SLOTS) * SB;
    if (off >= 0) *reinterpret_cast<float*>(dst + off) = v;
    // these generic writes, and the block's reads of the slot's last
    // window, before the bulk write
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncwarp();
    if (lane != 0) return;
    const uint32_t bar = smem_addr(full + j % RING_SLOTS);
    const uint32_t bytes = (uint32_t)(b - a);
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 :: "r"(bar), "r"(bytes) : "memory");
    if (bytes)
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
          " [%0], [%1], %2, [%3];"
          :: "r"(smem_addr(dst + (a - (s & ~(uintptr_t)15)))),
             "l"(reinterpret_cast<const void*>(a)), "r"(bytes), "r"(bar)
          : "memory");
  };

  float hv = 0.f;                  // warp 0: the next refill's head/tail
  int hoff = -1;
  if (warp == 0) {
    if (lane == 0) {
      for (int s = 0; s < RING_SLOTS; ++s)
        asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
                     :: "r"(smem_addr(full + s)) : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncwarp();
    for (int j = 0; j < min(RING_SLOTS, nw); ++j) {
      fetch(j, hv, hoff);
      issue(j, hv, hoff);
    }
    if (RING_SLOTS < nw) fetch(RING_SLOTS, hv, hoff);
  }
  __syncthreads();

  // warp 0 merges, refines and refills; warps 1.. own the rows, of which
  // the interior ones [a0, a1) hold the peak candidates
  const int r0 = warp == 0 ? 0 : (warp - 1) * Ga / (RING_WARPS - 1);
  const int r1 = warp == 0 ? 0 : warp * Ga / (RING_WARPS - 1);
  const int a0 = max(r0, 1), a1 = min(r1, Ga - 1);
  for (int j = 0; j < nw; ++j) {
    const long long b = w0 + j;
    mbar_wait(smem_addr(full + j % RING_SLOTS),
              (uint32_t)((j / RING_SLOTS) & 1));
    const float* W = reinterpret_cast<const float*>(
        ring + (j % RING_SLOTS) * SB + ((pb + (uintptr_t)b * G * 4) & 15));

    float tv[K];
    int ti[K];
#pragma unroll
    for (int q = 0; q < K; ++q) { tv[q] = -INFINITY; ti[q] = BIG; }
    float* mv = lv + (j & 1) * RING_WARPS * MAX_K;
    int* mi = li + (j & 1) * RING_WARPS * MAX_K;
    if (warp != 0) {
      // the stencil: this lane's interior columns e = 1 + lane + 32c down
      // the warp's interior rows, the up and centre values carried
      if (r0 < r1) {
        for (int e = 1 + lane; e < Ge - 1 && a0 < a1; e += 32) {
          float up = W[(a0 - 1) * Ge + e];
          float cur = W[a0 * Ge + e];
#pragma unroll 4
          for (int a = a0; a < a1; ++a) {
            const int g = a * Ge + e;
            const float down = W[g + Ge], left = W[g - 1], right = W[g + 1];
            if ((cur > up) & (cur >= down) & (cur > left) & (cur >= right))
              insert<K>(tv, ti, cur, g);
            up = cur;
            cur = down;
          }
        }
      }
      warp_merge<K>(tv, ti);                // the warp's lanes
      if (lane == 0) {
#pragma unroll
        for (int q = 0; q < K; ++q) {
          mv[warp * MAX_K + q] = tv[q];
          mi[warp * MAX_K + q] = ti[q];
        }
      }
    }
    __syncthreads();
    if (warp != 0) continue;

    // warp 0: the warps' lists, lane l of 1..RING_WARPS-1 holding warp l's
    const bool has = lane >= 1 && lane < RING_WARPS;
#pragma unroll
    for (int q = 0; q < K; ++q) {
      tv[q] = has ? mv[lane * MAX_K + q] : -INFINITY;
      ti[q] = has ? mi[lane * MAX_K + q] : BIG;
    }
    warp_merge<K>(tv, ti);                  // the block's warps

    // no peak (or a best one that is not finite): the global argmax
    float gv = tv[0];
    int gi = ti[0];
    if (!isfinite(tv[0])) {
      warp_argmax(W, G, lane, gv, gi);
    }
    // lane r < K: peak r, padded with the best, refined from the slot
    if (lane < K) {
      float v = tv[0];
      int i = ti[0];
#pragma unroll
      for (int q = 1; q < K; ++q)
        if (q == lane) { v = tv[q]; i = ti[q]; }
      if (!isfinite(v)) {
        v = isfinite(tv[0]) ? tv[0] : gv;
        i = isfinite(tv[0]) ? ti[0] : gi;
      }
      const int ia = i / Ge, ie = i - ia * Ge;
      float fa = (float)ia, fe = (float)ie;
      if (refine) {
        fa = refine_frac(W, i, ia, Ga, Ge);
        fe = refine_frac(W, i, ie, Ge, 1);
      }
      vals[b * K + lane] = v;
      az[b * K + lane] = __fadd_rn(az0, __fmul_rn(fa, daz));
      el[b * K + lane] = __fadd_rn(el0, __fmul_rn(fe, del));
    }
    if (j + RING_SLOTS < nw) {
      issue(j + RING_SLOTS, hv, hoff);
      if (j + RING_SLOTS + 1 < nw) fetch(j + RING_SLOTS + 1, hv, hoff);
    }
  }
}

constexpr int MAX_DEVICES = 64;

// The persistent grid: every block of smem bytes that fits on the card at
// once, and no more than there are windows. The shared-memory attribute
// and the SM count are set up once a device, the blocks that fit once for
// each size.
template <int K>
int launch_ring(const float* P, float* vals, float* az, float* el, int B,
                int Ga, int Ge, float az0, float daz, float el0, float del,
                int refine, cudaStream_t stream) {
  static int sms[MAX_DEVICES] = {};                    // 0: not set up yet
  static int fit_smem[MAX_DEVICES] = {}, fit[MAX_DEVICES] = {};
  const int smem = (int)ring_bytes(Ga * Ge);
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (sms[dev] == 0) {
    e = cudaFuncSetAttribute(peaks2d_ring<K>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM_LIMIT);
    if (e != cudaSuccess) return (int)e;
    e = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount,
                               dev);
    if (e != cudaSuccess) return (int)e;
  }
  if (fit_smem[dev] != smem) {
    int per_sm = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, peaks2d_ring<K>, RING_THREADS, smem);
    if (e != cudaSuccess) return (int)e;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    fit[dev] = per_sm * sms[dev];
    fit_smem[dev] = smem;
  }
  const int grid = B < fit[dev] ? B : fit[dev];
  peaks2d_ring<K><<<grid, RING_THREADS, smem, stream>>>(
      P, vals, az, el, B, Ga, Ge, az0, daz, el0, del, refine);
  return (int)cudaGetLastError();
}

}  // namespace

// P f32[B, Ga*Ge] → vals, az, el f32[B, k] (degrees), k <= 4, in the form
// `ring` names (1: the ring form, 0: the block form); a ring form the grid
// does not fit is refused.
extern "C" int doa_peaks2d_form(const void* P, void* vals, void* az,
                                void* el, int B, int Ga, int Ge, int k,
                                float az0, float daz, float el0, float del,
                                int refine, int ring, void* stream) {
  if (B < 1 || Ga < 2 || Ge < 2 || k < 1 || k > MAX_K ||
      (long long)Ga * Ge > 0x7fffffffLL - THREADS ||
      (ring && !ring_form((long long)Ga * Ge)))
    return (int)cudaErrorInvalidValue;
  if (ring) {
    auto go = [&](auto launch) {
      return launch((const float*)P, (float*)vals, (float*)az, (float*)el, B,
                    Ga, Ge, az0, daz, el0, del, refine,
                    (cudaStream_t)stream);
    };
    switch (k) {
      case 1: return go(launch_ring<1>);
      case 2: return go(launch_ring<2>);
      case 3: return go(launch_ring<3>);
      default: return go(launch_ring<4>);
    }
  }
  peaks2d_kernel<<<B, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)P, (float*)vals, (float*)az, (float*)el, Ga, Ge, k, az0,
      daz, el0, del, refine);
  return (int)cudaGetLastError();
}

// The same in the form ring_form(Ga * Ge) names.
extern "C" int doa_peaks2d(const void* P, void* vals, void* az, void* el,
                           int B, int Ga, int Ge, int k, float az0,
                           float daz, float el0, float del, int refine,
                           void* stream) {
  return doa_peaks2d_form(P, vals, az, el, B, Ga, Ge, k, az0, daz, el0, del,
                          refine, ring_form((long long)Ga * Ge) ? 1 : 0,
                          stream);
}
