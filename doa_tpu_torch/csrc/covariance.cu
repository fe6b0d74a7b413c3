// Kernels 8 and 12: covariance planes from sample planes (the planes path).
//
// Replaces the two Pallas kernels of doa_tpu/ops/pallas/covariance.py:
//
//   kernel 8, `_chunk_kernel` (chunk_grams_pallas): per chunk of g rows,
//     the Gram of Z = [Xr | Xi] (g x 2N), folded to the unnormalised planes
//     Rr = XrT Xr + XiT Xi = TL + BR and Ri = XiT Xr - XrT Xi = BL - TR
//     (f32[n, N, N] each); f32 products, or bf16-rounded inputs with f32
//     accumulation;
//   kernel 12, `_cov_kernel` (cov_windows_pallas, gcd(S, hop) < 64): one
//     full Gram per window of S rows starting at b*hop, divided by S and
//     folded the same way. Every window's Gram is computed in full, as on
//     the TPU (no sliding update: that is another computation with other
//     rounding).
//
// The TPU kernels stack Z in VMEM from the two planes. Here a block owns one
// chunk (kernel 8) or one window (kernel 12); its rows pass through shared
// memory STAGE values at a time as Z, and each thread owns an RT x RT
// register tile of the 2N x 2N Gram (RT = 4 when 4 | 2N, else 2) and a
// residue class of rows: K1's register-tile Gram (csrc/cov_gram.cu). The row
// classes are summed in a fixed order, then the epilogue writes the folded
// N x N planes, half of K1's output bytes.
//
// Inputs are two f32 plane pointers with a row stride and an element
// stride: separate planes have element stride 1; the planes of an
// interleaved complex64 capture are the views x[..., 0] and x[..., 1] of
// x f32[T, N, 2], element stride 2. In that case (xi == xr + 1) a block
// loads whole rows, two (re, im) pairs a thread as one float4 (one pair as
// a float2 when N is odd), and splits them into Z in shared memory: two
// stride-2 streams would waste half of every sector. Separate planes with
// contiguous rows load as float4 of one plane; any other strides one value
// a thread. Each thread's place in a stage is fixed, so no load divides.
//
// What bounds them on an H100: kernel 8 at c3 (T = 2^24, N = 16, g = 1024)
// reads 2 GiB once (0.64 ms at 3.35 TB/s) for 17.2 G FMAs (0.26 ms at the
// 67 TFLOP/s FP32 peak): memory. Kernel 12 re-reads each row S/hop times;
// consecutive windows overlap by (S - hop)/S, so most re-reads hit L2, and
// at small hops its FMAs (B*S*(2N)^2) bound it. True FP32 FMAs on the CUDA
// cores (no TF32); bf16 rounds on load (round to nearest even), and a
// product of two bf16 values is exact in FP32.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int THREADS = 256;
constexpr int STAGE = 4096;     // staged values (16 KiB); also the
                                // reduction buffer: THREADS * RT^2 <= STAGE

template <bool BF16>
__device__ __forceinline__ float load_cvt(float v) {
  if (BF16) return __bfloat162float(__float2bfloat16_rn(v));
  return v;
}

struct alignas(16) Vec4 { float v[4]; };
struct alignas(8) Vec2 { float v[2]; };
template <int RT> struct VecT;
template <> struct VecT<4> { using type = Vec4; };
template <> struct VecT<2> { using type = Vec2; };

// How a block stages rows into Z = [Xr | Xi] (host-chosen, see the entries)
enum Load : int {
  LOAD_ILV4 = 0,    // interleaved rows, float4 = two (re, im) pairs
  LOAD_ILV2 = 1,    // interleaved rows, float2 = one pair
  LOAD_PLANAR4 = 2, // planes with contiguous rows, float4 of one plane
  LOAD_GENERIC = 3  // any strides, one value a thread
};

// Block b: Gram of rows [b*step, b*step + rows) of Z = [Xr | Xi], folded.
// WIN: divide each Gram entry by S before the fold (kernel 12). Each
// thread's place in a stage (row offset, column) is fixed; a stage's rows
// advance by `rstep`, so the loads carry no division.
template <int RT, int LOAD, bool BF16, bool WIN>
__global__ void __launch_bounds__(THREADS)
planes_gram_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                   long long rs, long long es, float* __restrict__ rr_out,
                   float* __restrict__ ri_out, long long step, int rows,
                   int N, float S) {
  using V = typename VecT<RT>::type;
  __shared__ __align__(16) float tile[STAGE];
  const int n2 = 2 * N;
  const int tid = threadIdx.x;
  const int nt = n2 / RT;                 // register tiles per side
  const int ntiles = nt * nt;             // <= THREADS (host-checked)
  const int groups = THREADS / ntiles;    // residue classes of rows
  const int ti = tid % ntiles, rg = tid / ntiles;
  const bool active = rg < groups;
  const int i0 = (ti / nt) * RT, j0 = (ti % nt) * RT;
  const int TS = STAGE / n2;              // rows per stage
  const long long r0 = (long long)blockIdx.x * step;
  // loads a row takes: ILV4 N/2, ILV2 N, PLANAR4 2 * N/4, GENERIC 2N
  const int per_row = LOAD == LOAD_ILV4 ? N / 2
                      : LOAD == LOAD_ILV2 ? N
                      : LOAD == LOAD_PLANAR4 ? N / 2 : n2;
  const int rstep = THREADS / per_row;    // rows a pass of the block loads
  const int lt = tid / per_row, lc = tid - lt * per_row;
  const bool loader = lt < rstep;

  float acc[RT][RT];
#pragma unroll
  for (int r = 0; r < RT; ++r)
#pragma unroll
    for (int s = 0; s < RT; ++s) acc[r][s] = 0.f;

  for (int t0 = 0; t0 < rows; t0 += TS) {
    const int nr = min(TS, rows - t0);
    if (loader) {
      for (int t = lt; t < nr; t += rstep) {
        const long long row = (r0 + t0 + t) * rs;
        float* z = tile + t * n2;
        if (LOAD == LOAD_ILV4) {          // pairs 2lc, 2lc + 1
          const float4 v = *reinterpret_cast<const float4*>(xr + row + 4 * lc);
          z[2 * lc] = load_cvt<BF16>(v.x);
          z[2 * lc + 1] = load_cvt<BF16>(v.z);
          z[N + 2 * lc] = load_cvt<BF16>(v.y);
          z[N + 2 * lc + 1] = load_cvt<BF16>(v.w);
        } else if (LOAD == LOAD_ILV2) {   // pair lc
          const float2 v = *reinterpret_cast<const float2*>(xr + row + 2 * lc);
          z[lc] = load_cvt<BF16>(v.x);
          z[N + lc] = load_cvt<BF16>(v.y);
        } else if (LOAD == LOAD_PLANAR4) {  // 4 values of one plane
          const int q = N / 4;
          const bool im = lc >= q;
          const int c = 4 * (im ? lc - q : lc);
          const float4 v = *reinterpret_cast<const float4*>(
              (im ? xi : xr) + row + c);
          float4 w;
          w.x = load_cvt<BF16>(v.x);
          w.y = load_cvt<BF16>(v.y);
          w.z = load_cvt<BF16>(v.z);
          w.w = load_cvt<BF16>(v.w);
          *reinterpret_cast<float4*>(z + (im ? N : 0) + c) = w;
        } else {                          // column lc of Z
          const float v = lc < N ? xr[row + lc * es] : xi[row + (lc - N) * es];
          z[lc] = load_cvt<BF16>(v);
        }
      }
    }
    __syncthreads();
    if (active) {
      for (int t = rg; t < nr; t += groups) {
        const V a = *reinterpret_cast<const V*>(tile + t * n2 + i0);
        const V b = *reinterpret_cast<const V*>(tile + t * n2 + j0);
#pragma unroll
        for (int r = 0; r < RT; ++r)
#pragma unroll
          for (int s = 0; s < RT; ++s) acc[r][s] += a.v[r] * b.v[s];
      }
    }
    __syncthreads();
  }

  // the row classes' partial Grams, summed in a fixed order into tile[0:n2^2]
  if (active) {
#pragma unroll
    for (int r = 0; r < RT; ++r)
#pragma unroll
      for (int s = 0; s < RT; ++s)
        tile[(rg * n2 + i0 + r) * n2 + j0 + s] = acc[r][s];
  }
  __syncthreads();
  for (int idx = tid; idx < n2 * n2; idx += THREADS) {
    float sum = tile[idx];
    for (int q = 1; q < groups; ++q) sum += tile[q * n2 * n2 + idx];
    tile[idx] = sum;
  }
  __syncthreads();

  // fold: Rr = TL + BR, Ri = BL - TR (each entry / S first for windows)
  const long long ob = (long long)blockIdx.x * N * N;
  for (int idx = tid; idx < N * N; idx += THREADS) {
    const int i = idx / N, j = idx - i * N;
    float tl = tile[i * n2 + j], br = tile[(N + i) * n2 + N + j];
    float bl = tile[(N + i) * n2 + j], tr = tile[i * n2 + N + j];
    if (WIN) {
      tl = __fdiv_rn(tl, S);
      br = __fdiv_rn(br, S);
      bl = __fdiv_rn(bl, S);
      tr = __fdiv_rn(tr, S);
    }
    rr_out[ob + idx] = tl + br;
    ri_out[ob + idx] = bl - tr;
  }
}

template <bool BF16, bool WIN>
int launch(const float* xr, const float* xi, long long rs, long long es,
           int load, float* rr, float* ri, int n_blocks, long long step,
           int rows, int N, float S, cudaStream_t stream) {
  const int n2 = 2 * N;
  if (n_blocks < 1 || rows < 1 || N < 1 || load < 0 || load > 3)
    return (int)cudaErrorInvalidValue;
#define DOA_PLANES_LAUNCH(RT, L)                                             \
  planes_gram_kernel<RT, L, BF16, WIN><<<n_blocks, THREADS, 0, stream>>>(    \
      xr, xi, rs, es, rr, ri, step, rows, N, S)
  if (n2 % 4 == 0 && n2 <= 64) {          // N even: every load form
    switch (load) {
      case LOAD_ILV4: DOA_PLANES_LAUNCH(4, LOAD_ILV4); break;
      case LOAD_ILV2: DOA_PLANES_LAUNCH(4, LOAD_ILV2); break;
      case LOAD_PLANAR4:
        if (N % 4) return (int)cudaErrorInvalidValue;
        DOA_PLANES_LAUNCH(4, LOAD_PLANAR4);
        break;
      default: DOA_PLANES_LAUNCH(4, LOAD_GENERIC); break;
    }
  } else if (n2 <= 30) {                  // N odd: no pair of pairs
    switch (load) {
      case LOAD_ILV2: DOA_PLANES_LAUNCH(2, LOAD_ILV2); break;
      case LOAD_GENERIC: DOA_PLANES_LAUNCH(2, LOAD_GENERIC); break;
      default: return (int)cudaErrorInvalidValue;
    }
  } else {
    return (int)cudaErrorInvalidValue;
  }
#undef DOA_PLANES_LAUNCH
  return (int)cudaGetLastError();
}

}  // namespace

// Kernel 8. Planes xr, xi: element (t, c) at x[t*rs + c*es]. load (the
// host checks its conditions): 0 interleaved (xi == xr + 1, es == 2), N
// even, rows 16-byte aligned; 1 interleaved, rows 8-byte aligned; 2 es == 1,
// 4 | N, rows of both planes 16-byte aligned; 3 any strides.
// rr, ri: f32[n_chunks, N, N]. dtype 0 = float32, 1 = bfloat16 inputs.
// N: 2N a multiple of 4 up to 64, or N <= 15.
extern "C" int doa_planes_chunk_grams(const void* xr, const void* xi,
                                      long long rs, long long es,
                                      int load, void* rr, void* ri,
                                      int n_chunks, int g, int N, int dtype,
                                      void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (g < 1) return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case 0:
      return launch<false, false>((const float*)xr, (const float*)xi, rs, es,
                                  load, (float*)rr, (float*)ri, n_chunks,
                                  g, g, N, 1.f, s);
    case 1:
      return launch<true, false>((const float*)xr, (const float*)xi, rs, es,
                                 load, (float*)rr, (float*)ri, n_chunks,
                                 g, g, N, 1.f, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Kernel 12. Window b: rows [b*hop, b*hop + S); rr, ri: f32[B, N, N] =
// the folded Gram / S. Same plane layout and N rule as kernel 8.
extern "C" int doa_planes_cov_windows(const void* xr, const void* xi,
                                      long long rs, long long es,
                                      int load, void* rr, void* ri,
                                      int B, int S, int hop, int N,
                                      void* stream) {
  if (S < 1 || hop < 1) return (int)cudaErrorInvalidValue;
  return launch<false, true>((const float*)xr, (const float*)xi, rs, es,
                             load, (float*)rr, (float*)ri, B, hop, S, N,
                             (float)S, (cudaStream_t)stream);
}
