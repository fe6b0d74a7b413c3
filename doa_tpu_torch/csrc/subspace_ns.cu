// Kernel 11: the cold Newton-Schulz signal subspace, in two forms.
//
// Replaces the Pallas kernel doa_tpu/ops/pallas/subspace.py:47
// `_subspace_kernel` (subspace_packed_pallas, the fused path's
// subspace_impl="pallas" route). Per window of E f32[n2, n2] (n2 = 2N):
//
//   Ep = E / max(tr(E)/n2, 1e-30); `squarings` times Ep = Ep Ep followed
//   by Ep = (Ep + Ep^T)/2; Vt = rows 0..K2-1 of Ep; then `rounds` rounds of
//   [Vt = Vt Ep (not in round 0); Jacobi-preconditioned Newton-Schulz:
//    G = Vt Vt^T, d = 1/sqrt(max(diag G, 1e-30)), G~ = G o d d^T,
//    fro = ||G~||_F, Y = G~/max(fro, 1e-30), Z = I, n times
//    T = 1.5 I - 0.5 Z Y, Y = Y T, Z = T Z (n = ns_iters in the first and
//    last rounds, ns_iters_mid between), Vt = Z^T (d o Vt)/sqrt(max(fro,
//    1e-30))].
//
// The TPU kernel packs 128/n2 windows into one block-diagonal tile for the
// MXU and consolidates W windows' chains into one; block-diagonal algebra
// is closed, so each window's result is the per-window chain computed here.
//
// What bounds it on an H100: at the headline (B = 16384, n2 = 32, K2 = 4,
// 8 rounds, squarings 0) E is read once and Vt written once (64 + 8 MiB,
// 0.0225 ms at 3.35 TB/s); the chain is ~89 kFLOP a window, ~1.5 GFLOP in
// all (0.022 ms at 67 TFLOP/s). Neither sets its pace: the chain is a
// sequence of dependent steps on 2K x 2K matrices (72 Newton-Schulz steps
// of three products at the headline), so a window's time is the latency of
// those steps, and the kernel's the rate at which the SMs overlap windows.
// FP32 FMAs throughout, each product summed in index order (no TF32, no
// fast math: 1.0f / sqrtf). Two forms, chosen by warp_form(n2, K2):
//
// Warp form, n2 <= WARP_MAX_N2 = 64 and K2 <= WARP_MAX_K2 = 8 (the
// headline (32, 4), ULA-12 (24, 6), ULA-8 (16, 4)): one warp a window, up
// to MAX_WARPS windows a block, and no block barrier at all: a window's
// steps wait only on its own warp's shuffles.
// - E: scaled by 1/tr on its way into the warp's slice of shared memory,
//   16 bytes a load (the trace from E's diagonal in device memory, the
//   block form's sum order). With squarings, E^2 goes to a second slice of
//   stride n2 + 1 (its column reads in the symmetrisation conflict-free),
//   SQ_ROWS rows a pass, and its symmetrised half back into the first.
// - Vt: lane holds columns j = lane + 32c (c < CPL = n2 / 32 rounded up)
//   of every row in registers. Each apply Vt = Vt Ep stores them
//   transposed to the slice (Vs[n][k]: a row of n a 16- or 8-byte load),
//   then sums over n in order, E read across lanes, Vt[.][n] broadcast.
// - Gram: G's upper triangle, each entry the lane's CPL products in c
//   order, then the xor shuffle tree (the entries' trees independent, so
//   their shuffles overlap); every lane ends with all of G and computes
//   d, fro and the 1/sqrt terms itself.
// - Chain in registers, on half-warps: lanes 0-15 hold Y, lanes 16-31 Z,
//   an entry (k, l) a lane and slot (RPS = 16 / K2 rows a slot, SLOTS =
//   K2 / RPS rounded up: 1 slot at K2 <= 4, 3 at 6, 4 at 8). Both halves
//   compute T (row of Z, column of Y by shuffles), then in the same
//   shuffles the lower half forms Y T (row of Y, column of T) and the
//   upper T Z (row of T, column of Z): 2 K2 (SLOTS + 1) shuffles a step,
//   16 at K2 = 4.
// - Output: Z^T (d o Vt) / sqrt(fro), Z stored transposed to the slice and
//   read a broadcast column at a time, straight from registers to the
//   output rows.
// What sets its pace (exp_subspace_ns.py on an H100 80GB HBM3 at 700 W):
// the latency of each window's chain of dependent steps against the warps
// an SM holds (56 registers a thread at the headline: 36 warps). A Gram by
// a shuffle reduce-scatter onto the chain's lanes (24 shuffles a round at
// K2 = 4, not 50) ran 15-20% slower: its shuffle levels depend on each
// other, where the xor trees' do not. A wider squaring (16 rows a pass,
// 16-byte row loads) cost registers and ran slower.
//
// Block form, everything else kernel 11 takes (n2 <= 128, K2 <= 16; c5's
// subbands at (128, 4)): the first form, one window a 128-thread block,
// E, its square, Vt and the chain in shared memory, each product one
// output entry a thread behind a block barrier (~200 barriers a window at
// the headline's shape).

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;
constexpr int MAX_N2 = 128;
constexpr int MAX_K2 = 16;
constexpr size_t SMEM_LIMIT = 232448;   // bytes a block may use (H100)
constexpr int WARP_MAX_N2 = 64;         // the warp form's shapes
constexpr int WARP_MAX_K2 = 8;
constexpr int MAX_WARPS = 4;            // warp form: windows a block
constexpr int WARP_BLOCK_SMEM = 49152;  // warp form: shared bytes a block
constexpr int SQ_ROWS = 8;              // warp form: rows of E^2 a pass
constexpr unsigned FULL = 0xffffffffu;

__host__ __device__ constexpr bool warp_form(int n2, int K2) {
  return n2 <= WARP_MAX_N2 && K2 <= WARP_MAX_K2;
}

// ----------------------------------------------------------- block form

// the sum over the block of one value a thread, returned to every thread;
// red: 32 floats of shared memory
__device__ float block_sum(float v, float* red) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();                       // red is free again
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float s = 0.f;
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) s += red[w];
  return s;
}

// C[r][c] = sum_m A[r][m] B[m][c] (R x Cc, depth Kd), one entry a thread
__device__ void matmul(const float* A, int lda, const float* B, int ldb,
                       float* C, int ldc, int R, int Cc, int Kd) {
  for (int idx = threadIdx.x; idx < R * Cc; idx += blockDim.x) {
    const int r = idx / Cc, c = idx - r * Cc;
    float s = 0.f;
    for (int m = 0; m < Kd; ++m) s = fmaf(A[r * lda + m], B[m * ldb + c], s);
    C[r * ldc + c] = s;
  }
}

__global__ void __launch_bounds__(THREADS)
subspace_ns_kernel(const float* __restrict__ E, float* __restrict__ Vt_out,
                   int n2, int K2, int rounds, int ns_iters, int ns_iters_mid,
                   int squarings) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int nn = n2 * n2, kn = K2 * n2, kk = K2 * K2;
  float* A = smem;                              // Ep
  float* Sq = A + nn;                           // the square (squarings > 0)
  float* V = Sq + (squarings > 0 ? nn : 0);     // Vt, K2 x n2
  float* W = V + kn;
  float* G = W + kn;                            // the 2K x 2K chain
  float* Y = G + kk;
  float* Z = Y + kk;
  float* T = Z + kk;
  float* Yn = T + kk;
  float* Zn = Yn + kk;
  float* d = Zn + kk;
  float* red = d + K2;                          // 32 floats

  // E in, 16 bytes a load (n2 even: n2^2 a multiple of 4)
  const float4* E4 =
      reinterpret_cast<const float4*>(E + (size_t)blockIdx.x * nn);
  float4* A4 = reinterpret_cast<float4*>(A);
  for (int i = tid; i < nn / 4; i += blockDim.x) A4[i] = E4[i];
  __syncthreads();

  // trace normalisation
  const float tr = block_sum(tid < n2 ? A[tid * n2 + tid] : 0.f, red);
  const float inv_tr = 1.0f / fmaxf(tr / (float)n2, 1e-30f);
  for (int i = tid; i < nn; i += blockDim.x) A[i] *= inv_tr;
  __syncthreads();

  // E^(2^squarings), symmetrised after each squaring
  for (int s = 0; s < squarings; ++s) {
    matmul(A, n2, A, n2, Sq, n2, n2, n2, n2);
    __syncthreads();
    for (int i = tid; i < nn; i += blockDim.x) {
      const int r = i / n2, c = i - r * n2;
      A[i] = 0.5f * (Sq[i] + Sq[c * n2 + r]);
    }
    __syncthreads();
  }

  for (int i = tid; i < kn; i += blockDim.x) V[i] = A[i];   // rows 0..K2-1
  __syncthreads();

  for (int r = 0; r < rounds; ++r) {
    if (r > 0) {                                  // apply: Vt = Vt Ep
      matmul(V, n2, A, n2, W, n2, K2, n2, n2);
      __syncthreads();
      float* t = V; V = W; W = t;
    }
    // Gram of the rows
    for (int idx = tid; idx < kk; idx += blockDim.x) {
      const int k = idx / K2, l = idx - k * K2;
      float s = 0.f;
      for (int n = 0; n < n2; ++n) s = fmaf(V[k * n2 + n], V[l * n2 + n], s);
      G[idx] = s;
    }
    __syncthreads();
    if (tid < K2) d[tid] = 1.0f / sqrtf(fmaxf(G[tid * K2 + tid], 1e-30f));
    __syncthreads();
    // Jacobi preconditioning, then the Frobenius norm of the result
    float part = 0.f;
    for (int idx = tid; idx < kk; idx += blockDim.x) {
      const int k = idx / K2, l = idx - k * K2;
      const float g = G[idx] * d[l] * d[k];
      G[idx] = g;
      part += g * g;
    }
    const float fro = sqrtf(block_sum(part, red));
    const float inv = 1.0f / fmaxf(fro, 1e-30f);
    for (int idx = tid; idx < kk; idx += blockDim.x) {
      const int k = idx / K2, l = idx - k * K2;
      Y[idx] = G[idx] * inv;
      Z[idx] = k == l ? 1.f : 0.f;
    }
    __syncthreads();
    const int n_ns = (r == 0 || r == rounds - 1) ? ns_iters : ns_iters_mid;
    for (int it = 0; it < n_ns; ++it) {
      for (int idx = tid; idx < kk; idx += blockDim.x) {
        const int k = idx / K2, l = idx - k * K2;
        float s = 0.f;
        for (int m = 0; m < K2; ++m) s = fmaf(Z[k * K2 + m], Y[m * K2 + l], s);
        T[idx] = (k == l ? 1.5f : 0.f) - 0.5f * s;
      }
      __syncthreads();
      matmul(Y, K2, T, K2, Yn, K2, K2, K2, K2);
      matmul(T, K2, Z, K2, Zn, K2, K2, K2, K2);
      __syncthreads();
      float* t = Y; Y = Yn; Yn = t;
      t = Z; Z = Zn; Zn = t;
    }
    // Vt = Z^T (d o Vt) / sqrt(max(fro, 1e-30))
    const float sc = 1.0f / sqrtf(fmaxf(fro, 1e-30f));
    for (int idx = tid; idx < kn; idx += blockDim.x) {
      const int l = idx / n2, n = idx - l * n2;
      float s = 0.f;
      for (int k = 0; k < K2; ++k)
        s = fmaf(Z[k * K2 + l], V[k * n2 + n] * d[k], s);
      W[idx] = s * sc;
    }
    __syncthreads();
    float* t = V; V = W; W = t;
  }

  float* out = Vt_out + (size_t)blockIdx.x * kn;
  for (int i = tid; i < kn; i += blockDim.x) out[i] = V[i];
}

int launch_block(const float* E, float* Vt, int B, int n2, int K2,
                 int rounds, int ns_iters, int ns_iters_mid, int squarings,
                 cudaStream_t stream) {
  const size_t floats = (size_t)n2 * n2 * (squarings > 0 ? 2 : 1) +
                        2 * (size_t)K2 * n2 + 6 * (size_t)K2 * K2 + K2 + 32;
  const size_t smem = floats * sizeof(float);
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        subspace_ns_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  subspace_ns_kernel<<<B, THREADS, smem, stream>>>(
      E, Vt, n2, K2, rounds, ns_iters, ns_iters_mid, squarings);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------ warp form

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
  return v;
}

// floats of a warp's slice: E (n2^2), its square (n2 (n2 + 1), rounded up
// to 16 bytes; squarings > 0 only), Vt transposed (n2 K2)
__host__ __device__ inline int warp_floats(int n2, int K2, int squarings) {
  const int sq = squarings > 0 ? (n2 * (n2 + 1) + 3) / 4 * 4 : 0;
  return n2 * n2 + sq + n2 * K2;
}

// the index of G[a][b], a <= b, in the packed upper triangle
template <int K2>
__device__ __forceinline__ constexpr int tri(int a, int b) {
  return a * K2 - a * (a - 1) / 2 + (b - a);
}

// K2 floats at p (16-byte aligned for K2 % 4 == 0, else 8-byte)
template <int K2>
__device__ __forceinline__ void load_col(const float* p, float (&x)[K2]) {
  if constexpr (K2 % 4 == 0) {
#pragma unroll
    for (int q = 0; q < K2 / 4; ++q) {
      const float4 t = reinterpret_cast<const float4*>(p)[q];
      x[4 * q] = t.x; x[4 * q + 1] = t.y; x[4 * q + 2] = t.z;
      x[4 * q + 3] = t.w;
    }
  } else {
#pragma unroll
    for (int q = 0; q < K2 / 2; ++q) {
      const float2 t = reinterpret_cast<const float2*>(p)[q];
      x[2 * q] = t.x; x[2 * q + 1] = t.y;
    }
  }
}

template <int K2>
__device__ __forceinline__ void store_col(float* p, const float (&x)[K2]) {
  if constexpr (K2 % 4 == 0) {
#pragma unroll
    for (int q = 0; q < K2 / 4; ++q)
      reinterpret_cast<float4*>(p)[q] =
          make_float4(x[4 * q], x[4 * q + 1], x[4 * q + 2], x[4 * q + 3]);
  } else {
#pragma unroll
    for (int q = 0; q < K2 / 2; ++q)
      reinterpret_cast<float2*>(p)[q] = make_float2(x[2 * q], x[2 * q + 1]);
  }
}

// Ep = Ep Ep, then Ep = (Ep + Ep^T)/2, in the warp's slices A and Sq
// (stride n2 + 1); lane: columns j = lane + 32c
template <int CPL>
__device__ void square(float* A, float* Sq, int n2, int lane) {
  const int ld = n2 + 1;
  for (int i0 = 0; i0 < n2; i0 += SQ_ROWS) {
    float acc[SQ_ROWS][CPL];
#pragma unroll
    for (int r = 0; r < SQ_ROWS; ++r)
#pragma unroll
      for (int c = 0; c < CPL; ++c) acc[r][c] = 0.f;
    for (int m = 0; m < n2; m += 2) {
      float e0[CPL], e1[CPL];
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        const int j = lane + 32 * c;
        e0[c] = j < n2 ? A[m * n2 + j] : 0.f;
        e1[c] = j < n2 ? A[(m + 1) * n2 + j] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < SQ_ROWS; ++r) {
        if (i0 + r < n2) {
          const float2 a =
              *reinterpret_cast<const float2*>(A + (i0 + r) * n2 + m);
#pragma unroll
          for (int c = 0; c < CPL; ++c) {
            acc[r][c] = fmaf(a.x, e0[c], acc[r][c]);
            acc[r][c] = fmaf(a.y, e1[c], acc[r][c]);
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < SQ_ROWS; ++r)
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        const int j = lane + 32 * c;
        if (i0 + r < n2 && j < n2) Sq[(i0 + r) * ld + j] = acc[r][c];
      }
  }
  __syncwarp();
  for (int i = 0; i < n2; ++i)
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      const int j = lane + 32 * c;
      if (j < n2) A[i * n2 + j] = 0.5f * (Sq[i * ld + j] + Sq[j * ld + i]);
    }
  __syncwarp();
}

// Vt = Vt Ep: v (lane: columns lane + 32c of each row) stored transposed
// to Vs, then each new column summed over n in order
template <int K2, int CPL>
__device__ __forceinline__ void apply(float (&v)[K2][CPL], const float* A,
                                      float* Vs, int n2, int lane) {
  __syncwarp();                     // the last apply's reads of Vs are done
#pragma unroll
  for (int c = 0; c < CPL; ++c) {
    const int j = lane + 32 * c;
    float x[K2];
#pragma unroll
    for (int k = 0; k < K2; ++k) x[k] = v[k][c];
    if (j < n2) store_col<K2>(Vs + j * K2, x);
  }
  __syncwarp();
#pragma unroll
  for (int k = 0; k < K2; ++k)
#pragma unroll
    for (int c = 0; c < CPL; ++c) v[k][c] = 0.f;
#pragma unroll 4
  for (int n = 0; n < n2; ++n) {
    float e[CPL], vn[K2];
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      const int j = lane + 32 * c;
      e[c] = j < n2 ? A[n * n2 + j] : 0.f;
    }
    load_col<K2>(Vs + n * K2, vn);
#pragma unroll
    for (int k = 0; k < K2; ++k)
#pragma unroll
      for (int c = 0; c < CPL; ++c) v[k][c] = fmaf(vn[k], e[c], v[k][c]);
  }
}

// One round's orthonormalisation of the rows in v, on the warp: the Gram,
// the Newton-Schulz chain of n_ns steps, and Vt = Z^T (d o Vt)/sqrt(fro);
// Zs: K2^2 floats of the warp's slice, free until the next apply. The
// chain's lane map: half h = lane / 16 holds Y (0) or Z (1); in slot s
// lane i = lane % 16 holds entry (s RPS + i / K2, l = i % K2), rl = i - l
// the first lane of its row.
template <int K2, int CPL>
__device__ __forceinline__ void orthonormalise(float (&v)[K2][CPL],
                                               float* Zs, int n_ns,
                                               int lane) {
  constexpr int RPS = 16 / K2;                   // chain rows a slot
  constexpr int SLOTS = (K2 + RPS - 1) / RPS;    // chain entries a lane
  const int h = lane >> 4, i = lane & 15;
  const int l = i % K2, rl = i - l;
  // Gram's upper triangle on every lane; d, fro from it on every lane
  float g[K2 * (K2 + 1) / 2];
#pragma unroll
  for (int a = 0; a < K2; ++a)
#pragma unroll
    for (int bb = a; bb < K2; ++bb) {
      float p = 0.f;
#pragma unroll
      for (int c = 0; c < CPL; ++c) p = fmaf(v[a][c], v[bb][c], p);
      g[tri<K2>(a, bb)] = warp_sum(p);
    }
  float d[K2];
#pragma unroll
  for (int k = 0; k < K2; ++k)
    d[k] = 1.0f / sqrtf(fmaxf(g[tri<K2>(k, k)], 1e-30f));
  float fro2 = 0.f;
#pragma unroll
  for (int a = 0; a < K2; ++a)
#pragma unroll
    for (int bb = 0; bb < K2; ++bb) {
      const float gt = g[a <= bb ? tri<K2>(a, bb) : tri<K2>(bb, a)] *
                       d[bb] * d[a];
      fro2 = fmaf(gt, gt, fro2);
    }
  const float fro = sqrtf(fro2);
  const float inv = 1.0f / fmaxf(fro, 1e-30f);
  // Y = G~ / fro on the lower half, Z = I on the upper
  float dl = 0.f;
#pragma unroll
  for (int bb = 0; bb < K2; ++bb)
    if (l == bb) dl = d[bb];
  float M[SLOTS];
#pragma unroll
  for (int s = 0; s < SLOTS; ++s) {
    const int k = s * RPS + i / K2;
    float gk = 0.f, dk = 0.f;
#pragma unroll
    for (int a = s * RPS; a < (s + 1) * RPS; ++a) {
      if (a < K2 && k == a) dk = d[a];
#pragma unroll
      for (int bb = 0; bb < K2; ++bb)
        if (a < K2 && k == a && l == bb)
          gk = g[a <= bb ? tri<K2>(a, bb) : tri<K2>(bb, a)];
    }
    M[s] = h ? (k == l ? 1.f : 0.f) : gk * dl * dk * inv;
  }
  for (int it = 0; it < n_ns; ++it) {
    // T = 1.5 I - 0.5 Z Y: row k of Z (upper half), column l of Y (lower)
    float col[K2], T[SLOTS];
#pragma unroll
    for (int m = 0; m < K2; ++m)
      col[m] = __shfl_sync(FULL, M[m / RPS], (m % RPS) * K2 + l);
#pragma unroll
    for (int s = 0; s < SLOTS; ++s) {
      float acc = 0.f;
#pragma unroll
      for (int m = 0; m < K2; ++m)
        acc = fmaf(__shfl_sync(FULL, M[s], 16 + rl + m), col[m], acc);
      const int k = s * RPS + i / K2;
      T[s] = (k == l ? 1.5f : 0.f) - 0.5f * acc;
    }
    // lower: Y = Y T (row of Y, column of T); upper: Z = T Z (row of T,
    // column of Z), each half shuffling within itself
#pragma unroll
    for (int m = 0; m < K2; ++m)
      col[m] = __shfl_sync(FULL, h ? M[m / RPS] : T[m / RPS],
                           16 * h + (m % RPS) * K2 + l);
#pragma unroll
    for (int s = 0; s < SLOTS; ++s) {
      float acc = 0.f;
#pragma unroll
      for (int m = 0; m < K2; ++m)
        acc = fmaf(__shfl_sync(FULL, h ? T[s] : M[s], 16 * h + rl + m),
                   col[m], acc);
      M[s] = acc;
    }
  }
  // Vt = Z^T (d o Vt) / sqrt(max(fro, 1e-30)): Z stored transposed to Zs,
  // a column of Z then one broadcast load a row of the output
  __syncwarp();                     // the apply's reads of Zs are done
#pragma unroll
  for (int s = 0; s < SLOTS; ++s) {
    const int k = s * RPS + i / K2;
    if (h && i < RPS * K2 && k < K2) Zs[l * K2 + k] = M[s];
  }
  __syncwarp();
  const float sc = 1.0f / sqrtf(fmaxf(fro, 1e-30f));
  float w[K2][CPL];
#pragma unroll
  for (int lo = 0; lo < K2; ++lo) {
    float z[K2];
    load_col<K2>(Zs + lo * K2, z);
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      float s = 0.f;
#pragma unroll
      for (int k = 0; k < K2; ++k) s = fmaf(z[k], v[k][c] * d[k], s);
      w[lo][c] = s * sc;
    }
  }
#pragma unroll
  for (int k = 0; k < K2; ++k)
#pragma unroll
    for (int c = 0; c < CPL; ++c) v[k][c] = w[k][c];
}

template <int K2, int CPL>
__global__ void __launch_bounds__(MAX_WARPS * 32)
subspace_ns_warp(const float* __restrict__ E, float* __restrict__ Vt_out,
                 int B, int n2, int rounds, int ns_iters, int ns_iters_mid,
                 int squarings) {
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x * (blockDim.x >> 5) + warp;
  if (b >= B) return;               // warps are independent: no block sync
  const int nn = n2 * n2;
  float* A = smem + warp * warp_floats(n2, K2, squarings);   // Ep
  float* Sq = A + nn;                                         // E^2
  float* Vs = A + warp_floats(n2, K2, squarings) - n2 * K2;   // Vs[n][k]
  const float* Eb = E + (size_t)b * nn;

  // trace normalisation: the block form's sum (a tree over the first 32
  // diagonal entries, plus one over the rest); E scaled on its way in
  const float t0 = lane < n2 ? Eb[lane * (n2 + 1)] : 0.f;
  const float t1 = lane + 32 < n2 ? Eb[(lane + 32) * (n2 + 1)] : 0.f;
  const float tr = warp_sum(t0) + warp_sum(t1);
  const float inv_tr = 1.0f / fmaxf(tr / (float)n2, 1e-30f);
  const float4* E4 = reinterpret_cast<const float4*>(Eb);
  float4* A4 = reinterpret_cast<float4*>(A);
#pragma unroll 4
  for (int i = lane; i < nn / 4; i += 32) {
    float4 e = E4[i];
    e.x *= inv_tr; e.y *= inv_tr; e.z *= inv_tr; e.w *= inv_tr;
    A4[i] = e;
  }
  __syncwarp();
  for (int s = 0; s < squarings; ++s) square<CPL>(A, Sq, n2, lane);

  float v[K2][CPL];                 // Vt: columns lane + 32c of each row
#pragma unroll
  for (int k = 0; k < K2; ++k)
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      const int j = lane + 32 * c;
      v[k][c] = j < n2 ? A[k * n2 + j] : 0.f;
    }
  for (int r = 0; r < rounds; ++r) {
    if (r > 0) apply<K2, CPL>(v, A, Vs, n2, lane);
    orthonormalise<K2, CPL>(
        v, Vs, (r == 0 || r == rounds - 1) ? ns_iters : ns_iters_mid, lane);
  }

  float* out = Vt_out + (size_t)b * K2 * n2;
#pragma unroll
  for (int k = 0; k < K2; ++k)
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      const int j = lane + 32 * c;
      if (j < n2) out[k * n2 + j] = v[k][c];
    }
}

template <int K2, int CPL>
int launch_warp(const float* E, float* Vt, int B, int n2, int rounds,
                int ns_iters, int ns_iters_mid, int squarings,
                cudaStream_t stream) {
  const int per_warp =
      (int)sizeof(float) * warp_floats(n2, K2, squarings);   // <= 35 KiB
  int warps = WARP_BLOCK_SMEM / per_warp;
  warps = warps > MAX_WARPS ? MAX_WARPS : warps < 1 ? 1 : warps;
  const int blocks = (B + warps - 1) / warps;
  subspace_ns_warp<K2, CPL><<<blocks, warps * 32, per_warp * warps,
                              stream>>>(E, Vt, B, n2, rounds, ns_iters,
                                        ns_iters_mid, squarings);
  return (int)cudaGetLastError();
}

template <int CPL>
int launch_warp_k(const float* E, float* Vt, int B, int n2, int K2,
                  int rounds, int ns_iters, int ns_iters_mid, int squarings,
                  cudaStream_t st) {
  switch (K2) {
    case 2: return launch_warp<2, CPL>(E, Vt, B, n2, rounds, ns_iters,
                                       ns_iters_mid, squarings, st);
    case 4: return launch_warp<4, CPL>(E, Vt, B, n2, rounds, ns_iters,
                                       ns_iters_mid, squarings, st);
    case 6: return launch_warp<6, CPL>(E, Vt, B, n2, rounds, ns_iters,
                                       ns_iters_mid, squarings, st);
    default: return launch_warp<8, CPL>(E, Vt, B, n2, rounds, ns_iters,
                                        ns_iters_mid, squarings, st);
  }
}

}  // namespace

// E f32[B, n2, n2] (16-byte aligned) → Vt f32[B, K2, n2]. n2 even, at
// most 128; K2 even, at most min(16, n2); rounds >= 1. warp: 1 the warp
// form (warp_form(n2, K2) must hold), 0 the block form.
extern "C" int doa_subspace_ns_form(const void* E, void* Vt, int B, int n2,
                                    int K2, int rounds, int ns_iters,
                                    int ns_iters_mid, int squarings, int warp,
                                    void* stream) {
  if (B < 1 || n2 < 2 || n2 > MAX_N2 || n2 % 2 || K2 < 2 || K2 > MAX_K2 ||
      K2 % 2 || K2 > n2 || rounds < 1 || ns_iters < 0 || ns_iters_mid < 0 ||
      squarings < 0 || (warp && !warp_form(n2, K2)))
    return (int)cudaErrorInvalidValue;
  const float* e = (const float*)E;
  float* vt = (float*)Vt;
  cudaStream_t st = (cudaStream_t)stream;
  if (!warp)
    return launch_block(e, vt, B, n2, K2, rounds, ns_iters, ns_iters_mid,
                        squarings, st);
  if (n2 <= 32)
    return launch_warp_k<1>(e, vt, B, n2, K2, rounds, ns_iters, ns_iters_mid,
                            squarings, st);
  return launch_warp_k<2>(e, vt, B, n2, K2, rounds, ns_iters, ns_iters_mid,
                          squarings, st);
}

// The same in the form warp_form(n2, K2) names.
extern "C" int doa_subspace_ns(const void* E, void* Vt, int B, int n2, int K2,
                               int rounds, int ns_iters, int ns_iters_mid,
                               int squarings, void* stream) {
  return doa_subspace_ns_form(E, Vt, B, n2, K2, rounds, ns_iters,
                              ns_iters_mid, squarings,
                              warp_form(n2, K2) ? 1 : 0, stream);
}
