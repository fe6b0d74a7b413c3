// The tracker's scan: all B windows of doa_tpu/tracking.py's alpha-beta
// tracker in one launch (kernel "track").
//
// Replaces no Pallas kernel: it takes the place of the XLA lax.scan of
// doa_tpu/tracking.py::track_batch (tracking.py:110-124), the tracker's
// device program. Run as torch ops, one window costs about 70 small
// launches (doa_tpu_torch/tracking.py::_step, the plain version); c4's
// 4095 windows of a 2^21-sample capture would be some 290 thousand.
//
// What it computes, window by window from the input state (angle, vel,
// active, missed, age of M slots) to the output state, with the tracks
// out[b, m] (the angle of a confirmed slot, else NaN):
//   pred = angle + vel;
//   association, tracks in slot order: cost_j = |pred_m - d_j| (+inf for
//     a detection already used), j = the first NaN cost, else the first
//     minimum; matched if active_m and cost_j <= gate; j is then used;
//   update: matched slots angle = pred + alpha*(d_j - pred), vel = vel +
//     beta*(d_j - pred), missed = 0; the others angle = pred, missed + 1;
//     active while missed <= max_missed; age + 1 while active, else 0;
//   spawn: the detections in a stable descending order of their values
//     (NaN values last), each not used takes the first free slot.
// Every sum and product rounds on its own (__fadd_rn, __fsub_rn,
// __fmul_rn: no contraction into an FMA), so the kernel is bit-equal to
// the plain version, whose torch ops round each step.
//
// Design: one block of one warp. The detections come in by stages of
// whole windows (coalesced loads into shared memory); the state lives in
// shared memory, one slot a lane. Lane m predicts and updates slot m; lane
// j ranks detection j for the spawn order; lane 0 runs the association in
// slot order and the spawns, as the reference's loops do, on bit masks of
// the used detections and the free slots. __syncwarp orders the steps.
//
// Bound (bytes): the detections read once (B*K*8 bytes) and the tracks
// written once (B*M*4), over 3.35 TB/s: 0.04 us at c4's B = 4095, K = 2,
// M = 4. The kernel is set by its dependent chain (a window's steps wait
// on the one before), not by this bound.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int LANES = 32;       // max_tracks and K at most this
constexpr int STAGE = 4096;     // detection values staged at a time

__global__ void __launch_bounds__(LANES)
track_kernel(const float* __restrict__ ang, const float* __restrict__ val,
             int B, int K, const float* __restrict__ angle0,
             const float* __restrict__ vel0,
             const unsigned char* __restrict__ active0,
             const int* __restrict__ missed0, const int* __restrict__ age0,
             float* __restrict__ angle1, float* __restrict__ vel1,
             unsigned char* __restrict__ active1, int* __restrict__ missed1,
             int* __restrict__ age1, float* __restrict__ out, int M,
             float gate, float alpha, float beta, int max_missed,
             int min_age) {
  __shared__ float s_ang[STAGE];
  __shared__ float s_val[STAGE];
  __shared__ float s_angle[LANES], s_vel[LANES], s_pred[LANES];
  __shared__ int s_active[LANES], s_missed[LANES], s_age[LANES];
  __shared__ int s_match[LANES], s_order[LANES];
  __shared__ unsigned s_used;
  const int l = threadIdx.x;
  const unsigned FULL = 0xffffffffu;
  if (l < M) {
    s_angle[l] = angle0[l];
    s_vel[l] = vel0[l];
    s_active[l] = active0[l] != 0;
    s_missed[l] = missed0[l];
    s_age[l] = age0[l];
  }
  const int per_stage = STAGE / K;
  for (int b = 0; b < B; ++b) {
    const int sb = b % per_stage;
    if (sb == 0) {                       // stage the next windows
      __syncwarp();
      const int nwin = min(per_stage, B - b);
      const long long base = (long long)b * K;
      for (int i = l; i < nwin * K; i += LANES) {
        s_ang[i] = ang[base + i];
        s_val[i] = val[base + i];
      }
    }
    __syncwarp();
    const float* da = s_ang + sb * K;
    const float* dv = s_val + sb * K;

    // 1. predict (lane m), rank detection j for the spawn order (lane j)
    if (l < M) s_pred[l] = __fadd_rn(s_angle[l], s_vel[l]);
    if (l < K) {
      const float x = -dv[l];
      const bool xn = isnan(x);
      int rank = 0;
      for (int i = 0; i < K; ++i) {
        const float y = -dv[i];
        const bool yn = isnan(y);
        const bool before =
            yn ? (xn && i < l) : (xn || y < x || (y == x && i < l));
        rank += before;
      }
      s_order[rank] = l;
    }
    __syncwarp();

    // 2. association in slot order (lane 0)
    if (l == 0) {
      unsigned used = 0u;
      for (int m = 0; m < M; ++m) {
        const float pm = s_pred[m];
        float cbest = 0.f;
        int jbest = 0;
        for (int j = 0; j < K; ++j) {
          const float c = ((used >> j) & 1u) ? INFINITY
                                             : fabsf(__fsub_rn(pm, da[j]));
          if (j == 0 || (!isnan(cbest) && (isnan(c) || c < cbest))) {
            cbest = c;
            jbest = j;
          }
        }
        const bool ok = s_active[m] && cbest <= gate;
        s_match[m] = ok ? jbest : -1;
        if (ok) used |= 1u << jbest;
      }
      s_used = used;
    }
    __syncwarp();

    // 3. update (lane m)
    bool still = false;
    if (l < M) {
      const int j = s_match[l];
      const float pred = s_pred[l];
      float a = pred, v = s_vel[l];
      int missed = s_missed[l] + 1;
      if (j >= 0) {
        const float resid = __fsub_rn(da[j], pred);
        a = __fadd_rn(pred, __fmul_rn(alpha, resid));
        v = __fadd_rn(v, __fmul_rn(beta, resid));
        missed = 0;
      }
      still = s_active[l] && missed <= max_missed;
      s_angle[l] = a;
      s_vel[l] = v;
      s_missed[l] = missed;
      s_active[l] = still;
      s_age[l] = still ? s_age[l] + 1 : 0;
    }
    unsigned free_slots = __ballot_sync(FULL, l < M && !still);
    __syncwarp();

    // 4. spawn in the descending order of the values (lane 0)
    if (l == 0) {
      unsigned used = s_used;
      for (int kk = 0; kk < K; ++kk) {
        const int j = s_order[kk];
        const int slot = free_slots ? __ffs(free_slots) - 1 : 0;
        if (((free_slots >> slot) & 1u) && !((used >> j) & 1u)) {
          s_angle[slot] = da[j];
          s_vel[slot] = 0.f;
          s_active[slot] = 1;
          s_missed[slot] = 0;
          s_age[slot] = 0;
          free_slots &= ~(1u << slot);
        }
        used |= 1u << j;
      }
    }
    __syncwarp();

    // 5. the tracks of this window (lane m)
    if (l < M)
      out[(long long)b * M + l] =
          (s_active[l] && s_age[l] >= min_age) ? s_angle[l] : NAN;
  }
  __syncwarp();
  if (l < M) {
    angle1[l] = s_angle[l];
    vel1[l] = s_vel[l];
    active1[l] = (unsigned char)s_active[l];
    missed1[l] = s_missed[l];
    age1[l] = s_age[l];
  }
}

}  // namespace

// ang, val: f32[B, K] row-major; the state (angle0 ... age0) in, its
// copy (angle1 ... age1) out, each of M slots (active as one byte a
// slot); out: f32[B, M]. 1 <= M, K <= 32.
extern "C" int doa_track_scan(const void* ang, const void* val, int B,
                              int K, const void* angle0, const void* vel0,
                              const void* active0, const void* missed0,
                              const void* age0, void* angle1, void* vel1,
                              void* active1, void* missed1, void* age1,
                              void* out, int M, float gate, float alpha,
                              float beta, int max_missed, int min_age,
                              void* stream) {
  if (B < 0 || K < 1 || K > LANES || M < 1 || M > LANES)
    return (int)cudaErrorInvalidValue;
  track_kernel<<<1, LANES, 0, (cudaStream_t)stream>>>(
      (const float*)ang, (const float*)val, B, K, (const float*)angle0,
      (const float*)vel0, (const unsigned char*)active0,
      (const int*)missed0, (const int*)age0, (float*)angle1, (float*)vel1,
      (unsigned char*)active1, (int*)missed1, (int*)age1, (float*)out, M,
      gate, alpha, beta, max_missed, min_age);
  return (int)cudaGetLastError();
}
