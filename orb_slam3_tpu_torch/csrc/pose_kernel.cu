// K2: motion-only pose BA, mono or mixed mono/stereo, batched.
//
// Replaces: the Pallas TPU kernel orb_slam3_tpu/tracking/pose_kernel.py::
// _pose_kernel (Optimizer::PoseOptimization): rounds x iters damped
// Gauss-Newton steps on one SE3 pose; Huber weights in rounds 0-1 (delta
// sqrt(5.991) mono, sqrt(7.815) stereo rows); analytic pinhole Jacobians of
// the left-multiplicative update; stereo rows (ur >= 0) add uR = uL - bf/z;
// 21 + 6 row sums -> 6x6 normal equations + lambda I; unrolled Cholesky with
// pivot floor 1e-12; a non-finite step becomes 0; Rodrigues retraction with
// V; the step is kept when the gated cost sum(min(chi2, gate) * mask) drops
// (lambda * 0.5, else * 4); chi2 = 1e9 where z <= 0; after each round
// mask = (chi2 < gate) && valid. Arithmetic is f32 and each row's
// expressions are those of the plain PyTorch version; the build turns FMA
// contraction off so each product rounds as there.
//
// What bounds it on an H100: at the tracking shape (one problem of 2048
// rows) the function needs 21 sweeps over the rows, about 5 MFLOP, and
// reads 53 KB: well under a microsecond of ALU or memory time. The chain of
// 18 dependent iterations, each a reduction over all rows followed by a 6x6
// solve, bounds it: latency, not throughput.
//
// Design, against that latency:
// - One sweep per iteration. The sweep at the trial pose computes the gated
//   cost and the 27 normal-equation sums together: on accept those sums are
//   the next iteration's normal equations (same pose, mask and Huber flag);
//   on reject the previous ones still hold. Each staged row keeps its chi2
//   at the current pose (two slots, swapped on accept), so the end-of-round
//   reclassification needs no sweep; it is folded into the next round's
//   first sweep, which also gives that round's starting cost. Per round:
//   1 + iters sweeps, 21 at rounds=3, iters=6 (the plain version makes 42).
// - A thread-block cluster of C = min(8, ceil(N/256)) CTAs per problem
//   (grid = B x C, cudaLaunchKernelEx with the cluster dimension): at
//   N = 2048 each of the 8 x 256 threads owns one row. A reduction is a
//   warp reduce-scatter (31 shuffles for 32 values), one CTA barrier, the
//   CTA's partial sums pushed into a slot of every CTA's shared memory
//   (distributed shared memory stores, in flight during the barrier), one
//   cluster barrier, and every warp summing the C slots in rank order. All
//   threads of all CTAs thus hold bit-identical totals, the result is the
//   same from run to run, and every thread solves the 6x6 system and
//   retracts itself: no broadcast barrier. Slots are double buffered, so
//   one cluster barrier per reduction suffices; a last cluster barrier
//   keeps every CTA alive until rank 0 has read the inlier counts.
// - Rows are staged once in dynamic shared memory (up to kStageRows rows per
//   CTA, 33-37 bytes a row), with their valid/mask flags and chi2 slots. Rows
//   past that capacity stream from global memory each sweep, keep their
//   mask in the output array, and get one extra pass at the end for their
//   final chi2.
// Launches on the caller's stream and allocates nothing.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 8;    // the portable cluster size limit
constexpr int kStageRows = 1024;  // rows staged in shared memory per CTA
constexpr int kSums = 28;         // 21 entries of H's lower triangle, 6 of g, cost
constexpr int kCost = 27;
constexpr unsigned kFull = 0xffffffffu;

struct Cam {
  float fx, fy, cx, cy, bf;
};

struct Row {
  float X0, X1, X2, U, V, UR, hur, isg, gate, delta;
};

// The row arrays of one problem in global memory.
struct Rows {
  const float* xw;
  const float* uv;
  const float* isig;
  const uint8_t* valid;
  const float* ur;
};

// A CTA's staged rows, structure of arrays in dynamic shared memory.
struct Stage {
  float *X0, *X1, *X2, *U, *V, *isg, *UR;
  float* chi2;  // two slots: chi2[slot * stride + j]
  int stride;
  uint8_t* flags;  // bit 0 valid, bit 1 mask
};

template <bool kStereo>
__device__ __forceinline__ Row make_row(float X0, float X1, float X2, float U, float V,
                                        float isg, float UR, float chi2_mono,
                                        float chi2_stereo, float delta_mono) {
  Row r;
  r.X0 = X0;
  r.X1 = X1;
  r.X2 = X2;
  r.U = U;
  r.V = V;
  r.isg = isg;
  if (kStereo) {
    r.UR = UR;
    r.hur = r.UR >= 0.f ? 1.f : 0.f;
    r.gate = r.hur > 0.f ? chi2_stereo : chi2_mono;
    r.delta = sqrtf(r.gate);
  } else {
    r.UR = 0.f;
    r.hur = 0.f;
    r.gate = chi2_mono;
    r.delta = delta_mono;
  }
  return r;
}

template <bool kStereo>
__device__ __forceinline__ Row global_row(const Rows& g, int i, float chi2_mono,
                                          float chi2_stereo, float delta_mono) {
  return make_row<kStereo>(g.xw[3 * i], g.xw[3 * i + 1], g.xw[3 * i + 2], g.uv[2 * i],
                           g.uv[2 * i + 1], g.isig[i], kStereo ? g.ur[i] : 0.f,
                           chi2_mono, chi2_stereo, delta_mono);
}

template <bool kStereo>
__device__ __forceinline__ Row staged_row(const Stage& s, int j, float chi2_mono,
                                          float chi2_stereo, float delta_mono) {
  return make_row<kStereo>(s.X0[j], s.X1[j], s.X2[j], s.U[j], s.V[j], s.isg[j],
                           kStereo ? s.UR[j] : 0.f, chi2_mono, chi2_stereo, delta_mono);
}

// chi2 of one row at pose P (R row-major in P[0..9), t in P[9..12)).
template <bool kStereo>
__device__ __forceinline__ float chi2_of(const float (&P)[12], const Cam& c, const Row& r,
                                         float& x, float& y, float& z, float& ru,
                                         float& rv, float& rw) {
  x = P[0] * r.X0 + P[1] * r.X1 + P[2] * r.X2 + P[9];
  y = P[3] * r.X0 + P[4] * r.X1 + P[5] * r.X2 + P[10];
  z = P[6] * r.X0 + P[7] * r.X1 + P[8] * r.X2 + P[11];
  const float zs = fabsf(z) < 1e-9f ? 1e-9f : z;
  const float u_pred = c.fx * x / zs + c.cx;
  ru = r.U - u_pred;
  rv = r.V - (c.fy * y / zs + c.cy);
  float c2 = ru * ru + rv * rv;
  if (kStereo) {
    rw = (r.UR - (u_pred - c.bf / zs)) * r.hur;
    c2 = c2 + rw * rw;
  } else {
    rw = 0.f;
  }
  c2 = c2 * r.isg;
  return z > 0.f ? c2 : 1e9f;
}

// Add one row's gated cost and weighted normal-equation terms to v.
template <bool kStereo>
__device__ __forceinline__ void accumulate(const Cam& cam, const Row& r, float c2, float x,
                                           float y, float z, float ru, float rv, float rw,
                                           float m, bool huber, float (&v)[32]) {
  v[kCost] += fminf(c2, r.gate) * m;
  const float zs = fabsf(z) < 1e-9f ? 1e-9f : z;
  const float zi = 1.f / zs;
  float w_rob = 1.f;
  if (huber) {
    const float e = sqrtf(fmaxf(c2, 1e-18f));
    w_rob = e <= r.delta ? 1.f : r.delta / e;
  }
  const float w = w_rob * r.isg * m;

  const float xz = x * zi, yz = y * zi;
  const float Ju[6] = {cam.fx * zi, 0.f, -cam.fx * xz * zi,
                       -cam.fx * xz * yz, cam.fx * (1.f + xz * xz), -cam.fx * yz};
  const float Jv[6] = {0.f, cam.fy * zi, -cam.fy * yz * zi,
                       -cam.fy * (1.f + yz * yz), cam.fy * xz * yz, cam.fy * xz};
  float Jw[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (kStereo) {
    const float q = (cam.bf - cam.fx * x) * zi * zi;
    Jw[0] = cam.fx * zi * r.hur;
    Jw[2] = q * r.hur;
    Jw[3] = q * y * r.hur;
    Jw[4] = (cam.fx - q * x) * r.hur;
    Jw[5] = -cam.fx * yz * r.hur;
  }
  // which Jacobian entries exist (u: no d/dty, v: no d/dtx, uR: no d/dty)
  constexpr bool kHu[6] = {true, false, true, true, true, true};
  constexpr bool kHv[6] = {false, true, true, true, true, true};
  int k = 0;
#pragma unroll
  for (int a = 0; a < 6; ++a) {
#pragma unroll
    for (int c = 0; c <= a; ++c) {
      float acc = 0.f;
      bool have = false;
      if (kHu[a] && kHu[c]) {
        acc = Ju[a] * Ju[c];
        have = true;
      }
      if (kHv[a] && kHv[c]) {
        const float tm = Jv[a] * Jv[c];
        acc = have ? acc + tm : tm;
        have = true;
      }
      if (kStereo && kHu[a] && kHu[c]) {
        const float tm = Jw[a] * Jw[c];
        acc = have ? acc + tm : tm;
        have = true;
      }
      if (have) v[k] += acc * w;
      ++k;
    }
  }
#pragma unroll
  for (int a = 0; a < 6; ++a) {
    float acc = 0.f;
    bool have = false;
    if (kHu[a]) {
      acc = Ju[a] * ru;
      have = true;
    }
    if (kHv[a]) {
      const float tm = Jv[a] * rv;
      acc = have ? acc + tm : tm;
      have = true;
    }
    if (kStereo && kHu[a]) {
      const float tm = Jw[a] * rw;
      acc = have ? acc + tm : tm;
    }
    v[21 + a] += acc * w;
  }
}

// One halving step of a warp reduce-scatter over v[0..2H): lanes with bit H
// set keep the upper half, the others the lower half, each adding its
// partner's copy. A template, so every index is a constant and v stays in
// registers.
template <int H>
__device__ __forceinline__ void reduce_scatter_step(float (&v)[32], int lane) {
  const bool upper = (lane & H) != 0;
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float send = upper ? v[i] : v[i + H];
    const float keep = upper ? v[i + H] : v[i];
    v[i] = keep + __shfl_xor_sync(kFull, send, H);
  }
}

// Sums of v[0..kSums) over the cluster's threads, the same bits in every
// thread. Each CTA pushes its partial sums into slot `rank` of every CTA's
// `part` (remote stores, in flight during the barrier); after the cluster
// barrier each CTA sums its C local slots in rank order. `buf` alternates
// between calls: a CTA writes a buffer again only two barriers later, when
// every CTA has read it.
__device__ __forceinline__ void cluster_sum(float (&v)[32], float* red, float* part, int buf,
                                            cg::cluster_group& cluster, int csize, int rank,
                                            float (&tot)[kSums]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // reduce-scatter: afterwards lane l holds the warp's sum of value l in v[0]
  reduce_scatter_step<16>(v, lane);
  reduce_scatter_step<8>(v, lane);
  reduce_scatter_step<4>(v, lane);
  reduce_scatter_step<2>(v, lane);
  reduce_scatter_step<1>(v, lane);
  red[warp * 32 + lane] = v[0];
  __syncthreads();
  float* slots = part + buf * kMaxCluster * 32;
  if (threadIdx.x < kSums) {
    float s = red[threadIdx.x];
    for (int w = 1; w < kWarps; ++w) s += red[w * 32 + threadIdx.x];
    for (int d = 0; d < csize; ++d) {
      cluster.map_shared_rank(slots, d)[rank * 32 + threadIdx.x] = s;
    }
  }
  cluster.sync();
  float p[kMaxCluster];
#pragma unroll
  for (int r = 0; r < kMaxCluster; ++r) p[r] = r < csize ? slots[r * 32 + lane] : 0.f;
  float t = p[0];
#pragma unroll
  for (int r = 1; r < kMaxCluster; ++r) {
    if (r < csize) t += p[r];
  }
#pragma unroll
  for (int k = 0; k < kSums; ++k) tot[k] = __shfl_sync(kFull, t, k);
}

__device__ __forceinline__ void chol_solve6(const float (&H)[6][6], const float (&g)[6],
                                            float (&x)[6]) {
  float L[6][6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      float s = H[i][j];
#pragma unroll
      for (int k = 0; k < j; ++k) s = s - L[i][k] * L[j][k];
      L[i][j] = (i == j) ? sqrtf(fmaxf(s, 1e-12f)) : s / L[j][j];
    }
  }
  float y[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float s = g[i];
#pragma unroll
    for (int k = 0; k < i; ++k) s = s - L[i][k] * y[k];
    y[i] = s / L[i][i];
  }
#pragma unroll
  for (int i = 5; i >= 0; --i) {
    float s = y[i];
#pragma unroll
    for (int k = i + 1; k < 6; ++k) s = s - L[k][i] * x[k];
    x[i] = s / L[i][i];
  }
}

__device__ __forceinline__ void rodrigues(float px, float py, float pz, float (&dR)[9],
                                          float (&V)[9]) {
  const float th2 = px * px + py * py + pz * pz;
  const bool small = th2 < 1e-12f;
  const float th = sqrtf(small ? 1.f : th2);
  float sn, cs;
  sincosf(th, &sn, &cs);
  const float a = small ? 1.f - th2 / 6.f : sn / th;
  const float b = small ? 0.5f - th2 / 24.f : (1.f - cs) / th2;
  const float c = small ? 1.f / 6.f - th2 / 120.f : (th - sn) / (th2 * th);
  const float W[9] = {0.f, -pz, py, pz, 0.f, -px, -py, px, 0.f};
  const float xx = px * px, yy = py * py, zz = pz * pz;
  const float xy = px * py, xz = px * pz, yz = py * pz;
  const float W2[9] = {-(yy + zz), xy, xz, xy, -(xx + zz), yz, xz, yz, -(xx + yy)};
  const float E[9] = {1.f, 0.f, 0.f, 0.f, 1.f, 0.f, 0.f, 0.f, 1.f};
#pragma unroll
  for (int i = 0; i < 9; ++i) {
    dR[i] = E[i] + a * W[i] + b * W2[i];
    V[i] = E[i] + b * W[i] + c * W2[i];
  }
}

// Solve (H + lambda I) dxi = g from the totals and retract P by exp(dxi).
__device__ __forceinline__ void solve_and_retract(const float (&tot)[kSums], float lam,
                                                  const float (&P)[12], float (&Pn)[12]) {
  float H[6][6], g[6];
  int k = 0;
#pragma unroll
  for (int a = 0; a < 6; ++a) {
#pragma unroll
    for (int b = 0; b <= a; ++b) {
      H[a][b] = tot[k];
      H[b][a] = tot[k];
      ++k;
    }
  }
#pragma unroll
  for (int a = 0; a < 6; ++a) g[a] = tot[21 + a];
#pragma unroll
  for (int a = 0; a < 6; ++a) H[a][a] = H[a][a] + lam;
  float dx[6];
  chol_solve6(H, g, dx);
  bool ok = true;
#pragma unroll
  for (int a = 0; a < 6; ++a) ok = ok && isfinite(dx[a]);
  if (!ok) {
#pragma unroll
    for (int a = 0; a < 6; ++a) dx[a] = 0.f;
  }
  float dR[9], V[9];
  rodrigues(dx[3], dx[4], dx[5], dR, V);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      Pn[3 * i + j] = dR[3 * i] * P[j] + dR[3 * i + 1] * P[3 + j] + dR[3 * i + 2] * P[6 + j];
    }
    const float dt = V[3 * i] * dx[0] + V[3 * i + 1] * dx[1] + V[3 * i + 2] * dx[2];
    const float tn = dR[3 * i] * P[9] + dR[3 * i + 1] * P[10] + dR[3 * i + 2] * P[11];
    Pn[9 + i] = tn + dt;
  }
}

template <bool kStereo>
__global__ void __launch_bounds__(kThreads) pose_kernel(
    const float* __restrict__ K, int k_stride, const float* __restrict__ R0,
    const float* __restrict__ t0, const float* __restrict__ bf,
    const float* __restrict__ xw_all, const float* __restrict__ uv_all,
    const float* __restrict__ isig_all, const uint8_t* __restrict__ valid_all,
    const float* __restrict__ ur_all, int N, int rows_per_cta, int stage_rows, int rounds,
    int iters, float chi2_mono, float chi2_stereo, float delta_mono,
    float* __restrict__ R_out, float* __restrict__ t_out, uint8_t* __restrict__ mask_all,
    int* __restrict__ n_out) {
  __shared__ float s_red[kWarps * 32];
  __shared__ float s_part[2 * kMaxCluster * 32];
  __shared__ int s_cnt[kWarps];
  extern __shared__ float s_dyn[];

  cg::cluster_group cluster = cg::this_cluster();
  const int csize = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.x / csize;

  const Cam cam{K[k_stride * b], K[k_stride * b + 1], K[k_stride * b + 2],
                K[k_stride * b + 3], kStereo ? bf[b] : 0.f};
  const size_t off = static_cast<size_t>(b) * N;
  const Rows g{xw_all + 3 * off, uv_all + 2 * off, isig_all + off, valid_all + off,
               kStereo ? ur_all + off : nullptr};
  uint8_t* mask = mask_all + off;
  const int base = rank * rows_per_cta;
  const int cnt = max(0, min(rows_per_cta, N - base));
  const int S = min(cnt, stage_rows);

  Stage st;
  {
    float* p = s_dyn;
    st.X0 = p; p += stage_rows;
    st.X1 = p; p += stage_rows;
    st.X2 = p; p += stage_rows;
    st.U = p; p += stage_rows;
    st.V = p; p += stage_rows;
    st.isg = p; p += stage_rows;
    st.chi2 = p; p += 2 * stage_rows;
    st.stride = stage_rows;
    st.UR = p;
    if (kStereo) p += stage_rows;
    st.flags = reinterpret_cast<uint8_t*>(p);
  }
  // Stage this thread's rows; only the thread that owns a row touches it.
  for (int j = threadIdx.x; j < S; j += kThreads) {
    const int i = base + j;
    st.X0[j] = g.xw[3 * i];
    st.X1[j] = g.xw[3 * i + 1];
    st.X2[j] = g.xw[3 * i + 2];
    st.U[j] = g.uv[2 * i];
    st.V[j] = g.uv[2 * i + 1];
    st.isg[j] = g.isig[i];
    if (kStereo) st.UR[j] = g.ur[i];
    st.flags[j] = g.valid[i] ? 1 : 0;
  }

  float P[12];
#pragma unroll
  for (int q = 0; q < 9; ++q) P[q] = R0[9 * b + q];
#pragma unroll
  for (int q = 0; q < 3; ++q) P[9 + q] = t0[3 * b + q];

  int cur = 0;  // chi2 slot of the current pose
  int buf = 0;  // partials buffer of the next reduction
  float x, y, z, ru, rv, rw;
  for (int round = 0; round < rounds; ++round) {
    const bool huber = round < 2;
    // first sweep of the round: reclassify (rounds > 0) at the current pose,
    // then the starting cost and the normal equations with the new mask
    float v[32];
#pragma unroll
    for (int k = 0; k < 32; ++k) v[k] = 0.f;
    for (int j = threadIdx.x; j < cnt; j += kThreads) {
      const bool staged = j < S;
      const int i = base + j;
      const Row r = staged ? staged_row<kStereo>(st, j, chi2_mono, chi2_stereo, delta_mono)
                           : global_row<kStereo>(g, i, chi2_mono, chi2_stereo, delta_mono);
      const float c2 = chi2_of<kStereo>(P, cam, r, x, y, z, ru, rv, rw);
      const bool val = staged ? (st.flags[j] & 1) : g.valid[i] != 0;
      const bool m = round == 0 ? val : (c2 < r.gate && val);
      if (staged) {
        st.flags[j] = (val ? 1 : 0) | (m ? 2 : 0);
        st.chi2[cur * st.stride + j] = c2;
      } else {
        mask[i] = m ? 1 : 0;
      }
      accumulate<kStereo>(cam, r, c2, x, y, z, ru, rv, rw, m ? 1.f : 0.f, huber, v);
    }
    float tot[kSums];
    cluster_sum(v, s_red, s_part, buf, cluster, csize, rank, tot);
    buf ^= 1;
    float lam = 1e-3f;

    for (int it = 0; it < iters; ++it) {
      float Pn[12];
      solve_and_retract(tot, lam, P, Pn);
      // one sweep at the trial pose: its cost, and the normal equations the
      // next iteration uses if the step is kept
#pragma unroll
      for (int k = 0; k < 32; ++k) v[k] = 0.f;
      for (int j = threadIdx.x; j < cnt; j += kThreads) {
        const bool staged = j < S;
        const int i = base + j;
        const Row r = staged ? staged_row<kStereo>(st, j, chi2_mono, chi2_stereo, delta_mono)
                             : global_row<kStereo>(g, i, chi2_mono, chi2_stereo, delta_mono);
        const float c2 = chi2_of<kStereo>(Pn, cam, r, x, y, z, ru, rv, rw);
        const bool m = staged ? (st.flags[j] & 2) != 0 : mask[i] != 0;
        if (staged) st.chi2[(cur ^ 1) * st.stride + j] = c2;
        accumulate<kStereo>(cam, r, c2, x, y, z, ru, rv, rw, m ? 1.f : 0.f, huber, v);
      }
      float tn[kSums];
      cluster_sum(v, s_red, s_part, buf, cluster, csize, rank, tn);
      buf ^= 1;
      if (tn[kCost] < tot[kCost]) {
#pragma unroll
        for (int q = 0; q < 12; ++q) P[q] = Pn[q];
#pragma unroll
        for (int k = 0; k < kSums; ++k) tot[k] = tn[k];
        lam = lam * 0.5f;
        cur ^= 1;
      } else {
        lam = lam * 4.f;
      }
    }
  }

  // final reclassification against `valid` (with no rounds the mask is
  // `valid`); staged rows kept their chi2 at the final pose, streamed rows
  // compute it once more
  int n_mine = 0;
  for (int j = threadIdx.x; j < cnt; j += kThreads) {
    const int i = base + j;
    bool m;
    if (j < S) {
      const Row r = staged_row<kStereo>(st, j, chi2_mono, chi2_stereo, delta_mono);
      m = (st.flags[j] & 1) && (rounds == 0 || st.chi2[cur * st.stride + j] < r.gate);
    } else {
      const Row r = global_row<kStereo>(g, i, chi2_mono, chi2_stereo, delta_mono);
      m = g.valid[i] != 0 &&
          (rounds == 0 || chi2_of<kStereo>(P, cam, r, x, y, z, ru, rv, rw) < r.gate);
    }
    mask[i] = m ? 1 : 0;
    n_mine += m ? 1 : 0;
  }
  n_mine = __reduce_add_sync(kFull, n_mine);
  if ((threadIdx.x & 31) == 0) s_cnt[threadIdx.x >> 5] = n_mine;
  cluster.sync();
  if (rank == 0) {
    if (threadIdx.x == 0) {
      int n = 0;
      for (int r = 0; r < csize; ++r) {
        const int* c = cluster.map_shared_rank(s_cnt, r);
        for (int w = 0; w < kWarps; ++w) n += c[w];
      }
      n_out[b] = n;
    }
    if (threadIdx.x < 9) R_out[9 * b + threadIdx.x] = P[threadIdx.x];
    if (threadIdx.x < 3) t_out[3 * b + threadIdx.x] = P[9 + threadIdx.x];
  }
  // no CTA may exit while rank 0 still reads its counts
  cluster.sync();
}

__global__ void noop_kernel() {}

}  // namespace

// The cluster size K2 launches with for N rows per problem.
extern "C" int pose_kernel_cluster(int N) {
  return std::max(1, std::min(kMaxCluster, (N + kThreads - 1) / kThreads));
}

extern "C" int pose_kernel_launch(
    const void* K, int k_stride, const void* R0, const void* t0, const void* bf,
    const void* xw, const void* uv, const void* isig, const void* valid, const void* ur,
    int B, int N, int rounds, int iters, int stereo, float chi2_mono, float chi2_stereo,
    float delta_mono, void* R_out, void* t_out, void* mask_out, void* n_out, void* stream) {
  if (B <= 0) return 0;
  const int C = pose_kernel_cluster(N);
  const int per = (N + C - 1) / C;
  const int stage = std::max(1, std::min(per, kStageRows));
  const size_t smem = static_cast<size_t>(stage) * ((stereo ? 9 : 8) * sizeof(float) + 1);

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(B * C));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(C);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;

  const float* Kp = static_cast<const float*>(K);
  const float* R0p = static_cast<const float*>(R0);
  const float* t0p = static_cast<const float*>(t0);
  const float* bfp = static_cast<const float*>(bf);
  const float* xwp = static_cast<const float*>(xw);
  const float* uvp = static_cast<const float*>(uv);
  const float* isp = static_cast<const float*>(isig);
  const uint8_t* vp = static_cast<const uint8_t*>(valid);
  const float* urp = static_cast<const float*>(ur);
  float* Rp = static_cast<float*>(R_out);
  float* tp = static_cast<float*>(t_out);
  uint8_t* mp = static_cast<uint8_t*>(mask_out);
  int* np = static_cast<int*>(n_out);
  const cudaError_t e =
      stereo ? cudaLaunchKernelEx(&cfg, pose_kernel<true>, Kp, k_stride, R0p, t0p, bfp, xwp,
                                  uvp, isp, vp, urp, N, per, stage, rounds, iters, chi2_mono,
                                  chi2_stereo, delta_mono, Rp, tp, mp, np)
             : cudaLaunchKernelEx(&cfg, pose_kernel<false>, Kp, k_stride, R0p, t0p, bfp, xwp,
                                  uvp, isp, vp, urp, N, per, stage, rounds, iters, chi2_mono,
                                  chi2_stereo, delta_mono, Rp, tp, mp, np);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// An empty one-warp kernel: its device time is the floor any launch pays.
extern "C" int noop_kernel_launch(void* stream) {
  noop_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
