// K2: motion-only pose BA, mono or mixed mono/stereo, batched.
//
// Replaces the Pallas TPU kernel orb_slam3_tpu/tracking/pose_kernel.py::
// _pose_kernel (Optimizer::PoseOptimization): rounds x iters damped
// Gauss-Newton steps on one SE3 pose; Huber weights in rounds 0-1 (delta
// sqrt(5.991) mono, sqrt(7.815) stereo rows); analytic pinhole Jacobians of
// the left-multiplicative update; stereo rows (ur >= 0) add uR = uL - bf/z;
// 21 + 6 row sums -> 6x6 normal equations + lambda I; unrolled Cholesky with
// pivot floor 1e-12; a non-finite step becomes 0; Rodrigues retraction with
// V; the step is kept when the gated cost sum(min(chi2, gate) * mask) drops
// (lambda * 0.5, else * 4); chi2 = 1e9 where z <= 0; after each round
// mask = (chi2 < gate) && valid. Arithmetic is f32 in the order of the Pallas
// kernel; the build turns FMA contraction off so each product rounds as in
// the plain PyTorch version.
//
// What bounds it on an H100: at the tracking shape (one problem of 2048
// rows) the work is 3 rounds x 6 iterations x 2 passes over the rows, about
// 10 MFLOP and 50 KB of input: well under a microsecond of ALU or memory
// time. The chain of 18 dependent iterations, each a block-wide reduction
// followed by a serial 6x6 solve, bounds it: latency, not throughput.
//
// Design: one 256-thread block per problem (grid = batch B), so the whole
// loop runs in one launch with no host round trip. Threads stride over rows
// (rows past N are never touched: no padding). Each pass accumulates per-
// thread sums in registers, reduces them with warp shuffles and one shared
// array, thread 0 solves and retracts, and the pose is broadcast through
// shared memory. The inlier mask output doubles as the working mask: every
// thread reads and writes only its own rows. Launches on the caller's stream
// and allocates nothing.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSums = 27;  // 21 entries of the lower triangle of H, 6 of g

struct Cam {
  float fx, fy, cx, cy, bf;
};

struct Row {
  float X0, X1, X2, U, V, UR, hur, isg, gate, delta;
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// Block-wide sums of K per-thread values; every thread sees them in out[].
template <int K>
__device__ __forceinline__ void block_sum(float (&v)[K], float* red, float* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < K; ++k) v[k] = warp_sum(v[k]);
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) red[warp * K + k] = v[k];
  }
  __syncthreads();
  if (threadIdx.x < K) {
    float s = red[threadIdx.x];
    for (int w = 1; w < kWarps; ++w) s += red[w * K + threadIdx.x];
    out[threadIdx.x] = s;
  }
  __syncthreads();
}

template <bool kStereo>
__device__ __forceinline__ Row load_row(const float* xw, const float* uv,
                                        const float* isig, const float* ur,
                                        int i, float chi2_mono,
                                        float chi2_stereo, float delta_mono) {
  Row r;
  r.X0 = xw[3 * i];
  r.X1 = xw[3 * i + 1];
  r.X2 = xw[3 * i + 2];
  r.U = uv[2 * i];
  r.V = uv[2 * i + 1];
  r.isg = isig[i];
  if (kStereo) {
    r.UR = ur[i];
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

// chi2 of one row at pose P (R row-major in P[0..9), t in P[9..12)).
template <bool kStereo>
__device__ __forceinline__ float chi2_of(const float* P, const Cam& c, const Row& r,
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

__device__ void chol_solve6(const float (&H)[6][6], const float (&g)[6], float (&x)[6]) {
  float L[6][6];
  for (int i = 0; i < 6; ++i) {
    for (int j = 0; j <= i; ++j) {
      float s = H[i][j];
      for (int k = 0; k < j; ++k) s = s - L[i][k] * L[j][k];
      L[i][j] = (i == j) ? sqrtf(fmaxf(s, 1e-12f)) : s / L[j][j];
    }
  }
  float y[6];
  for (int i = 0; i < 6; ++i) {
    float s = g[i];
    for (int k = 0; k < i; ++k) s = s - L[i][k] * y[k];
    y[i] = s / L[i][i];
  }
  for (int i = 5; i >= 0; --i) {
    float s = y[i];
    for (int k = i + 1; k < 6; ++k) s = s - L[k][i] * x[k];
    x[i] = s / L[i][i];
  }
}

__device__ void rodrigues(float px, float py, float pz, float (&dR)[9], float (&V)[9]) {
  const float th2 = px * px + py * py + pz * pz;
  const bool small = th2 < 1e-12f;
  const float th = sqrtf(small ? 1.f : th2);
  const float sn = sinf(th), cs = cosf(th);
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

// Thread 0: solve (H + lambda I) dxi = g and retract P by exp(dxi) into Pn.
__device__ void solve_and_retract(const float* tot, float lam, const float* P, float* Pn) {
  float H[6][6], g[6];
  int k = 0;
  for (int a = 0; a < 6; ++a) {
    for (int b = 0; b <= a; ++b) {
      H[a][b] = tot[k];
      H[b][a] = tot[k];
      ++k;
    }
  }
  for (int a = 0; a < 6; ++a) g[a] = tot[21 + a];
  for (int a = 0; a < 6; ++a) H[a][a] = H[a][a] + lam;
  float dx[6];
  chol_solve6(H, g, dx);
  bool ok = true;
  for (int a = 0; a < 6; ++a) ok = ok && isfinite(dx[a]);
  if (!ok) {
    for (int a = 0; a < 6; ++a) dx[a] = 0.f;
  }
  float dR[9], V[9];
  rodrigues(dx[3], dx[4], dx[5], dR, V);
  for (int i = 0; i < 3; ++i) {
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
    const float* __restrict__ sc, const float* __restrict__ xw_all,
    const float* __restrict__ uv_all, const float* __restrict__ isig_all,
    const uint8_t* __restrict__ valid_all, const float* __restrict__ ur_all,
    int N, int rounds, int iters, float chi2_mono, float chi2_stereo,
    float delta_mono, float* __restrict__ R_out, float* __restrict__ t_out,
    uint8_t* __restrict__ mask_all, int* __restrict__ n_out) {
  __shared__ float s_pose[12], s_new[12];
  __shared__ float s_red[kWarps * kSums], s_tot[kSums];
  __shared__ float s_lam, s_cur;

  const int b = blockIdx.x;
  const float* s = sc + 17 * b;
  const Cam cam{s[0], s[1], s[2], s[3], s[16]};
  const size_t off = static_cast<size_t>(b) * N;
  const float* xw = xw_all + 3 * off;
  const float* uv = uv_all + 2 * off;
  const float* isig = isig_all + off;
  const uint8_t* valid = valid_all + off;
  const float* ur = kStereo ? ur_all + off : nullptr;
  uint8_t* mask = mask_all + off;

  if (threadIdx.x < 12) s_pose[threadIdx.x] = s[4 + threadIdx.x];
  for (int i = threadIdx.x; i < N; i += kThreads) mask[i] = valid[i] ? 1 : 0;
  __syncthreads();

  float x, y, z, ru, rv, rw;
  for (int round = 0; round < rounds; ++round) {
    const bool huber = round < 2;
    {
      float v[1] = {0.f};
      for (int i = threadIdx.x; i < N; i += kThreads) {
        const Row r = load_row<kStereo>(xw, uv, isig, ur, i, chi2_mono, chi2_stereo, delta_mono);
        const float c2 = chi2_of<kStereo>(s_pose, cam, r, x, y, z, ru, rv, rw);
        v[0] += fminf(c2, r.gate) * (mask[i] ? 1.f : 0.f);
      }
      block_sum<1>(v, s_red, s_tot);
      if (threadIdx.x == 0) {
        s_cur = s_tot[0];
        s_lam = 1e-3f;
      }
      __syncthreads();
    }
    for (int it = 0; it < iters; ++it) {
      float v[kSums];
#pragma unroll
      for (int k = 0; k < kSums; ++k) v[k] = 0.f;
      for (int i = threadIdx.x; i < N; i += kThreads) {
        const Row r = load_row<kStereo>(xw, uv, isig, ur, i, chi2_mono, chi2_stereo, delta_mono);
        const float m = mask[i] ? 1.f : 0.f;
        const float c2 = chi2_of<kStereo>(s_pose, cam, r, x, y, z, ru, rv, rw);
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
      block_sum<kSums>(v, s_red, s_tot);
      if (threadIdx.x == 0) solve_and_retract(s_tot, s_lam, s_pose, s_new);
      __syncthreads();

      float c[1] = {0.f};
      for (int i = threadIdx.x; i < N; i += kThreads) {
        const Row r = load_row<kStereo>(xw, uv, isig, ur, i, chi2_mono, chi2_stereo, delta_mono);
        const float c2 = chi2_of<kStereo>(s_new, cam, r, x, y, z, ru, rv, rw);
        c[0] += fminf(c2, r.gate) * (mask[i] ? 1.f : 0.f);
      }
      block_sum<1>(c, s_red, s_tot);
      if (threadIdx.x == 0) {
        const float c_new = s_tot[0];
        if (c_new < s_cur) {
          for (int q = 0; q < 12; ++q) s_pose[q] = s_new[q];
          s_lam = s_lam * 0.5f;
          s_cur = c_new;
        } else {
          s_lam = s_lam * 4.f;
        }
      }
      __syncthreads();
    }
    // reclassify against `valid` for the next round
    for (int i = threadIdx.x; i < N; i += kThreads) {
      const Row r = load_row<kStereo>(xw, uv, isig, ur, i, chi2_mono, chi2_stereo, delta_mono);
      const float c2 = chi2_of<kStereo>(s_pose, cam, r, x, y, z, ru, rv, rw);
      mask[i] = (c2 < r.gate && valid[i]) ? 1 : 0;
    }
    __syncthreads();
  }

  float cnt[1] = {0.f};
  for (int i = threadIdx.x; i < N; i += kThreads) cnt[0] += mask[i] ? 1.f : 0.f;
  block_sum<1>(cnt, s_red, s_tot);
  if (threadIdx.x < 9) R_out[9 * b + threadIdx.x] = s_pose[threadIdx.x];
  if (threadIdx.x < 3) t_out[3 * b + threadIdx.x] = s_pose[9 + threadIdx.x];
  if (threadIdx.x == 0) n_out[b] = static_cast<int>(s_tot[0]);
}

}  // namespace

extern "C" int pose_kernel_launch(
    const void* sc, const void* xw, const void* uv, const void* isig,
    const void* valid, const void* ur, int B, int N, int rounds, int iters,
    int stereo, float chi2_mono, float chi2_stereo, float delta_mono,
    void* R_out, void* t_out, void* mask_out, void* n_out, void* stream) {
  if (B <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (stereo) {
    pose_kernel<true><<<B, kThreads, 0, st>>>(
        static_cast<const float*>(sc), static_cast<const float*>(xw),
        static_cast<const float*>(uv), static_cast<const float*>(isig),
        static_cast<const uint8_t*>(valid), static_cast<const float*>(ur), N,
        rounds, iters, chi2_mono, chi2_stereo, delta_mono,
        static_cast<float*>(R_out), static_cast<float*>(t_out),
        static_cast<uint8_t*>(mask_out), static_cast<int*>(n_out));
  } else {
    pose_kernel<false><<<B, kThreads, 0, st>>>(
        static_cast<const float*>(sc), static_cast<const float*>(xw),
        static_cast<const float*>(uv), static_cast<const float*>(isig),
        static_cast<const uint8_t*>(valid), nullptr, N, rounds, iters,
        chi2_mono, chi2_stereo, delta_mono, static_cast<float*>(R_out),
        static_cast<float*>(t_out), static_cast<uint8_t*>(mask_out),
        static_cast<int*>(n_out));
  }
  return static_cast<int>(cudaGetLastError());
}
