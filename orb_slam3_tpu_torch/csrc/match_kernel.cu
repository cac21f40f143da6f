// K1: projection-windowed ORB descriptor search.
//
// Replaces the Pallas TPU kernel orb_slam3_tpu/frontend/match_kernel.py::
// _match_kernel. For every predicted landmark, over all frame keypoints:
// window gate |dx| <= r and |dy| <= r, octave gate ko in [po+lo, po+hi],
// both valid flags, 256-bit Hamming distance, the best distance with its
// first argmin, the second best without the argmin column, and
// ok = best <= max_dist && best < ratio * second (f32).
//
// What bounds it on an H100: at the tracking shapes (2048 landmarks x 1000
// keypoints) it reads ~0.15 MB and does ~2M gate tests plus 8 XOR+popc per
// pair that passes them, far below a microsecond of memory or ALU time; the
// launch latency (a few microseconds) bounds it. The TPU version computed the
// distance of every pair on the MXU from +/-1 bit expansions; here each pair
// is gated first and only gated-in pairs pay the 8 XOR+__popc on u32 words,
// which is exact without any expansion.
//
// Design: one warp per landmark, 8 landmarks per 256-thread block. The
// block stages keypoints in tiles of 1024 in shared memory (32 B descriptor,
// x/y, octave, valid: 45 KB), each lane walks the tile with stride 32 and
// keeps (best, idx, second) for its columns, then the warp merges the 32
// triples with shuffles: merging (b1,i1,s1) with (b2,i2,s2) gives
// (b1, i1, min(s1,b2)) if b1 < b2 || (b1 == b2 && i1 < i2), else
// (b2, i2, min(s2,b1)). Masked pairs count as BIG, so a row where nothing
// passes returns (idx 0, BIG, false) like argmin over an all-BIG row.
// Launches on the caller's stream and allocates nothing.

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kTileM = 1024;
constexpr int kBig = 100000;

__device__ __forceinline__ void merge(int& b1, int& i1, int& s1, int b2, int i2, int s2) {
  if (b1 < b2 || (b1 == b2 && i1 < i2)) {
    s1 = min(s1, b2);
  } else {
    s1 = min(s2, b1);
    b1 = b2;
    i1 = i2;
  }
}

__device__ __forceinline__ int hamming(const uint4& a0, const uint4& a1,
                                       const uint4& b0, const uint4& b1) {
  return __popc(a0.x ^ b0.x) + __popc(a0.y ^ b0.y) + __popc(a0.z ^ b0.z) +
         __popc(a0.w ^ b0.w) + __popc(a1.x ^ b1.x) + __popc(a1.y ^ b1.y) +
         __popc(a1.z ^ b1.z) + __popc(a1.w ^ b1.w);
}

__global__ void __launch_bounds__(kThreads) match_kernel(
    const float* __restrict__ uv_pred, const float* __restrict__ radius,
    const int* __restrict__ pred_oct, const uint8_t* __restrict__ pred_valid,
    const uint4* __restrict__ pred_desc, const float* __restrict__ kp_xy,
    const int* __restrict__ kp_oct, const uint8_t* __restrict__ kp_valid,
    const uint4* __restrict__ kp_desc, int n, int m, float max_dist,
    float ratio, int use_ratio, int level_lo, int level_hi,
    int* __restrict__ out_idx, int* __restrict__ out_dist,
    uint8_t* __restrict__ out_ok) {
  __shared__ uint4 s_desc[2 * kTileM];
  __shared__ float2 s_xy[kTileM];
  __shared__ int s_oct[kTileM];
  __shared__ uint8_t s_valid[kTileM];

  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const bool active = row < n;

  float px = 0.f, py = 0.f, r = -1.f;
  int po = 0;
  bool pv = false;
  uint4 a0 = make_uint4(0, 0, 0, 0), a1 = a0;
  if (active) {
    px = uv_pred[2 * row];
    py = uv_pred[2 * row + 1];
    r = radius[row];
    po = pred_oct[row];
    pv = pred_valid[row] != 0;
    a0 = pred_desc[2 * row];
    a1 = pred_desc[2 * row + 1];
  }

  int best = kBig, idx = INT_MAX, second = kBig;
  for (int base = 0; base < m; base += kTileM) {
    const int cnt = min(kTileM, m - base);
    __syncthreads();
    for (int j = threadIdx.x; j < cnt; j += kThreads) {
      const int g = base + j;
      s_desc[2 * j] = kp_desc[2 * g];
      s_desc[2 * j + 1] = kp_desc[2 * g + 1];
      s_xy[j] = make_float2(kp_xy[2 * g], kp_xy[2 * g + 1]);
      s_oct[j] = kp_oct[g];
      s_valid[j] = kp_valid[g];
    }
    __syncthreads();
    if (active && pv) {
      for (int j = lane; j < cnt; j += 32) {
        const float2 k = s_xy[j];
        const int ko = s_oct[j];
        if (!s_valid[j] || !(fabsf(px - k.x) <= r) || !(fabsf(py - k.y) <= r) ||
            ko < po + level_lo || ko > po + level_hi) {
          continue;
        }
        const int d = hamming(a0, a1, s_desc[2 * j], s_desc[2 * j + 1]);
        // columns arrive in increasing order, so a tie keeps the earlier one
        if (d < best) {
          second = best;
          best = d;
          idx = base + j;
        } else {
          second = min(second, d);
        }
      }
    }
  }

#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const int b2 = __shfl_down_sync(0xffffffffu, best, off);
    const int i2 = __shfl_down_sync(0xffffffffu, idx, off);
    const int s2 = __shfl_down_sync(0xffffffffu, second, off);
    merge(best, idx, second, b2, i2, s2);
  }

  if (active && lane == 0) {
    if (best >= kBig) idx = 0;
    bool ok = static_cast<float>(best) <= max_dist;
    if (use_ratio) ok = ok && (static_cast<float>(best) < ratio * static_cast<float>(second));
    out_idx[row] = idx;
    out_dist[row] = best;
    out_ok[row] = ok ? 1 : 0;
  }
}

}  // namespace

extern "C" int match_kernel_launch(
    const void* uv_pred, const void* radius, const void* pred_oct,
    const void* pred_valid, const void* pred_desc, const void* kp_xy,
    const void* kp_oct, const void* kp_valid, const void* kp_desc, int n,
    int m, float max_dist, float ratio, int use_ratio, int level_lo,
    int level_hi, void* out_idx, void* out_dist, void* out_ok, void* stream) {
  if (n <= 0) return 0;
  const dim3 grid((n + kWarps - 1) / kWarps);
  match_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(uv_pred), static_cast<const float*>(radius),
      static_cast<const int*>(pred_oct), static_cast<const uint8_t*>(pred_valid),
      static_cast<const uint4*>(pred_desc), static_cast<const float*>(kp_xy),
      static_cast<const int*>(kp_oct), static_cast<const uint8_t*>(kp_valid),
      static_cast<const uint4*>(kp_desc), n, m, max_dist, ratio, use_ratio,
      level_lo, level_hi, static_cast<int*>(out_idx),
      static_cast<int*>(out_dist), static_cast<uint8_t*>(out_ok));
  return static_cast<int>(cudaGetLastError());
}
