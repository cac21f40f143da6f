// K1: projection-windowed ORB descriptor search.
//
// Replaces: the Pallas TPU kernel orb_slam3_tpu/frontend/match_kernel.py::
// _match_kernel. For every predicted landmark, over all frame keypoints:
// window gate |dx| <= r and |dy| <= r, octave gate ko in [po+lo, po+hi],
// both valid flags, 256-bit Hamming distance, the best distance with its
// first argmin, the second best without the argmin column, and
// ok = best <= max_dist && best < ratio * second (f32).
//
// What bounds it on an H100: at the tracking shapes (2048 landmarks x 1000
// keypoints) it reads ~0.16 MB and, gating only the keypoints near each
// window, does well under a microsecond of ALU work; the launch and the
// few block-wide barriers of the binning bound it. The TPU version computed
// the distance of every pair on the MXU from +/-1 bit expansions; here each
// pair is gated first and only gated-in pairs pay 8 XOR + __popc on u32
// words, which is exact without any expansion.
//
// Design: keypoints are binned spatially, as ORB-SLAM's
// Frame::GetFeaturesInArea grid does, so a landmark gates only the
// keypoints of the cells its window overlaps, not all M.
// - A block is 512 threads, one warp per landmark (16 landmarks a block,
//   128 blocks at N = 2048). It takes the keypoints in tiles of kTileM,
//   each thread loading its four keypoints of a tile into registers once.
//   For each tile it computes the bounding box of the valid, finite
//   keypoints (so keypoints anywhere work), lays a grid of kGridX x kGridY
//   cells over it (tall cells: a window spans few rows, and one row's run
//   fills a warp), counts keypoints per cell with shared atomics, takes the
//   exclusive prefix sum, and scatters each keypoint's (x, y, octave, index)
//   and descriptor into cell order in dynamic shared memory (48 B a
//   keypoint, 96 KB a tile), so the search touches no global memory. Valid
//   keypoints with a non-finite coordinate go to one extra bin after the
//   grid.
// - A landmark's warp visits, for each grid row its window (widened by a
//   relative 1e-6 margin, so rounding cannot drop a keypoint the gate would
//   take) overlaps, the contiguous run of keypoints in the overlapped
//   columns; lanes stride over the run. A window outside the box visits no
//   cell and gives the empty result (idx 0, dist 100000, not ok). A
//   landmark with a non-finite position or radius scans the whole tile.
// - Visiting order is not column order, so the lane-local update breaks
//   ties on the keypoint index itself: a distance equal to the best with a
//   lower index takes its place. The warp then merges the 32 lanes'
//   (best, idx, second) with shuffles: merging (b1,i1,s1) with (b2,i2,s2)
//   gives (b1, i1, min(s1,b2)) if b1 < b2 || (b1 == b2 && i1 < i2), else
//   (b2, i2, min(s2,b1)). Both rules are order-free, so ties go to the
//   lowest column exactly as JAX's argmin gives them, and the lane state
//   carries across tiles: any M works, M = 0 included.
// Launches on the caller's stream and allocates nothing.

#include <cuda_runtime.h>
#include <math_constants.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;
constexpr int kTileM = 2048;
constexpr int kPer = kTileM / kThreads;  // keypoints a thread holds per tile
constexpr int kGridX = 63;
constexpr int kGridY = 8;
constexpr int kCells = kGridX * kGridY;  // bin kCells holds non-finite keypoints
constexpr int kBins = kCells + 1;
static_assert(kBins <= kThreads, "the prefix sum gives each bin one thread");
constexpr int kBig = 100000;
constexpr unsigned kFull = 0xffffffffu;
constexpr size_t kDynSmem = kTileM * (sizeof(int4) + 2 * sizeof(uint4));

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

// Grid column (or row) of coordinate v among G: monotone in v, clamped.
template <int G>
__device__ __forceinline__ int cell_of(float v, float v0, float inv) {
  const float t = fminf(fmaxf((v - v0) * inv, 0.f), static_cast<float>(G - 1));
  return static_cast<int>(t);
}

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fminf(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

__device__ __forceinline__ int warp_incl_scan(int v, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int o = __shfl_up_sync(kFull, v, off);
    if (lane >= off) v += o;
  }
  return v;
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
  extern __shared__ uint4 s_dyn[];
  int4* s_kp = reinterpret_cast<int4*>(s_dyn);  // x bits, y bits, octave, keypoint index
  uint4* s_desc = s_dyn + kTileM;                // two uint4 per keypoint, same order
  __shared__ int s_start[kBins + 1];
  __shared__ int s_fill[kBins];
  __shared__ float s_box[kWarps * 4];
  __shared__ int s_wsum[kWarps];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row = blockIdx.x * kWarps + warp;

  float px = 0.f, py = 0.f, r = -1.f;
  int po = 0;
  bool search = false, full_scan = false;
  uint4 a0 = make_uint4(0, 0, 0, 0), a1 = a0;
  if (row < n) {
    px = uv_pred[2 * row];
    py = uv_pred[2 * row + 1];
    r = radius[row];
    po = pred_oct[row];
    a0 = pred_desc[2 * row];
    a1 = pred_desc[2 * row + 1];
    // r < 0 (or NaN) passes no gate; -0 passes exact hits
    search = pred_valid[row] != 0 && r >= 0.f;
    full_scan = !(isfinite(px) && isfinite(py) && isfinite(r));
  }
  const float margin = (fabsf(px) + r) * 1e-6f;
  const float wx0 = px - r - margin, wx1 = px + r + margin;
  const float wy0 = py - r - margin, wy1 = py + r + margin;

  int best = kBig, idx = INT_MAX, second = kBig;
  for (int base = 0; base < m; base += kTileM) {
    const int cnt = min(kTileM, m - base);
    // this thread's keypoints of the tile, loaded once: keypoint base + j,
    // j = threadIdx.x + q * kThreads; cell -1 marks an invalid one
    float kx[kPer], ky[kPer];
    int ko[kPer], cell[kPer];
    uint4 kd0[kPer], kd1[kPer];
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      const int j = threadIdx.x + q * kThreads;
      const int g = base + j;
      const bool in = j < cnt;
      kx[q] = in ? kp_xy[2 * g] : 0.f;
      ky[q] = in ? kp_xy[2 * g + 1] : 0.f;
      ko[q] = in ? kp_oct[g] : 0;
      cell[q] = in && kp_valid[g] ? 0 : -1;
      kd0[q] = in ? kp_desc[2 * g] : make_uint4(0, 0, 0, 0);
      kd1[q] = in ? kp_desc[2 * g + 1] : make_uint4(0, 0, 0, 0);
    }
    __syncthreads();  // the previous tile's search is done with the bins
    // bounding box of the tile's valid, finite keypoints; clear the counts
    float mnx = CUDART_INF_F, mny = CUDART_INF_F, mxx = -CUDART_INF_F, mxy = -CUDART_INF_F;
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      if (cell[q] == 0 && isfinite(kx[q]) && isfinite(ky[q])) {
        mnx = fminf(mnx, kx[q]);
        mny = fminf(mny, ky[q]);
        mxx = fmaxf(mxx, kx[q]);
        mxy = fmaxf(mxy, ky[q]);
      }
    }
    mnx = warp_min(mnx);
    mny = warp_min(mny);
    mxx = warp_max(mxx);
    mxy = warp_max(mxy);
    if (lane == 0) {
      s_box[4 * warp] = mnx;
      s_box[4 * warp + 1] = mny;
      s_box[4 * warp + 2] = mxx;
      s_box[4 * warp + 3] = mxy;
    }
    if (threadIdx.x < kBins) s_fill[threadIdx.x] = 0;
    __syncthreads();
    // every warp reduces the kWarps warp boxes itself: no broadcast barrier
    const bool w_in = lane < kWarps;
    const float x0 = warp_min(w_in ? s_box[4 * lane] : CUDART_INF_F);
    const float y0 = warp_min(w_in ? s_box[4 * lane + 1] : CUDART_INF_F);
    const float x1 = warp_max(w_in ? s_box[4 * lane + 2] : -CUDART_INF_F);
    const float y1 = warp_max(w_in ? s_box[4 * lane + 3] : -CUDART_INF_F);
    float inv_w = x1 > x0 ? kGridX / (x1 - x0) : 0.f;
    float inv_h = y1 > y0 ? kGridY / (y1 - y0) : 0.f;
    if (!isfinite(inv_w)) inv_w = 0.f;
    if (!isfinite(inv_h)) inv_h = 0.f;

    // histogram of the valid keypoints over the bins
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      if (cell[q] == 0) {
        const bool finite = isfinite(kx[q]) && isfinite(ky[q]);
        cell[q] = finite ? cell_of<kGridY>(ky[q], y0, inv_h) * kGridX +
                               cell_of<kGridX>(kx[q], x0, inv_w)
                         : kCells;
        atomicAdd(&s_fill[cell[q]], 1);
      }
    }
    __syncthreads();
    // exclusive prefix sum of the counts: s_start[c] .. s_start[c + 1]
    const int c_cnt = threadIdx.x < kBins ? s_fill[threadIdx.x] : 0;
    const int incl = warp_incl_scan(c_cnt, lane);
    if (lane == 31) s_wsum[warp] = incl;
    __syncthreads();
    const int wincl = warp_incl_scan(lane < kWarps ? s_wsum[lane] : 0, lane);
    const int before = __shfl_sync(kFull, wincl, warp > 0 ? warp - 1 : 0);
    const int excl = (warp > 0 ? before : 0) + incl - c_cnt;
    if (threadIdx.x < kBins) {
      s_start[threadIdx.x] = excl;
      s_fill[threadIdx.x] = excl;
    }
    if (threadIdx.x == kBins - 1) s_start[kBins] = excl + c_cnt;
    __syncthreads();
    // scatter into cell order
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      if (cell[q] >= 0) {
        const int pos = atomicAdd(&s_fill[cell[q]], 1);
        s_kp[pos] = make_int4(__float_as_int(kx[q]), __float_as_int(ky[q]), ko[q],
                              base + threadIdx.x + q * kThreads);
        s_desc[2 * pos] = kd0[q];
        s_desc[2 * pos + 1] = kd1[q];
      }
    }
    __syncthreads();

    if (!search) continue;
    // runs of cell-ordered keypoints to gate: one per overlapped grid row,
    // or the whole tile
    int cx0 = 0, cx1 = -1, cy0 = 0, cy1 = -1;
    if (full_scan) {
      cy1 = 0;
    } else if (!(wx1 < x0 || wx0 > x1 || wy1 < y0 || wy0 > y1)) {
      cx0 = cell_of<kGridX>(wx0, x0, inv_w);
      cx1 = cell_of<kGridX>(wx1, x0, inv_w);
      cy0 = cell_of<kGridY>(wy0, y0, inv_h);
      cy1 = cell_of<kGridY>(wy1, y0, inv_h);
    }
    for (int cy = cy0; cy <= cy1; ++cy) {
      const int lo = full_scan ? 0 : s_start[cy * kGridX + cx0];
      const int hi = full_scan ? s_start[kBins] : s_start[cy * kGridX + cx1 + 1];
      for (int k = lo + lane; k < hi; k += 32) {
        const int4 e = s_kp[k];
        const float dx = fabsf(px - __int_as_float(e.x)), dy = fabsf(py - __int_as_float(e.y));
        if (!(dx <= r) || !(dy <= r) || e.z < po + level_lo || e.z > po + level_hi) {
          continue;
        }
        const int g = e.w;
        const int d = hamming(a0, a1, s_desc[2 * k], s_desc[2 * k + 1]);
        // keypoints arrive in cell order: a tie goes to the lower index
        if (d < best || (d == best && g < idx)) {
          second = best;
          best = d;
          idx = g;
        } else {
          second = min(second, d);
        }
      }
    }
  }

#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const int b2 = __shfl_down_sync(kFull, best, off);
    const int i2 = __shfl_down_sync(kFull, idx, off);
    const int s2 = __shfl_down_sync(kFull, second, off);
    merge(best, idx, second, b2, i2, s2);
  }

  if (row < n && lane == 0) {
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
  // 96 KB of binned keypoints: above the 48 KB default, so opt in (once
  // per device)
  static bool opted[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < 64 && !opted[dev]) {
    e = cudaFuncSetAttribute(match_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kDynSmem));
    if (e != cudaSuccess) return static_cast<int>(e);
    opted[dev] = true;
  }
  const dim3 grid((n + kWarps - 1) / kWarps);
  match_kernel<<<grid, kThreads, kDynSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(uv_pred), static_cast<const float*>(radius),
      static_cast<const int*>(pred_oct), static_cast<const uint8_t*>(pred_valid),
      static_cast<const uint4*>(pred_desc), static_cast<const float*>(kp_xy),
      static_cast<const int*>(kp_oct), static_cast<const uint8_t*>(kp_valid),
      static_cast<const uint4*>(kp_desc), n, m, max_dist, ratio, use_ratio,
      level_lo, level_hi, static_cast<int*>(out_idx),
      static_cast<int*>(out_dist), static_cast<uint8_t*>(out_ok));
  return static_cast<int>(cudaGetLastError());
}
