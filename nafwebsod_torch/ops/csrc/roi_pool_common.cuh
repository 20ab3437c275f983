// Device functions shared by the RoIPoolF forward (roi_pool.cu) and backward
// (roi_pool_bwd.cu): the rounding of RoI coordinates and the integer bin
// edges, so both kernels see exactly the same bins.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace roi_pool {

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ int round_half_away(float coord, float scale) {
  // floor(|v| + 0.5) * sign(v) -- NOT roundf, which differs from that
  // formula at v = 0.49999997f. __fmul_rn keeps the product from being
  // contracted into an FMA.
  const float v = __fmul_rn(coord, scale);
  const float r = floorf(fabsf(v) + 0.5f);
  return v < 0.f ? -static_cast<int>(r) : static_cast<int>(r);
}

// One RoI on the map: its first cell and its extent (floored at 1).
struct Roi {
  int x1, y1, roi_w, roi_h;
};

__device__ __forceinline__ Roi load_roi(const float* __restrict__ rois, int r,
                                        float spatial_scale) {
  const float* roi = rois + 5LL * r;
  Roi q;
  q.x1 = round_half_away(roi[1], spatial_scale);
  q.y1 = round_half_away(roi[2], spatial_scale);
  const int x2 = round_half_away(roi[3], spatial_scale);
  const int y2 = round_half_away(roi[4], spatial_scale);
  q.roi_h = max(y2 - q.y1 + 1, 1);
  q.roi_w = max(x2 - q.x1 + 1, 1);
  return q;
}

// [start, end) of bin p of P over an extent that starts at lo, clipped to
// [0, size]: floor(p * extent / P) and ceil((p + 1) * extent / P) in exact
// integer arithmetic.
__device__ __forceinline__ int bin_start(int p, int extent, int P, int lo,
                                         int size) {
  return min(max((p * extent) / P + lo, 0), size);
}
__device__ __forceinline__ int bin_end(int p, int extent, int P, int lo,
                                       int size) {
  return min(max(((p + 1) * extent + P - 1) / P + lo, 0), size);
}

}  // namespace roi_pool
