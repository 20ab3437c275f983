// RoIAlign forward for Hopper (sm_90a), with a plain C interface for ctypes.
//
// Replaces the TPU kernel K4: nafwebsod_tpu/ops/pallas/roi_align_pallas.py
// roi_align_pallas (body _kernel, weights _axis_weights), Detectron's legacy
// RoIAlign with a static sampling grid:
//   * RoI coordinates are scaled by spatial_scale and NOT rounded; extents
//     are floored at 1 in feature units;
//   * bin (ph, pw) takes sr x sr samples at
//     start + p * bin + (s + 0.5) * bin / sr, no half-pixel offset;
//   * a sample counts iff -1 <= coord <= limit on both axes (the closed
//     upper end: a sample at exactly H counts and is clipped to H - 1),
//     limit being the map's true H or W; a sample outside has its whole
//     value multiplied by 0 (so a NaN cell under it gives NaN, as in the
//     plain version);
//   * coordinates are clipped to [0, limit - 1], the upper neighbour is
//     min(c0 + 1, limit - 1), the value is the 4-corner bilinear blend;
//   * the output is the mean of the bin's samples, float32 whatever the
//     map's type (a bfloat16 cell is widened before the products).
//
// Every float operation is spelled with a round-to-nearest intrinsic in the
// order of the plain version (ops/roi_pool.py roi_align_reference), so that
// no product and sum is contracted into an FMA and the two agree bit for
// bit.
//
// Layout: feat (H, W, C) channels-last, rois (R, 5) float32 rows of
// (batch, x1, y1, x2, y2) in image coordinates, out (R, PH, PW, C) float32.
//
// Bound on the card: bytes. The function must read the map once and write
// R * PH * PW * C float32 outputs; at the mask head's training shapes (an
// (87, 119, 512) bfloat16 map, 2048 RoIs, 14 x 14) the output is 822 MB
// against a 10.6 MB map. This first design reads the four corners of every
// sample from global memory (the map fits in the L2), 4 * sr * sr loads per
// output, on top of the bound.
//
// Design: one block per (RoI, block of 128 channels); one thread per
// channel, so a warp's read of one cell is 32 consecutive channels and its
// writes are contiguous. The block first computes, once per RoI and axis,
// each sample's two cells, its fraction and its validity into shared
// memory; then every thread walks the bins. Nothing of the TPU kernel's
// shape is kept: no resident channel block, no window tiers, no aligned
// window base or W padding, no 0/1 group-sum product, no size limit on the
// map and no fallback.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// One sample along one axis: its lower and upper cell, the upper cell's
// weight, and 1 or 0 for a sample inside or outside [-1, limit].
struct Sample {
  int c0, c1;
  float frac, valid;
};

// Sample i (bin i / sr, offset i % sr) of `pooled` bins between the scaled
// coordinates start and end on an axis of `limit` cells.
__device__ __forceinline__ Sample axis_sample(float start, float end, int i,
                                              int pooled, int sr, int limit) {
  const float extent = fmaxf(__fsub_rn(end, start), 1.f);
  const float bin = __fdiv_rn(extent, static_cast<float>(pooled));
  const float p = static_cast<float>(i / sr);
  const float s = static_cast<float>(i % sr);
  const float coord = __fadd_rn(
      __fadd_rn(start, __fmul_rn(p, bin)),
      __fdiv_rn(__fmul_rn(__fadd_rn(s, 0.5f), bin), static_cast<float>(sr)));
  const float top = static_cast<float>(limit);
  Sample q;
  q.valid = (coord >= -1.f && coord <= top) ? 1.f : 0.f;
  const float cc = fminf(fmaxf(coord, 0.f), __fsub_rn(top, 1.f));
  const float lo = floorf(cc);
  q.c0 = min(max(static_cast<int>(lo), 0), limit - 1);
  q.c1 = min(q.c0 + 1, limit - 1);
  q.frac = __fsub_rn(cc, lo);
  return q;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
roi_align_fwd_kernel(const T* __restrict__ feat,
                     const float* __restrict__ rois, float* __restrict__ out,
                     int H, int W, int C, int PH, int PW, int sr,
                     float spatial_scale) {
  extern __shared__ Sample samples[];   // PH * sr rows, then PW * sr columns
  Sample* sy = samples;
  Sample* sx = samples + PH * sr;

  const int r = blockIdx.x;
  const float* roi = rois + 5LL * r;
  const float start_w = __fmul_rn(roi[1], spatial_scale);
  const float start_h = __fmul_rn(roi[2], spatial_scale);
  const float end_w = __fmul_rn(roi[3], spatial_scale);
  const float end_h = __fmul_rn(roi[4], spatial_scale);
  for (int i = threadIdx.x; i < PH * sr; i += kThreads)
    sy[i] = axis_sample(start_h, end_h, i, PH, sr, H);
  for (int i = threadIdx.x; i < PW * sr; i += kThreads)
    sx[i] = axis_sample(start_w, end_w, i, PW, sr, W);
  __syncthreads();

  const int c = blockIdx.y * kThreads + threadIdx.x;
  if (c >= C) return;

  const T* fc = feat + c;
  float* oc = out + static_cast<long long>(r) * PH * PW * C + c;
  const float count = static_cast<float>(sr * sr);
  const long long row_stride = static_cast<long long>(W) * C;
  for (int ph = 0; ph < PH; ++ph) {
    for (int pw = 0; pw < PW; ++pw) {
      float acc = 0.f;
      for (int iy = 0; iy < sr; ++iy) {
        const Sample y = sy[ph * sr + iy];
        const float hy = __fsub_rn(1.f, y.frac);
        const T* row0 = fc + y.c0 * row_stride;
        const T* row1 = fc + y.c1 * row_stride;
        for (int ix = 0; ix < sr; ++ix) {
          const Sample x = sx[pw * sr + ix];
          const float hx = __fsub_rn(1.f, x.frac);
          const long long o0 = static_cast<long long>(x.c0) * C;
          const long long o1 = static_cast<long long>(x.c1) * C;
          const float f00 = to_float(row0[o0]);
          const float f01 = to_float(row0[o1]);
          const float f10 = to_float(row1[o0]);
          const float f11 = to_float(row1[o1]);
          float v = __fmul_rn(__fmul_rn(f00, hy), hx);
          v = __fadd_rn(v, __fmul_rn(__fmul_rn(f01, hy), x.frac));
          v = __fadd_rn(v, __fmul_rn(__fmul_rn(f10, y.frac), hx));
          v = __fadd_rn(v, __fmul_rn(__fmul_rn(f11, y.frac), x.frac));
          v = __fmul_rn(v, __fmul_rn(y.valid, x.valid));
          acc = (iy == 0 && ix == 0) ? v : __fadd_rn(acc, v);
        }
      }
      oc[static_cast<long long>(ph * PW + pw) * C] = __fdiv_rn(acc, count);
    }
  }
}

template <typename T>
int launch(const void* feat, const void* rois, void* out, int H, int W, int C,
           int R, int PH, int PW, int sr, float spatial_scale, void* stream) {
  if (R == 0 || C == 0) return 0;
  const size_t shared = static_cast<size_t>(PH + PW) * sr * sizeof(Sample);
  if (shared > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(R, (C + kThreads - 1) / kThreads);
  roi_align_fwd_kernel<T><<<grid, kThreads, shared,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(feat), static_cast<const float*>(rois),
      static_cast<float*>(out), H, W, C, PH, PW, sr, spatial_scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Each returns the cudaError_t of the launch (0 on success).
int roi_align_fwd_f32(const void* feat, const void* rois, void* out, int H,
                      int W, int C, int R, int PH, int PW, int sr,
                      float spatial_scale, void* stream) {
  return launch<float>(feat, rois, out, H, W, C, R, PH, PW, sr, spatial_scale,
                       stream);
}

int roi_align_fwd_bf16(const void* feat, const void* rois, void* out, int H,
                       int W, int C, int R, int PH, int PW, int sr,
                       float spatial_scale, void* stream) {
  return launch<__nv_bfloat16>(feat, rois, out, H, W, C, R, PH, PW, sr,
                               spatial_scale, stream);
}

const char* roi_align_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
