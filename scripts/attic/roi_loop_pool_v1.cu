// The first design of the RoILoopPool forward (K2), kept as an engineering
// record beside its redesign in nafwebsod_torch/ops/csrc/. The package never
// builds it; scripts/port_k2k4_ab.py does (nvcc -I
// nafwebsod_torch/ops/csrc), to time the two in one run.
//
// RoILoopPool (ring max pooling) forward for Hopper (sm_90a), with a plain C
// interface for ctypes.
//
// Replaces the TPU kernel K2: nafwebsod_tpu/ops/pallas/roi_loop_pool_pallas.py
// roi_loop_pool_pallas (body _kernel), the Caffe2 RoILoopPool forward of the
// context head:
//   * a RoI is 9 floats (batch, outer x1 y1 x2 y2, inner x1 y1 x2 y2) in
//     image coordinates; all eight coordinates are scaled by spatial_scale
//     and rounded half away from zero exactly as RoIPoolF rounds them;
//   * the bins are RoIPoolF's integer bins of the OUTER box (extents floored
//     at 1, edges clipped to the map): roi_pool_common.cuh, shared with the
//     RoIPoolF kernels so that all three see the same bins;
//   * each output is the max over its bin's cells EXCEPT those strictly
//     inside the inner box (iy1 < y < iy2 and ix1 < x < ix2): the inner
//     box's own border cells belong to the ring, and an inner box one or two
//     cells wide excludes nothing;
//   * the running max starts at 0: an empty bin, an empty ring and an
//     all-negative ring give 0 (unlike RoIPoolF, where a negative max
//     survives);
//   * a ring that holds a NaN or +inf gives 0, as the plain version does
//     (its max propagates NaN, and every non-finite max is mapped to 0). A
//     non-finite cell in the excluded interior is never read. -inf cells
//     lose against the 0 the max starts at.
//
// Layout: feat (H, W, C) channels-last, rois9 (R, 9) float32, out
// (R, PH, PW, C) in the feature type -- the JAX package's layout.
//
// Bound on the card: bytes. The function must read the map once and write
// R * PH * PW * C outputs (context head, bf16: ~10.6 MB in, ~103 MB out,
// ~34 us at 3.35 TB/s). Like the RoIPoolF forward, this first design reads
// every ring cell from global memory (the map fits in the 50 MB L2), so it
// moves about (area of the ring on the map) * C * sizeof(T) of L2 traffic
// per RoI on top of the bound, in a serial per-thread scan.
//
// Design: RoIPoolF's. One block per (RoI, block of 128 channels), one
// thread per channel: a warp's reads of one cell are 32 consecutive
// channels (coalesced), its writes contiguous. Each thread scans its bins
// row by row; a row strictly inside the inner box's rows is scanned as two
// spans, up to the inner box's left border column and from its right
// border column on, so the excluded interior costs nothing and both loops
// are RoIPoolF's plain ones (a scan that tests every cell and jumps took
// 2.5x RoIPoolF's time on the same outer boxes: the data-dependent loop
// variable keeps the loads from overlapping). No size limit and no other
// path.

#include "roi_pool_common.cuh"

namespace {

using roi_pool::bin_end;
using roi_pool::bin_start;
using roi_pool::round_half_away;
using roi_pool::to_float;

constexpr int kThreads = 128;

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  // v is a bf16 value widened to float (or 0): the conversion is exact.
  *p = __float2bfloat16_rn(v);
}

// Folds the cells [x0, x1) of one map row into the running max.
template <typename T>
__device__ __forceinline__ void scan(const T* __restrict__ row, int x0, int x1,
                                     int C, float& m, bool& bad) {
  for (int x = x0; x < x1; ++x) {
    const float v = to_float(row[static_cast<long long>(x) * C]);
    bad |= isnan(v);
    m = fmaxf(m, v);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
roi_loop_pool_fwd_kernel(const T* __restrict__ feat,
                         const float* __restrict__ rois9, T* __restrict__ out,
                         int H, int W, int C, int PH, int PW,
                         float spatial_scale) {
  const int r = blockIdx.x;
  const int c = blockIdx.y * kThreads + threadIdx.x;
  if (c >= C) return;

  const float* roi = rois9 + 9LL * r;
  const int x1 = round_half_away(roi[1], spatial_scale);
  const int y1 = round_half_away(roi[2], spatial_scale);
  const int x2 = round_half_away(roi[3], spatial_scale);
  const int y2 = round_half_away(roi[4], spatial_scale);
  const int ix1 = round_half_away(roi[5], spatial_scale);
  const int iy1 = round_half_away(roi[6], spatial_scale);
  const int ix2 = round_half_away(roi[7], spatial_scale);
  const int iy2 = round_half_away(roi[8], spatial_scale);
  const int roi_h = max(y2 - y1 + 1, 1);
  const int roi_w = max(x2 - x1 + 1, 1);

  const T* fc = feat + c;
  T* oc = out + static_cast<long long>(r) * PH * PW * C + c;
  for (int ph = 0; ph < PH; ++ph) {
    const int hs = bin_start(ph, roi_h, PH, y1, H);
    const int he = bin_end(ph, roi_h, PH, y1, H);
    for (int pw = 0; pw < PW; ++pw) {
      const int ws = bin_start(pw, roi_w, PW, x1, W);
      const int we = bin_end(pw, roi_w, PW, x1, W);
      float m = 0.f;     // the op's maxval starts at 0
      bool bad = false;  // fmaxf drops NaNs; the plain version's max keeps them
      for (int y = hs; y < he; ++y) {
        const T* row = fc + static_cast<long long>(y) * W * C;
        // The ring's cells of this bin row: [ws, e1) and [s2, we). Off the
        // inner box's open rows, or with no open columns between its
        // borders, the first span is the whole bin row and the second empty.
        const bool hole = y > iy1 && y < iy2 && ix2 - ix1 > 1;
        const int e1 = hole ? min(max(ix1 + 1, ws), we) : we;
        const int s2 = hole ? min(max(ix2, ws), we) : we;
        scan(row, ws, e1, C, m, bad);
        scan(row, s2, we, C, m, bad);
      }
      store(oc + static_cast<long long>(ph * PW + pw) * C,
            (bad || !isfinite(m)) ? 0.f : m);
    }
  }
}

template <typename T>
int launch(const void* feat, const void* rois9, void* out, int H, int W, int C,
           int R, int PH, int PW, float spatial_scale, void* stream) {
  if (R == 0 || C == 0) return 0;
  const dim3 grid(R, (C + kThreads - 1) / kThreads);
  roi_loop_pool_fwd_kernel<T><<<grid, kThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(feat), static_cast<const float*>(rois9),
      static_cast<T*>(out), H, W, C, PH, PW, spatial_scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Each returns the cudaError_t of the launch (0 on success).
int roi_loop_pool_fwd_f32(const void* feat, const void* rois9, void* out,
                          int H, int W, int C, int R, int PH, int PW,
                          float spatial_scale, void* stream) {
  return launch<float>(feat, rois9, out, H, W, C, R, PH, PW, spatial_scale,
                       stream);
}

int roi_loop_pool_fwd_bf16(const void* feat, const void* rois9, void* out,
                           int H, int W, int C, int R, int PH, int PW,
                           float spatial_scale, void* stream) {
  return launch<__nv_bfloat16>(feat, rois9, out, H, W, C, R, PH, PW,
                               spatial_scale, stream);
}

const char* roi_loop_pool_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
