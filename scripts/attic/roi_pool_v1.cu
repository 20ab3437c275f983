// The first design of the RoIPoolF forward (K1), kept as an engineering
// record beside its redesign in nafwebsod_torch/ops/csrc/. The package never
// builds it; scripts/port_k1k3_ab.py does (nvcc -I
// nafwebsod_torch/ops/csrc), to time the two in one run.
//
// RoIPoolF forward for Hopper (sm_90a), with a plain C interface for ctypes.
//
// Replaces the TPU kernel K1: nafwebsod_tpu/ops/pallas/roi_pool_pallas.py
// roi_pool_pallas (body _kernel), the Caffe2 RoIPoolF forward:
//   * each RoI coordinate is scaled by spatial_scale and rounded half away
//     from zero as floor(|v| + 0.5) * sign(v) -- NOT roundf, which differs
//     from that formula at v = 0.49999997f; extents are floored at 1;
//   * bin edges are floor(p * roi / P) and ceil((p + 1) * roi / P) in exact
//     integer arithmetic, clipped to the map;
//   * each output is the max over its bin, an empty bin gives 0 (the
//     reference maps every non-finite max to 0, and so does this kernel).
//
// Layout: feat (H, W, C) channels-last, rois (R, 5) float32 rows of
// (batch, x1, y1, x2, y2) in image coordinates, out (R, PH, PW, C) in the
// feature type -- the JAX package's layout.
//
// Bound on the card: bytes. The function must read the map once and write
// R * PH * PW * C outputs (flagship bf16: ~10.6 MB in, ~103 MB out, ~34 us
// at 3.35 TB/s). This first design reads every bin cell from global memory
// (the map fits in the 50 MB L2), so it moves about (area of the RoI on the
// map) * C * sizeof(T) of L2 traffic per RoI on top of the bound.
//
// Design: one block per (RoI, block of 128 channels); one thread per
// channel. NHWC makes a warp's reads of one cell 32 consecutive channels
// (coalesced) and its output writes contiguous. Each thread computes the
// RoI's integer bin edges itself (a few integer ops) and loops over each
// bin's cells. The max runs in float, which is exact for bf16 inputs.

#include "roi_pool_common.cuh"

namespace {

using roi_pool::bin_end;
using roi_pool::bin_start;
using roi_pool::to_float;

constexpr int kThreads = 128;

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  // v is a bf16 value widened to float (or 0): the conversion is exact.
  *p = __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
roi_pool_fwd_kernel(const T* __restrict__ feat, const float* __restrict__ rois,
                    T* __restrict__ out, int H, int W, int C, int PH, int PW,
                    float spatial_scale) {
  const int r = blockIdx.x;
  const int c = blockIdx.y * kThreads + threadIdx.x;
  if (c >= C) return;

  const roi_pool::Roi q = roi_pool::load_roi(rois, r, spatial_scale);

  const T* fc = feat + c;
  T* oc = out + static_cast<long long>(r) * PH * PW * C + c;
  for (int ph = 0; ph < PH; ++ph) {
    const int hs = bin_start(ph, q.roi_h, PH, q.y1, H);
    const int he = bin_end(ph, q.roi_h, PH, q.y1, H);
    for (int pw = 0; pw < PW; ++pw) {
      const int ws = bin_start(pw, q.roi_w, PW, q.x1, W);
      const int we = bin_end(pw, q.roi_w, PW, q.x1, W);
      float m = -INFINITY;
      bool nan = false;  // fmaxf drops NaNs; the plain version's max keeps them
      for (int y = hs; y < he; ++y) {
        const T* row = fc + static_cast<long long>(y) * W * C;
        for (int x = ws; x < we; ++x) {
          const float v = to_float(row[static_cast<long long>(x) * C]);
          nan |= isnan(v);
          m = fmaxf(m, v);
        }
      }
      store(oc + static_cast<long long>(ph * PW + pw) * C,
            (nan || !isfinite(m)) ? 0.f : m);
    }
  }
}

template <typename T>
int launch(const void* feat, const void* rois, void* out, int H, int W, int C,
           int R, int PH, int PW, float spatial_scale, void* stream) {
  if (R == 0 || C == 0) return 0;
  const dim3 grid(R, (C + kThreads - 1) / kThreads);
  roi_pool_fwd_kernel<T><<<grid, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(feat), static_cast<const float*>(rois),
      static_cast<T*>(out), H, W, C, PH, PW, spatial_scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Each returns the cudaError_t of the launch (0 on success).
int roi_pool_fwd_f32(const void* feat, const void* rois, void* out, int H,
                     int W, int C, int R, int PH, int PW, float spatial_scale,
                     void* stream) {
  return launch<float>(feat, rois, out, H, W, C, R, PH, PW, spatial_scale,
                       stream);
}

int roi_pool_fwd_bf16(const void* feat, const void* rois, void* out, int H,
                      int W, int C, int R, int PH, int PW,
                      float spatial_scale, void* stream) {
  return launch<__nv_bfloat16>(feat, rois, out, H, W, C, R, PH, PW,
                               spatial_scale, stream);
}

const char* roi_pool_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
