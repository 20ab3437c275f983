// The first design of the RoIPoolF backward (K3), kept as an engineering
// record beside its redesign in nafwebsod_torch/ops/csrc/. The package never
// builds it; scripts/port_k1k3_ab.py does (nvcc -I
// nafwebsod_torch/ops/csrc), to time the two in one run.
//
// RoIPoolF backward for Hopper (sm_90a), with a plain C interface for ctypes.
//
// Replaces the TPU kernel K3: nafwebsod_tpu/ops/pallas/roi_pool_pallas.py
// roi_pool_pallas_bwd (body _bwd_kernel), the Caffe2 RoIPoolF gradient:
//   * the bins are those of the forward (roi_pool_common.cuh);
//   * each bin's cotangent goes to the FIRST max cell of the bin in
//     row-major order (a strict > while scanning rows, then columns);
//   * an empty bin and a bin whose max is not finite (the forward wrote 0
//     there) pass nothing back;
//   * G seed batches share one argmax scan: g is (G, R, PH, PW, C) and
//     dfeat (G, H, W, C); a (bin, channel) whose G cotangents are all zero
//     is not scanned at all, so an all-zero seed batch costs one read of g.
//
// Layout: feat (H, W, C) channels-last float32 or bfloat16, rois (R, 5)
// float32, g float32 or bfloat16, dfeat float32 and zeroed by the caller.
// The comparison runs in float, which is exact for bf16 features.
//
// Bound on the card: bytes. The function must read feat, rois and g once
// and write dfeat once (flagship, G = 1, bf16: ~10.6 MB + ~103 MB in,
// ~21 MB out, ~40 us at 3.35 TB/s). Like the forward, this first design
// reads every bin cell from global memory (the map sits in the L2).
//
// Design: what the TPU kernel kept serial (a VMEM-resident accumulator
// walked RoI by RoI, tiered windows, a 96x96 size limit) does not carry
// over. One block per (RoI, block of 128 channels), one thread per channel:
// a warp's reads of one cell and its adds to one cell are 32 consecutive
// channels. RoIs overlap, so many blocks add to one cell: the sums use
// float atomicAdd. The routing is deterministic; the order of the additions
// is not, so sums of non-integers differ from run to run in the last bits.

#include "roi_pool_common.cuh"

namespace {

using roi_pool::bin_end;
using roi_pool::bin_start;
using roi_pool::to_float;

constexpr int kThreads = 128;

template <typename T, typename TG>
__global__ void __launch_bounds__(kThreads)
roi_pool_bwd_kernel(const T* __restrict__ feat, const float* __restrict__ rois,
                    const TG* __restrict__ g, float* __restrict__ dfeat,
                    int H, int W, int C, int R, int G, int PH, int PW,
                    float spatial_scale) {
  const int r = blockIdx.x;
  const int c = blockIdx.y * kThreads + threadIdx.x;
  if (c >= C) return;

  const roi_pool::Roi q = roi_pool::load_roi(rois, r, spatial_scale);

  const T* fc = feat + c;
  const long long map = static_cast<long long>(H) * W * C;
  const long long seed = static_cast<long long>(R) * PH * PW * C;
  const TG* gc = g + static_cast<long long>(r) * PH * PW * C + c;
  for (int ph = 0; ph < PH; ++ph) {
    const int hs = bin_start(ph, q.roi_h, PH, q.y1, H);
    const int he = bin_end(ph, q.roi_h, PH, q.y1, H);
    if (he <= hs) continue;
    for (int pw = 0; pw < PW; ++pw) {
      const int ws = bin_start(pw, q.roi_w, PW, q.x1, W);
      const int we = bin_end(pw, q.roi_w, PW, q.x1, W);
      if (we <= ws) continue;
      const TG* gb = gc + static_cast<long long>(ph * PW + pw) * C;
      bool live = false;
      for (int s = 0; s < G; ++s) live |= to_float(gb[s * seed]) != 0.f;
      if (!live) continue;

      float m = -INFINITY;
      bool nan = false;
      long long best = -1;
      for (int y = hs; y < he; ++y) {
        const long long row = static_cast<long long>(y) * W;
        for (int x = ws; x < we; ++x) {
          const long long cell = (row + x) * C;
          const float v = to_float(fc[cell]);
          nan |= isnan(v);
          if (v > m) {  // strict: the first max in row-major order wins
            m = v;
            best = cell;
          }
        }
      }
      if (nan || best < 0 || !isfinite(m)) continue;
      for (int s = 0; s < G; ++s) {
        const float gv = to_float(gb[s * seed]);
        if (gv != 0.f) atomicAdd(dfeat + s * map + best + c, gv);
      }
    }
  }
}

template <typename T, typename TG>
int launch(const void* feat, const void* rois, const void* g, void* dfeat,
           int H, int W, int C, int R, int G, int PH, int PW,
           float spatial_scale, void* stream) {
  if (R == 0 || C == 0 || G == 0) return 0;
  const dim3 grid(R, (C + kThreads - 1) / kThreads);
  roi_pool_bwd_kernel<T, TG><<<grid, kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(feat), static_cast<const float*>(rois),
      static_cast<const TG*>(g), static_cast<float*>(dfeat), H, W, C, R, G,
      PH, PW, spatial_scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Each returns the cudaError_t of the launch (0 on success). The name is
// roi_pool_bwd_<feature type>_<cotangent type>.
#define ROI_POOL_BWD_ENTRY(NAME, T, TG)                                      \
  int NAME(const void* feat, const void* rois, const void* g, void* dfeat,  \
           int H, int W, int C, int R, int G, int PH, int PW,               \
           float spatial_scale, void* stream) {                             \
    return launch<T, TG>(feat, rois, g, dfeat, H, W, C, R, G, PH, PW,       \
                         spatial_scale, stream);                            \
  }

extern "C" {

ROI_POOL_BWD_ENTRY(roi_pool_bwd_f32_f32, float, float)
ROI_POOL_BWD_ENTRY(roi_pool_bwd_f32_bf16, float, __nv_bfloat16)
ROI_POOL_BWD_ENTRY(roi_pool_bwd_bf16_f32, __nv_bfloat16, float)
ROI_POOL_BWD_ENTRY(roi_pool_bwd_bf16_bf16, __nv_bfloat16, __nv_bfloat16)

const char* roi_pool_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
