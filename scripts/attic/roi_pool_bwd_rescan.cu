// RoIPoolF backward, candidate (b): the rescan. Kept as an engineering record
// beside the saved-index scatter that the package builds
// (nafwebsod_torch/ops/csrc/roi_pool_bwd.cu); only scripts/port_k1k3_ab.py
// builds it (nvcc -I nafwebsod_torch/ops/csrc), to time the two in one run.
//
// The function is K3's: each bin's cotangent goes to the first max cell of
// the bin in row-major order; an empty bin and a NaN or non-finite max pass
// nothing back; G seed batches share one scan. Instead of reading a saved
// index it finds the first max again with the forward's scan and work
// split (roi_pool.cu, roi_pool_scan.cuh): one (RoI, bin, vector of N
// channels) item per thread, the bin edges once per block into shared
// memory, one 16-byte load per cell and four cells in flight. An item whose
// cotangents are all zero in every seed is not scanned. The sums are float
// atomicAdds.
//
// Layout: feat (H, W, C) and g (G, R, PH, PW, C) of one type (float32 or
// bfloat16), rois (R, 5) float32, dfeat (G, H, W, C) float32 zeroed by the
// caller. n: the channels a thread loads at once (as roi_pool.cu's).

#include <stdint.h>

#include "roi_pool_scan.cuh"

namespace {

using roi_pool::BinEdges;
using roi_pool::BinMax;
using roi_pool::Pack;

constexpr int kThreads = 128;

template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
roi_pool_bwd_rescan_kernel(const T* __restrict__ feat,
                           const float* __restrict__ rois,
                           const T* __restrict__ g, float* __restrict__ dfeat,
                           int H, int W, int C, int R, int G, int PH, int PW,
                           float spatial_scale) {
  __shared__ BinEdges edges[kThreads + 1];
  const int nv = C / N;
  const long long items = static_cast<long long>(R) * PH * PW * nv;
  const long long first = static_cast<long long>(blockIdx.x) * kThreads;
  const long long last = min(first + kThreads, items) - 1;
  const long long b0 = first / nv;
  roi_pool::bin_edges(rois, spatial_scale, H, W, PH, PW, b0,
                      static_cast<int>(last / nv - b0 + 1), edges);

  const long long i = first + threadIdx.x;
  if (i > last) return;
  const long long bin = i / nv;
  const int c = static_cast<int>(i - bin * nv) * N;
  const long long seed = static_cast<long long>(R) * PH * PW * C;
  const long long map = static_cast<long long>(H) * W * C;
  const T* gb = g + bin * C + c;
  bool live = false;
  for (int s = 0; s < G; ++s) {
    Pack<T, N> gv;
    roi_pool::load(gb + s * seed, gv);
#pragma unroll
    for (int k = 0; k < N; ++k) live |= roi_pool::to_float(gv.v[k]) != 0.f;
  }
  if (!live) return;
  const BinEdges& e = edges[bin - b0];
  const BinMax<T, N, true> a = roi_pool::scan_bin<T, N, true>(
      feat + c, e.hs, e.he, e.ws, e.we, W, C);
  for (int s = 0; s < G; ++s) {
    Pack<T, N> gv;
    roi_pool::load(gb + s * seed, gv);
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const float v = roi_pool::to_float(gv.v[k]);
      if (a.ok(k) && v != 0.f) {
        atomicAdd(
            dfeat + s * map + static_cast<long long>(a.best[k]) * C + c + k,
            v);
      }
    }
  }
}

template <typename T, int N>
int launch_n(const void* feat, const void* rois, const void* g, void* dfeat,
             int H, int W, int C, int R, int G, int PH, int PW,
             float spatial_scale, cudaStream_t stream) {
  const long long items = static_cast<long long>(R) * PH * PW * (C / N);
  const unsigned blocks = static_cast<unsigned>((items + kThreads - 1) /
                                                kThreads);
  roi_pool_bwd_rescan_kernel<T, N><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(feat), static_cast<const float*>(rois),
      static_cast<const T*>(g), static_cast<float*>(dfeat), H, W, C, R, G, PH,
      PW, spatial_scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* feat, const void* rois, const void* g, void* dfeat,
           int H, int W, int C, int R, int G, int PH, int PW, int n,
           float spatial_scale, void* stream) {
  if (R == 0 || C == 0 || G == 0) return 0;
  const size_t bytes = n * sizeof(T);
  const uintptr_t mask = (bytes < 16 ? bytes : 16) - 1;
  if (n < 1 || bytes > 16 || (n & (n - 1)) != 0 || C % n != 0 ||
      (reinterpret_cast<uintptr_t>(feat) & mask) != 0 ||
      (reinterpret_cast<uintptr_t>(g) & mask) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  constexpr int kWide = static_cast<int>(16 / sizeof(T));
  switch (n) {
    case 1:
      return launch_n<T, 1>(feat, rois, g, dfeat, H, W, C, R, G, PH, PW,
                            spatial_scale, s);
    case 2:
      return launch_n<T, 2>(feat, rois, g, dfeat, H, W, C, R, G, PH, PW,
                            spatial_scale, s);
    case 4:
      return launch_n<T, 4>(feat, rois, g, dfeat, H, W, C, R, G, PH, PW,
                            spatial_scale, s);
    default:
      return launch_n<T, kWide>(feat, rois, g, dfeat, H, W, C, R, G, PH, PW,
                                spatial_scale, s);
  }
}

}  // namespace

extern "C" {

int roi_pool_bwd_rescan_f32(const void* feat, const void* rois, const void* g,
                            void* dfeat, int H, int W, int C, int R, int G,
                            int PH, int PW, int n, float spatial_scale,
                            void* stream) {
  return launch<float>(feat, rois, g, dfeat, H, W, C, R, G, PH, PW, n,
                       spatial_scale, stream);
}

int roi_pool_bwd_rescan_bf16(const void* feat, const void* rois,
                             const void* g, void* dfeat, int H, int W, int C,
                             int R, int G, int PH, int PW, int n,
                             float spatial_scale, void* stream) {
  return launch<__nv_bfloat16>(feat, rois, g, dfeat, H, W, C, R, G, PH, PW, n,
                               spatial_scale, stream);
}

}  // extern "C"
