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
//     reference maps every non-finite max to 0, and so does this kernel);
//   * on request it also writes each output's first max cell (the cell a
//     backward routes the cotangent to), int32 flat y * W + x, and -1 where
//     no gradient flows: an empty bin, a NaN or a non-finite max. This is
//     the JAX package's saved-argmax convention (its CPU custom call).
//
// Layout: feat (H, W, C) channels-last, rois (R, 5) float32 rows of
// (batch, x1, y1, x2, y2) in image coordinates, out and argmax
// (R, PH, PW, C) -- the JAX package's layout.
//
// Bound on the card: bytes. The function must read the map once and write
// R * PH * PW * C outputs (flagship bf16: ~10.6 MB in, ~103 MB out, ~34 us
// at 3.35 TB/s; the index adds ~205 MB, ~61 us). What bounds this kernel is
// the L2: every bin cell is read from it (the map fits in its 50 MB), ~1.0
// GB in bf16 and ~2.1 GB in float32 on the flagship's 2048 proposals, and
// the kernel reads them at ~5.8 TB/s in both types on an H100 SXM (700 W),
// where 8 cells a round in flight instead of 4 gain nothing. The first
// design (scripts/attic/roi_pool_v1.cu: one thread per channel, 2-byte
// loads, one block per RoI walking its ~500 cells) was bound by its load
// latency: float32 moved twice the bytes in 5% more time. The first-max
// index costs a strict compare and two selects per channel and cell on top
// of the packed max, and its writes.
//
// Design: the work is the list of (RoI, bin, vector of N channels) items,
// one per thread, 128 to a block. A thread reads its N consecutive channels
// with one 16-byte load per cell (8 bf16 or 4 float32 channels), so a warp
// reads 512 contiguous bytes of one cell, and it walks the bin's cells four
// loads at a time (roi_pool_scan.cuh). The edges of the bins a block covers
// are computed once, one thread per bin, into shared memory. A large RoI
// spreads over many blocks and SMs: with one block per RoI (an earlier
// version of this design) the whole-image proposal's 11k cells kept one
// block busy for 6x the mean time, and that tail set the kernel's time. N
// is the widest of 16, 8, 4 bytes (or one channel) that divides a cell's C
// channels and the base addresses: any C runs in the kernel, C % 8 == 0
// bf16 (C % 4 == 0 float32) with 16-byte loads. The max runs in float,
// which is exact for bf16 inputs.

#include <stdint.h>

#include "roi_pool_scan.cuh"

namespace {

using roi_pool::BinEdges;
using roi_pool::BinMax;
using roi_pool::Pack;

constexpr int kThreads = 128;

template <typename T, int N, bool ARGMAX>
__global__ void __launch_bounds__(kThreads)
roi_pool_fwd_kernel(const T* __restrict__ feat, const float* __restrict__ rois,
                    T* __restrict__ out, int* __restrict__ argmax, int H,
                    int W, int C, int R, int PH, int PW,
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
  const long long bin = i / nv;  // (r * PH + ph) * PW + pw
  const int c = static_cast<int>(i - bin * nv) * N;
  const BinEdges& e = edges[bin - b0];
  const BinMax<T, N, ARGMAX> a = roi_pool::scan_bin<T, N, ARGMAX>(
      feat + c, e.hs, e.he, e.ws, e.we, W, C);
  const long long o = bin * C + c;
  Pack<T, N> res;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    roi_pool::from_float(a.ok(k) ? roi_pool::to_float(a.top.v[k]) : 0.f,
                         res.v[k]);
  }
  roi_pool::store(out + o, res);
  if constexpr (ARGMAX) {
    Pack<int, N> idx;
#pragma unroll
    for (int k = 0; k < N; ++k) idx.v[k] = a.ok(k) ? a.best[k] : -1;
    roi_pool::store(argmax + o, idx);
  }
}

template <typename T, int N>
int launch_n(const void* feat, const void* rois, void* out, void* argmax,
             int H, int W, int C, int R, int PH, int PW, float spatial_scale,
             cudaStream_t stream) {
  const long long items = static_cast<long long>(R) * PH * PW * (C / N);
  const unsigned blocks = static_cast<unsigned>((items + kThreads - 1) /
                                                kThreads);
  if (argmax != nullptr) {
    roi_pool_fwd_kernel<T, N, true><<<blocks, kThreads, 0, stream>>>(
        static_cast<const T*>(feat), static_cast<const float*>(rois),
        static_cast<T*>(out), static_cast<int*>(argmax), H, W, C, R, PH, PW,
        spatial_scale);
  } else {
    roi_pool_fwd_kernel<T, N, false><<<blocks, kThreads, 0, stream>>>(
        static_cast<const T*>(feat), static_cast<const float*>(rois),
        static_cast<T*>(out), nullptr, H, W, C, R, PH, PW, spatial_scale);
  }
  return static_cast<int>(cudaGetLastError());
}

bool aligned(const void* p, size_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// n: the channels a thread loads at once (1, 2, 4 or 8 bf16; 1, 2 or 4
// float32). Refuses an n that does not divide C or whose loads and stores
// would not be aligned.
template <typename T>
int launch(const void* feat, const void* rois, void* out, void* argmax, int H,
           int W, int C, int R, int PH, int PW, int n, float spatial_scale,
           void* stream) {
  if (R == 0 || C == 0) return 0;
  const size_t bytes = n * sizeof(T);
  if (n < 1 || bytes > 16 || (n & (n - 1)) != 0 || C % n != 0 ||
      !aligned(feat, bytes) || !aligned(out, bytes) ||
      (argmax != nullptr && !aligned(argmax, n * sizeof(int) < 16
                                                 ? n * sizeof(int) : 16))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  constexpr int kWide = static_cast<int>(16 / sizeof(T));
  switch (n) {
    case 1:
      return launch_n<T, 1>(feat, rois, out, argmax, H, W, C, R, PH, PW,
                            spatial_scale, s);
    case 2:
      return launch_n<T, 2>(feat, rois, out, argmax, H, W, C, R, PH, PW,
                            spatial_scale, s);
    case 4:
      return launch_n<T, 4>(feat, rois, out, argmax, H, W, C, R, PH, PW,
                            spatial_scale, s);
    default:
      return launch_n<T, kWide>(feat, rois, out, argmax, H, W, C, R, PH, PW,
                                spatial_scale, s);
  }
}

}  // namespace

extern "C" {

// Each returns the cudaError_t of the launch (0 on success). argmax may be
// null: then the kernel writes no index.
int roi_pool_fwd_f32(const void* feat, const void* rois, void* out,
                     void* argmax, int H, int W, int C, int R, int PH, int PW,
                     int n, float spatial_scale, void* stream) {
  return launch<float>(feat, rois, out, argmax, H, W, C, R, PH, PW, n,
                       spatial_scale, stream);
}

int roi_pool_fwd_bf16(const void* feat, const void* rois, void* out,
                      void* argmax, int H, int W, int C, int R, int PH,
                      int PW, int n, float spatial_scale, void* stream) {
  return launch<__nv_bfloat16>(feat, rois, out, argmax, H, W, C, R, PH, PW,
                               n, spatial_scale, stream);
}

const char* roi_pool_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
