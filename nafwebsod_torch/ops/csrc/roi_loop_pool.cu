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
//   * the max is floored at 0: an empty bin, an empty ring and an
//     all-negative or all -inf ring give 0 (unlike RoIPoolF, where a
//     negative max survives);
//   * a ring that holds a NaN or +inf gives 0, as the plain version does
//     (its max propagates NaN, and every non-finite max is mapped to 0). A
//     non-finite cell in the excluded interior is never read.
//
// Layout: feat (H, W, C) channels-last, rois9 (R, 9) float32, out
// (R, PH, PW, C) in the feature type -- the JAX package's layout.
//
// Bound on the card: bytes. The function must read the map once and write
// R * PH * PW * C outputs (context head, bf16: ~10.6 MB in, ~103 MB out,
// ~34 us at 3.35 TB/s). What bounds this kernel is K1's limit, the L2: every
// ring cell is read from it (the map fits in its 50 MB), ~0.83 GB of bf16 on
// the frame rois of 2048 proposals and ~1.47 GB on their context rois, in
// 0.17-0.22 ms and 0.23-0.27 ms on an H100 SXM (700 W), ~4-6 TB/s.
// The first design (scripts/attic/roi_loop_pool_v1.cu: one thread per
// channel, 2-byte loads, each thread walking its 49 bins with one load in
// flight, an isnan flag per cell, the whole-image proposal on one block)
// was bound by its load latency at 1.09-1.23 ms bf16 on an H100 SXM (700 W).
//
// Design: K1's (roi_pool.cu). The work is the list of (RoI, bin, vector of
// N channels) items, one per thread, 128 to a block. A thread reads its N
// consecutive channels with one 16-byte load per cell (8 bf16 or 4 float32
// channels), four loads in flight at a time, and folds them with the packed
// NaN-propagating max of roi_pool_scan.cuh. The bins a block covers, each
// cut into the ring's four rectangles -- the rows above the inner box's open
// interior, its open rows left and right of the interior, the rows below
// it -- are computed once, one thread per bin, into shared memory; a bin
// inside the interior has four empty rectangles. The max is exact and
// independent of order, so the cut cannot change a bit. The running max
// starts at 0: a finite result is the floored max, and a non-finite one (a
// NaN or +inf in the ring) gives 0. N is the widest of 16, 8, 4 bytes (or
// one channel) that divides C and the base addresses: any C runs.

#include <stdint.h>

#include "roi_pool_scan.cuh"

namespace {

using roi_pool::bin_end;
using roi_pool::bin_start;
using roi_pool::kUnroll;
using roi_pool::Pack;
using roi_pool::round_half_away;

constexpr int kThreads = 128;

// One bin's ring as four rectangles of the map: rows [hs, y0) and [y1, he)
// over the columns [ws, we), and rows [y0, y1) over [ws, x0) and [x1, we).
// [y0, y1) x [x0, x1) is the inner box's open interior clipped to the bin.
struct RingBin {
  int hs, y0, y1, he, ws, x0, x1, we;
};

// The rings of the bins b0 .. b0 + nbins - 1 (bin b = (r * PH + ph) * PW +
// pw), one thread per bin, into e[0 .. nbins). Call from every thread of
// the block; ends with __syncthreads().
__device__ __forceinline__ void ring_bins(const float* __restrict__ rois9,
                                          float spatial_scale, int H, int W,
                                          int PH, int PW, long long b0,
                                          int nbins, RingBin* e) {
  for (int t = threadIdx.x; t < nbins; t += blockDim.x) {
    const long long b = b0 + t;
    const int r = static_cast<int>(b / (PH * PW));
    const int p = static_cast<int>(b - static_cast<long long>(r) * PH * PW);
    const int ph = p / PW;
    const int pw = p - ph * PW;
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
    RingBin q;
    q.hs = bin_start(ph, roi_h, PH, y1, H);
    q.he = bin_end(ph, roi_h, PH, y1, H);
    q.ws = bin_start(pw, roi_w, PW, x1, W);
    q.we = bin_end(pw, roi_w, PW, x1, W);
    // the open interior [iy1 + 1, iy2) x [ix1 + 1, ix2), clipped to the bin
    // (hs <= he and ws <= we: bin edges are clipped monotonically); an
    // empty one gives y1 == y0 or x1 == x0
    q.y0 = min(max(iy1 + 1, q.hs), q.he);
    q.y1 = min(max(iy2, q.y0), q.he);
    q.x0 = min(max(ix1 + 1, q.ws), q.we);
    q.x1 = min(max(ix2, q.x0), q.we);
    e[t] = q;
  }
  __syncthreads();
}

// acc = max(acc, every cell of [y0, y1) x [x0, x1)) for the N channels from
// fc (feat + c0) on, kUnroll loads in flight.
template <typename T, int N>
__device__ __forceinline__ void fold_rect(Pack<T, N>& acc,
                                          const T* __restrict__ fc, int y0,
                                          int y1, int x0, int x1, int W,
                                          int C) {
  const int bw = x1 - x0;
  const int n = (y1 > y0 && bw > 0) ? (y1 - y0) * bw : 0;
  int y = y0, x = x0;
  for (int k = 0; k < n; k += kUnroll) {
    Pack<T, N> v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (k + u < n) {
        roi_pool::load(fc + static_cast<long long>(y * W + x) * C, v[u]);
      }
      if (++x == x1) {
        x = x0;
        ++y;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (k + u < n) roi_pool::fold_max(acc, v[u]);
    }
  }
}

template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
roi_loop_pool_fwd_kernel(const T* __restrict__ feat,
                         const float* __restrict__ rois9, T* __restrict__ out,
                         int H, int W, int C, int R, int PH, int PW,
                         float spatial_scale) {
  __shared__ RingBin rings[kThreads + 1];
  const int nv = C / N;
  const long long items = static_cast<long long>(R) * PH * PW * nv;
  const long long first = static_cast<long long>(blockIdx.x) * kThreads;
  const long long last = min(first + kThreads, items) - 1;
  const long long b0 = first / nv;
  ring_bins(rois9, spatial_scale, H, W, PH, PW, b0,
            static_cast<int>(last / nv - b0 + 1), rings);

  const long long i = first + threadIdx.x;
  if (i > last) return;
  const long long bin = i / nv;  // (r * PH + ph) * PW + pw
  const int c = static_cast<int>(i - bin * nv) * N;
  const RingBin& e = rings[bin - b0];
  const T* fc = feat + c;
  Pack<T, N> acc;
#pragma unroll
  for (int k = 0; k < N; ++k) roi_pool::from_float(0.f, acc.v[k]);
  fold_rect(acc, fc, e.hs, e.y0, e.ws, e.we, W, C);  // above the interior
  fold_rect(acc, fc, e.y0, e.y1, e.ws, e.x0, W, C);  // left of it
  fold_rect(acc, fc, e.y0, e.y1, e.x1, e.we, W, C);  // right of it
  fold_rect(acc, fc, e.y1, e.he, e.ws, e.we, W, C);  // below it
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const float m = roi_pool::to_float(acc.v[k]);
    roi_pool::from_float(isfinite(m) ? m : 0.f, acc.v[k]);
  }
  roi_pool::store(out + bin * C + c, acc);
}

template <typename T, int N>
int launch_n(const void* feat, const void* rois9, void* out, int H, int W,
             int C, int R, int PH, int PW, float spatial_scale,
             cudaStream_t stream) {
  const long long items = static_cast<long long>(R) * PH * PW * (C / N);
  const unsigned blocks = static_cast<unsigned>((items + kThreads - 1) /
                                                kThreads);
  roi_loop_pool_fwd_kernel<T, N><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(feat), static_cast<const float*>(rois9),
      static_cast<T*>(out), H, W, C, R, PH, PW, spatial_scale);
  return static_cast<int>(cudaGetLastError());
}

bool aligned(const void* p, size_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// n: the channels a thread loads at once (1, 2, 4 or 8 bf16; 1, 2 or 4
// float32). Refuses an n that does not divide C or whose loads and stores
// would not be aligned.
template <typename T>
int launch(const void* feat, const void* rois9, void* out, int H, int W,
           int C, int R, int PH, int PW, int n, float spatial_scale,
           void* stream) {
  if (R == 0 || C == 0) return 0;
  const size_t bytes = n * sizeof(T);
  if (n < 1 || bytes > 16 || (n & (n - 1)) != 0 || C % n != 0 ||
      !aligned(feat, bytes) || !aligned(out, bytes)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  constexpr int kWide = static_cast<int>(16 / sizeof(T));
  switch (n) {
    case 1:
      return launch_n<T, 1>(feat, rois9, out, H, W, C, R, PH, PW,
                            spatial_scale, s);
    case 2:
      return launch_n<T, 2>(feat, rois9, out, H, W, C, R, PH, PW,
                            spatial_scale, s);
    case 4:
      return launch_n<T, 4>(feat, rois9, out, H, W, C, R, PH, PW,
                            spatial_scale, s);
    default:
      return launch_n<T, kWide>(feat, rois9, out, H, W, C, R, PH, PW,
                                spatial_scale, s);
  }
}

}  // namespace

extern "C" {

// Each returns the cudaError_t of the launch (0 on success).
int roi_loop_pool_fwd_f32(const void* feat, const void* rois9, void* out,
                          int H, int W, int C, int R, int PH, int PW, int n,
                          float spatial_scale, void* stream) {
  return launch<float>(feat, rois9, out, H, W, C, R, PH, PW, n,
                       spatial_scale, stream);
}

int roi_loop_pool_fwd_bf16(const void* feat, const void* rois9, void* out,
                           int H, int W, int C, int R, int PH, int PW, int n,
                           float spatial_scale, void* stream) {
  return launch<__nv_bfloat16>(feat, rois9, out, H, W, C, R, PH, PW, n,
                               spatial_scale, stream);
}

const char* roi_loop_pool_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
