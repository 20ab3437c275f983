// The first-max scan of one RoIPoolF bin over a vector of channels, shared by
// the RoIPoolF forward (roi_pool.cu) and the rescan candidate of its backward
// (scripts/attic/roi_pool_bwd_rescan.cu).
//
// A thread owns N consecutive channels of one bin and reads them with one
// load of N * sizeof(T) bytes per cell (16 bytes: 8 bf16 or 4 float32
// channels; 32 bytes are two loads). The bin's cells are walked in row-major
// order, kUnroll cells per round: the round's loads are all issued before
// any of them is folded, so that many loads are in flight per thread. The
// fold keeps a NaN-propagating max per channel (max.NaN.f32, or __hmax2_nan
// on pairs of bf16: one instruction per one or two channels) and, where the
// caller asks for it, the first max cell of each channel (a strict > in
// row-major order) as flat y * W + x.
#pragma once

#include "roi_pool_common.cuh"

namespace roi_pool {

// Cells per round (8 were no faster on an H100).
constexpr int kUnroll = 4;

// N values of T, aligned for one load of up to 16 bytes.
template <typename T, int N>
struct alignas(N * sizeof(T) < 16 ? N * sizeof(T) : 16) Pack {
  T v[N];
};

template <int BYTES>
struct Word;
template <>
struct Word<16> {
  using type = uint4;
};
template <>
struct Word<8> {
  using type = uint2;
};
template <>
struct Word<4> {
  using type = unsigned int;
};
template <>
struct Word<2> {
  using type = unsigned short;
};

// Loads N values at p (aligned to min(16, N * sizeof(T)) bytes) through the
// read-only path.
template <typename T, int N>
__device__ __forceinline__ void load(const T* __restrict__ p, Pack<T, N>& x) {
  constexpr int kBytes = N * sizeof(T);
  constexpr int kChunk = kBytes < 16 ? kBytes : 16;
  using W = typename Word<kChunk>::type;
#pragma unroll
  for (int k = 0; k < kBytes / kChunk; ++k) {
    reinterpret_cast<W*>(&x)[k] = __ldg(reinterpret_cast<const W*>(p) + k);
  }
}

// Stores N values at p (aligned as for load).
template <typename T, int N>
__device__ __forceinline__ void store(T* __restrict__ p, const Pack<T, N>& x) {
  constexpr int kBytes = N * sizeof(T);
  constexpr int kChunk = kBytes < 16 ? kBytes : 16;
  using W = typename Word<kChunk>::type;
#pragma unroll
  for (int k = 0; k < kBytes / kChunk; ++k) {
    reinterpret_cast<W*>(p)[k] = reinterpret_cast<const W*>(&x)[k];
  }
}

__device__ __forceinline__ void from_float(float v, float& out) { out = v; }
__device__ __forceinline__ void from_float(float v, __nv_bfloat16& out) {
  // v is a bf16 value widened to float (or 0): the conversion is exact.
  out = __float2bfloat16_rn(v);
}

// The larger of a and b, NaN if either is NaN (fmaxf drops a NaN; the plain
// version's max keeps it).
__device__ __forceinline__ float nan_max(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

// acc = max(acc, v) channel by channel, NaN-propagating: one instruction
// per float32 channel, one per pair of bf16 channels.
template <int N>
__device__ __forceinline__ void fold_max(Pack<float, N>& acc,
                                         const Pack<float, N>& v) {
#pragma unroll
  for (int i = 0; i < N; ++i) acc.v[i] = nan_max(acc.v[i], v.v[i]);
}
template <int N>
__device__ __forceinline__ void fold_max(Pack<__nv_bfloat16, N>& acc,
                                         const Pack<__nv_bfloat16, N>& v) {
  if constexpr (N == 1) {
    acc.v[0] = __hmax_nan(acc.v[0], v.v[0]);
  } else {
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      reinterpret_cast<__nv_bfloat162*>(acc.v)[i] =
          __hmax2_nan(reinterpret_cast<const __nv_bfloat162*>(acc.v)[i],
                      reinterpret_cast<const __nv_bfloat162*>(v.v)[i]);
    }
  }
}

// The running max of N channels of one bin: `top`, the NaN-propagating
// max in the map's type; with ARGMAX also each channel's first max cell.
template <typename T, int N, bool ARGMAX>
struct BinMax {
  Pack<T, N> top;
  float m[ARGMAX ? N : 1];   // the strict-> running max
  int best[ARGMAX ? N : 1];  // flat y * W + x of the first max cell

  // Whether channel i has a gradient cell: a finite max, so no NaN, no
  // +inf, and a cell above -inf (an empty bin keeps -inf). Where it has
  // none, the forward writes 0 and the index -1.
  __device__ __forceinline__ bool ok(int i) const {
    return isfinite(to_float(top.v[i]));
  }
};

// Scans the bin [hs, he) x [ws, we) of the map whose channel c0 is at fc
// (feat + c0), for the N channels from c0 on.
template <typename T, int N, bool ARGMAX>
__device__ __forceinline__ BinMax<T, N, ARGMAX> scan_bin(
    const T* __restrict__ fc, int hs, int he, int ws, int we, int W, int C) {
  BinMax<T, N, ARGMAX> a;
#pragma unroll
  for (int i = 0; i < N; ++i) from_float(-INFINITY, a.top.v[i]);
  if constexpr (ARGMAX) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      a.m[i] = -INFINITY;
      a.best[i] = -1;
    }
  }
  const int bw = we - ws;
  const int n = (he > hs && bw > 0) ? (he - hs) * bw : 0;
  int y = hs, x = ws;
  for (int k = 0; k < n; k += kUnroll) {
    Pack<T, N> v[kUnroll];
    int cell[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      cell[u] = y * W + x;
      if (k + u < n) load(fc + static_cast<long long>(cell[u]) * C, v[u]);
      if (++x == we) {
        x = ws;
        ++y;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (k + u < n) {
        fold_max(a.top, v[u]);
        if constexpr (ARGMAX) {
#pragma unroll
          for (int i = 0; i < N; ++i) {
            const float f = to_float(v[u].v[i]);
            if (f > a.m[i]) {  // strict: the first max in row-major order
              a.m[i] = f;
              a.best[i] = cell[u];
            }
          }
        }
      }
    }
  }
  return a;
}

// The edges of one bin: rows [hs, he), columns [ws, we) of the map.
struct BinEdges {
  int hs, he, ws, we;
};

// The edges of the bins b0 .. b0 + nbins - 1 (bin b = (r * PH + ph) * PW +
// pw), one thread per bin, into e[0 .. nbins). Call from every thread of
// the block; ends with __syncthreads().
__device__ __forceinline__ void bin_edges(const float* __restrict__ rois,
                                          float spatial_scale, int H, int W,
                                          int PH, int PW, long long b0,
                                          int nbins, BinEdges* e) {
  for (int t = threadIdx.x; t < nbins; t += blockDim.x) {
    const long long b = b0 + t;
    const int r = static_cast<int>(b / (PH * PW));
    const int p = static_cast<int>(b - static_cast<long long>(r) * PH * PW);
    const int ph = p / PW;
    const int pw = p - ph * PW;
    const Roi q = load_roi(rois, r, spatial_scale);
    e[t].hs = bin_start(ph, q.roi_h, PH, q.y1, H);
    e[t].he = bin_end(ph, q.roi_h, PH, q.y1, H);
    e[t].ws = bin_start(pw, q.roi_w, PW, q.x1, W);
    e[t].we = bin_end(pw, q.roi_w, PW, q.x1, W);
  }
  __syncthreads();
}

}  // namespace roi_pool
