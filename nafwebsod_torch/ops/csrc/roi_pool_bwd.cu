// RoIPoolF backward for Hopper (sm_90a), with a plain C interface for ctypes.
//
// Replaces the TPU kernel K3: nafwebsod_tpu/ops/pallas/roi_pool_pallas.py
// roi_pool_pallas_bwd (body _bwd_kernel), the Caffe2 RoIPoolF gradient:
//   * each bin's cotangent goes to the FIRST max cell of the bin in
//     row-major order; an empty bin and a bin whose max is not finite pass
//     nothing back;
//   * that cell comes from the forward: roi_pool.cu writes it beside the
//     pooled map when the map needs a gradient, int32 flat y * W + x per
//     (RoI, bin, channel), -1 where no gradient flows (the JAX package's
//     saved-argmax convention, and the Caffe2 op's). So this kernel is a
//     scatter: dfeat[s, argmax[e], c(e)] += g[s, e] for every element e of
//     the (R, PH, PW, C) index with argmax[e] >= 0 and g[s, e] != 0;
//   * G seed batches share one index: g is (G, R, PH, PW, C) and dfeat
//     (G, H, W, C).
//
// Layout: argmax int32, g float32 or bfloat16, dfeat float32 and zeroed by
// the caller.
//
// Bound on the card: bytes. The function must read the index and g once
// and write dfeat once (flagship, G = 1, bf16: ~205 MB + ~103 MB in, ~21 MB
// out, ~98 us at 3.35 TB/s). RoIs overlap, so many elements add to one
// cell: the sums are float atomicAdds (one per nonzero element and seed,
// ~51M at the flagship's shape), which the L2 executes, and they bound this
// kernel: on an H100 SXM (700 W) the atomics alone take ~90% of its time,
// the reads alone ~35%. The first design (scripts/attic/roi_pool_bwd_v1.cu)
// repeated the forward's serial scan of every bin to find the first max,
// read g with 2-byte loads, and was bound by the scan and the atomics.
//
// Design: no scan. Each warp takes 256 consecutive elements: lane l reads
// elements 8l..8l+7 of the index (two 16-byte loads) and of g (one 16-byte
// load in bf16, two in float32) and puts them in shared memory; then lane l
// adds elements l, l + 32, ..., l + 224, so that a warp's atomics go to 32
// consecutive channels (one 128-byte line where their cells agree). The
// seeds are the grid's second dimension, so that one seed's dfeat at a time
// is hot in the L2 (three seeds' 63 MB would not fit); each seed reads the
// index again. An index whose size or base addresses do not suit 16-byte
// loads is read one element per thread. The routing is deterministic; the order of the
// additions is not, so sums of non-integers differ from run to run in the
// last bits.

#include <stdint.h>

#include "roi_pool_common.cuh"

// Parts of the kernel for scripts/port_k1k3_ab.py, which times each alone:
// 0 the whole kernel (the package's build), 1 the reads of the index and g
// without the atomics, 2 the atomics (of 1.0) without reading g.
#ifndef ROI_POOL_BWD_PART
#define ROI_POOL_BWD_PART 0
#endif

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 256;  // elements per warp and round: 8 per lane

using roi_pool::to_float;

// Lane's 8 cotangents at p (16-byte aligned) into shared memory as float.
__device__ __forceinline__ void stage(const float* __restrict__ p,
                                      float* dst) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  dst[0] = a.x; dst[1] = a.y; dst[2] = a.z; dst[3] = a.w;
  dst[4] = b.x; dst[5] = b.y; dst[6] = b.z; dst[7] = b.w;
}
__device__ __forceinline__ void stage(const __nv_bfloat16* __restrict__ p,
                                      float* dst) {
  const uint4 a = __ldg(reinterpret_cast<const uint4*>(p));
  const unsigned w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    dst[2 * k] = __uint_as_float(w[k] << 16);
    dst[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
  }
}

// n % 8 == 0 and every base address 16-byte aligned. Seed blockIdx.y.
template <typename TG>
__global__ void __launch_bounds__(kThreads)
roi_pool_bwd_vec_kernel(const int* __restrict__ argmax,
                        const TG* __restrict__ g, float* __restrict__ dfeat,
                        long long n, int C, long long map) {
  __shared__ int s_idx[kWarps][kChunk];
  __shared__ float s_g[kWarps][kChunk];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const TG* gs = g + blockIdx.y * n;
  float* ds = dfeat + blockIdx.y * map;
  float sink = 0.f;
  const long long stride = static_cast<long long>(gridDim.x) * kWarps * kChunk;
  for (long long base = (static_cast<long long>(blockIdx.x) * kWarps + warp) *
                        kChunk;
       base < n; base += stride) {
    const long long e0 = base + 8 * lane;
    if (e0 < n) {
      const int4 a = __ldg(reinterpret_cast<const int4*>(argmax + e0));
      const int4 b = __ldg(reinterpret_cast<const int4*>(argmax + e0) + 1);
      int* d = s_idx[warp] + 8 * lane;
      d[0] = a.x; d[1] = a.y; d[2] = a.z; d[3] = a.w;
      d[4] = b.x; d[5] = b.y; d[6] = b.z; d[7] = b.w;
      if (ROI_POOL_BWD_PART != 2) stage(gs + e0, s_g[warp] + 8 * lane);
    }
    __syncwarp();
    // lane's elements base + lane + 32 j, at channels c, c + 32, ...
    int c = static_cast<int>((base + lane) % C);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int k = lane + 32 * j;
      const int cell = base + k < n ? s_idx[warp][k] : -1;
      const float v = ROI_POOL_BWD_PART == 2 ? 1.f : s_g[warp][k];
      if (ROI_POOL_BWD_PART == 1) {
        sink += cell >= 0 ? v : 0.f;
      } else if (cell >= 0 && v != 0.f) {
        atomicAdd(ds + static_cast<long long>(cell) * C + c, v);
      }
      c += 32;
      while (c >= C) c -= C;
    }
    __syncwarp();
  }
  if (ROI_POOL_BWD_PART == 1 && n < 0) ds[0] = sink;  // keeps the reads
}

// Any n and alignment: one element per thread. Seed blockIdx.y.
template <typename TG>
__global__ void __launch_bounds__(kThreads)
roi_pool_bwd_kernel(const int* __restrict__ argmax, const TG* __restrict__ g,
                    float* __restrict__ dfeat, long long n, int C,
                    long long map) {
  const TG* gs = g + blockIdx.y * n;
  float* ds = dfeat + blockIdx.y * map;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long e = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       e < n; e += stride) {
    const int cell = argmax[e];
    const float v = to_float(gs[e]);
    if (cell >= 0 && v != 0.f) {
      atomicAdd(ds + static_cast<long long>(cell) * C + e % C, v);
    }
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename TG>
int launch(const void* argmax, const void* g, void* dfeat, int H, int W,
           int C, long long n, int G, void* stream) {
  if (n == 0 || G == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long map = static_cast<long long>(H) * W * C;
  const int* a = static_cast<const int*>(argmax);
  const TG* gt = static_cast<const TG*>(g);
  float* d = static_cast<float*>(dfeat);
  // blockIdx.y is the seed: the blocks run roughly in order, so one seed's
  // dfeat (21 MB at the flagship's shape) is hot in the L2 at a time
  if (n % 8 == 0 && aligned16(argmax) && aligned16(g)) {
    const long long rounds = (n + kWarps * kChunk - 1) / (kWarps * kChunk);
    const dim3 grid(static_cast<unsigned>(rounds < (1 << 20) ? rounds
                                                               : 1 << 20),
                    G);
    roi_pool_bwd_vec_kernel<TG><<<grid, kThreads, 0, s>>>(a, gt, d, n, C,
                                                           map);
  } else {
    const long long rounds = (n + kThreads - 1) / kThreads;
    const dim3 grid(static_cast<unsigned>(rounds < (1 << 20) ? rounds
                                                               : 1 << 20),
                    G);
    roi_pool_bwd_kernel<TG><<<grid, kThreads, 0, s>>>(a, gt, d, n, C, map);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Each returns the cudaError_t of the launch (0 on success). argmax holds n
// = R * PH * PW * C elements; g G times n; dfeat G * H * W * C. The name is
// roi_pool_bwd_<cotangent type>.
int roi_pool_bwd_f32(const void* argmax, const void* g, void* dfeat, int H,
                     int W, int C, long long n, int G, void* stream) {
  return launch<float>(argmax, g, dfeat, H, W, C, n, G, stream);
}

int roi_pool_bwd_bf16(const void* argmax, const void* g, void* dfeat, int H,
                      int W, int C, long long n, int G, void* stream) {
  return launch<__nv_bfloat16>(argmax, g, dfeat, H, W, C, n, G, stream);
}

const char* roi_pool_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
