// The per-bin form of candidate (a) of the RoIAlign forward's redesign
// (K4), kept as an engineering record beside the package's kernel in
// nafwebsod_torch/ops/csrc/roi_align.cu, where a thread walks a run of
// seven bins of a bin row instead of one bin. The package never builds it;
// scripts/port_k2k4_ab.py does (nvcc -I nafwebsod_torch/ops/csrc), to time
// the designs in one run.
//
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
// order of the plain version (ops/roi_pool.py roi_align_reference), channel
// by channel, so that no product and sum is contracted into an FMA and the
// two agree bit for bit: the corner products in the plain order, the
// validity product, the samples summed in row-major order, then the
// division by their count. Two steps are skipped where they cannot change a
// bit: the validity product of a sample inside the map (v * 1 is v), and
// the division where the count is a power of two (x * (1 / count) is the
// same correctly rounded value). The separable form Wy @ window @ Wx^T on
// the tensor cores is not taken: it sums in another order (so it would hold
// only to a tolerance), it does no less arithmetic per RoI and channel than
// the direct form, with C innermost every RoI is a batch of C tiny products
// that fill a 64-row wgmma tile poorly, and the bound is bytes, not
// operations.
//
// Layout: feat (H, W, C) channels-last, rois (R, 5) float32 rows of
// (batch, x1, y1, x2, y2) in image coordinates, out (R, PH, PW, C) float32.
//
// Bound on the card: bytes. The function must read the map once and write
// R * PH * PW * C float32 outputs; at the mask head's training shapes (an
// (87, 119, 512) bfloat16 map, 2048 RoIs, 14 x 14) the output is 822 MB
// against a 10.6 MB map (0.245 ms at 3.35 TB/s; the arithmetic, 13 float
// operations per sample and output, 0.16 ms at 67 TFLOP/s, twice that for
// products and sums that are not fused). What bounds this form is the L2:
// the four corners of every sample are read from it, 6.58 GB of bf16 at
// 14x14 where the RoIs' samples touch 0.59 GB of distinct cells, because
// the bins of a row, in different threads, ask for the same lines at the
// same time and the L1 catches few of the repeats. The first design
// (scripts/attic/roi_align_v1.cu: one block per (RoI, 128 channels), one
// thread per channel, 2-byte loads) read them from the L2 too, with one
// load in flight per thread.
//
// Design, candidate (a): K1's (roi_pool.cu). The work is the list of
// (RoI, bin, vector of N channels) items, one per thread, 128 to a block; a
// thread reads its N consecutive channels with one 16-byte load per corner
// (8 bf16 or 4 float32 channels), 4 * sr * sr loads per output, and writes
// its N float32 outputs with 16-byte stores. The sr y-samples and sr
// x-samples (cells, fraction, validity) of the bins a block covers are
// computed once, one thread per sample, into shared memory. A large RoI
// spreads over many blocks and a block may straddle two RoIs, so mask
// inference's 100 boxes fill the card as well as training's 2048. An order
// of the items that put 16 neighbouring bins of 64 channels in a block, so
// that the L1 would serve their repeated corner reads, timed no faster than
// this one: neighbouring bins ask for the same lines at about the same
// time. N is the widest of 16, 8, 4 bytes (or one channel) that divides C
// and the base addresses: any C runs in the kernel. No size limit on the
// map and no fallback.

#include <stdint.h>

#include "roi_pool_scan.cuh"

namespace {

using roi_pool::Pack;
using roi_pool::to_float;

constexpr int kThreads = 128;

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

// The most bins a block of kThreads items covers, nv items a bin.
__host__ __device__ __forceinline__ int block_bins(int nv) {
  return (kThreads - 1) / nv + 2;
}

template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
roi_align_fwd_kernel(const T* __restrict__ feat,
                     const float* __restrict__ rois, float* __restrict__ out,
                     int H, int W, int C, int R, int PH, int PW, int sr,
                     float spatial_scale) {
  // per bin of the block: sr y-samples, then sr x-samples
  extern __shared__ Sample samples[];
  const int nv = C / N;
  const long long items = static_cast<long long>(R) * PH * PW * nv;
  const long long first = static_cast<long long>(blockIdx.x) * kThreads;
  const long long last = min(first + kThreads, items) - 1;
  const long long b0 = first / nv;
  const int nbins = static_cast<int>(last / nv - b0 + 1);
  for (int t = threadIdx.x; t < nbins * 2 * sr; t += kThreads) {
    const int j = t % (2 * sr);
    const long long b = b0 + t / (2 * sr);  // (r * PH + ph) * PW + pw
    const int r = static_cast<int>(b / (PH * PW));
    const int p = static_cast<int>(b - static_cast<long long>(r) * PH * PW);
    const float* roi = rois + 5LL * r;
    const float start_w = __fmul_rn(roi[1], spatial_scale);
    const float start_h = __fmul_rn(roi[2], spatial_scale);
    const float end_w = __fmul_rn(roi[3], spatial_scale);
    const float end_h = __fmul_rn(roi[4], spatial_scale);
    samples[t] = j < sr ? axis_sample(start_h, end_h, p / PW * sr + j, PH,
                                      sr, H)
                        : axis_sample(start_w, end_w, p % PW * sr + j - sr,
                                      PW, sr, W);
  }
  __syncthreads();

  const long long i = first + threadIdx.x;
  if (i > last) return;
  const long long bin = i / nv;
  const int c = static_cast<int>(i - bin * nv) * N;
  const Sample* sy = samples + (bin - b0) * 2 * sr;
  const Sample* sx = sy + sr;
  const T* fc = feat + c;
  const long long row_stride = static_cast<long long>(W) * C;
  float acc[N];
  for (int iy = 0; iy < sr; ++iy) {
    const Sample y = sy[iy];
    const float hy = __fsub_rn(1.f, y.frac);
    const T* row0 = fc + y.c0 * row_stride;
    const T* row1 = fc + y.c1 * row_stride;
    for (int ix = 0; ix < sr; ++ix) {
      const Sample x = sx[ix];
      const float hx = __fsub_rn(1.f, x.frac);
      const long long o0 = static_cast<long long>(x.c0) * C;
      const long long o1 = static_cast<long long>(x.c1) * C;
      Pack<T, N> f00, f01, f10, f11;
      roi_pool::load(row0 + o0, f00);
      roi_pool::load(row0 + o1, f01);
      roi_pool::load(row1 + o0, f10);
      roi_pool::load(row1 + o1, f11);
      const float valid = __fmul_rn(y.valid, x.valid);
#pragma unroll
      for (int k = 0; k < N; ++k) {
        float v = __fmul_rn(__fmul_rn(to_float(f00.v[k]), hy), hx);
        v = __fadd_rn(v, __fmul_rn(__fmul_rn(to_float(f01.v[k]), hy),
                                   x.frac));
        v = __fadd_rn(v, __fmul_rn(__fmul_rn(to_float(f10.v[k]), y.frac),
                                   hx));
        v = __fadd_rn(v, __fmul_rn(__fmul_rn(to_float(f11.v[k]), y.frac),
                                   x.frac));
        // the validity product: v * 1 is v, so only a sample outside pays
        if (valid != 1.f) v = __fmul_rn(v, valid);
        acc[k] = (iy == 0 && ix == 0) ? v : __fadd_rn(acc[k], v);
      }
    }
  }
  // the mean: x / count, or x * (1 / count) where count is a power of two
  // (the same correctly rounded value, without a division)
  const int count = sr * sr;
  const bool pow2 = (count & (count - 1)) == 0;
  const float inv = __frcp_rn(static_cast<float>(count));
  Pack<float, N> res;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    res.v[k] = pow2 ? __fmul_rn(acc[k], inv)
                    : __fdiv_rn(acc[k], static_cast<float>(count));
  }
  roi_pool::store(out + bin * C + c, res);
}

template <typename T, int N>
int launch_n(const void* feat, const void* rois, void* out, int H, int W,
             int C, int R, int PH, int PW, int sr, float spatial_scale,
             cudaStream_t stream) {
  const int nv = C / N;
  const size_t shared =
      static_cast<size_t>(block_bins(nv)) * 2 * sr * sizeof(Sample);
  if (shared > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  if (shared > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        roi_align_fwd_kernel<T, N>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(shared));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const long long items = static_cast<long long>(R) * PH * PW * nv;
  const unsigned blocks = static_cast<unsigned>((items + kThreads - 1) /
                                                kThreads);
  roi_align_fwd_kernel<T, N><<<blocks, kThreads, shared, stream>>>(
      static_cast<const T*>(feat), static_cast<const float*>(rois),
      static_cast<float*>(out), H, W, C, R, PH, PW, sr, spatial_scale);
  return static_cast<int>(cudaGetLastError());
}

bool aligned(const void* p, size_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// n: the channels a thread loads at once (1, 2, 4 or 8 bf16; 1, 2 or 4
// float32). Refuses an n that does not divide C or whose loads and float32
// stores would not be aligned.
template <typename T>
int launch(const void* feat, const void* rois, void* out, int H, int W,
           int C, int R, int PH, int PW, int sr, int n, float spatial_scale,
           void* stream) {
  if (R == 0 || C == 0) return 0;
  const size_t bytes = n * sizeof(T);
  const size_t out_bytes = n * sizeof(float);
  if (sr < 1 || n < 1 || bytes > 16 || (n & (n - 1)) != 0 || C % n != 0 ||
      !aligned(feat, bytes) ||
      !aligned(out, out_bytes < 16 ? out_bytes : 16)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  constexpr int kWide = static_cast<int>(16 / sizeof(T));
  switch (n) {
    case 1:
      return launch_n<T, 1>(feat, rois, out, H, W, C, R, PH, PW, sr,
                            spatial_scale, s);
    case 2:
      return launch_n<T, 2>(feat, rois, out, H, W, C, R, PH, PW, sr,
                            spatial_scale, s);
    case 4:
      return launch_n<T, 4>(feat, rois, out, H, W, C, R, PH, PW, sr,
                            spatial_scale, s);
    default:
      return launch_n<T, kWide>(feat, rois, out, H, W, C, R, PH, PW, sr,
                                spatial_scale, s);
  }
}

}  // namespace

extern "C" {

// Each returns the cudaError_t of the launch (0 on success).
int roi_align_fwd_f32(const void* feat, const void* rois, void* out, int H,
                      int W, int C, int R, int PH, int PW, int sr, int n,
                      float spatial_scale, void* stream) {
  return launch<float>(feat, rois, out, H, W, C, R, PH, PW, sr, n,
                       spatial_scale, stream);
}

int roi_align_fwd_bf16(const void* feat, const void* rois, void* out, int H,
                       int W, int C, int R, int PH, int PW, int sr, int n,
                       float spatial_scale, void* stream) {
  return launch<__nv_bfloat16>(feat, rois, out, H, W, C, R, PH, PW, sr, n,
                               spatial_scale, stream);
}

const char* roi_align_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
