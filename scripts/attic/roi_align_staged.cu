// Candidate (b) of the RoIAlign forward's redesign (K4), kept as an
// engineering record beside the package's kernel in
// nafwebsod_torch/ops/csrc/roi_align.cu, which is candidate (a): (b) was
// slower than (a) at every shape it was timed at (PERF.md). The package
// never builds it; scripts/port_k2k4_ab.py does (nvcc -I
// nafwebsod_torch/ops/csrc), to time the designs in one run.
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
// products and sums that are not fused). The first design
// (scripts/attic/roi_align_v1.cu: one block per (RoI, 128 channels), one
// thread per channel, 2-byte loads) read the four corners of every sample
// from the L2, 6.58 GB of bf16 at 14x14 where a RoI's samples touch 0.59 GB
// of distinct cells, and took 2.79-2.94 ms bf16 on an H100 SXM (700 W); on
// the <= 100 boxes of mask inference its 400 blocks left the card nearly
// empty. Candidate (a) of the redesign (nafwebsod_torch/ops/csrc/
// roi_align.cu: K1's item split, a 16-byte load per corner) reads every
// corner through the L1 and the L2.
//
// Design, candidate (b): stage the distinct sample cells in shared memory.
// One block per (RoI, bin row, slab of V vectors of N channels): V = 8
// vectors of 16 bytes, 64 bf16 or 32 float32 channels, one 128-byte line a
// cell. The block computes its bin row's sr y-samples and the RoI's PW * sr
// x-samples (cells, fraction, validity) into shared memory, one thread per
// sample; it then loads, one 16-byte vector a thread, the cells those
// samples touch -- on each axis the window from the first sample's lower
// cell to the last one's upper cell where it holds at most two cells a
// sample, else the two cells of each sample -- so the L2 sees little more
// than the distinct cells; and each thread of the block blends one (bin,
// vector) item's 4 * sr * sr corners from shared memory and writes its N
// float32 outputs with 16-byte stores. A block has PW * V threads, rounded
// up to a warp (at most 256, which then take several items each). N is the
// widest of 16, 8, 4 bytes (or one channel) that divides C and the base
// addresses, and V the largest power of two up to 8 that divides C / N and
// keeps the stage within the shared memory: any C runs in the kernel. No
// size limit on the map and no fallback.

#include <stdint.h>

#include "roi_pool_scan.cuh"

namespace {

using roi_pool::Pack;
using roi_pool::to_float;

// Vectors of one slab at most, and threads of one block at most.
constexpr int kSlabVectors = 8;
constexpr int kMaxThreads = 256;
// Loads in flight per thread while staging.
constexpr int kStage = 4;

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

// The block's shared memory: the staged cells (up to 2 * sr rows by
// 2 * PW * sr columns by V vectors), then per axis the samples, the map cell
// of each staged row or column, and each sample's two slots (its lower and
// upper cell among the staged ones).
struct Stage {
  int tile_bytes;  // rounded up to 16
  int bytes;

  __host__ __device__ Stage(int pw, int sr, int v, int pack_bytes) {
    tile_bytes = (4 * pw * sr * sr * v * pack_bytes + 15) / 16 * 16;
    const int samples = sr + pw * sr;
    bytes = tile_bytes + samples * static_cast<int>(sizeof(Sample)) +
            4 * samples * static_cast<int>(sizeof(int));
  }
};

// Plans the staging of one axis: n samples in a; writes each staged cell
// (cell[k], k < the return value) and each sample's two slots (slot[2j],
// slot[2j + 1]). Called by the thread of sample j; returns the number of
// staged cells.
__device__ __forceinline__ int plan_axis(const Sample* a, int n, int j,
                                         int* cell, int* slot) {
  const int lo = a[0].c0;
  const int span = a[n - 1].c1 - lo + 1;  // the cells are monotone in j
  if (span <= 2 * n) {  // the window [lo, lo + span)
    slot[2 * j] = a[j].c0 - lo;
    slot[2 * j + 1] = a[j].c1 - lo;
    if (2 * j < span) cell[2 * j] = lo + 2 * j;
    if (2 * j + 1 < span) cell[2 * j + 1] = lo + 2 * j + 1;
    return span;
  }
  slot[2 * j] = 2 * j;  // two cells a sample
  slot[2 * j + 1] = 2 * j + 1;
  cell[2 * j] = a[j].c0;
  cell[2 * j + 1] = a[j].c1;
  return 2 * n;
}

// Blends the 4 * sr * sr staged corners of bin pw's samples for the N
// channels of vector vec and writes their N float32 means to o.
template <typename T, int N>
__device__ __forceinline__ void blend(const Sample* sy, const Sample* sx,
                                      const int* slot_y, const int* slot_x,
                                      const Pack<T, N>* tile, int cols,
                                      int V, int sr, int pw, int vec,
                                      float* __restrict__ o) {
  float acc[N];
  for (int iy = 0; iy < sr; ++iy) {
    const Sample y = sy[iy];
    const float hy = __fsub_rn(1.f, y.frac);
    const Pack<T, N>* row0 = tile + slot_y[2 * iy] * cols * V + vec;
    const Pack<T, N>* row1 = tile + slot_y[2 * iy + 1] * cols * V + vec;
    for (int ix = 0; ix < sr; ++ix) {
      const int j = pw * sr + ix;
      const Sample x = sx[j];
      const float hx = __fsub_rn(1.f, x.frac);
      const int o0 = slot_x[2 * j] * V;
      const int o1 = slot_x[2 * j + 1] * V;
      const Pack<T, N> f00 = row0[o0];
      const Pack<T, N> f01 = row0[o1];
      const Pack<T, N> f10 = row1[o0];
      const Pack<T, N> f11 = row1[o1];
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
  roi_pool::store(o, res);
}

template <typename T, int N>
__global__ void __launch_bounds__(kMaxThreads)
roi_align_fwd_kernel(const T* __restrict__ feat,
                     const float* __restrict__ rois, float* __restrict__ out,
                     int H, int W, int C, int PH, int PW, int sr, int V,
                     float spatial_scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int staged[2];  // rows, columns
  const Stage layout(PW, sr, V, static_cast<int>(sizeof(Pack<T, N>)));
  const int ny = sr;
  const int nx = PW * sr;
  Pack<T, N>* tile = reinterpret_cast<Pack<T, N>*>(smem);
  Sample* sy = reinterpret_cast<Sample*>(smem + layout.tile_bytes);
  Sample* sx = sy + ny;
  int* cell_y = reinterpret_cast<int*>(sx + nx);
  int* cell_x = cell_y + 2 * ny;
  int* slot_y = cell_x + 2 * nx;
  int* slot_x = slot_y + 2 * ny;

  const int slabs = C / (N * V);
  const int s = static_cast<int>(blockIdx.x % slabs);
  const int rph = static_cast<int>(blockIdx.x / slabs);  // r * PH + ph
  const int r = rph / PH;
  const int ph = rph - r * PH;
  const float* roi = rois + 5LL * r;
  const float start_w = __fmul_rn(roi[1], spatial_scale);
  const float start_h = __fmul_rn(roi[2], spatial_scale);
  const float end_w = __fmul_rn(roi[3], spatial_scale);
  const float end_h = __fmul_rn(roi[4], spatial_scale);
  for (int t = threadIdx.x; t < ny + nx; t += blockDim.x) {
    if (t < ny) {
      sy[t] = axis_sample(start_h, end_h, ph * sr + t, PH, sr, H);
    } else {
      sx[t - ny] = axis_sample(start_w, end_w, t - ny, PW, sr, W);
    }
  }
  __syncthreads();
  for (int t = threadIdx.x; t < ny + nx; t += blockDim.x) {
    if (t < ny) {
      const int rows = plan_axis(sy, ny, t, cell_y, slot_y);
      if (t == 0) staged[0] = rows;
    } else {
      const int cols = plan_axis(sx, nx, t - ny, cell_x, slot_x);
      if (t == ny) staged[1] = cols;
    }
  }
  __syncthreads();

  // the staged cells of this slab, kStage loads in flight per thread
  const int rows = staged[0];
  const int cols = staged[1];
  const int total = rows * cols * V;
  const T* fs = feat + s * V * N;
  for (int k0 = threadIdx.x; k0 < total; k0 += kStage * blockDim.x) {
    Pack<T, N> v[kStage];
#pragma unroll
    for (int u = 0; u < kStage; ++u) {
      const int k = k0 + u * blockDim.x;
      if (k < total) {
        const int cv = k / V;  // row slot * cols + column slot
        const int ry = cv / cols;
        roi_pool::load(fs + (static_cast<long long>(cell_y[ry]) * W +
                             cell_x[cv - ry * cols]) * C + (k - cv * V) * N,
                       v[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kStage; ++u) {
      const int k = k0 + u * blockDim.x;
      if (k < total) tile[k] = v[u];
    }
  }
  __syncthreads();

  // one (bin, vector) item a thread: item = pw * V + vector
  for (int item = threadIdx.x; item < PW * V; item += blockDim.x) {
    const int pw = item / V;
    const int vec = item - pw * V;
    blend(sy, sx, slot_y, slot_x, tile, cols, V, sr, pw, vec,
          out + (static_cast<long long>(rph) * PW + pw) * C +
              (s * V + vec) * N);
  }
}

template <typename T, int N>
int launch_n(const void* feat, const void* rois, void* out, int H, int W,
             int C, int R, int PH, int PW, int sr, float spatial_scale,
             cudaStream_t stream) {
  constexpr int kSharedMax = 227 * 1024;
  const int nv = C / N;
  int v = kSlabVectors;
  while (nv % v != 0 ||
         (v > 1 && Stage(PW, sr, v, sizeof(Pack<T, N>)).bytes > kSharedMax)) {
    v /= 2;
  }
  const int shared = Stage(PW, sr, v, sizeof(Pack<T, N>)).bytes;
  const int threads = min((PW * v + 31) / 32 * 32, kMaxThreads);
  if (shared > kSharedMax) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (shared > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        roi_align_fwd_kernel<T, N>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, shared);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const long long blocks = static_cast<long long>(R) * PH * (nv / v);
  roi_align_fwd_kernel<T, N><<<static_cast<unsigned>(blocks), threads,
                               shared, stream>>>(
      static_cast<const T*>(feat), static_cast<const float*>(rois),
      static_cast<float*>(out), H, W, C, PH, PW, sr, v, spatial_scale);
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
