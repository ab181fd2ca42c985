// ROIAlignV2 over the packed FPN pyramid (K5).
//
// Replaces: video_gen_evals_tpu/ops/roi_align.py::roi_align_pyramid_dma
// (_pool_dma_kernel, pallas_call at roi_align.py:335).
//
// For ROI r of image i = r / rois_per_image, on level l = levels[r], the JAX
// DMA pool's geometry (roi_align.py:283-302) gives a window of `window` rows
// and `window_x` columns at (wy0, wx0) in buffer coordinates, and the
// separable weights Wy [7, window], Wx [7, window_x] of _axis_weights
// (roi_align.py:76): per bin, the sum over its ceil(length / 7) sample
// positions (capped at max_samples) of the two bilinear tap weights over the
// sample count, a tap beyond the window counting for the window's last cell.
// Then
//   out[r, p, q, c] = sum_w Wx[q, w] * sum_h Wy[p, h] * buf[i, wy0 + h, wx0 + w, c]
// The buffer is channels last, [n_images, buf_h, buf_w, C] float32, and the
// output [n_rois, 7, 7, C] float32 (the JAX layout). The geometry and the
// weights are computed here from the box with IEEE round-to-nearest
// operations in JAX's order (no contraction into FMAs), so the taps are the
// plain version's.
//
// Bound on the H100: bytes. K5 must read once each buffer cell that some ROI
// weights, and no other: the zero padding right of p3-p5 in the 360 x 336
// packed buffer carries no weight. For a chunk of 8 images that is at most
// the levels' 85,680 cells of 256 floats an image (702 MB of the buffer's
// 991 MB), plus 8000 x 49 x 256 output floats (401 MB): at most 0.329 ms at
// 3.35 TB/s (chip_smoke.py counts the cells its proposals weight). The
// operations (about 2 x 7 FMAs per cell read) are far below the fp32 rate. The TPU kernel fed the MXU one dense product
// [49, window * window_x] @ [window * window_x, C] per ROI with outer-product
// weights built in XLA (527 KB a ROI, 4.2 GB for the chunk); here those weights
// are never formed, and the separable ones live only in shared memory.
//
// Design: one block per ROI, one thread per channel (C = 256 at full width;
// smaller C rounds the block up to a warp and masks), so every read of a cell
// is one coalesced 1 KB row of channels. The block builds Wy and Wx in shared
// memory (one thread per weight), finds for each bin row p the window rows
// [ylo_p, yhi_p] with non-zero weight and the columns [xlo, xhi] that any bin
// column weights, and reads only those cells: for each p and each column w,
// the column's Wy-weighted sum t over rows ylo_p..yhi_p, added into seven
// accumulators acc[q] += Wx[q, w] * t held in registers. Rows shared by two
// neighbouring bins are read twice (from L1 or L2); the window is read from
// device memory about once. The sums run in the plain version's order (rows
// first, then columns), so the two differ by rounding only.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBins = 7;
constexpr int kMaxThreads = 256;

struct RoiGeom {
  float start_y, start_x, len_y, len_x;
  int extent_y, extent_x;
  int win_y, win_x;      // window starts in level coordinates (weights)
  int buf_y, buf_x;      // window starts in buffer coordinates (reads)
};

// One entry of _axis_weights: bin b, window cell j.
__device__ float axis_weight(float start, float length, int extent, int win_start, int b, int j,
                             int window, int max_samples) {
  const float binw = __fdiv_rn(length, (float)kBins);
  const int s = min(max((int)ceilf(binw), 0), max_samples);
  const float safe = (float)max(s, 1);
  const float w = __fdiv_rn(1.0f, safe);
  float acc = 0.0f;
  for (int k = 0; k < s; ++k) {
    const float pos = __fadd_rn(
        start, __fmul_rn(binw, __fadd_rn((float)b, __fdiv_rn(__fadd_rn((float)k, 0.5f), safe))));
    if (pos < -1.0f || pos > (float)extent) continue;
    const float p = fmaxf(pos, 0.0f);
    int low = (int)floorf(p);
    int high;
    float frac;
    if (low >= extent - 1) {
      low = high = extent - 1;
      frac = 0.0f;
    } else {
      high = low + 1;
      frac = __fsub_rn(p, (float)low);
    }
    const float lo_term = min(low - win_start, window - 1) == j ? __fmul_rn(w, __fsub_rn(1.0f, frac)) : 0.0f;
    const float hi_term = min(high - win_start, window - 1) == j ? __fmul_rn(w, frac) : 0.0f;
    acc = __fadd_rn(acc, __fadd_rn(lo_term, hi_term));
  }
  return acc;
}

__global__ void __launch_bounds__(kMaxThreads) roi_align_kernel(
    const float* __restrict__ buf, int buf_h, int buf_w, int channels,
    const float* __restrict__ boxes, const int* __restrict__ levels,
    const int* __restrict__ level_info,   // [3, n_levels]: row offset, H_l, W_l
    const float* __restrict__ strides, int n_levels,
    int rois_per_image, int window, int window_x, int max_samples, float* __restrict__ out) {
  extern __shared__ float smem[];
  float* wy = smem;                       // [kBins, window]
  float* wx = smem + kBins * window;      // [kBins, window_x]
  __shared__ RoiGeom g;
  __shared__ int ylo[kBins], yhi[kBins];
  __shared__ int xlo_s, xhi_s;

  const int r = blockIdx.x;
  const int tid = threadIdx.x;
  if (tid == 0) {
    const int lvl = min(max(levels[r], 0), n_levels - 1);
    const float stride = strides[lvl];
    const int off = level_info[lvl], h_l = level_info[n_levels + lvl], w_l = level_info[2 * n_levels + lvl];
    const float* box = boxes + 4 * (size_t)r;
    g.start_x = __fsub_rn(__fdiv_rn(box[0], stride), 0.5f);
    g.start_y = __fsub_rn(__fdiv_rn(box[1], stride), 0.5f);
    g.len_x = __fdiv_rn(__fsub_rn(box[2], box[0]), stride);
    g.len_y = __fdiv_rn(__fsub_rn(box[3], box[1]), stride);
    g.extent_y = h_l;
    g.extent_x = w_l;
    // rows: clipped to the level, then to the buffer
    int wy0 = min(max((int)floorf(g.start_y), 0), max(h_l - window, 0)) + off;
    wy0 = min(max(wy0, 0), buf_h - window);
    // columns: clipped to the buffer (not the level), floored to 8
    int wx0 = min(max((int)floorf(g.start_x), 0), buf_w);
    wx0 = min(max(wx0 / 8 * 8, 0), buf_w - window_x);
    g.buf_y = wy0;
    g.buf_x = wx0;
    g.win_y = wy0 - off;
    g.win_x = wx0;
  }
  __syncthreads();

  const int n_wy = kBins * window;
  for (int e = tid; e < n_wy + kBins * window_x; e += blockDim.x) {
    if (e < n_wy) {
      wy[e] = axis_weight(g.start_y, g.len_y, g.extent_y, g.win_y, e / window, e % window, window, max_samples);
    } else {
      const int f = e - n_wy;
      wx[f] = axis_weight(g.start_x, g.len_x, g.extent_x, g.win_x, f / window_x, f % window_x, window_x,
                          max_samples);
    }
  }
  __syncthreads();

  if (tid < kBins) {
    int lo = window, hi = -1;
    for (int h = 0; h < window; ++h) {
      if (wy[tid * window + h] != 0.0f) {
        lo = min(lo, h);
        hi = h;
      }
    }
    ylo[tid] = lo;
    yhi[tid] = hi;
  } else if (tid == (int)blockDim.x - 1) {
    int lo = window_x, hi = -1;
    for (int w = 0; w < window_x; ++w) {
      bool any = false;
#pragma unroll
      for (int q = 0; q < kBins; ++q) any |= wx[q * window_x + w] != 0.0f;
      if (any) {
        lo = min(lo, w);
        hi = w;
      }
    }
    xlo_s = lo;
    xhi_s = hi;
  }
  __syncthreads();

  const int img = r / rois_per_image;
  const size_t row_stride = (size_t)buf_w * channels;
  const float* base = buf + ((size_t)img * buf_h + g.buf_y) * row_stride + (size_t)g.buf_x * channels;
  const int xlo = xlo_s, xhi = xhi_s;
  float* out_r = out + (size_t)r * kBins * kBins * channels;

  for (int c = tid; c < channels; c += blockDim.x) {
    const float* col_c = base + c;
    for (int p = 0; p < kBins; ++p) {
      float acc[kBins];
#pragma unroll
      for (int q = 0; q < kBins; ++q) acc[q] = 0.0f;
      const int h0 = ylo[p], h1 = yhi[p];
      const float* wy_p = wy + p * window;
      for (int w = xlo; w <= xhi; ++w) {
        const float* cell = col_c + (size_t)w * channels;
        float t = 0.0f;
#pragma unroll 4
        for (int h = h0; h <= h1; ++h) t = fmaf(wy_p[h], __ldg(cell + (size_t)h * row_stride), t);
#pragma unroll
        for (int q = 0; q < kBins; ++q) acc[q] = fmaf(wx[q * window_x + w], t, acc[q]);
      }
#pragma unroll
      for (int q = 0; q < kBins; ++q) out_r[(p * kBins + q) * channels + c] = acc[q];
    }
  }
}

}  // namespace

// boxes [n_rois, 4] float32 xyxy (image coords), levels [n_rois] int32,
// level_info [3, n_levels] int32, strides [n_levels] float32; ROI r belongs
// to image r / rois_per_image of the [n_images, buf_h, buf_w, channels] buffer.
extern "C" int vge_roi_align(
    int device, const float* buf, int buf_h, int buf_w, int channels,
    const float* boxes, const int* levels, const int* level_info, const float* strides,
    int n_levels, int n_rois, int rois_per_image, int window, int window_x, int max_samples,
    float* out, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (channels < 1 || window < 1 || window_x < 1 || rois_per_image < 1 || n_levels < 1 ||
      window > buf_h || window_x > buf_w || max_samples < 1) {
    return (int)cudaErrorInvalidValue;
  }
  if (n_rois == 0) return (int)cudaSuccess;
  const int threads = channels >= kMaxThreads ? kMaxThreads : (channels + 31) / 32 * 32;
  const size_t smem = (size_t)kBins * (window + window_x) * sizeof(float);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  roi_align_kernel<<<n_rois, threads, smem, stream>>>(
      buf, buf_h, buf_w, channels, boxes, levels, level_info, strides, n_levels,
      rois_per_image, window, window_x, max_samples, out);
  return (int)cudaGetLastError();
}
