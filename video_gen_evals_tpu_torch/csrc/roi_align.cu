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
// The buffer is channels last, [n_images, buf_h, buf_w, C], float32 or
// bfloat16 (the JAX package's RCNNConfig.fast() packs its levels in bfloat16,
// rcnn.py:560-568), and the output [n_rois, 7, 7, C] float32 (the JAX
// layout). A bfloat16 cell is widened to float32 as it is loaded, and the
// weights and sums stay float32: what the TPU kernel computes with
// preferred_element_type float32 (in interpret mode it equals the float32
// pool on the buffer rounded to bfloat16 and back). The geometry and the
// weights are computed here from the box with IEEE round-to-nearest
// operations in JAX's order (no contraction into FMAs), so the taps are the
// plain version's.
//
// Bound on the H100: bytes. K5 must read once each buffer cell that some ROI
// weights, and no other: the zero padding right of p3-p5 in the 360 x 336
// packed buffer carries no weight. For a chunk of 8 images that is at most
// the levels' 85,680 cells of 256 floats an image (702 MB of the buffer's
// 991 MB), plus 8000 x 49 x 256 output floats (401 MB): at most 0.329 ms at
// 3.35 TB/s (chip_smoke.py counts the cells its proposals weight); a bfloat16
// buffer halves the cell bytes, and fast()'s window of 32 rows x 40 columns
// clips the widest ROIs' spans. The operations (about 2 x 1.5 FMAs per
// channel of a cell read, and 2 x 1.5 x 7 per channel of a weighted column)
// are far below the fp32 rate. The TPU kernel fed the MXU one dense product
// [49, window * window_x] @ [window * window_x, C] per ROI with outer-product
// weights built in XLA (527 KB a ROI, 4.2 GB for the chunk); here those
// weights are never formed, and the separable ones live only in shared
// memory.
//
// What sets the pace: overlapping ROIs read the same cells, so the loads of a
// chunk's ROIs cover several times the bytes of the bound (the sum over ROIs
// of their weighted rows x weighted columns: 2.5 M cells of 1 KB for the
// smoke's 8000 fp32 proposals, 6.9x the union), most of them from L2; and a
// ROI's sums run down its rows one after another. The design reads each
// weighted cell of a ROI's window once for that ROI, 16 bytes a thread, and
// keeps the per-row work short and shared:
// - One block a ROI, 256 threads, in passes of 128 channels (two at C =
//   256): kGroups groups of kLanes threads, each thread 16 bytes of channels
//   of a cell (4 fp32 or 8 bf16), so a group's load is one coalesced 512 B
//   (fp32) or 256 B (bf16) piece of a cell.
// - Setup, once a ROI: thread 0 computes the window (JAX's clamps); the block
//   computes each axis's 7 x max_samples sample taps once (positions, tap
//   cells and tap weights, with the IEEE operations of _axis_weights), then
//   every weight Wy[p, h], Wx[q, w] as the sum of its taps in the order of
//   the samples, the order and the rounding of the kernel it replaces. One
//   warp compacts the rows that carry weight into a table (row, the bins
//   plo..phi that weight it, the weights of plo and plo + 1), another the
//   weighted columns (their 7 weights, and for each bin q the first and last
//   column that it weights), by ballots.
// - Phase 1, the loads: the weighted columns go in chunks of kSlots = 16;
//   each group takes kCols of them (2 fp32, 1 bf16) and walks their weighted
//   rows once, kRows rows of each column loaded ahead, adding each cell into
//   the column's sums t[p] of the bins p that weight its row. Rows come in
//   order and the bins that weight them never go back (plo and phi do not
//   decrease down the window: the sample positions increase with (p, k) and
//   the tap cells with the positions), so two registers a column carry
//   t[plo] and t[plo + 1]; a bin the rows have passed goes to the chunk's
//   column sums in shared memory, and a row weighted by more than two bins
//   (a bin narrower than a cell) adds the rest there directly. The row
//   table, the band and its branches are the same for a group's columns, so
//   they are paid once a row for kCols cells. Each thread owns its channels
//   of its columns' sums: no barrier inside the phase.
// - Phase 2: a barrier, then each thread owns one bin row p and four
//   channels (the block's 256 threads are 8 rows of 32 channel quads) and
//   adds, for each bin column q, only the chunk's columns that q weights:
//   out[p, q] += Wx[q, w] * t[p, w], 7 x 4 accumulators in registers. A
//   barrier frees the column sums for the next chunk.
// - The output is written once a pass, 16 bytes a thread, 512 B a bin.
// Every sum runs in a fixed order (rows down a column, then the columns
// across a bin), with no atomics: two calls give the same bits. The sums run
// in the plain version's order, rows first, then columns, so the two differ
// by rounding only. A channel count that is no multiple of the vector width
// (or a buffer off 16 bytes) takes the same kernel with scalar loads and
// stores, masked at the tail.
//
// Tried on an H100 (PERF.md section 6; fp32 / bf16 ms on the smoke's chunk):
// one pass of 256 channels with 56 accumulators a thread across the chunks
// spilled in bf16 at 128 registers and read 0.94 / 0.82; with its loads cut
// out it still read 0.73 / 0.68, the per-row work of one column at a time
// setting the pace. Blocks ordered by image, level and row read 13% slower.
// Three blocks an SM (85 registers) spilled and read 1.16 in fp32. Here,
// with the loads cut out the kernel reads 0.69 / 0.56 and without its two
// phases 0.20 / 0.18 (the setup and the output): the phases' per-row work,
// not the loads, still sets the pace.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBins = 7;
constexpr int kThreads = 256;
constexpr int kMinBlocks = 2;   // blocks an SM: at most 128 registers a thread
constexpr int kSlots = 16;      // weighted columns a chunk

struct RoiGeom {
  float start_y, start_x, len_y, len_x;
  int extent_y, extent_x;
  int win_y, win_x;      // window starts in level coordinates (weights)
  int buf_y, buf_x;      // window starts in buffer coordinates (reads)
};

// A cell type's load: Raw holds kV channels as they are in memory (16
// bytes), widen makes them float32 (exact for bfloat16).
template <typename Cell>
struct CellIO;

// kV channels a thread (16 bytes), kLanes threads a group (128 channels, the
// pass), kGroups groups of kCols columns each (kSlots columns a chunk), kRows
// rows of each column loaded ahead.
template <>
struct CellIO<float> {
  static constexpr int kV = 4, kLanes = 32, kGroups = 8, kCols = 2, kRows = 4;
  using Raw = float4;
  // n: the channels left from p on (a multiple of kV on the vector path;
  // none in the last pass of a C that is no multiple of the pass)
  template <bool kVec>
  __device__ static Raw load(const float* p, int n) {
    if constexpr (kVec) {
      return n > 0 ? __ldg(reinterpret_cast<const float4*>(p)) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    } else {
      return make_float4(n > 0 ? __ldg(p) : 0.0f, n > 1 ? __ldg(p + 1) : 0.0f, n > 2 ? __ldg(p + 2) : 0.0f,
                         n > 3 ? __ldg(p + 3) : 0.0f);
    }
  }
  __device__ static void widen(const Raw& r, float (&v)[kV]) {
    v[0] = r.x, v[1] = r.y, v[2] = r.z, v[3] = r.w;
  }
};

template <>
struct CellIO<__nv_bfloat16> {
  static constexpr int kV = 8, kLanes = 16, kGroups = 16, kCols = 1, kRows = 4;
  using Raw = uint4;
  template <bool kVec>
  __device__ static Raw load(const __nv_bfloat16* p, int n) {
    if constexpr (kVec) {
      return n > 0 ? __ldg(reinterpret_cast<const uint4*>(p)) : make_uint4(0u, 0u, 0u, 0u);
    } else {
      const unsigned short* q = reinterpret_cast<const unsigned short*>(p);
      uint32_t w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint32_t lo = 2 * i < n ? __ldg(q + 2 * i) : 0u;
        const uint32_t hi = 2 * i + 1 < n ? __ldg(q + 2 * i + 1) : 0u;
        w[i] = lo | (hi << 16);
      }
      return make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
  __device__ static void widen(const Raw& r, float (&v)[kV]) {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

// Shared memory past the static part, in floats, laid out in this order:
// the column sums [kBins][kSlots][cp], cp = lanes * kV; the sample taps [2 axes][kBins]
// [max_samples] (float4: lo cell, hi cell as int bits, lo weight, hi
// weight); the row table [window] (int4: row, plo | phi << 16, the weights of
// plo and plo + 1 as float bits); the column weights [window_x][8]; Wy
// [kBins][window]; Wx [kBins][window_x]; the column table [window_x] (int).
size_t smem_floats(int lanes, int v, int window, int window_x, int max_samples) {
  return (size_t)kBins * kSlots * lanes * v + 2 * kBins * max_samples * 4 + (size_t)window * 4 +
         (size_t)window_x * 8 + (size_t)kBins * (window + window_x) + window_x;
}

// One sample tap of _axis_weights: bin b, sample k (of s, capped at
// max_samples), the IEEE operations in JAX's order. A sample past s or
// outside [-1, extent] gets cells -1 (it weights no cell).
__device__ float4 sample_tap(float start, float length, int extent, int win_start, int b, int k,
                             int window, int max_samples) {
  const float binw = __fdiv_rn(length, (float)kBins);
  const int s = min(max((int)ceilf(binw), 0), max_samples);
  const float safe = (float)max(s, 1);
  const float w = __fdiv_rn(1.0f, safe);
  float4 tap = make_float4(__int_as_float(-1), __int_as_float(-1), 0.0f, 0.0f);
  if (k >= s) return tap;
  const float pos = __fadd_rn(
      start, __fmul_rn(binw, __fadd_rn((float)b, __fdiv_rn(__fadd_rn((float)k, 0.5f), safe))));
  if (pos < -1.0f || pos > (float)extent) return tap;
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
  tap.x = __int_as_float(min(low - win_start, window - 1));
  tap.y = __int_as_float(min(high - win_start, window - 1));
  tap.z = __fmul_rn(w, __fsub_rn(1.0f, frac));
  tap.w = __fmul_rn(w, frac);
  return tap;
}

// One entry of _axis_weights, bin b, window cell j: the sum of the taps of
// its samples in their order (a sample that misses j adds an exact zero).
__device__ float axis_weight(const float4* taps, int b, int j, int max_samples) {
  float acc = 0.0f;
  for (int k = 0; k < max_samples; ++k) {
    const float4 t = taps[b * max_samples + k];
    const float lo = __float_as_int(t.x) == j ? t.z : 0.0f;
    const float hi = __float_as_int(t.y) == j ? t.w : 0.0f;
    acc = __fadd_rn(acc, __fadd_rn(lo, hi));
  }
  return acc;
}

template <typename Cell, bool kVec>
__global__ void __launch_bounds__(kThreads, kMinBlocks) roi_align_kernel(
    const Cell* __restrict__ buf, int buf_h, int buf_w, int channels,
    const float* __restrict__ boxes, const int* __restrict__ levels,
    const int* __restrict__ level_info,   // [3, n_levels]: row offset, H_l, W_l
    const float* __restrict__ strides, int n_levels,
    int rois_per_image, int window, int window_x, int max_samples, float* __restrict__ out) {
  using IO = CellIO<Cell>;
  constexpr int kV = IO::kV, kG = IO::kGroups, kJ = IO::kCols, kR = IO::kRows;
  static_assert(kG * kJ == kSlots, "a chunk's columns, kCols a group");
  using Raw = typename IO::Raw;
  extern __shared__ float4 smem4[];
  __shared__ RoiGeom g;
  __shared__ int n_rows, n_cols, q_first[kBins], q_last[kBins];

  const int lanes = min(IO::kLanes, (channels + kV - 1) / kV);
  const int cp = lanes * kV;                      // channels a pass
  float* tsum = reinterpret_cast<float*>(smem4);  // [kBins][kSlots][cp]
  float4* taps = smem4 + (size_t)kBins * kSlots * cp / 4;
  int4* rows = reinterpret_cast<int4*>(taps + 2 * kBins * max_samples);
  float* wxc = reinterpret_cast<float*>(rows + window);   // [window_x][8]
  float* wy = wxc + (size_t)window_x * 8;                 // [kBins][window]
  float* wx = wy + kBins * window;                        // [kBins][window_x]
  int* cols = reinterpret_cast<int*>(wx + kBins * window_x);

  const int r = blockIdx.x;
  const int tid = threadIdx.x, lane32 = tid & 31, warp = tid >> 5;
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

  // the sample taps of both axes, then the weights
  const int n_taps = kBins * max_samples;
  for (int i = tid; i < 2 * n_taps; i += blockDim.x) {
    const int b = (i % n_taps) / max_samples, k = i % max_samples;
    taps[i] = i < n_taps
                  ? sample_tap(g.start_y, g.len_y, g.extent_y, g.win_y, b, k, window, max_samples)
                  : sample_tap(g.start_x, g.len_x, g.extent_x, g.win_x, b, k, window_x, max_samples);
  }
  __syncthreads();
  const int n_wy = kBins * window;
  for (int e = tid; e < n_wy + kBins * window_x; e += blockDim.x) {
    if (e < n_wy) {
      wy[e] = axis_weight(taps, e / window, e % window, max_samples);
    } else {
      const int f = e - n_wy;
      wx[f] = axis_weight(taps + n_taps, f / window_x, f % window_x, max_samples);
    }
  }
  __syncthreads();

  // the tables, by ballots: warp 0 the weighted rows, warp 1 (warp 0 in a
  // one-warp block) the weighted columns
  const int n_warps = (int)blockDim.x >> 5;
  if (warp == 0) {
    int count = 0;
    for (int h0 = 0; h0 < window; h0 += 32) {
      const int h = h0 + lane32;
      int plo = kBins, phi = -1;
      if (h < window) {
#pragma unroll
        for (int p = kBins - 1; p >= 0; --p) plo = wy[p * window + h] != 0.0f ? p : plo;
#pragma unroll
        for (int p = 0; p < kBins; ++p) phi = wy[p * window + h] != 0.0f ? p : phi;
      }
      const uint32_t mask = __ballot_sync(0xffffffffu, phi >= 0);
      if (phi >= 0) {
        const float wa = wy[plo * window + h];
        const float wb = plo + 1 < kBins ? wy[(plo + 1) * window + h] : 0.0f;
        rows[count + __popc(mask & ((1u << lane32) - 1u))] =
            make_int4(h, plo | (phi << 16), __float_as_int(wa), __float_as_int(wb));
      }
      count += __popc(mask);
    }
    if (lane32 == 0) n_rows = count;
  }
  if (warp == (n_warps > 1 ? 1 : 0)) {
    int count = 0, first[kBins], last[kBins];
#pragma unroll
    for (int q = 0; q < kBins; ++q) first[q] = window_x, last[q] = -1;
    for (int w0 = 0; w0 < window_x; w0 += 32) {
      const int w = w0 + lane32;
      float wq[kBins];
      bool any = false;
#pragma unroll
      for (int q = 0; q < kBins; ++q) {
        wq[q] = w < window_x ? wx[q * window_x + w] : 0.0f;
        any |= wq[q] != 0.0f;
      }
      const uint32_t mask = __ballot_sync(0xffffffffu, any);
      const int at = count + __popc(mask & ((1u << lane32) - 1u));   // the column's place in the table
      if (any) {
        cols[at] = w;
#pragma unroll
        for (int q = 0; q < kBins; ++q) wxc[at * 8 + q] = wq[q];
        wxc[at * 8 + kBins] = 0.0f;
      }
#pragma unroll
      for (int q = 0; q < kBins; ++q) {
        const uint32_t bq = __ballot_sync(0xffffffffu, wq[q] != 0.0f);
        if (bq != 0u) {
          first[q] = min(first[q], count + __popc(mask & ((1u << (__ffs(bq) - 1)) - 1u)));
          last[q] = count + __popc(mask & ((1u << (31 - __clz(bq))) - 1u));
        }
      }
      count += __popc(mask);
    }
    if (lane32 == 0) {
      n_cols = count;
#pragma unroll
      for (int q = 0; q < kBins; ++q) q_first[q] = first[q], q_last[q] = last[q];
    }
  }
  __syncthreads();

  const int ny = n_rows, nx = n_cols;
  const int img = r / rois_per_image;
  const size_t row_stride = (size_t)buf_w * channels;
  const Cell* base = buf + ((size_t)img * buf_h + g.buf_y) * row_stride + (size_t)g.buf_x * channels;
  float* out_r = out + (size_t)r * kBins * kBins * channels;
  const bool active = tid < kG * lanes;
  // phase 1: group grp, the lane's kV channels, the chunk's columns grp + kG j
  const int grp = tid / lanes, lane = tid % lanes;
  // phase 2: bin row p2 (kG * lanes threads are 8 rows of cp / 4 quads) and
  // the channels of quad
  const int quads = cp / 4;
  const int quad = tid % quads, p2 = tid / quads;
  const bool owner = active && p2 < kBins;
  const size_t bin_stride = (size_t)kSlots * cp;   // floats between two bins' column sums

  for (int c0 = 0; c0 < channels; c0 += cp) {
    const int c = c0 + lane * kV;   // phase 1's first channel
    const int n_left = channels - c;
    float acc[kBins][4];
#pragma unroll
    for (int q = 0; q < kBins; ++q) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[q][e] = 0.0f;
    }
    for (int k0 = 0; k0 < nx; k0 += kSlots) {
      // phase 1: each group walks the weighted rows of its kJ columns of the
      // chunk at once; the rows' bins, and so the band, are the same for all
      if (active && k0 + grp < nx) {
        bool has[kJ];
        int col_off[kJ];   // the column's offset from base, in cells' elements
        float* ts[kJ];     // its sums, bin p at ts + p * bin_stride
#pragma unroll
        for (int j = 0; j < kJ; ++j) {
          const int s = grp + kG * j;
          has[j] = k0 + s < nx;
          col_off[j] = has[j] ? cols[k0 + s] * channels + c : 0;
          ts[j] = tsum + (size_t)s * cp + lane * kV;
          if (has[j]) {
#pragma unroll
            for (int p = 0; p < kBins; ++p) {
#pragma unroll
              for (int e = 0; e < kV; e += 4)
                *reinterpret_cast<float4*>(ts[j] + p * bin_stride + e) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
            }
          }
        }
        // ts[j][p] += t, four floats at a time
        auto flush = [&](const float (&t)[kV], int j, int p) {
          if (p >= kBins || !has[j]) return;
#pragma unroll
          for (int e = 0; e < kV; e += 4) {
            float4* d = reinterpret_cast<float4*>(ts[j] + p * bin_stride + e);
            const float4 o = *d;
            *d = make_float4(o.x + t[e], o.y + t[e + 1], o.z + t[e + 2], o.w + t[e + 3]);
          }
        };
        float t0[kJ][kV], t1[kJ][kV];
#pragma unroll
        for (int j = 0; j < kJ; ++j) {
#pragma unroll
          for (int e = 0; e < kV; ++e) t0[j][e] = t1[j][e] = 0.0f;
        }
        int band = ny > 0 ? rows[0].y & 0xffff : 0;   // t0 sums bin band, t1 bin band + 1
        for (int k = 0; k < ny; k += kR) {
          Raw raw[kR][kJ];
#pragma unroll
          for (int u = 0; u < kR; ++u) {
            if (k + u < ny) {
              const Cell* row_p = base + (size_t)rows[k + u].x * row_stride;
#pragma unroll
              for (int j = 0; j < kJ; ++j)
                raw[u][j] = IO::template load<kVec>(row_p + col_off[j], has[j] ? n_left : 0);
            }
          }
#pragma unroll
          for (int u = 0; u < kR; ++u) {
            if (k + u >= ny) break;
            const int4 row = rows[k + u];
            const int plo = row.y & 0xffff, phi = row.y >> 16;
            if (plo > band) {   // the rows have passed bin band (and band + 1 unless plo is it)
#pragma unroll
              for (int j = 0; j < kJ; ++j) {
                flush(t0[j], j, band);
                if (plo == band + 1) {
#pragma unroll
                  for (int e = 0; e < kV; ++e) t0[j][e] = t1[j][e];
                } else {
                  flush(t1[j], j, band + 1);
#pragma unroll
                  for (int e = 0; e < kV; ++e) t0[j][e] = 0.0f;
                }
#pragma unroll
                for (int e = 0; e < kV; ++e) t1[j][e] = 0.0f;
              }
              band = plo;
            }
            const float wa = __int_as_float(row.z), wb = __int_as_float(row.w);
#pragma unroll
            for (int j = 0; j < kJ; ++j) {
              float v[kV];
              IO::widen(raw[u][j], v);
              if (plo == band) {
#pragma unroll
                for (int e = 0; e < kV; ++e) {
                  t0[j][e] = fmaf(wa, v[e], t0[j][e]);
                  t1[j][e] = fmaf(wb, v[e], t1[j][e]);
                }
              }
              // bins past band + 1 (a bin narrower than a cell), and every bin
              // of a row whose plo fell behind the band (not reached: plo never
              // decreases), into the sums directly
              for (int p = plo == band ? plo + 2 : plo; p <= phi; ++p) {
                if (!has[j]) break;
                const float wp = wy[p * window + row.x];
#pragma unroll
                for (int e = 0; e < kV; e += 4) {
                  float4* d = reinterpret_cast<float4*>(ts[j] + p * bin_stride + e);
                  const float4 o = *d;
                  *d = make_float4(fmaf(wp, v[e], o.x), fmaf(wp, v[e + 1], o.y), fmaf(wp, v[e + 2], o.z),
                                   fmaf(wp, v[e + 3], o.w));
                }
              }
            }
          }
        }
#pragma unroll
        for (int j = 0; j < kJ; ++j) {
          flush(t0[j], j, band);
          flush(t1[j], j, band + 1);
        }
      }
      __syncthreads();
      // phase 2: bin row p2 of the quad's channels, each bin column over the
      // chunk's columns that it weights
      if (owner) {
        const int k_end = min(nx, k0 + kSlots) - 1;
        const float* tq = tsum + (size_t)p2 * bin_stride + quad * 4;
#pragma unroll
        for (int q = 0; q < kBins; ++q) {
          const int k_hi = min(q_last[q], k_end);
          for (int k = max(q_first[q], k0); k <= k_hi; ++k) {
            const float wq = wxc[k * 8 + q];
            const float4 t = *reinterpret_cast<const float4*>(tq + (size_t)(k - k0) * cp);
            acc[q][0] = fmaf(wq, t.x, acc[q][0]);
            acc[q][1] = fmaf(wq, t.y, acc[q][1]);
            acc[q][2] = fmaf(wq, t.z, acc[q][2]);
            acc[q][3] = fmaf(wq, t.w, acc[q][3]);
          }
        }
      }
      __syncthreads();
    }
    const int c2 = c0 + quad * 4;   // phase 2's first channel
    if (!owner || c2 >= channels) continue;
#pragma unroll
    for (int q = 0; q < kBins; ++q) {
      float* o = out_r + (size_t)(p2 * kBins + q) * channels + c2;
      if constexpr (kVec) {
        *reinterpret_cast<float4*>(o) = make_float4(acc[q][0], acc[q][1], acc[q][2], acc[q][3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (c2 + e < channels) o[e] = acc[q][e];
        }
      }
    }
  }
}

template <typename Cell, bool kVec>
cudaError_t launch_kernel(const Cell* buf, int buf_h, int buf_w, int channels, const float* boxes,
                          const int* levels, const int* level_info, const float* strides, int n_levels,
                          int n_rois, int rois_per_image, int window, int window_x, int max_samples,
                          float* out, size_t smem, int threads, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(roi_align_kernel<Cell, kVec>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  roi_align_kernel<Cell, kVec><<<n_rois, threads, smem, stream>>>(
      buf, buf_h, buf_w, channels, boxes, levels, level_info, strides, n_levels, rois_per_image, window,
      window_x, max_samples, out);
  return cudaGetLastError();
}

template <typename Cell>
int launch_roi_align(int device, const Cell* buf, int buf_h, int buf_w, int channels, const float* boxes,
                     const int* levels, const int* level_info, const float* strides, int n_levels, int n_rois,
                     int rois_per_image, int window, int window_x, int max_samples, float* out,
                     cudaStream_t stream) {
  using IO = CellIO<Cell>;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (channels < 1 || window < 1 || window_x < 1 || rois_per_image < 1 || n_levels < 1 ||
      window > buf_h || window_x > buf_w || max_samples < 1) {
    return (int)cudaErrorInvalidValue;
  }
  if (n_rois == 0) return (int)cudaSuccess;
  const int lanes = channels < IO::kLanes * IO::kV ? (channels + IO::kV - 1) / IO::kV : IO::kLanes;
  const int threads = (IO::kGroups * lanes + 31) / 32 * 32;
  const size_t smem = smem_floats(lanes, IO::kV, window, window_x, max_samples) * sizeof(float);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  // 16-byte loads and stores where every cell and output row starts on 16 bytes
  const bool vec = channels % IO::kV == 0 && reinterpret_cast<uintptr_t>(buf) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  auto launch = vec ? launch_kernel<Cell, true> : launch_kernel<Cell, false>;
  return (int)launch(buf, buf_h, buf_w, channels, boxes, levels, level_info, strides, n_levels, n_rois,
                     rois_per_image, window, window_x, max_samples, out, smem, threads, stream);
}

}  // namespace

// boxes [n_rois, 4] float32 xyxy (image coords), levels [n_rois] int32,
// level_info [3, n_levels] int32, strides [n_levels] float32; ROI r belongs
// to image r / rois_per_image of the [n_images, buf_h, buf_w, channels]
// buffer, float32 here and bfloat16 in vge_roi_align_bf16.
extern "C" int vge_roi_align(
    int device, const float* buf, int buf_h, int buf_w, int channels,
    const float* boxes, const int* levels, const int* level_info, const float* strides,
    int n_levels, int n_rois, int rois_per_image, int window, int window_x, int max_samples,
    float* out, cudaStream_t stream) {
  return launch_roi_align(device, buf, buf_h, buf_w, channels, boxes, levels, level_info, strides, n_levels,
                          n_rois, rois_per_image, window, window_x, max_samples, out, stream);
}

extern "C" int vge_roi_align_bf16(
    int device, const __nv_bfloat16* buf, int buf_h, int buf_w, int channels,
    const float* boxes, const int* levels, const int* level_info, const float* strides,
    int n_levels, int n_rois, int rois_per_image, int window, int window_x, int max_samples,
    float* out, cudaStream_t stream) {
  return launch_roi_align(device, buf, buf_h, buf_w, channels, boxes, levels, level_info, strides, n_levels,
                          n_rois, rois_per_image, window, window_x, max_samples, out, stream);
}
