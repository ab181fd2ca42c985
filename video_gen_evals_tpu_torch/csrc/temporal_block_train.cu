// Trainable fused residual dilated-conv stage (K4): forward and backward.
//
// Replaces: video_gen_evals_tpu/ops/conv_kernel_train.py::fused_temporal_block_train
// (bodies _fwd_kernel and _bwd_kernel, joined there by jax.custom_vjp).
//
// Forward, for each window b, with x[b] a [T, C] tile, weights [K, Cin, Cout]
// and an optional scaled keep mask (0 or 1/keep) of x's shape:
//   h1  = conv(x[b], w1)            k = 5, dilation d, zero padding inside the
//                                   window; a tap whose offset is >= T in size
//                                   contributes zero
//   d1  = GELU(h1) * mask
//   r   = conv(d1, w2) + x[b]
//   h   = GELU(r);  hn = (h - mean) * rstd   (GroupNorm(1) over T * C, eps 1e-5)
//   out = hn * gamma + beta
// Backward, from x, the weights, gamma, the mask and dy (nothing else is
// saved; the forward is recomputed):
//   dbeta = sum dy;  dgamma = sum dy * hn           over all windows and rows
//   dhn = dy * gamma
//   dr  = rstd * (dhn - mean(dhn) - hn * mean(dhn * hn)) * GELU'(r)
//   dw2[j] = shift_j(d1)^T dr                       shift_j(a)[t] = a[t + (j-2)d]
//   dd1 = conv(dr, w2t) * mask                      w2t tap-reversed, transposed
//   dh1 = dd1 * GELU'(h1)
//   dw1[j] = shift_j(x)^T dh1
//   dx  = dr + conv(dh1, w1t)
// GELU is the exact erf form, GELU'(u) = Phi(u) + u * phi(u).
//
// Precision:
//   "highest": fp32 products and sums.
//   "default": every product's two operands are rounded to bf16 (nearest
//              even) and multiplied and summed in fp32, the class of one bf16
//              pass with fp32 accumulation. Products of bf16 values are exact
//              in fp32.
//
// "highest", forward and backward: CUDA-core FMAs, bound by the fp32 FMA
// rate. Forward: 2 convs * 5 taps * T * C * C = 21 M FMAs per window (20.1 G
// at 960 windows). Backward: six conv-sized products (two recomputed, dd1,
// dx, dw1, dw2), 60.4 G at 960 windows.
//
// Design of the FMA kernels. The forward is the scoring kernel's
// (temporal_block.cu): one block per window, each thread keeps 4 output
// channels for all T rows in registers, the conv input sits in a shared tile.
// The backward is three launches, because Hopper's blocks run in no order and
// nothing carries a sum from one block to the next, as the TPU's sequential
// grid did:
//   1. train_bwd_window_kernel, one block per window: recomputes the forward,
//      then dr, dh1 and dx with the same column scheme (four convs). h1 is
//      kept in a second shared tile (thread-private columns) and r in the
//      conv-input tile once d1 has been consumed, so one register array of
//      T * 4 values per thread is enough. It writes dx, and d1, dr, dh1 for
//      the weight gradients, and per-window partials of dgamma and dbeta
//      (each thread owns its channels for all rows of the window).
//   2. tap_grad_kernel: dw1 and dw2 as ten [C, N] x [N, C] products (N =
//      B * T rows) tiled 64 x 64 over (tap, Cin tile, Cout tile), with the
//      rows split into a fixed number of ranges; each block writes its
//      partial tile. No atomics.
//   3. reduce_partials_kernel: sums the row-range partials of dw1, dw2 and
//      the per-window partials of dgamma, dbeta, each in a fixed order, so
//      two calls on the same inputs give the same bits.
//
// Forward at "default": train_fwd_tc_kernel on the tensor cores (mma.sync
// m16n8k16, bf16 operands, fp32 sums), bound by their bf16 rate: 20.1 G
// multiply-adds at [960, 32, 256] (0.041 ms at the H100 data sheet's 989
// TFLOP/s, 0.035 ms counting only the rows a shifted tap reaches). W = 128 /
// T windows a block (4 at T = 32) run the backward window kernel's first two
// convs below (tc_conv, P = 1, on one rounded bf16 plane): h1 = conv(x, w1);
// d1 = GELU(h1) * mask, rounded into the plane (the mask applied before
// rounding, as the plain version does); r = conv(d1, w2) + x, with x re-read
// in fp32 from device memory; GELU, GroupNorm and the affine element-wise on
// the accumulators staged in shared memory (TcEpi), a window's 2T threads on
// its float4s. The wrapper lays out w1 and w2 once a call as bf16 [2, 5, C,
// C]; each block reads those 1.3 MB once from L2, 0.31 GB a 960-window
// launch (the FMA body read 2.5 GB of fp32 weights, one window a block). It
// writes only out, no atomics: two calls give the same bits. Shared memory
// 199 KB at C = 256, so one block an SM: 240 blocks are 1.8 waves on 132 SMs.
//
// Backward at "default": the same three launches on the tensor cores
// (mma.sync m16n8k16, bf16 operands, fp32 sums), bound by the bf16
// tensor-core rate: 60.4 G multiply-adds at [960, 32, 256] (six conv-sized
// products; 0.12 ms at the H100 data sheet's 989 TFLOP/s, 0.105 ms counting only
// the rows a shifted tap reaches).
//   1. train_bwd_tc_kernel: W = 128 / T windows a block (4 at T = 32), its
//      four convs (h1, r, dd1 through w2t, dx through w1t) through the
//      tensor-core body of conv_tile.cuh (tc_conv, P = 1) on one rounded
//      bf16 plane in shared memory. The wrapper lays out w1, w2, w2t, w1t once
//      a call as bf16 [4, 5, C, C]. Each conv's accumulators go through an
//      fp32 staging area over the weight ring, and the epilogues (GELU and
//      its derivative, GroupNorm and its backward) run element-wise on it,
//      a window's 2T threads on its float4s. GELU'(h1) * mask waits in dx,
//      GELU'(r) and then dr (fp32, which dx reads back) in a scratch tensor,
//      each element written and read by one thread. It writes x, d1, dr and
//      dh1 as bf16 (the weight gradients read only the rounded values) and
//      the dgamma and dbeta partials of each window. Each block reads the
//      four convs' 2.6 MB of bf16 weights once from L2: 0.63 GB a
//      960-window launch (2.5 GB at one window a block). Shared memory 199
//      KB at C = 256 (one plane of 129 rows of C + 8 bf16, a 4-stage ring of
//      64 input channels), so one block an SM.
//   2. tap_grad_tc_kernel: dw[j] = shift_j(a)^T g as ten GEMMs with K = B * T
//      rows, 128 x 128 tiles (64 x 64 at C = 64) over a fixed number of row
//      ranges; rows come by 16-byte cp.async, zero-filled where the shifted
//      row leaves its window, and a^T through ldmatrix.trans. No atomics.
//   3. reduce_partials_kernel, as above.

#include "conv_tile.cuh"

namespace {

constexpr float kInvSqrt2 = 0.70710678118654752440f;
constexpr float kInvSqrt2Pi = 0.39894228040143267794f;

__device__ __forceinline__ float gelu_grad(float u) {
  return 0.5f * (1.0f + erff(u * kInvSqrt2)) + u * expf(-0.5f * u * u) * kInvSqrt2Pi;
}

// Mean and reciprocal standard deviation of the block's T * C values.
template <int T, int C, int kCols>
__device__ __forceinline__ void window_stats(const float (&col)[kCols][T], float* red,
                                             float& mean, float& rstd) {
  constexpr int kWarps = C / kCols / 32;
  constexpr float inv_n = 1.0f / (float)(T * C);
  float sum = 0.0f;
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
#pragma unroll
    for (int t = 0; t < T; ++t) sum += col[c][t];
  }
  mean = block_sum<kWarps>(sum, red) * inv_n;
  float sq = 0.0f;
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
#pragma unroll
    for (int t = 0; t < T; ++t) {
      const float dv = col[c][t] - mean;
      sq += dv * dv;
    }
  }
  rstd = rsqrtf(block_sum<kWarps>(sq, red) * inv_n + 1e-5f);
}

// ---------------------------------------------------------------- forward

// The forward at "highest" (fp32 FMAs).
template <int T, int C>
__global__ void __launch_bounds__(C / Cols<C, false>::value) train_fwd_kernel(
    const float* __restrict__ x, const float* __restrict__ w1, const float* __restrict__ w2,
    const float* __restrict__ gn_scale, const float* __restrict__ gn_bias,
    const float* __restrict__ mask, float* __restrict__ out, int dilation) {
  constexpr int kCols = Cols<C, false>::value;
  constexpr int kThreads = C / kCols;
  extern __shared__ float4 smem[];
  __shared__ float red[kThreads / 32];
  float* tile = reinterpret_cast<float*>(smem);
  const int co = threadIdx.x;
  const size_t win = (size_t)blockIdx.x * T * C;

  float col[kCols][T];
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
#pragma unroll
    for (int t = 0; t < T; ++t) col[c][t] = x[win + t * C + co + c * kThreads];
  }
  store_columns<T, C, false, kCols>(tile, col, co);
  __syncthreads();

  conv_columns<T, C, false, kCols>(tile, w1, co, dilation, col);
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
#pragma unroll
    for (int t = 0; t < T; ++t) {
      float v = gelu(col[c][t]);
      if (mask != nullptr) v *= mask[win + t * C + co + c * kThreads];
      col[c][t] = v;
    }
  }
  __syncthreads();  // every thread has finished reading x's tile
  store_columns<T, C, false, kCols>(tile, col, co);
  __syncthreads();

  conv_columns<T, C, false, kCols>(tile, w2, co, dilation, col);
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
#pragma unroll
    for (int t = 0; t < T; ++t) col[c][t] = gelu(col[c][t] + x[win + t * C + co + c * kThreads]);
  }
  float mean, rstd;
  window_stats<T, C, kCols>(col, red, mean, rstd);
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    const int ch = co + c * kThreads;
    const float g = gn_scale[ch];
    const float bias = gn_bias[ch];
#pragma unroll
    for (int t = 0; t < T; ++t) out[win + t * C + ch] = (col[c][t] - mean) * rstd * g + bias;
  }
}

// The forward at "default" on the tensor cores: W = 128 / T windows a block
// (see the header). w: [2, 5, C, C] bf16, the rounded w1 and w2. Each conv's
// accumulators go through an fp32 staging area over the ring, and the
// epilogues run element-wise on it (TcEpi), as in train_bwd_tc_kernel.
template <int T, int C>
__global__ void __launch_bounds__(TcConv<T, C, 1>::kThreads, 1) train_fwd_tc_kernel(
    const float* __restrict__ x, const __nv_bfloat16* __restrict__ w,
    const float* __restrict__ gn_scale, const float* __restrict__ gn_bias,
    const float* __restrict__ mask, float* __restrict__ out, int batch, int dilation) {
  using L = TcConv<T, C, 1>;
  using E = TcEpi<T, C>;
  static_assert(L::kStageBytes <= (size_t)L::kStages * L::kStageElems * 2, "staging fits the ring");
  constexpr size_t kPlaneW = (size_t)kTaps * C * C;
  constexpr float inv_n = 1.0f / (float)(T * C);
  extern __shared__ float4 smem_tc[];
  __nv_bfloat16* plane = reinterpret_cast<__nv_bfloat16*>(smem_tc);
  __nv_bfloat16* ring = plane + L::kPlaneElems;
  float* red = reinterpret_cast<float*>(ring + L::kStages * L::kStageElems);
  float* ys = reinterpret_cast<float*>(ring);  // between convs
  const int win0 = blockIdx.x * L::kWindows;
  const int valid_rows = min(L::kWindows, batch - win0) * T;
  const size_t base = (size_t)win0 * T * C;
  // the thread's window and its place there (TcEpi)
  const int win = threadIdx.x / E::kGroup, j = threadIdx.x % E::kGroup;
  const bool valid = win0 + win < batch;
  const size_t wbase = base + (size_t)win * T * C;
  float* yw = ys + win * T * L::kLdF;
  __nv_bfloat16* pw = plane + win * T * L::kLd;
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);

  tc_load_input<T, C, 1>(plane, x + base, valid_rows, nullptr);
  __syncthreads();
  float acc[L::kMT][L::kNT][4];

  // h1 = conv(x, w1); d1 = GELU(h1) * mask, rounded into the plane
  tc_conv<T, C, 1>(acc, plane, ring, w, 0, dilation, valid_rows);
  tc_stage_acc<T, C, 1>(ys, acc);
  __syncthreads();
#pragma unroll 4
  for (int k = 0; k < E::kSteps; ++k) {
    const int f = j + E::kGroup * k, r = f / (C / 4), c = (f % (C / 4)) * 4;
    float4 v = *reinterpret_cast<const float4*>(yw + r * L::kLdF + c);
    v = make_float4(gelu(v.x), gelu(v.y), gelu(v.z), gelu(v.w));
    if (mask != nullptr && valid) {
      const float4 m = __ldg(reinterpret_cast<const float4*>(mask + wbase + r * C + c));
      v = make_float4(v.x * m.x, v.y * m.y, v.z * m.z, v.w * m.w);
    }
    *reinterpret_cast<uint2*>(pw + r * L::kLd + c) = pack4_bf16(v);
  }
  __syncthreads();  // d1's plane is whole; nobody reads the staging area any more

  // r = conv(d1, w2) + x; h = GELU(r); the window's mean and rstd
  tc_conv<T, C, 1>(acc, plane, ring, w + kPlaneW, 0, dilation, valid_rows);
  tc_stage_acc<T, C, 1>(ys, acc);
  __syncthreads();
  float sum = 0.0f;
#pragma unroll 4
  for (int k = 0; k < E::kSteps; ++k) {
    const int f = j + E::kGroup * k, r = f / (C / 4), c = (f % (C / 4)) * 4;
    float4 v = *reinterpret_cast<const float4*>(yw + r * L::kLdF + c);
    const float4 xv = valid ? __ldg(reinterpret_cast<const float4*>(x + wbase + r * C + c)) : zero;
    v = make_float4(gelu(v.x + xv.x), gelu(v.y + xv.y), gelu(v.z + xv.z), gelu(v.w + xv.w));
    *reinterpret_cast<float4*>(yw + r * L::kLdF + c) = v;
    sum += v.x + v.y + v.z + v.w;
  }
  const float mean = window_sum<T>(sum, red) * inv_n;
  float sq = 0.0f;
#pragma unroll 4
  for (int k = 0; k < E::kSteps; ++k) {
    const int f = j + E::kGroup * k, r = f / (C / 4), c = (f % (C / 4)) * 4;
    const float4 v = *reinterpret_cast<const float4*>(yw + r * L::kLdF + c);
    const float d0 = v.x - mean, d1 = v.y - mean, d2 = v.z - mean, d3 = v.w - mean;
    sq += d0 * d0 + d1 * d1 + d2 * d2 + d3 * d3;
  }
  const float rstd = rsqrtf(window_sum<T>(sq, red) * inv_n + 1e-5f);
  if (!valid) return;
#pragma unroll 4
  for (int k = 0; k < E::kSteps; ++k) {
    const int f = j + E::kGroup * k, r = f / (C / 4), c = (f % (C / 4)) * 4;
    const float4 v = *reinterpret_cast<const float4*>(yw + r * L::kLdF + c);
    const float4 g = __ldg(reinterpret_cast<const float4*>(gn_scale + c));
    const float4 bias = __ldg(reinterpret_cast<const float4*>(gn_bias + c));
    *reinterpret_cast<float4*>(out + wbase + r * C + c) =
        make_float4((v.x - mean) * rstd * g.x + bias.x, (v.y - mean) * rstd * g.y + bias.y,
                    (v.z - mean) * rstd * g.z + bias.z, (v.w - mean) * rstd * g.w + bias.w);
  }
}

// ---------------------------------------------------------------- backward

// Launch 1 of 3 at "highest": per window, the recomputed forward, then dr, dh1, dx.
// d1_out, dr_out, dh1_out feed the weight-gradient kernel; pgamma, pbeta are
// [B, C] per-window partials.
template <int T, int C>
__global__ void __launch_bounds__(C / Cols<C, false>::value) train_bwd_window_kernel(
    const float* __restrict__ x, const float* __restrict__ w1, const float* __restrict__ w2,
    const float* __restrict__ w1t, const float* __restrict__ w2t,
    const float* __restrict__ gn_scale, const float* __restrict__ dy,
    const float* __restrict__ mask, float* __restrict__ dx, float* __restrict__ d1_out,
    float* dr_out, float* __restrict__ dh1_out, float* __restrict__ pgamma,
    float* __restrict__ pbeta, int dilation) {
  constexpr int kCols = Cols<C, false>::value;
  constexpr int kThreads = C / kCols;
  constexpr int kWarps = kThreads / 32;
  constexpr float inv_n = 1.0f / (float)(T * C);
  extern __shared__ float4 smem[];
  __shared__ float red[kWarps];
  float* tile = reinterpret_cast<float*>(smem);  // the current conv's input; r in between
  float* keep = tile + T * C;                    // h1, thread-private columns
  const int co = threadIdx.x;
  const size_t win = (size_t)blockIdx.x * T * C;

  float col[kCols][T];
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
#pragma unroll
    for (int t = 0; t < T; ++t) col[c][t] = x[win + t * C + co + c * kThreads];
  }
  store_columns<T, C, false, kCols>(tile, col, co);
  __syncthreads();

  // h1 = conv(x, w1); d1 = GELU(h1) * mask
  conv_columns<T, C, false, kCols>(tile, w1, co, dilation, col);
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
#pragma unroll
    for (int t = 0; t < T; ++t) {
      const int at = t * C + co + c * kThreads;
      keep[at] = col[c][t];
      float v = gelu(col[c][t]);
      if (mask != nullptr) v *= mask[win + at];
      col[c][t] = v;
      d1_out[win + at] = v;
    }
  }
  __syncthreads();  // every thread has finished reading x's tile
  store_columns<T, C, false, kCols>(tile, col, co);
  __syncthreads();

  // r = conv(d1, w2) + x, kept in the tile (own columns); h = GELU(r)
  conv_columns<T, C, false, kCols>(tile, w2, co, dilation, col);
  __syncthreads();  // every thread has finished reading d1's tile
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
#pragma unroll
    for (int t = 0; t < T; ++t) {
      const int at = t * C + co + c * kThreads;
      const float r = col[c][t] + x[win + at];
      tile[at] = r;
      col[c][t] = gelu(r);
    }
  }
  float mean, rstd;
  window_stats<T, C, kCols>(col, red, mean, rstd);

  // hn in col; the window's partials of dgamma and dbeta; means of dhn, dhn * hn
  float s1 = 0.0f, s2 = 0.0f;
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    const int ch = co + c * kThreads;
    const float g = gn_scale[ch];
    float pg = 0.0f, pb = 0.0f;
#pragma unroll
    for (int t = 0; t < T; ++t) {
      const float hn = (col[c][t] - mean) * rstd;
      col[c][t] = hn;
      const float dyv = dy[win + t * C + ch];
      pb += dyv;
      pg += dyv * hn;
      s1 += dyv * g;
      s2 += dyv * g * hn;
    }
    pgamma[(size_t)blockIdx.x * C + ch] = pg;
    pbeta[(size_t)blockIdx.x * C + ch] = pb;
  }
  const float m1 = block_sum<kWarps>(s1, red) * inv_n;
  const float m2 = block_sum<kWarps>(s2, red) * inv_n;

  // dr = rstd * (dhn - m1 - hn * m2) * GELU'(r)
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    const int ch = co + c * kThreads;
    const float g = gn_scale[ch];
#pragma unroll
    for (int t = 0; t < T; ++t) {
      const int at = t * C + ch;
      const float v = rstd * (dy[win + at] * g - m1 - col[c][t] * m2) * gelu_grad(tile[at]);
      col[c][t] = v;
      dr_out[win + at] = v;
    }
  }
  // r was read by its owner only, so the tile is free for dr
  store_columns<T, C, false, kCols>(tile, col, co);
  __syncthreads();

  // dd1 = conv(dr, w2t) * mask; dh1 = dd1 * GELU'(h1)
  conv_columns<T, C, false, kCols>(tile, w2t, co, dilation, col);
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
#pragma unroll
    for (int t = 0; t < T; ++t) {
      const int at = t * C + co + c * kThreads;
      float v = col[c][t];
      if (mask != nullptr) v *= mask[win + at];
      v *= gelu_grad(keep[at]);
      col[c][t] = v;
      dh1_out[win + at] = v;
    }
  }
  __syncthreads();  // every thread has finished reading dr's tile
  store_columns<T, C, false, kCols>(tile, col, co);
  __syncthreads();

  // dx = dr + conv(dh1, w1t); dr is read back by the thread that wrote it
  conv_columns<T, C, false, kCols>(tile, w1t, co, dilation, col);
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
#pragma unroll
    for (int t = 0; t < T; ++t) {
      const int at = t * C + co + c * kThreads;
      dx[win + at] = col[c][t] + dr_out[win + at];
    }
  }
}

// Launch 2 of 3 at "highest": partial[p][s][j][ci][co] = sum over the rows n = (b, t) of
// row range s of a_p[b, t + (j-2)d, ci] * g_p[b, t, co], rows outside the
// window reading zero; p = 0: (x, dh1) -> dw1, p = 1: (d1, dr) -> dw2.
// Grid: x = Cin tile * Cout tile, y = p * 5 + j, z = s. 256 threads, each a
// 4 x 4 corner of the 64 x 64 tile; 16 rows per step through shared memory,
// the next step's rows loaded before the current ones are used.
constexpr int kGradTile = 64;
constexpr int kGradRows = 16;

__global__ void __launch_bounds__(256) tap_grad_kernel(
    const float* __restrict__ a0, const float* __restrict__ g0, const float* __restrict__ a1,
    const float* __restrict__ g1, float* __restrict__ partial, int n_rows, int t_len,
    int channels, int dilation, int rows_per_split) {
  __shared__ __align__(16) float as[kGradRows][kGradTile];
  __shared__ __align__(16) float gs[kGradRows][kGradTile];
  const int tiles = channels / kGradTile;
  const int ci0 = (blockIdx.x / tiles) * kGradTile;
  const int co0 = (blockIdx.x % tiles) * kGradTile;
  const int problem = blockIdx.y / kTaps;
  const int j = blockIdx.y % kTaps;
  const float* __restrict__ a = problem ? a1 : a0;
  const float* __restrict__ g = problem ? g1 : g0;
  const int o = (j - kTaps / 2) * dilation;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;  // the thread's 4 x 4 corner
  const int lr = threadIdx.x / 16, lc = (threadIdx.x % 16) * 4;  // the float4 it loads

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[i][k] = 0.0f;
  }

  const int n_begin = blockIdx.z * rows_per_split;
  const int n_end = min(n_rows, n_begin + rows_per_split);
  auto load = [&](int n0, float4& av, float4& gv) {
    av = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    gv = av;
    const int n = n0 + lr;
    if (n < n_end) {
      const int ts = n % t_len + o;
      if (ts >= 0 && ts < t_len) {
        av = __ldg(reinterpret_cast<const float4*>(a + (size_t)(n + o) * channels + ci0 + lc));
        gv = __ldg(reinterpret_cast<const float4*>(g + (size_t)n * channels + co0 + lc));
      }
    }
  };

  if (o < t_len && o > -t_len && n_begin < n_end) {  // else the tap lies outside every window
    float4 av, gv;
    load(n_begin, av, gv);
    for (int n0 = n_begin; n0 < n_end; n0 += kGradRows) {
      __syncthreads();  // the previous step's reads are done
      *reinterpret_cast<float4*>(&as[lr][lc]) = av;
      *reinterpret_cast<float4*>(&gs[lr][lc]) = gv;
      __syncthreads();
      if (n0 + kGradRows < n_end) load(n0 + kGradRows, av, gv);
#pragma unroll
      for (int k = 0; k < kGradRows; ++k) {
        const float4 a4 = *reinterpret_cast<const float4*>(&as[k][ty * 4]);
        const float4 g4 = *reinterpret_cast<const float4*>(&gs[k][tx * 4]);
        const float ar[4] = {a4.x, a4.y, a4.z, a4.w};
        const float gr[4] = {g4.x, g4.y, g4.z, g4.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[i][q] = fmaf(ar[i], gr[q], acc[i][q]);
        }
      }
    }
  }
  const size_t base =
      (((size_t)problem * gridDim.z + blockIdx.z) * kTaps + j) * channels * channels;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    *reinterpret_cast<float4*>(partial + base + (size_t)(ci0 + ty * 4 + i) * channels + co0 +
                               tx * 4) = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  }
}

// Launch 3 of 3, both precisions: fixed-order sums. Blocks below w_blocks:
// one thread per element of dw1 and dw2 adds its row-range partials in order.
// The other blocks: one warp per channel of dgamma and dbeta; lane l adds
// partial rows l, l + 32, ... (n_part of them: windows, or window slabs at
// "default") in order, then the lanes join in a fixed tree.
__global__ void __launch_bounds__(256) reduce_partials_kernel(
    const float* __restrict__ partial, int splits, int n_w, float* __restrict__ dw1,
    float* __restrict__ dw2, const float* __restrict__ pgamma, const float* __restrict__ pbeta,
    int n_part, int channels, float* __restrict__ dgamma, float* __restrict__ dbeta, int w_blocks) {
  if ((int)blockIdx.x < w_blocks) {
    const int idx = blockIdx.x * 256 + threadIdx.x;
    if (idx >= 2 * n_w) return;
    const int p = idx / n_w, e = idx % n_w;
    float s = 0.0f;
    for (int sp = 0; sp < splits; ++sp) s += partial[((size_t)p * splits + sp) * n_w + e];
    (p ? dw2 : dw1)[e] = s;
    return;
  }
  const int warp = (blockIdx.x - w_blocks) * 8 + threadIdx.x / 32;
  if (warp >= 2 * channels) return;  // whole warps leave together
  const int lane = threadIdx.x % 32;
  const int ch = warp % channels;
  const float* __restrict__ src = warp < channels ? pgamma : pbeta;
  float s = 0.0f;
  for (int b = lane; b < n_part; b += 32) s += src[(size_t)b * channels + ch];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) (warp < channels ? dgamma : dbeta)[ch] = s;
}

// ------------------------------------------- backward at "default", tensor cores

// Launch 1 of 3 at "default": W = 128 / T windows a block (see the header).
// w: [4, 5, C, C] bf16, the rounded w1, w2, w2t, w1t. Writes dx; xb, d1b,
// drb, dh1b (bf16) for the weight gradients; dr32 (GELU'(r), then dr in fp32)
// and dx (GELU'(h1) * mask until dx replaces it) as scratch, each element
// written and read back by one thread; pgamma, pbeta [B * kShare, C]: the
// sums over a window's rows of dy * hn and dy, kShare partial rows a window.
// Each conv's accumulators go through an fp32 staging area over the ring, and
// the epilogues run element-wise on it (TcEpi).
template <int T, int C>
__global__ void __launch_bounds__(TcConv<T, C, 1>::kThreads, 1) train_bwd_tc_kernel(
    const float* __restrict__ x, const __nv_bfloat16* __restrict__ w,
    const float* __restrict__ gn_scale, const float* __restrict__ dy,
    const float* __restrict__ mask, float* __restrict__ dx, __nv_bfloat16* __restrict__ xb,
    __nv_bfloat16* __restrict__ d1b, __nv_bfloat16* __restrict__ drb,
    __nv_bfloat16* __restrict__ dh1b, float* __restrict__ dr32, float* __restrict__ pgamma,
    float* __restrict__ pbeta, int batch, int dilation) {
  using L = TcConv<T, C, 1>;
  using E = TcEpi<T, C>;
  static_assert(L::kStageBytes <= (size_t)L::kStages * L::kStageElems * 2, "staging fits the ring");
  constexpr size_t kPlaneW = (size_t)kTaps * C * C;
  constexpr float inv_n = 1.0f / (float)(T * C);
  extern __shared__ float4 smem_tc[];
  __nv_bfloat16* plane = reinterpret_cast<__nv_bfloat16*>(smem_tc);
  __nv_bfloat16* ring = plane + L::kPlaneElems;
  float* red = reinterpret_cast<float*>(ring + L::kStages * L::kStageElems);
  float* ys = reinterpret_cast<float*>(ring);  // between convs
  const int win0 = blockIdx.x * L::kWindows;
  const int valid_rows = min(L::kWindows, batch - win0) * T;
  const size_t base = (size_t)win0 * T * C;
  // the thread's window and its place there (TcEpi)
  const int win = threadIdx.x / E::kGroup, j = threadIdx.x % E::kGroup;
  const bool valid = win0 + win < batch;
  const size_t wbase = base + (size_t)win * T * C;
  float* yw = ys + win * T * L::kLdF;
  __nv_bfloat16* pw = plane + win * T * L::kLd;
  // step k of the thread's walk over its window: column c, the element's
  // offset in device memory, its staged value and its place in the plane
  struct Step {
    int c;
    size_t at;
    float* ya;
    uint2* pa;
  };
  auto step = [&](int k) {
    const int f = j + E::kGroup * k, r = f / (C / 4), c = (f % (C / 4)) * 4;
    return Step{c, wbase + r * C + c, yw + r * L::kLdF + c,
                reinterpret_cast<uint2*>(pw + r * L::kLd + c)};
  };
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);

  tc_load_input<T, C, 1>(plane, x + base, valid_rows, xb + base);
  __syncthreads();
  float acc[L::kMT][L::kNT][4];

  // h1 = conv(x, w1); d1 = GELU(h1) * mask; GELU'(h1) * mask to dx
  tc_conv<T, C, 1>(acc, plane, ring, w, 0, dilation, valid_rows);
  tc_stage_acc<T, C, 1>(ys, acc);
  __syncthreads();
#pragma unroll 2
  for (int k = 0; k < E::kSteps; ++k) {
    const Step st = step(k);
    const float4 h1 = *reinterpret_cast<const float4*>(st.ya);
    float4 m = make_float4(1.0f, 1.0f, 1.0f, 1.0f);
    if (mask != nullptr && valid) m = __ldg(reinterpret_cast<const float4*>(mask + st.at));
    float d[4], g[4];
    const float u[4] = {h1.x, h1.y, h1.z, h1.w}, mm[4] = {m.x, m.y, m.z, m.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float erf_u = erff(u[e] * kInvSqrt2);
      d[e] = 0.5f * u[e] * (1.0f + erf_u) * mm[e];
      g[e] = (0.5f * (1.0f + erf_u) + u[e] * expf(-0.5f * u[e] * u[e]) * kInvSqrt2Pi) * mm[e];
    }
    const uint2 d16 = pack4_bf16(make_float4(d[0], d[1], d[2], d[3]));
    *st.pa = d16;
    if (valid) {
      *reinterpret_cast<float4*>(dx + st.at) = make_float4(g[0], g[1], g[2], g[3]);
      *reinterpret_cast<uint2*>(d1b + st.at) = d16;
    }
  }
  __syncthreads();  // d1's plane is whole; nobody reads the staging area any more

  // r = conv(d1, w2) + x; h = GELU(r), GELU'(r) to dr32; the window's mean and rstd
  tc_conv<T, C, 1>(acc, plane, ring, w + kPlaneW, 0, dilation, valid_rows);
  tc_stage_acc<T, C, 1>(ys, acc);
  __syncthreads();
  float sum = 0.0f;
#pragma unroll 2
  for (int k = 0; k < E::kSteps; ++k) {
    const Step st = step(k);
    const float4 cv = *reinterpret_cast<const float4*>(st.ya);
    const float4 xv = valid ? __ldg(reinterpret_cast<const float4*>(x + st.at)) : zero;
    const float rr[4] = {cv.x + xv.x, cv.y + xv.y, cv.z + xv.z, cv.w + xv.w};
    float hv[4], gg[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float erf_r = erff(rr[e] * kInvSqrt2);
      hv[e] = 0.5f * rr[e] * (1.0f + erf_r);
      gg[e] = 0.5f * (1.0f + erf_r) + rr[e] * expf(-0.5f * rr[e] * rr[e]) * kInvSqrt2Pi;
      sum += hv[e];
    }
    *reinterpret_cast<float4*>(st.ya) = make_float4(hv[0], hv[1], hv[2], hv[3]);
    if (valid) *reinterpret_cast<float4*>(dr32 + st.at) = make_float4(gg[0], gg[1], gg[2], gg[3]);
  }
  const float mean = window_sum<T>(sum, red) * inv_n;
  float sq = 0.0f;
#pragma unroll 4
  for (int k = 0; k < E::kSteps; ++k) {
    const Step st = step(k);
    const float4 v = *reinterpret_cast<const float4*>(st.ya);
    const float d0 = v.x - mean, d1 = v.y - mean, d2 = v.z - mean, d3 = v.w - mean;
    sq += d0 * d0 + d1 * d1 + d2 * d2 + d3 * d3;
  }
  const float rstd = rsqrtf(window_sum<T>(sq, red) * inv_n + 1e-5f);

  // hn in the staging area; the thread's sums of dy * hn and dy for each of
  // its channels, and of dhn and dhn * hn over the window
  float pg[E::kColGroups][4], pb[E::kColGroups][4];
#pragma unroll
  for (int q = 0; q < E::kColGroups; ++q) {
#pragma unroll
    for (int e = 0; e < 4; ++e) pg[q][e] = pb[q][e] = 0.0f;
  }
  float s1 = 0.0f, s2 = 0.0f;
#pragma unroll
  for (int k = 0; k < E::kSteps; ++k) {
    const Step st = step(k);
    const int q = k % E::kColGroups;
    const float4 v = *reinterpret_cast<const float4*>(st.ya);
    const float4 dyv = valid ? __ldg(reinterpret_cast<const float4*>(dy + st.at)) : zero;
    const float4 g = __ldg(reinterpret_cast<const float4*>(gn_scale + st.c));
    const float hn[4] = {(v.x - mean) * rstd, (v.y - mean) * rstd, (v.z - mean) * rstd,
                         (v.w - mean) * rstd};
    const float dd[4] = {dyv.x, dyv.y, dyv.z, dyv.w}, gc[4] = {g.x, g.y, g.z, g.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      pb[q][e] += dd[e];
      pg[q][e] += dd[e] * hn[e];
      s1 += dd[e] * gc[e];
      s2 += dd[e] * gc[e] * hn[e];
    }
    *reinterpret_cast<float4*>(st.ya) = make_float4(hn[0], hn[1], hn[2], hn[3]);
  }
  if (valid) {
    const size_t prow = (size_t)(win0 + win) * E::kShare + (E::kShare > 1 ? j / (C / 4) : 0);
#pragma unroll
    for (int q = 0; q < E::kColGroups; ++q) {
      const int c = ((j + E::kGroup * q) % (C / 4)) * 4;
      *reinterpret_cast<float4*>(pgamma + prow * C + c) = make_float4(pg[q][0], pg[q][1], pg[q][2], pg[q][3]);
      *reinterpret_cast<float4*>(pbeta + prow * C + c) = make_float4(pb[q][0], pb[q][1], pb[q][2], pb[q][3]);
    }
  }
  const float m1 = window_sum<T>(s1, red) * inv_n;
  const float m2 = window_sum<T>(s2, red) * inv_n;

  // dr = rstd * (dhn - m1 - hn * m2) * GELU'(r)
#pragma unroll 4
  for (int k = 0; k < E::kSteps; ++k) {
    const Step st = step(k);
    float4 dr = zero;
    if (valid) {
      const float4 hn = *reinterpret_cast<const float4*>(st.ya);
      const float4 dyv = __ldg(reinterpret_cast<const float4*>(dy + st.at));
      const float4 g = __ldg(reinterpret_cast<const float4*>(gn_scale + st.c));
      const float4 gg = *reinterpret_cast<const float4*>(dr32 + st.at);
      dr = make_float4(rstd * (dyv.x * g.x - m1 - hn.x * m2) * gg.x,
                       rstd * (dyv.y * g.y - m1 - hn.y * m2) * gg.y,
                       rstd * (dyv.z * g.z - m1 - hn.z * m2) * gg.z,
                       rstd * (dyv.w * g.w - m1 - hn.w * m2) * gg.w);
      *reinterpret_cast<float4*>(dr32 + st.at) = dr;
    }
    const uint2 d16 = pack4_bf16(dr);
    *st.pa = d16;
    if (valid) *reinterpret_cast<uint2*>(drb + st.at) = d16;
  }
  __syncthreads();

  // dd1 = conv(dr, w2t); dh1 = dd1 * (GELU'(h1) * mask)
  tc_conv<T, C, 1>(acc, plane, ring, w + 2 * kPlaneW, 0, dilation, valid_rows);
  tc_stage_acc<T, C, 1>(ys, acc);
  __syncthreads();
#pragma unroll 4
  for (int k = 0; k < E::kSteps; ++k) {
    const Step st = step(k);
    float4 dh1 = zero;
    if (valid) {
      const float4 dd1 = *reinterpret_cast<const float4*>(st.ya);
      const float4 g = *reinterpret_cast<const float4*>(dx + st.at);
      dh1 = make_float4(dd1.x * g.x, dd1.y * g.y, dd1.z * g.z, dd1.w * g.w);
    }
    const uint2 d16 = pack4_bf16(dh1);
    *st.pa = d16;
    if (valid) *reinterpret_cast<uint2*>(dh1b + st.at) = d16;
  }
  __syncthreads();

  // dx = dr + conv(dh1, w1t); dr is read back by the thread that wrote it
  tc_conv<T, C, 1>(acc, plane, ring, w + 3 * kPlaneW, 0, dilation, valid_rows);
  tc_stage_acc<T, C, 1>(ys, acc);
  __syncthreads();
  if (!valid) return;
#pragma unroll 4
  for (int k = 0; k < E::kSteps; ++k) {
    const Step st = step(k);
    const float4 v = *reinterpret_cast<const float4*>(st.ya);
    const float4 dr = *reinterpret_cast<const float4*>(dr32 + st.at);
    *reinterpret_cast<float4*>(dx + st.at) = make_float4(v.x + dr.x, v.y + dr.y, v.z + dr.z, v.w + dr.w);
  }
}

// Launch 2 of 3 at "default": partial[p][s][j][ci][co] = sum over the rows n
// of row range s of a_p[n + (j-2)d, ci] * g_p[n, co] (zero where the shifted
// row leaves its window); p = 0: (x, dh1) -> dw1, p = 1: (d1, dr) -> dw2, all
// bf16. Grid: x = Cin tile * Cout tile, y = p * 5 + j, z = s. 8 warps, 2 x 4
// over the [kTile, kTile] tile (4 warps of 64 x 64 were 25% slower on an
// H100); kRows rows a stage through a kStages ring, the next kStages - 1
// stages in flight.
template <int C>
struct GradTc {
  static constexpr int kTile = C >= 128 ? 128 : 64;
  static constexpr int kWM = 2, kWN = 4;             // warps over Cin, Cout
  static constexpr int kThreads = 32 * kWM * kWN;
  static constexpr int kWarpM = kTile / kWM, kWarpN = kTile / kWN;
  static constexpr int kMT = kWarpM / 16, kNT = kWarpN / 8;
  static constexpr int kRows = 64;   // 32 rows a stage in 6 stages were 10% slower on an H100
  static constexpr int kLd = kTile + 8;
  static constexpr int kStages = 3;   // 104 KB at kTile = 128: two blocks an SM
  static constexpr int kStageElems = 2 * kRows * kLd;  // a, then g
  static constexpr size_t kSmem = (size_t)kStages * kStageElems * 2;
};

template <int C>
__device__ __forceinline__ void grad_load_stage(__nv_bfloat16* dst, const __nv_bfloat16* __restrict__ a,
                                                const __nv_bfloat16* __restrict__ g, int n0,
                                                int n_end, int t_len, int o, int ci0, int co0) {
  using G = GradTc<C>;
  constexpr int kPieces = G::kRows * G::kTile / 8;  // 16-byte pieces of a (and of g)
#pragma unroll
  for (int i = threadIdx.x; i < 2 * kPieces; i += G::kThreads) {
    const int which = i / kPieces, e = i % kPieces;
    const int r = e / (G::kTile / 8), c = (e % (G::kTile / 8)) * 8;
    const int n = n0 + r;
    bool ok = n < n_end;
    const __nv_bfloat16* src;
    if (which == 0) {
      const int ts = n % t_len + o;
      ok = ok && ts >= 0 && ts < t_len;
      src = a + (size_t)(n + o) * C + ci0 + c;
    } else {
      src = g + (size_t)n * C + co0 + c;
    }
    cp_async16_zfill(smem_u32(dst + (which * G::kRows + r) * G::kLd + c), ok ? src : a, ok);
  }
}

template <int C>
__global__ void __launch_bounds__(GradTc<C>::kThreads, 2) tap_grad_tc_kernel(
    const __nv_bfloat16* __restrict__ a0, const __nv_bfloat16* __restrict__ g0,
    const __nv_bfloat16* __restrict__ a1, const __nv_bfloat16* __restrict__ g1,
    float* __restrict__ partial, int n_rows, int t_len, int dilation, int rows_per_split) {
  using G = GradTc<C>;
  extern __shared__ float4 smem_tc[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem_tc);
  constexpr int kTiles = C / G::kTile;
  const int ci0 = (blockIdx.x / kTiles) * G::kTile;
  const int co0 = (blockIdx.x % kTiles) * G::kTile;
  const int problem = blockIdx.y / kTaps;
  const int j = blockIdx.y % kTaps;
  const __nv_bfloat16* __restrict__ a = problem ? a1 : a0;
  const __nv_bfloat16* __restrict__ g = problem ? g1 : g0;
  const int o = (j - kTaps / 2) * dilation;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp / G::kWN, wn = warp % G::kWN;

  float acc[G::kMT][G::kNT][4];
#pragma unroll
  for (int mt = 0; mt < G::kMT; ++mt) {
#pragma unroll
    for (int nt = 0; nt < G::kNT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.0f;
    }
  }
  const int n_begin = blockIdx.z * rows_per_split;
  const int n_end = min(n_rows, n_begin + rows_per_split);
  if (o < t_len && o > -t_len && n_begin < n_end) {  // else the tap lies outside every window
    const int steps = (n_end - n_begin + G::kRows - 1) / G::kRows;
    // a^T (A) through ldmatrix.trans: the lane's row n and column ci; g (B): row n, column co
    const uint32_t a_lane = smem_u32(ring) +
        (((lane & 7) + (lane >> 4) * 8) * G::kLd + wm * G::kWarpM + ((lane >> 3) & 1) * 8) * 2;
    const uint32_t g_lane = smem_u32(ring) +
        ((G::kRows + (lane & 15)) * G::kLd + wn * G::kWarpN + (lane >> 4) * 8) * 2;
#pragma unroll
    for (int s = 0; s < G::kStages - 1; ++s) {
      if (s < steps)
        grad_load_stage<C>(ring + s * G::kStageElems, a, g, n_begin + s * G::kRows, n_end, t_len, o,
                           ci0, co0);
      cp_async_commit();
    }
    int stage = 0;
    for (int s = 0; s < steps; ++s) {
      cp_async_wait<G::kStages - 2>();
      __syncthreads();
      {
        const int sn = s + G::kStages - 1;
        if (sn < steps) {
          const int slot = stage == 0 ? G::kStages - 1 : stage - 1;
          grad_load_stage<C>(ring + slot * G::kStageElems, a, g, n_begin + sn * G::kRows, n_end,
                             t_len, o, ci0, co0);
        }
        cp_async_commit();
      }
      const uint32_t off = stage * G::kStageElems * 2;
#pragma unroll
      for (int ks = 0; ks < G::kRows / 16; ++ks) {
        uint32_t af[G::kMT][4];
#pragma unroll
        for (int mt = 0; mt < G::kMT; ++mt)
          ldsm_x4_trans(af[mt], a_lane + off + (ks * 16 * G::kLd + mt * 16) * 2);
#pragma unroll
        for (int np = 0; np < G::kNT / 2; ++np) {
          uint32_t b[4];
          ldsm_x4_trans(b, g_lane + off + (ks * 16 * G::kLd + np * 16) * 2);
#pragma unroll
          for (int mt = 0; mt < G::kMT; ++mt) {
            mma_bf16(acc[mt][2 * np], af[mt], b[0], b[1]);
            mma_bf16(acc[mt][2 * np + 1], af[mt], b[2], b[3]);
          }
        }
      }
      stage = stage + 1 == G::kStages ? 0 : stage + 1;
    }
    cp_async_wait<0>();
  }
  const size_t base = (((size_t)problem * gridDim.z + blockIdx.z) * kTaps + j) * C * C;
#pragma unroll
  for (int mt = 0; mt < G::kMT; ++mt) {
#pragma unroll
    for (int nt = 0; nt < G::kNT; ++nt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int ci = ci0 + wm * G::kWarpM + mt * 16 + h * 8 + (lane >> 2);
        const int co = co0 + wn * G::kWarpN + nt * 8 + 2 * (lane & 3);
        *reinterpret_cast<float2*>(partial + base + (size_t)ci * C + co) =
            make_float2(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------- launches

struct FwdArgs {
  const float *x, *w1, *w2, *gs, *gb, *mask;
  float* out;
  int batch, dilation;
  cudaStream_t stream;
};

struct BwdArgs {
  const float *x, *w1, *w2, *w1t, *w2t, *gs, *dy, *mask;
  float *dx, *d1, *dr, *dh1, *pgamma, *pbeta;
  int batch, dilation;
  cudaStream_t stream;
};

template <int T, int C>
cudaError_t launch_fwd(const FwdArgs& a) {
  constexpr size_t smem = (size_t)T * C * 4;
  cudaError_t err = cudaFuncSetAttribute(train_fwd_kernel<T, C>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  train_fwd_kernel<T, C><<<a.batch, C / Cols<C, false>::value, smem, a.stream>>>(
      a.x, a.w1, a.w2, a.gs, a.gb, a.mask, a.out, a.dilation);
  return cudaGetLastError();
}

template <int T, int C>
cudaError_t launch_fwd_tc(const float* x, const __nv_bfloat16* w, const float* gs, const float* gb,
                          const float* mask, float* out, int batch, int dilation,
                          int windows_per_block, int smem_bytes, cudaStream_t stream) {
  using L = TcConv<T, C, 1>;
  // the caller's plan (ops/conv_kernel.py::tc_plan) must be this instantiation's
  if (windows_per_block != L::kWindows || smem_bytes != (int)L::kSmem) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(train_fwd_tc_kernel<T, C>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::kSmem);
  if (err != cudaSuccess) return err;
  const int blocks = (batch + L::kWindows - 1) / L::kWindows;
  train_fwd_tc_kernel<T, C><<<blocks, L::kThreads, L::kSmem, stream>>>(x, w, gs, gb, mask, out,
                                                                      batch, dilation);
  return cudaGetLastError();
}

template <int T, int C>
cudaError_t launch_bwd(const BwdArgs& a) {
  constexpr size_t smem = (size_t)T * C * 4 * 2;
  cudaError_t err = cudaFuncSetAttribute(train_bwd_window_kernel<T, C>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  train_bwd_window_kernel<T, C><<<a.batch, C / Cols<C, false>::value, smem, a.stream>>>(
      a.x, a.w1, a.w2, a.w1t, a.w2t, a.gs, a.dy, a.mask, a.dx, a.d1, a.dr, a.dh1, a.pgamma,
      a.pbeta, a.dilation);
  return cudaGetLastError();
}

struct BwdTcArgs {
  const float* x;
  const __nv_bfloat16* w;
  const float *gs, *dy, *mask;
  float* dx;
  __nv_bfloat16 *xb, *d1, *dr, *dh1;
  float *dr32, *pgamma, *pbeta, *partial, *dw1, *dw2, *dgamma, *dbeta;
  int batch, dilation, windows_per_block, smem_bytes, slabs, splits, grad_smem_bytes;
  cudaStream_t stream;
};

// The three launches of the backward at "default" (see the header).
template <int T, int C>
cudaError_t launch_bwd_tc(const BwdTcArgs& a) {
  using L = TcConv<T, C, 1>;
  using G = GradTc<C>;
  constexpr size_t kSmem = L::kSmem;
  constexpr int kSlabs = TcEpi<T, C>::kShare;
  // the caller's plan (ops/conv_kernel.py::tc_plan) must be this instantiation's
  if (a.windows_per_block != L::kWindows || a.smem_bytes != (int)kSmem || a.slabs != kSlabs ||
      a.grad_smem_bytes != (int)G::kSmem || a.splits < 1)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(train_bwd_tc_kernel<T, C>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
  if (err != cudaSuccess) return err;
  const int blocks = (a.batch + L::kWindows - 1) / L::kWindows;
  train_bwd_tc_kernel<T, C><<<blocks, L::kThreads, kSmem, a.stream>>>(
      a.x, a.w, a.gs, a.dy, a.mask, a.dx, a.xb, a.d1, a.dr, a.dh1, a.dr32, a.pgamma, a.pbeta,
      a.batch, a.dilation);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const int n_rows = a.batch * T;
  int rows_per_split = (n_rows + a.splits - 1) / a.splits;
  rows_per_split = (rows_per_split + G::kRows - 1) / G::kRows * G::kRows;
  err = cudaFuncSetAttribute(tap_grad_tc_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)G::kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((C / G::kTile) * (C / G::kTile), 2 * kTaps, a.splits);
  tap_grad_tc_kernel<C><<<grid, G::kThreads, G::kSmem, a.stream>>>(a.xb, a.dh1, a.d1, a.dr, a.partial,
                                                            n_rows, T, a.dilation, rows_per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const int n_w = kTaps * C * C;
  const int w_blocks = (2 * n_w + 255) / 256;
  const int c_blocks = (2 * C + 7) / 8;
  reduce_partials_kernel<<<w_blocks + c_blocks, 256, 0, a.stream>>>(
      a.partial, a.splits, n_w, a.dw1, a.dw2, a.pgamma, a.pbeta, a.batch * kSlabs, C, a.dgamma,
      a.dbeta, w_blocks);
  return cudaGetLastError();
}

}  // namespace

// The forward at "highest": w1, w2 [5, C, C] fp32. Supported: t_len in {8,
// 16, 32}, channels in {64, 128, 256}. mask may be null.
extern "C" int vge_temporal_block_train_fwd(int device, const float* x, const float* w1,
                                            const float* w2, const float* gs, const float* gb,
                                            const float* mask, float* out, int batch, int t_len,
                                            int channels, int dilation, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (batch == 0) return (int)cudaSuccess;
  const FwdArgs a{x, w1, w2, gs, gb, mask, out, batch, dilation, stream};
  return (int)with_shape(t_len, channels, [&](auto t, auto c) {
    return launch_fwd<decltype(t)::value, decltype(c)::value>(a);
  });
}

// The forward at "default" on the tensor cores: w [2, 5, C, C] bf16 (w1, w2,
// rounded). mask may be null. windows_per_block and smem_bytes: the wrapper's
// plan, which must match the instantiation's (else cudaErrorInvalidValue).
extern "C" int vge_temporal_block_train_fwd_tc(int device, const float* x, const void* w,
                                               const float* gs, const float* gb, const float* mask,
                                               float* out, int batch, int t_len, int channels,
                                               int dilation, int windows_per_block, int smem_bytes,
                                               cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (batch == 0) return (int)cudaErrorInvalidValue;
  const auto* wb = static_cast<const __nv_bfloat16*>(w);
  return (int)with_shape(t_len, channels, [&](auto t, auto c) {
    return launch_fwd_tc<decltype(t)::value, decltype(c)::value>(
        x, wb, gs, gb, mask, out, batch, dilation, windows_per_block, smem_bytes, stream);
  });
}

// The three launches of one stage backward at "highest". w1t, w2t: the
// weights tap-reversed with Cin and Cout swapped. Scratch, allocated by the
// caller: d1, dr, dh1 [B, T, C]; pgamma, pbeta [B, C]; partial [2, splits, 5,
// C, C].
extern "C" int vge_temporal_block_train_bwd(
    int device, const float* x, const float* w1, const float* w2, const float* w1t,
    const float* w2t, const float* gs, const float* dy, const float* mask, float* dx, float* d1,
    float* dr, float* dh1, float* pgamma, float* pbeta, float* partial, float* dw1, float* dw2,
    float* dgamma, float* dbeta, int batch, int t_len, int channels, int dilation, int splits,
    cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (batch == 0 || splits < 1) return (int)cudaErrorInvalidValue;
  const BwdArgs a{x, w1, w2, w1t, w2t, gs, dy, mask, dx, d1, dr, dh1, pgamma, pbeta,
                  batch, dilation, stream};
  err = with_shape(t_len, channels, [&](auto t, auto c) {
    return launch_bwd<decltype(t)::value, decltype(c)::value>(a);
  });
  if (err != cudaSuccess) return (int)err;

  const int n_rows = batch * t_len;
  int rows_per_split = (n_rows + splits - 1) / splits;
  rows_per_split = (rows_per_split + kGradRows - 1) / kGradRows * kGradRows;
  const int tiles = channels / kGradTile;
  const dim3 grid(tiles * tiles, 2 * kTaps, splits);
  tap_grad_kernel<<<grid, 256, 0, stream>>>(x, dh1, d1, dr, partial, n_rows, t_len, channels,
                                            dilation, rows_per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const int n_w = kTaps * channels * channels;
  const int w_blocks = (2 * n_w + 255) / 256;
  const int c_blocks = (2 * channels + 7) / 8;
  reduce_partials_kernel<<<w_blocks + c_blocks, 256, 0, stream>>>(
      partial, splits, n_w, dw1, dw2, pgamma, pbeta, batch, channels, dgamma, dbeta, w_blocks);
  return (int)cudaGetLastError();
}

// The three launches of one stage backward at "default", on the tensor
// cores. w: [4, 5, C, C] bf16 (w1, w2, w2t, w1t, rounded). Scratch, allocated
// by the caller: xb, d1, dr, dh1 [B, T, C] bf16; dr32 [B, T, C] fp32; pgamma,
// pbeta [B * slabs, C]; partial [2, splits, 5, C, C]. windows_per_block,
// smem_bytes, slabs, grad_smem_bytes: the wrapper's plan, which must match
// the instantiation's (else cudaErrorInvalidValue).
extern "C" int vge_temporal_block_train_bwd_tc(
    int device, const float* x, const void* w, const float* gs, const float* dy,
    const float* mask, float* dx, void* xb, void* d1, void* dr, void* dh1, float* dr32,
    float* pgamma, float* pbeta, float* partial, float* dw1, float* dw2, float* dgamma,
    float* dbeta, int batch, int t_len, int channels, int dilation, int windows_per_block,
    int smem_bytes, int slabs, int splits, int grad_smem_bytes, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (batch == 0) return (int)cudaErrorInvalidValue;
  using B16 = __nv_bfloat16;
  const BwdTcArgs a{x, static_cast<const B16*>(w), gs, dy, mask, dx, static_cast<B16*>(xb),
                    static_cast<B16*>(d1), static_cast<B16*>(dr), static_cast<B16*>(dh1), dr32,
                    pgamma, pbeta, partial, dw1, dw2, dgamma, dbeta, batch, dilation,
                    windows_per_block, smem_bytes, slabs, splits, grad_smem_bytes, stream};
  return (int)with_shape(t_len, channels, [&](auto t, auto c) {
    return launch_bwd_tc<decltype(t)::value, decltype(c)::value>(a);
  });
}
