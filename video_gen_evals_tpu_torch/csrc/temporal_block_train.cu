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
//              pass with fp32 accumulation. The wrapper rounds the weights
//              once per call; the kernels round each conv's input tile as it
//              goes to shared memory and, in the weight-gradient kernel, both
//              operands as they are loaded. Products of bf16 values are exact
//              in fp32, so CUDA-core FMAs give that class of result.
//
// Bound on the H100: the fp32 FMA rate. Forward: 2 convs * 5 taps * T * C * C =
// 21 M FMAs per window (20.1 G at 960 windows). Backward: six conv-sized
// products (two recomputed, dd1, dx, dw1, dw2), 60.4 G at 960 windows.
//
// Design. The forward is the scoring kernel's (temporal_block.cu): one block
// per window, each thread keeps 4 output channels for all T rows in
// registers, the conv input sits in a shared tile. The backward is three
// launches, because Hopper's blocks run in no order and nothing carries a
// sum from one block to the next, as the TPU's sequential grid did:
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
// Tensor cores (wgmma) and TMA are left to a later change.

#include "conv_tile.cuh"

namespace {

constexpr float kInvSqrt2 = 0.70710678118654752440f;
constexpr float kInvSqrt2Pi = 0.39894228040143267794f;

__device__ __forceinline__ float gelu_grad(float u) {
  return 0.5f * (1.0f + erff(u * kInvSqrt2)) + u * expf(-0.5f * u * u) * kInvSqrt2Pi;
}

// The thread's columns of a [T, C] conv input into the shared tile, rounded
// to bf16 values (held in fp32) at "default".
template <int T, int C, bool kRound, int kCols>
__device__ __forceinline__ void store_tile(float* tile, const float (&col)[kCols][T], int co) {
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    const int ch = co + c * (C / kCols);
#pragma unroll
    for (int t = 0; t < T; ++t) tile[t * C + ch] = kRound ? bf16_round(col[c][t]) : col[c][t];
  }
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

template <int T, int C, bool kRound>
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
  store_tile<T, C, kRound, kCols>(tile, col, co);
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
  store_tile<T, C, kRound, kCols>(tile, col, co);
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

// ---------------------------------------------------------------- backward

// Launch 1 of 3: per window, the recomputed forward, then dr, dh1, dx.
// d1_out, dr_out, dh1_out feed the weight-gradient kernel; pgamma, pbeta are
// [B, C] per-window partials.
template <int T, int C, bool kRound>
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
  store_tile<T, C, kRound, kCols>(tile, col, co);
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
  store_tile<T, C, kRound, kCols>(tile, col, co);
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
  store_tile<T, C, kRound, kCols>(tile, col, co);
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
  store_tile<T, C, kRound, kCols>(tile, col, co);
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

// Launch 2 of 3: partial[p][s][j][ci][co] = sum over the rows n = (b, t) of
// row range s of a_p[b, t + (j-2)d, ci] * g_p[b, t, co], rows outside the
// window reading zero; p = 0: (x, dh1) -> dw1, p = 1: (d1, dr) -> dw2.
// Grid: x = Cin tile * Cout tile, y = p * 5 + j, z = s. 256 threads, each a
// 4 x 4 corner of the 64 x 64 tile; 16 rows per step through shared memory,
// the next step's rows loaded before the current ones are used.
constexpr int kGradTile = 64;
constexpr int kGradRows = 16;

template <bool kRound>
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
        if (kRound) {
          av = make_float4(bf16_round(av.x), bf16_round(av.y), bf16_round(av.z), bf16_round(av.w));
          gv = make_float4(bf16_round(gv.x), bf16_round(gv.y), bf16_round(gv.z), bf16_round(gv.w));
        }
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

// Launch 3 of 3: fixed-order sums. Blocks below w_blocks: one thread per
// element of dw1 and dw2 adds its row-range partials in order. The other
// blocks: one warp per channel of dgamma and dbeta; lane l adds windows l,
// l + 32, ... in order, then the lanes join in a fixed tree.
__global__ void __launch_bounds__(256) reduce_partials_kernel(
    const float* __restrict__ partial, int splits, int n_w, float* __restrict__ dw1,
    float* __restrict__ dw2, const float* __restrict__ pgamma, const float* __restrict__ pbeta,
    int batch, int channels, float* __restrict__ dgamma, float* __restrict__ dbeta, int w_blocks) {
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
  for (int b = lane; b < batch; b += 32) s += src[(size_t)b * channels + ch];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) (warp < channels ? dgamma : dbeta)[ch] = s;
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

template <int T, int C, bool kRound>
cudaError_t launch(const FwdArgs& a) {
  constexpr size_t smem = (size_t)T * C * 4;
  cudaError_t err = cudaFuncSetAttribute(train_fwd_kernel<T, C, kRound>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  train_fwd_kernel<T, C, kRound><<<a.batch, C / Cols<C, false>::value, smem, a.stream>>>(
      a.x, a.w1, a.w2, a.gs, a.gb, a.mask, a.out, a.dilation);
  return cudaGetLastError();
}

template <int T, int C, bool kRound>
cudaError_t launch(const BwdArgs& a) {
  constexpr size_t smem = (size_t)T * C * 4 * 2;
  cudaError_t err = cudaFuncSetAttribute(train_bwd_window_kernel<T, C, kRound>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  train_bwd_window_kernel<T, C, kRound><<<a.batch, C / Cols<C, false>::value, smem, a.stream>>>(
      a.x, a.w1, a.w2, a.w1t, a.w2t, a.gs, a.dy, a.mask, a.dx, a.d1, a.dr, a.dh1, a.pgamma,
      a.pbeta, a.dilation);
  return cudaGetLastError();
}

template <int T, bool kRound, typename Args>
cudaError_t dispatch_c(int channels, const Args& a) {
  switch (channels) {
    case 64:
      return launch<T, 64, kRound>(a);
    case 128:
      return launch<T, 128, kRound>(a);
    case 256:
      return launch<T, 256, kRound>(a);
    default:
      return cudaErrorInvalidValue;
  }
}

template <bool kRound, typename Args>
cudaError_t dispatch(int t_len, int channels, const Args& a) {
  switch (t_len) {
    case 8:
      return dispatch_c<8, kRound>(channels, a);
    case 16:
      return dispatch_c<16, kRound>(channels, a);
    case 32:
      return dispatch_c<32, kRound>(channels, a);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Supported: t_len in {8, 16, 32}, channels in {64, 128, 256}. mask may be
// null. With round_bf16 the caller passes weights already rounded to bf16
// values (held in fp32).
extern "C" int vge_temporal_block_train_fwd(int device, const float* x, const float* w1,
                                            const float* w2, const float* gs, const float* gb,
                                            const float* mask, float* out, int batch, int t_len,
                                            int channels, int dilation, int round_bf16,
                                            cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (batch == 0) return (int)cudaSuccess;
  const FwdArgs a{x, w1, w2, gs, gb, mask, out, batch, dilation, stream};
  err = round_bf16 ? dispatch<true>(t_len, channels, a) : dispatch<false>(t_len, channels, a);
  return (int)err;
}

// The three launches of one stage backward. w1t, w2t: the weights
// tap-reversed with Cin and Cout swapped. Scratch, allocated by the caller:
// d1, dr, dh1 [B, T, C]; pgamma, pbeta [B, C]; partial [2, splits, 5, C, C].
extern "C" int vge_temporal_block_train_bwd(
    int device, const float* x, const float* w1, const float* w2, const float* w1t,
    const float* w2t, const float* gs, const float* dy, const float* mask, float* dx, float* d1,
    float* dr, float* dh1, float* pgamma, float* pbeta, float* partial, float* dw1, float* dw2,
    float* dgamma, float* dbeta, int batch, int t_len, int channels, int dilation,
    int round_bf16, int splits, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (batch == 0 || splits < 1) return (int)cudaErrorInvalidValue;
  const BwdArgs a{x, w1, w2, w1t, w2t, gs, dy, mask, dx, d1, dr, dh1, pgamma, pbeta,
                  batch, dilation, stream};
  err = round_bf16 ? dispatch<true>(t_len, channels, a) : dispatch<false>(t_len, channels, a);
  if (err != cudaSuccess) return (int)err;

  const int n_rows = batch * t_len;
  int rows_per_split = (n_rows + splits - 1) / splits;
  rows_per_split = (rows_per_split + kGradRows - 1) / kGradRows * kGradRows;
  const int tiles = channels / kGradTile;
  const dim3 grid(tiles * tiles, 2 * kTaps, splits);
  if (round_bf16) {
    tap_grad_kernel<true><<<grid, 256, 0, stream>>>(x, dh1, d1, dr, partial, n_rows, t_len,
                                                    channels, dilation, rows_per_split);
  } else {
    tap_grad_kernel<false><<<grid, 256, 0, stream>>>(x, dh1, d1, dr, partial, n_rows, t_len,
                                                     channels, dilation, rows_per_split);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const int n_w = kTaps * channels * channels;
  const int w_blocks = (2 * n_w + 255) / 256;
  const int c_blocks = (2 * channels + 7) / 8;
  reduce_partials_kernel<<<w_blocks + c_blocks, 256, 0, stream>>>(
      partial, splits, n_w, dw1, dw2, pgamma, pbeta, batch, channels, dgamma, dbeta, w_blocks);
  return (int)cudaGetLastError();
}
