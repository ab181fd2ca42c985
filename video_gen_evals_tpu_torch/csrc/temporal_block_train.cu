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
// at 960 windows, 17.3 G counting only the rows a shifted tap reaches: 0.52
// ms at the H100 data sheet's 67 TFLOP/s, the mean over d = 1/2/4/8).
// Backward: six conv-sized products (two recomputed, dd1, dx, dw1, dw2),
// 60.4 G at 960 windows.
//
// Forward at "highest": fma_block_kernel of conv_tile.cuh, the stage forward
// K3 runs at "highest", here with the dropout mask. W = 128 / T windows a
// block (4 at T = 32) on the FMA body (fma_conv: x row-major in a shared tile
// of 129 rows of C + 1 floats, fp32 weights through a 4-stage cp.async ring,
// an 8 x 16 register tile a thread at C = 256): conv1 staged in the tile and
// d1 = GELU(h1) * mask written there in place (the mask applied before conv2,
// as train_bwd_fma_kernel's first epilogue does); conv2 staged, the residual
// x re-read from device memory, GELU, the window's mean and variance
// (window_sum, a fixed order) and the affine on the tile. Each block reads
// the two convs' 2.6 MB of fp32 weights once from L2: 0.63 GB a 960-window
// launch (2.5 GB at one window a block, the CUDA-core body it replaces). It
// writes only out, no atomics: two calls give the same bits. Shared memory
// 194 KB at C = 256, one block an SM: 240 blocks are 1.8 waves on 132 SMs.
//
// Backward at "highest": three launches, because Hopper's blocks run in no
// order and nothing carries a sum from one block to the next, as the TPU's
// sequential grid did. 60.4 G FMAs at [960, 32, 256], 58.1 G counting only
// the rows a shifted tap reaches (1.73 ms at d = 1 at the H100 data sheet's
// 67 TFLOP/s):
//   1. train_bwd_fma_kernel: W = 128 / T windows a block (4 at T = 32), its
//      four convs (h1 and r recomputed, dd1 through w2t, dx through w1t) on
//      the FMA body of conv_tile.cuh (fma_conv: the conv input in shared
//      memory, fp32 weights through a cp.async ring, an 8 x 16 register tile
//      a thread at C = 256). Each conv's accumulators are staged in the
//      tile and the epilogues (GELU and its derivative, GroupNorm and its
//      backward) run there element-wise (fma_epilogue), a window's 2T
//      threads on whole columns of it, a window's sums by window_sum in a
//      fixed order; the next conv's input is written in place. GELU'(h1) *
//      mask waits in dx, GELU'(r) and then dr in dr. It writes d1, dr and
//      dh1 in fp32 (the weight gradients read unrounded values), dx, and one
//      partial row of dgamma and dbeta a window (each thread sums its own
//      columns over the window's rows). Each block reads the four convs' 5.2
//      MB of fp32 weights once from L2: 1.26 GB a 960-window launch (5 GB at
//      one window a block). Shared memory 194 KB at C = 256, one block an
//      SM: 240 blocks are 1.8 waves.
//   2. tap_grad_fma_kernel: dw1 and dw2 as ten [C, N] x [N, C] fp32 products
//      over (tap, Cin tile, Cout tile) tiles of 128 x 128 (64 x 64 at C =
//      64), an 8 x 8 register tile a thread; the rows come through a cp.async
//      ring, only those whose shifted row stays inside its window (B * (T -
//      |o|) of them), split into a fixed number of ranges; each block writes
//      its partial tile. No atomics.
//   3. reduce_partials_kernel: sums the row-range partials of dw1, dw2 and
//      the partial rows of dgamma, dbeta, each in a fixed order, so two calls
//      on the same inputs give the same bits.
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

// ---------------------------------------------------------------- forward

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

// Launch 1 of 3 at "highest": W = 128 / T windows a block on the FMA body
// (see the header). Writes dx; d1, dr and dh1 in fp32 for the weight
// gradients (dr: GELU'(r) until dr replaces it; dx: GELU'(h1) * mask until dx
// replaces it); pgamma, pbeta [B, C]: the sums of dy * hn and dy over each
// window's rows. Each conv's accumulators are staged in the tile and the
// epilogues run there (fma_epilogue), a window's 2T threads on whole columns.
template <int T, int C>
__global__ void __launch_bounds__(FmaConv<T, C>::kThreads, 1) train_bwd_fma_kernel(
    const float* __restrict__ x, const float* __restrict__ w1, const float* __restrict__ w2,
    const float* __restrict__ w1t, const float* __restrict__ w2t,
    const float* __restrict__ gn_scale, const float* __restrict__ dy,
    const float* __restrict__ mask, float* __restrict__ dx, float* __restrict__ d1_out,
    float* __restrict__ dr_out, float* __restrict__ dh1_out, float* __restrict__ pgamma,
    float* __restrict__ pbeta, int batch, int dilation) {
  using L = FmaConv<T, C>;
  constexpr float inv_n = 1.0f / (float)(T * C);
  constexpr int kColsPer = C / (2 * T);   // columns a thread owns in the epilogues
  extern __shared__ float4 smem_f[];
  float* in = reinterpret_cast<float*>(smem_f);
  float* ring = in + L::kTileFloats;
  float* red = ring + L::kStages * L::kStageFloats;
  const int win0 = blockIdx.x * L::kWindows;
  const int valid_rows = min(L::kWindows, batch - win0) * T;
  const size_t base = (size_t)win0 * T * C;
  // the thread's window in the epilogues is inside the batch
  const int win = threadIdx.x / (2 * T);
  const bool valid = win0 + win < batch;
  auto g = [&](int r, int c) { return base + (size_t)r * C + c; };   // device offset of tile (r, c)
  auto t = [](int r, int c) { return r * L::kLd + c; };                // tile offset

  fma_load_input<T, C>(in, x + base, valid_rows);
  __syncthreads();
  float acc[L::kRM][L::kCols];

  // h1 = conv(x, w1); d1 = GELU(h1) * mask to d1_out and the tile; GELU'(h1) * mask to dx
  fma_conv<T, C>(acc, in, ring, w1, dilation, valid_rows);
  fma_store_input<T, C>(in, acc);
  __syncthreads();
  fma_epilogue<T, C>([&](int r, int c, int) {
    if (!valid) return;
    const float u = in[t(r, c)];
    const float m = mask != nullptr ? __ldg(mask + g(r, c)) : 1.0f;
    const float erf_u = erff(u * kInvSqrt2);
    const float d = 0.5f * u * (1.0f + erf_u) * m;
    in[t(r, c)] = d;
    d1_out[g(r, c)] = d;
    dx[g(r, c)] = (0.5f * (1.0f + erf_u) + u * expf(-0.5f * u * u) * kInvSqrt2Pi) * m;
  });
  __syncthreads();

  // r = conv(d1, w2) + x; h = GELU(r), GELU'(r) to dr_out; the window's mean and rstd
  fma_conv<T, C>(acc, in, ring, w2, dilation, valid_rows);
  fma_store_input<T, C>(in, acc);
  __syncthreads();
  float sum = 0.0f;
  fma_epilogue<T, C>([&](int r, int c, int) {
    const float rv = in[t(r, c)] + (valid ? __ldg(x + g(r, c)) : 0.0f);
    const float erf_r = erff(rv * kInvSqrt2);
    const float h = 0.5f * rv * (1.0f + erf_r);
    in[t(r, c)] = h;
    sum += h;
    if (valid) dr_out[g(r, c)] = 0.5f * (1.0f + erf_r) + rv * expf(-0.5f * rv * rv) * kInvSqrt2Pi;
  });
  const float mean = window_sum<T>(sum, red) * inv_n;
  float sq = 0.0f;
  fma_epilogue<T, C>([&](int r, int c, int) {
    const float dv = in[t(r, c)] - mean;
    sq += dv * dv;
  });
  const float rstd = rsqrtf(window_sum<T>(sq, red) * inv_n + 1e-5f);

  // hn in the tile; the window's sums of dhn = dy * gamma and dhn * hn, and
  // the thread's columns' sums of dy * hn and dy (dgamma's and dbeta's partial
  // row of the window)
  float s1 = 0.0f, s2 = 0.0f, pg[kColsPer], pb[kColsPer];
#pragma unroll
  for (int m = 0; m < kColsPer; ++m) pg[m] = pb[m] = 0.0f;
  fma_epilogue<T, C>([&](int r, int c, int m) {
    const float hn = (in[t(r, c)] - mean) * rstd;
    in[t(r, c)] = hn;
    const float dyv = valid ? __ldg(dy + g(r, c)) : 0.0f;
    const float dhn = dyv * __ldg(gn_scale + c);
    s1 += dhn;
    s2 += dhn * hn;
    pg[m] += dyv * hn;
    pb[m] += dyv;
  });
  if (valid) {
    const int j = threadIdx.x % (2 * T);
#pragma unroll
    for (int m = 0; m < kColsPer; ++m) {
      pgamma[(size_t)(win0 + win) * C + j + 2 * T * m] = pg[m];
      pbeta[(size_t)(win0 + win) * C + j + 2 * T * m] = pb[m];
    }
  }
  const float m1 = window_sum<T>(s1, red) * inv_n;
  const float m2 = window_sum<T>(s2, red) * inv_n;

  // dr = rstd * (dhn - m1 - hn * m2) * GELU'(r) to dr_out and the tile
  fma_epilogue<T, C>([&](int r, int c, int) {
    float dr = 0.0f;
    if (valid) {
      dr = rstd * (__ldg(dy + g(r, c)) * __ldg(gn_scale + c) - m1 - in[t(r, c)] * m2) * dr_out[g(r, c)];
      dr_out[g(r, c)] = dr;
    }
    in[t(r, c)] = dr;
  });
  __syncthreads();

  // dd1 = conv(dr, w2t); dh1 = dd1 * (GELU'(h1) * mask) to dh1_out and the tile
  fma_conv<T, C>(acc, in, ring, w2t, dilation, valid_rows);
  fma_store_input<T, C>(in, acc);
  __syncthreads();
  fma_epilogue<T, C>([&](int r, int c, int) {
    float dh1 = 0.0f;
    if (valid) {
      dh1 = in[t(r, c)] * dx[g(r, c)];
      dh1_out[g(r, c)] = dh1;
    }
    in[t(r, c)] = dh1;
  });
  __syncthreads();

  // dx = dr + conv(dh1, w1t); dr comes back from device memory, written by
  // this block's threads before the barriers above
  fma_conv<T, C>(acc, in, ring, w1t, dilation, valid_rows);
  fma_store_input<T, C>(in, acc);
  __syncthreads();
  if (!valid) return;
  fma_epilogue<T, C>([&](int r, int c, int) { dx[g(r, c)] = in[t(r, c)] + dr_out[g(r, c)]; });
}

// Launch 2 of 3 at "highest": partial[p][s][j][ci][co] = sum over the rows
// of row range s of a_p[n + (j-2)d, ci] * g_p[n, co]; p = 0: (x, dh1) -> dw1,
// p = 1: (d1, dr) -> dw2, fp32. Only the rows whose shifted row lies inside
// its window are visited: tap j's V = B * (T - |o|) rows, row v of them n =
// (v / (T - |o|)) T + v % (T - |o|) + max(0, -o), split into `splits` ranges.
// Grid: x = Cin tile * Cout tile, y = p * 5 + j, z = s. 256 threads in a 16 x
// 16 grid as in FmaConv, each kH x kH corners of 4 x 4, 64 apart (an 8 x 8
// tile a thread at kTile = 128): per row, 2 kH 16-byte shared loads for 16
// kH^2 FMAs. kRows rows a stage through a kStages ring by 16-byte cp.async,
// the next kStages - 1 stages in flight; one division a thread a stage finds
// its row (a division a piece cost 12% on an H100). No atomics.
template <int C>
struct GradFma {
  static constexpr int kTile = C >= 128 ? 128 : 64;
  static constexpr int kThreads = 256;
  static constexpr int kH = kTile / 64;
  static constexpr int kRows = 32;
  static constexpr int kStages = 3;                      // 96 KB at kTile = 128: two blocks an SM
  static constexpr int kStageFloats = 2 * kRows * kTile;  // a, then g
  static constexpr size_t kSmem = (size_t)kStages * kStageFloats * 4;
};

// One stage: rows v0 .. v0 + kRows of the visited rows (zeros from v_end on),
// a's shifted row and g's row. kThreads / kRows threads a row, so each thread
// finds its row's n with one division a stage.
template <int C>
__device__ __forceinline__ void grad_fma_load_stage(float* dst, const float* __restrict__ a,
                                                    const float* __restrict__ g, int v0, int v_end,
                                                    int span, int lo, int t_len, int o, int ci0,
                                                    int co0) {
  using G = GradFma<C>;
  constexpr int kPerRow = G::kThreads / G::kRows;   // threads a row
  constexpr int kQ = G::kTile / 4;                  // 16-byte pieces a row of a (and of g)
  static_assert(kQ % kPerRow == 0, "whole pieces a thread");
  const int r = threadIdx.x / kPerRow, sub = threadIdx.x % kPerRow;
  const int v = v0 + r;
  const bool ok = v < v_end;
  const int n = ok ? (v / span) * t_len + v % span + lo : 0;
  const float* a_row = a + (size_t)(n + o) * C + ci0;
  const float* g_row = g + (size_t)n * C + co0;
#pragma unroll
  for (int p = sub; p < kQ; p += kPerRow) {
    cp_async16_zfill(smem_u32(dst + r * G::kTile + 4 * p), ok ? a_row + 4 * p : a, ok);
    cp_async16_zfill(smem_u32(dst + (G::kRows + r) * G::kTile + 4 * p), ok ? g_row + 4 * p : g, ok);
  }
}

template <int C>
__global__ void __launch_bounds__(GradFma<C>::kThreads, 2) tap_grad_fma_kernel(
    const float* __restrict__ a0, const float* __restrict__ g0, const float* __restrict__ a1,
    const float* __restrict__ g1, float* __restrict__ partial, int batch, int t_len, int dilation) {
  using G = GradFma<C>;
  constexpr int kTiles = C / G::kTile;
  constexpr int kTM = 4 * G::kH;
  extern __shared__ float4 smem_f[];
  float* ring = reinterpret_cast<float*>(smem_f);
  const int ci0 = (blockIdx.x / kTiles) * G::kTile;
  const int co0 = (blockIdx.x % kTiles) * G::kTile;
  const int problem = blockIdx.y / kTaps;
  const int j = blockIdx.y % kTaps;
  const float* __restrict__ a = problem ? a1 : a0;
  const float* __restrict__ g = problem ? g1 : g0;
  const int o = (j - kTaps / 2) * dilation;
  const int tx = fma_tx(), ty = fma_ty();

  float acc[kTM][kTM];
#pragma unroll
  for (int r = 0; r < kTM; ++r) {
#pragma unroll
    for (int c = 0; c < kTM; ++c) acc[r][c] = 0.0f;
  }
  const int span = t_len - abs(o);   // rows of a window whose shifted row stays inside
  if (span > 0) {
    const int total = batch * span;
    const int per = (total + gridDim.z - 1) / gridDim.z;
    const int v_begin = min(total, (int)blockIdx.z * per);
    const int v_end = min(total, v_begin + per);
    const int lo = max(0, -o);
    const int steps = (v_end - v_begin + G::kRows - 1) / G::kRows;
#pragma unroll
    for (int s = 0; s < G::kStages - 1; ++s) {
      if (s < steps)
        grad_fma_load_stage<C>(ring + s * G::kStageFloats, a, g, v_begin + s * G::kRows, v_end, span,
                               lo, t_len, o, ci0, co0);
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
          grad_fma_load_stage<C>(ring + slot * G::kStageFloats, a, g, v_begin + sn * G::kRows, v_end,
                                 span, lo, t_len, o, ci0, co0);
        }
        cp_async_commit();
      }
      const float* as = ring + stage * G::kStageFloats + ty * 4;
      const float* gs = ring + stage * G::kStageFloats + G::kRows * G::kTile + tx * 4;
#pragma unroll
      for (int k = 0; k < G::kRows; ++k) {
        float av[kTM], gv[kTM];
#pragma unroll
        for (int h = 0; h < G::kH; ++h) {
          const float4 a4 = *reinterpret_cast<const float4*>(as + k * G::kTile + 64 * h);
          const float4 g4 = *reinterpret_cast<const float4*>(gs + k * G::kTile + 64 * h);
          av[4 * h] = a4.x, av[4 * h + 1] = a4.y, av[4 * h + 2] = a4.z, av[4 * h + 3] = a4.w;
          gv[4 * h] = g4.x, gv[4 * h + 1] = g4.y, gv[4 * h + 2] = g4.z, gv[4 * h + 3] = g4.w;
        }
#pragma unroll
        for (int r = 0; r < kTM; ++r) {
#pragma unroll
          for (int c = 0; c < kTM; ++c) acc[r][c] = fmaf(av[r], gv[c], acc[r][c]);
        }
      }
      stage = stage + 1 == G::kStages ? 0 : stage + 1;
    }
    cp_async_wait<0>();
  }
  const size_t base = (((size_t)problem * gridDim.z + blockIdx.z) * kTaps + j) * C * C;
#pragma unroll
  for (int r = 0; r < kTM; ++r) {
    const int ci = ci0 + ty * 4 + 64 * (r / 4) + r % 4;
#pragma unroll
    for (int h = 0; h < G::kH; ++h) {
      *reinterpret_cast<float4*>(partial + base + (size_t)ci * C + co0 + tx * 4 + 64 * h) =
          make_float4(acc[r][4 * h], acc[r][4 * h + 1], acc[r][4 * h + 2], acc[r][4 * h + 3]);
    }
  }
}

// Launch 3 of 3, both precisions: fixed-order sums. Blocks below w_blocks:
// one thread per element of dw1 and dw2 adds its row-range partials in order.
// The other blocks: one warp per channel of dgamma and dbeta; lane l adds
// partial rows l, l + 32, ... (n_part of them: one a window at "highest",
// TcEpi::kShare at "default") in order, then the lanes join in a fixed tree.
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

struct BwdArgs {
  const float *x, *w1, *w2, *w1t, *w2t, *gs, *dy, *mask;
  float *dx, *d1, *dr, *dh1, *pgamma, *pbeta, *partial, *dw1, *dw2, *dgamma, *dbeta;
  int batch, dilation, windows_per_block, smem_bytes, splits, grad_smem_bytes;
  cudaStream_t stream;
};

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

// The three launches of the backward at "highest" (see the header).
template <int T, int C>
cudaError_t launch_bwd(const BwdArgs& a) {
  using L = FmaConv<T, C>;
  using G = GradFma<C>;
  // the caller's plan (ops/conv_kernel.py::fma_plan) must be this instantiation's
  if (a.windows_per_block != L::kWindows || a.smem_bytes != (int)L::kSmem ||
      a.grad_smem_bytes != (int)G::kSmem || a.splits < 1 || a.splits > 65535)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(train_bwd_fma_kernel<T, C>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::kSmem);
  if (err != cudaSuccess) return err;
  const int blocks = (a.batch + L::kWindows - 1) / L::kWindows;
  train_bwd_fma_kernel<T, C><<<blocks, L::kThreads, L::kSmem, a.stream>>>(
      a.x, a.w1, a.w2, a.w1t, a.w2t, a.gs, a.dy, a.mask, a.dx, a.d1, a.dr, a.dh1, a.pgamma, a.pbeta,
      a.batch, a.dilation);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  err = cudaFuncSetAttribute(tap_grad_fma_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)G::kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((C / G::kTile) * (C / G::kTile), 2 * kTaps, a.splits);
  tap_grad_fma_kernel<C><<<grid, G::kThreads, G::kSmem, a.stream>>>(a.x, a.dh1, a.d1, a.dr, a.partial,
                                                                    a.batch, T, a.dilation);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const int n_w = kTaps * C * C;
  const int w_blocks = (2 * n_w + 255) / 256;
  const int c_blocks = (2 * C + 7) / 8;
  reduce_partials_kernel<<<w_blocks + c_blocks, 256, 0, a.stream>>>(
      a.partial, a.splits, n_w, a.dw1, a.dw2, a.pgamma, a.pbeta, a.batch, C, a.dgamma, a.dbeta,
      w_blocks);
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

// The forward at "highest" on the FMA body (fma_block_kernel): w1, w2 [5, C,
// C] fp32. Supported: t_len in {8, 16, 32}, channels in {64, 128, 256}. mask
// may be null. windows_per_block and smem_bytes: the wrapper's plan, which
// must match the instantiation's (else cudaErrorInvalidValue).
extern "C" int vge_temporal_block_train_fwd(int device, const float* x, const float* w1,
                                            const float* w2, const float* gs, const float* gb,
                                            const float* mask, float* out, int batch, int t_len,
                                            int channels, int dilation, int windows_per_block,
                                            int smem_bytes, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (batch == 0) return (int)cudaErrorInvalidValue;
  return (int)with_shape(t_len, channels, [&](auto t, auto c) {
    return launch_fma_block<decltype(t)::value, decltype(c)::value>(
        x, w1, w2, gs, gb, mask, out, batch, dilation, windows_per_block, smem_bytes, stream);
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

// The three launches of one stage backward at "highest", on the FMA body.
// w1, w2 [5, C, C] fp32; w1t, w2t: the weights tap-reversed with Cin and Cout
// swapped. Scratch, allocated by the caller: d1, dr, dh1 [B, T, C] fp32;
// pgamma, pbeta [B, C]; partial [2, splits, 5, C, C]. Every pointer on 16
// bytes. windows_per_block, smem_bytes, grad_smem_bytes: the wrapper's plan,
// which must match the instantiation's (else cudaErrorInvalidValue). mask may
// be null.
extern "C" int vge_temporal_block_train_bwd(
    int device, const float* x, const float* w1, const float* w2, const float* w1t,
    const float* w2t, const float* gs, const float* dy, const float* mask, float* dx, float* d1,
    float* dr, float* dh1, float* pgamma, float* pbeta, float* partial, float* dw1, float* dw2,
    float* dgamma, float* dbeta, int batch, int t_len, int channels, int dilation,
    int windows_per_block, int smem_bytes, int splits, int grad_smem_bytes, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (batch == 0) return (int)cudaErrorInvalidValue;
  const BwdArgs a{x, w1, w2, w1t, w2t, gs, dy, mask, dx, d1, dr, dh1, pgamma, pbeta, partial, dw1,
                  dw2, dgamma, dbeta, batch, dilation, windows_per_block, smem_bytes, splits,
                  grad_smem_bytes, stream};
  return (int)with_shape(t_len, channels, [&](auto t, auto c) {
    return launch_bwd<decltype(t)::value, decltype(c)::value>(a);
  });
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
