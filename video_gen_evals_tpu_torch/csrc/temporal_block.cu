// Fused residual dilated-conv stage of the scoring encoder (K3), and the same
// stage over S stacked chains in one launch (K9).
//
// Replaces: video_gen_evals_tpu/ops/conv_kernel.py::fused_temporal_block
// (bodies _block_kernel_f32 for precision "highest" and _block_kernel_high_mm
// for "high"), and ::fused_temporal_block_stacked (_block_kernel_high_stacked,
// "high" only) through vge_temporal_block_high over its chains.
//
// For each window b, with x[b] a [T, C] tile and weights laid out [K, Cin, Cout]:
//   h      = GELU(conv(x[b], w1))   k = 5, dilation d, zero padding inside the
//                                   window, no bias; a tap whose offset is
//                                   >= T in size contributes zero
//   y      = GELU(conv(h, w2) + x[b])
//   out[b] = (y - mean) * rsqrt(var + 1e-5) * gamma + beta
//            (GroupNorm(1): two-pass mean and variance over all T * C values)
// GELU is the exact erf form.
//
// Precision:
//   "highest": fp32 products and sums.
//   "high":    bf16x3, the class of split_bf16 / _block_kernel_high_mm. Each
//              tap adds hi*whi + hi*wlo + lo*whi in fp32, with hi and lo the
//              round-to-nearest-even bf16 split of a value; products of bf16
//              values are exact in fp32.
//
// "high" (temporal_block_high_kernel): the tensor-core body of conv_tile.cuh
// (tc_conv, P = 3). The wrapper lays out the weights once a call as bf16 hi
// and lo planes, [2 convs, 2 planes, 5, C, C]. A block of 8 warps owns W =
// 128 / T windows (4 at T = 32): it splits x into hi and lo planes in shared
// memory, runs conv1 as three mma.sync products a term, passes the
// accumulators through an fp32 staging area in the ring (half the rows at a
// time) to GELU and split them back into the same planes, runs conv2, stages
// its accumulators over the planes, and adds the residual x (re-read from
// device memory), applies GELU and GroupNorm over each window element-wise,
// a window's 2T threads on its float4s. Bound on the H100: the bf16
// tensor-core rate, 3 products of 2 convs * 5 taps * T * C * C a window (63
// M multiply-adds at T = 32, C = 256; 64.4 GFLOP at 512 windows, 0.065 ms at
// the H100 data sheet's 989 TFLOP/s, 0.056 ms counting only the rows a shifted
// tap reaches). Each block reads the 2.6 MB of hi and lo weight planes once
// from L2, so a 512-window launch reads 0.34 GB (1.34 GB at one window a
// block). Shared memory 221 KB at C = 256 (two planes of 129 rows of C + 8
// bf16, a 5-stage ring of 16 input channels), so one block an SM.
//
// "highest" (fma_block_kernel in conv_tile.cuh, which K4's forward at
// "highest" runs with its dropout mask): the FMA body of conv_tile.cuh
// (fma_conv), fp32 products and sums on the CUDA cores, bound by their FMA
// rate: 2 convs * 5 taps * T * C * C FMAs a window (21 M at T = 32, C = 256;
// 10.3 G at 512 windows counting only the rows a shifted tap reaches, 0.31 ms
// at d = 1 at the H100 data sheet's 67 TFLOP/s). A block of 256 threads owns W
// = 128 / T windows (4 at T = 32): it stores x in shared memory, runs conv1 as
// register-tiled outer products (8 rows x 16 columns a thread at C = 256) with
// the fp32 weights streaming through a cp.async ring, stages the
// accumulators in the tile and applies GELU there in place, runs conv2,
// stages again, and adds the residual x (re-read from device memory),
// applies GELU and GroupNorm over each window on the staged tile, a window's
// 2T threads on whole columns of it. Each block reads the two convs' 2.6 MB of
// fp32 weights once from L2, 0.34 GB a 512-window launch (1.34 GB at one
// window a block). Shared memory 195 KB at C = 256 (the input tile of 129
// rows of C + 1 floats 130 KB, a 4-stage ring of 16 input channels 64 KB),
// so one block an SM: 128 blocks on 132 SMs.
//
// K9 (stacked chains): the "high" kernel above with a chain axis. blockIdx.y
// picks the chain, and with it the chain's slice of x and out ([S, B, T, C]),
// of the weight planes ([S, 2 convs, 2 planes, 5, C, C] bf16, the layout K10
// reads) and of gn_scale and gn_bias ([S, C]); each block then runs K3
// "high"'s body unchanged, so K9 on chain s is bitwise K3 "high" on chain s,
// and K3 "high" is the launch with S = 1. Bound: S times K3's (0.56 ms for
// the scorer's 10 chains at [512, 32, 256], counting only the rows a shifted
// tap reaches). The windows are on blockIdx.x and the chain on blockIdx.y
// because blocks are dispatched x-fastest: the resident blocks then work
// through one chain's 2.6 MB of weight planes at a time, where a
// chain-fastest order would cycle through all S chains' planes (26 MB for
// the scorer's 10 chains, half the 50 MB L2, beside the activations) at
// once. At [10, 512, 32, 256]: 1280 blocks of 4 windows, one an SM, 9.7
// waves on 132 SMs; 3.4 GB of plane reads from L2 a launch. There, on an
// H100 at 700 W, K9 read 2.35 ms (23.8% of the bound; 0.95 of ten K3 "high"
// launches), where the one-window CUDA-core bf16x3 body it replaced read
// 20.6 ms (scripts/profile_torch_conv.py).

#include "conv_tile.cuh"

namespace {

// K3 at "high", and K9 over the chains of blockIdx.y: W = 128 / T windows a
// block on the tensor cores (see the header). x, out [chains, batch, T, C];
// w [chains, 2 convs, 2 planes (hi, lo), 5, C, C] bf16; gn_scale, gn_bias
// [chains, C].
template <int T, int C>
__global__ void __launch_bounds__(TcConv<T, C, 3>::kThreads, 1) temporal_block_high_kernel(
    const float* __restrict__ x, const __nv_bfloat16* __restrict__ w,
    const float* __restrict__ gn_scale, const float* __restrict__ gn_bias,
    float* __restrict__ out, int batch, int dilation) {
  using L = TcConv<T, C, 3>;
  constexpr size_t kPlaneW = (size_t)kTaps * C * C;
  const size_t chain = blockIdx.y;
  x += chain * batch * T * C;
  out += chain * batch * T * C;
  w += chain * 4 * kPlaneW;
  gn_scale += chain * C;
  gn_bias += chain * C;
  extern __shared__ float4 smem_tc[];
  __nv_bfloat16* planes = reinterpret_cast<__nv_bfloat16*>(smem_tc);
  __nv_bfloat16* ring = planes + L::kPlanes * L::kPlaneElems;
  float* red = reinterpret_cast<float*>(ring + L::kStages * L::kStageElems);
  const int win0 = blockIdx.x * L::kWindows;
  const int valid_rows = min(L::kWindows, batch - win0) * T;
  const size_t base = (size_t)win0 * T * C;

  tc_load_input<T, C, 3>(planes, x + base, valid_rows, nullptr);
  __syncthreads();
  float acc[L::kMT][L::kNT][4];
  tc_conv<T, C, 3>(acc, planes, ring, w, kPlaneW, dilation, valid_rows);
  static_assert((size_t)L::kRows / 2 * L::kLdF * 4 <= (size_t)L::kStages * L::kStageElems * 2,
                "half the rows' staging fits the ring");
  // h = GELU(conv1), split back into the planes
  tc_store_planes<T, C, 3>(planes, reinterpret_cast<float*>(ring), acc,
                           [](float v) { return gelu(v); });
  tc_conv<T, C, 3>(acc, planes, ring, w + 2 * kPlaneW, kPlaneW, dilation, valid_rows);

  // y = GELU(conv2 + x), GroupNorm over each window, element-wise from the
  // accumulators staged over the planes
  using E = TcEpi<T, C>;
  static_assert(L::kStageBytes <= (size_t)L::kPlanes * L::kPlaneElems * 2, "staging fits the planes");
  float* ys = reinterpret_cast<float*>(planes);
  tc_stage_acc<T, C, 3>(ys, acc);
  __syncthreads();
  const int win = threadIdx.x / E::kGroup, j = threadIdx.x % E::kGroup;
  const bool valid = win0 + win < batch;
  const size_t wbase = base + (size_t)win * T * C;
  float* yw = ys + win * T * L::kLdF;
  constexpr float inv_n = 1.0f / (float)(T * C);
  float sum = 0.0f;
#pragma unroll 4
  for (int k = 0; k < E::kSteps; ++k) {
    const int f = j + E::kGroup * k, r = f / (C / 4), c = (f % (C / 4)) * 4;
    float4 v = *reinterpret_cast<const float4*>(yw + r * L::kLdF + c);
    float4 xv = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (valid) xv = __ldg(reinterpret_cast<const float4*>(x + wbase + r * C + c));
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

template <int T, int C>
cudaError_t launch_high(const float* x, const __nv_bfloat16* w, const float* gs, const float* gb,
                        float* out, int chains, int batch, int dilation, int windows_per_block,
                        int smem_bytes, cudaStream_t stream) {
  using L = TcConv<T, C, 3>;
  // the caller's plan (ops/conv_kernel.py::tc_plan) must be this instantiation's
  if (windows_per_block != L::kWindows || smem_bytes != (int)L::kSmem) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(temporal_block_high_kernel<T, C>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)L::kSmem);
  if (err != cudaSuccess) return err;
  const int blocks = (batch + L::kWindows - 1) / L::kWindows;
  temporal_block_high_kernel<T, C><<<dim3(blocks, chains), L::kThreads, L::kSmem, stream>>>(
      x, w, gs, gb, out, batch, dilation);
  return cudaGetLastError();
}

}  // namespace

// K3 at "highest" on the FMA body: w1, w2 [5, C, C] fp32. Supported: t_len in
// {8, 16, 32}, channels in {64, 128, 256}. windows_per_block and smem_bytes:
// the wrapper's plan, which must match the instantiation's (else
// cudaErrorInvalidValue).
extern "C" int vge_temporal_block(int device, const float* x, const float* w1,
                                  const float* w2, const float* gs,
                                  const float* gb, float* out, int batch,
                                  int t_len, int channels, int dilation,
                                  int windows_per_block, int smem_bytes,
                                  cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (batch == 0) return (int)cudaSuccess;
  return (int)with_shape(t_len, channels, [&](auto t, auto c) {
    return launch_fma_block<decltype(t)::value, decltype(c)::value>(
        x, w1, w2, gs, gb, nullptr, out, batch, dilation, windows_per_block, smem_bytes, stream);
  });
}

// K3 at "high" on the tensor cores (chains = 1), and K9 over chains on
// blockIdx.y: x, out [chains, batch, t_len, channels]; w [chains, 2 convs, 2
// planes (hi, lo), 5, C, C] bf16; gs, gb [chains, C]. windows_per_block and
// smem_bytes: the wrapper's plan, which must match the instantiation's (else
// cudaErrorInvalidValue), as must chains <= 65535 (the grid's second axis).
extern "C" int vge_temporal_block_high(int device, const float* x, const void* w,
                                       const float* gs, const float* gb, float* out, int chains,
                                       int batch, int t_len, int channels, int dilation,
                                       int windows_per_block, int smem_bytes,
                                       cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (batch == 0 || chains == 0) return (int)cudaSuccess;
  if (chains > 65535) return (int)cudaErrorInvalidValue;
  const auto* wb = static_cast<const __nv_bfloat16*>(w);
  return (int)with_shape(t_len, channels, [&](auto t, auto c) {
    return launch_high<decltype(t)::value, decltype(c)::value>(
        x, wb, gs, gb, out, chains, batch, dilation, windows_per_block, smem_bytes, stream);
  });
}
