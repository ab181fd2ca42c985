// Whole-chain fused conv kernel of the scoring encoder (K10): S consecutive
// residual dilated-conv stages of one chain (4, or 2 for "chain2") in one
// launch.
//
// Replaces: video_gen_evals_tpu/ops/chain_kernel.py::fused_temporal_chain
// (bodies _chain_kernel, variant "slice", and _chain_kernel_mm, variant
// "mm_first": the two differ only in the order in which taps are summed, so
// this one kernel serves both).
//
// For each window b, stage s = 0 .. S-1 computes K3's "high" stage
// (temporal_block.cu) on the previous stage's output:
//   h   = GELU(conv(y, w1[s]))     k = 5, dilation dilations[s], zero padding
//                                  inside the window, no bias
//   z   = GELU(conv(h, w2[s]) + y)
//   y   = GroupNorm(1)(z) * gamma[s] + beta[s]
// with y = x[b] before stage 0 and out[b] = y after stage S-1. "high" only:
// bf16x3, weights pre-split by the wrapper into (hi, lo) pairs stored
// interleaved as [S, K, Cin, Cout, 2] fp32, each conv input split in the
// kernel, as in K3.
//
// Bound on the H100: fp32 FMA issue, S times K3's (S * 32 G FMAs per
// 512-window launch at T = 32, C = 256). The S stages' split weights (5.2 MB
// a stage at C = 256, 21 MB for 4 stages) are shared by all blocks of the
// launch and stay in the 50 MB L2.
//
// Design: K3's block, run S times. One block per window owns its [T, C]
// tile; each thread owns kCols output channels for all T rows in registers,
// and one shared tile holds the current conv input as (hi, lo) pairs. What
// K3 cannot do here is re-read the residual from device memory: for s > 0
// the stage input exists only inside the kernel. The thread's residual
// columns are the same columns it computes, so it keeps them in a second
// register array (res), which also carries y from one stage to the next:
// activations cross no device memory between stages, and the launch reads x
// and writes out once. This costs kCols * T registers a thread more than K3
// (64 at C = 256); ptxas -v reports the count and any spill.

#include "conv_tile.cuh"

namespace {

constexpr int kMaxStages = 4;

struct Stages {
  int n;
  int dilation[kMaxStages];
};

template <int T, int C>
__global__ void __launch_bounds__(C / Cols<C, true>::value) temporal_chain_kernel(
    const float* __restrict__ x, const float* __restrict__ w1s,
    const float* __restrict__ w2s, const float* __restrict__ gn_scales,
    const float* __restrict__ gn_biases, float* __restrict__ out, Stages stages) {
  constexpr int kCols = Cols<C, true>::value;
  constexpr int kThreads = C / kCols;
  constexpr size_t kStageWeights = (size_t)kTaps * C * C * 2;   // one conv's (hi, lo) pairs
  extern __shared__ float4 smem[];
  __shared__ float red[kThreads / 32];
  float* tile = reinterpret_cast<float*>(smem);
  const int co = threadIdx.x;
  const size_t win = (size_t)blockIdx.x * T * C;

  float res[kCols][T], col[kCols][T];
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
#pragma unroll
    for (int t = 0; t < T; ++t) res[c][t] = x[win + t * C + co + c * kThreads];
  }

  for (int s = 0; s < stages.n; ++s) {
    const int dilation = s == 0 ? stages.dilation[0]
                         : s == 1 ? stages.dilation[1]
                         : s == 2 ? stages.dilation[2]
                                  : stages.dilation[3];
    // the previous stage's conv2 reads of the tile ended before block_sum's barriers
    store_columns<T, C, true, kCols>(tile, res, co);
    __syncthreads();

    conv_columns<T, C, true, kCols>(tile, w1s + s * kStageWeights, co, dilation, col);
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
#pragma unroll
      for (int t = 0; t < T; ++t) col[c][t] = gelu(col[c][t]);
    }
    __syncthreads();  // every thread has finished reading the stage input's tile
    store_columns<T, C, true, kCols>(tile, col, co);
    __syncthreads();

    conv_columns<T, C, true, kCols>(tile, w2s + s * kStageWeights, co, dilation, col);
    float sum = 0.0f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
#pragma unroll
      for (int t = 0; t < T; ++t) {
        col[c][t] = gelu(col[c][t] + res[c][t]);
        sum += col[c][t];
      }
    }
    constexpr float inv_n = 1.0f / (float)(T * C);
    const float mean = block_sum<kThreads / 32>(sum, red) * inv_n;
    float sq = 0.0f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
#pragma unroll
      for (int t = 0; t < T; ++t) {
        const float dv = col[c][t] - mean;
        sq += dv * dv;
      }
    }
    const float var = block_sum<kThreads / 32>(sq, red) * inv_n;
    const float rstd = rsqrtf(var + 1e-5f);
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int ch = co + c * kThreads;
      const float g = gn_scales[s * C + ch];
      const float bias = gn_biases[s * C + ch];
#pragma unroll
      for (int t = 0; t < T; ++t) res[c][t] = (col[c][t] - mean) * rstd * g + bias;
    }
  }

#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    const int ch = co + c * kThreads;
#pragma unroll
    for (int t = 0; t < T; ++t) out[win + t * C + ch] = res[c][t];
  }
}

template <int T, int C>
cudaError_t launch(const float* x, const float* w1s, const float* w2s, const float* gs,
                   const float* gb, float* out, int batch, Stages stages, cudaStream_t stream) {
  constexpr size_t smem = (size_t)T * C * 8;
  cudaError_t err = cudaFuncSetAttribute(temporal_chain_kernel<T, C>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  temporal_chain_kernel<T, C><<<batch, C / Cols<C, true>::value, smem, stream>>>(
      x, w1s, w2s, gs, gb, out, stages);
  return cudaGetLastError();
}

template <int T>
cudaError_t dispatch_c(int channels, const float* x, const float* w1s, const float* w2s,
                       const float* gs, const float* gb, float* out, int batch, Stages stages,
                       cudaStream_t stream) {
  switch (channels) {
    case 64:
      return launch<T, 64>(x, w1s, w2s, gs, gb, out, batch, stages, stream);
    case 128:
      return launch<T, 128>(x, w1s, w2s, gs, gb, out, batch, stages, stream);
    case 256:
      return launch<T, 256>(x, w1s, w2s, gs, gb, out, batch, stages, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// x, out: [batch, t_len, channels]; w1s, w2s: [n_stages, 5, C, C, 2] (hi, lo)
// pairs; gs, gb: [n_stages, C]; dilations: n_stages ints.
// Supported: n_stages in 1..4, t_len in {8, 16, 32}, channels in {64, 128, 256}.
extern "C" int vge_temporal_chain(int device, const float* x, const float* w1s,
                                  const float* w2s, const float* gs, const float* gb,
                                  float* out, int batch, int t_len, int channels,
                                  int n_stages, const int* dilations, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n_stages < 1 || n_stages > kMaxStages) return (int)cudaErrorInvalidValue;
  if (batch == 0) return (int)cudaSuccess;
  Stages stages{n_stages, {1, 1, 1, 1}};
  for (int s = 0; s < n_stages; ++s) stages.dilation[s] = dilations[s];
  switch (t_len) {
    case 8:
      return (int)dispatch_c<8>(channels, x, w1s, w2s, gs, gb, out, batch, stages, stream);
    case 16:
      return (int)dispatch_c<16>(channels, x, w1s, w2s, gs, gb, out, batch, stages, stream);
    case 32:
      return (int)dispatch_c<32>(channels, x, w1s, w2s, gs, gb, out, batch, stages, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
