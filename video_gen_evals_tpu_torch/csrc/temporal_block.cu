// Fused residual dilated-conv stage of the scoring encoder (K3), and the same
// stage over S stacked chains in one launch (K9).
//
// Replaces: video_gen_evals_tpu/ops/conv_kernel.py::fused_temporal_block
// (bodies _block_kernel_f32 for precision "highest" and _block_kernel_high_mm
// for "high"), and ::fused_temporal_block_stacked (_block_kernel_high_stacked,
// "high" only) through vge_temporal_block_stacked.
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
//   "high":    bf16x3, the class of split_bf16 / _block_kernel_high_mm. The
//              wrapper splits the weights once into round-to-nearest-even bf16
//              (hi, lo) pairs, stored interleaved as [K, Cin, Cout, 2] fp32;
//              the kernel splits each conv's input tile the same way. Each tap
//              adds hi*whi + hi*wlo + lo*whi in fp32; products of bf16 values
//              are exact in fp32, so CUDA-core FMAs give the bf16x3 result.
//
// Bound on the H100: fp32 FMA issue. A stage is 2 convs * 5 taps * T * C * C
// FMAs per window (21 M at T = 32, C = 256; three times that at "high"),
// 10.7 G (32 G) per 512-window launch. Every block reads the same 2.6 MB
// (5.2 MB at "high") of weights, which stay in the 50 MB L2.
//
// Design: one block per window owns its whole [T, C] tile, so GroupNorm is a
// block reduction over registers, with no second pass over device memory.
// Each thread computes kCols output channels (co, co + C/kCols, ...) for all
// T rows, in kCols * T fp32 registers: kCols = 4 at "highest", 2 at "high"
// (64 or 128 threads at C = 256). The conv input tile sits in shared memory
// and is read as broadcasts, four input channels per 16-byte load (two loads
// at "high"); each load feeds 4 * kCols FMAs (12 * kCols at "high"), so the
// shared-memory pipe stops being the limit. Weight rows are read coalesced
// across threads (consecutive co) through the read-only path, each weight
// once per block, and the next four input channels' weights are loaded
// before the current ones are used, so the L2 latency hides behind the FMAs.
// T and C are template parameters: tile addresses are immediate offsets and
// the row loop unrolls. conv1's input x and conv2's input h share one shared
// buffer (each thread keeps its h columns in registers across the barrier),
// so the block holds one tile: T * C * 4 bytes, twice that at "high" (32 or
// 64 KB at T = 32, C = 256); above 48 KB the dynamic shared memory limit is
// raised with cudaFuncSetAttribute before the launch. The residual re-reads
// x from device memory. Tensor cores (wgmma) and TMA are left to a later
// change.
//
// K9 (stacked chains): blockIdx.y picks the chain, and with it the chain's
// slice of x, out, w1, w2, gn_scale and gn_bias; each block then runs the
// body above unchanged. Bound: S times K3's FMAs. The windows are on
// blockIdx.x and the chain on blockIdx.y because blocks are dispatched
// x-fastest: the resident blocks then work through one chain's weights
// (5.2 MB at "high") at a time, where a chain-fastest order would cycle
// through all S chains' weights (52 MB for the scorer's 10 chains, more than
// the 50 MB L2) and stream them from device memory.

#include "conv_tile.cuh"

namespace {

// kStacked: K9's chain axis on blockIdx.y. It is a template flag so that K3's
// instantiations keep their pointer arguments in the parameter bank: with the
// offsets, K3 at "highest" (T = 32, C = 256) needed 255 registers and spilled.
template <int T, int C, bool kSplit, bool kStacked>
__global__ void __launch_bounds__(C / Cols<C, kSplit>::value) temporal_block_kernel(
    const float* __restrict__ x, const float* __restrict__ w1,
    const float* __restrict__ w2, const float* __restrict__ gn_scale,
    const float* __restrict__ gn_bias, float* __restrict__ out, int dilation) {
  constexpr int kCols = Cols<C, kSplit>::value;
  constexpr int kThreads = C / kCols;
  extern __shared__ float4 smem[];
  __shared__ float red[kThreads / 32];
  float* tile = reinterpret_cast<float*>(smem);
  const int co = threadIdx.x;
  if constexpr (kStacked) {
    // chain blockIdx.y of the grid (windows, chains): its activations,
    // weights and norm parameters
    const size_t chain = blockIdx.y;
    x += chain * gridDim.x * T * C;
    out += chain * gridDim.x * T * C;
    w1 += chain * kTaps * C * C * (kSplit ? 2 : 1);
    w2 += chain * kTaps * C * C * (kSplit ? 2 : 1);
    gn_scale += chain * C;
    gn_bias += chain * C;
  }
  const size_t win = (size_t)blockIdx.x * T * C;

  float col[kCols][T];
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
#pragma unroll
    for (int t = 0; t < T; ++t) col[c][t] = x[win + t * C + co + c * kThreads];
  }
  store_columns<T, C, kSplit, kCols>(tile, col, co);
  __syncthreads();

  conv_columns<T, C, kSplit, kCols>(tile, w1, co, dilation, col);
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
#pragma unroll
    for (int t = 0; t < T; ++t) col[c][t] = gelu(col[c][t]);
  }
  __syncthreads();  // every thread has finished reading x's tile
  store_columns<T, C, kSplit, kCols>(tile, col, co);
  __syncthreads();

  conv_columns<T, C, kSplit, kCols>(tile, w2, co, dilation, col);
  float sum = 0.0f;
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
#pragma unroll
    for (int t = 0; t < T; ++t) {
      col[c][t] = gelu(col[c][t] + x[win + t * C + co + c * kThreads]);
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
    const float g = gn_scale[ch];
    const float bias = gn_bias[ch];
#pragma unroll
    for (int t = 0; t < T; ++t) out[win + t * C + ch] = (col[c][t] - mean) * rstd * g + bias;
  }
}

template <int T, int C, bool kSplit, bool kStacked>
cudaError_t launch_kernel(const float* x, const float* w1, const float* w2, const float* gs,
                          const float* gb, float* out, int chains, int batch, int dilation,
                          cudaStream_t stream) {
  constexpr size_t smem = (size_t)T * C * (kSplit ? 8 : 4);
  cudaError_t err = cudaFuncSetAttribute(temporal_block_kernel<T, C, kSplit, kStacked>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  temporal_block_kernel<T, C, kSplit, kStacked>
      <<<dim3(batch, chains), C / Cols<C, kSplit>::value, smem, stream>>>(
          x, w1, w2, gs, gb, out, dilation);
  return cudaGetLastError();
}

// chains == 0: K3 (one chain, no chain axis); chains >= 1: K9, "high" only.
template <int T, int C, bool kSplit>
cudaError_t launch(const float* x, const float* w1, const float* w2, const float* gs,
                   const float* gb, float* out, int chains, int batch, int dilation,
                   cudaStream_t stream) {
  if (chains == 0)
    return launch_kernel<T, C, kSplit, false>(x, w1, w2, gs, gb, out, 1, batch, dilation, stream);
  if constexpr (kSplit)
    return launch_kernel<T, C, true, true>(x, w1, w2, gs, gb, out, chains, batch, dilation, stream);
  return cudaErrorInvalidValue;
}

template <int T, bool kSplit>
cudaError_t dispatch_c(int channels, const float* x, const float* w1, const float* w2,
                       const float* gs, const float* gb, float* out, int chains, int batch,
                       int dilation, cudaStream_t stream) {
  switch (channels) {
    case 64:
      return launch<T, 64, kSplit>(x, w1, w2, gs, gb, out, chains, batch, dilation,
                                        stream);
    case 128:
      return launch<T, 128, kSplit>(x, w1, w2, gs, gb, out, chains, batch, dilation,
                                        stream);
    case 256:
      return launch<T, 256, kSplit>(x, w1, w2, gs, gb, out, chains, batch, dilation,
                                        stream);
    default:
      return cudaErrorInvalidValue;
  }
}

template <bool kSplit>
cudaError_t dispatch(int t_len, int channels, const float* x, const float* w1, const float* w2,
                     const float* gs, const float* gb, float* out, int chains, int batch,
                     int dilation, cudaStream_t stream) {
  switch (t_len) {
    case 8:
      return dispatch_c<8, kSplit>(channels, x, w1, w2, gs, gb, out, chains, batch, dilation,
                                       stream);
    case 16:
      return dispatch_c<16, kSplit>(channels, x, w1, w2, gs, gb, out, chains, batch, dilation,
                                       stream);
    case 32:
      return dispatch_c<32, kSplit>(channels, x, w1, w2, gs, gb, out, chains, batch, dilation,
                                       stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// w1, w2: [5, C, C] fp32 for split_bf16 == 0, [5, C, C, 2] (hi, lo) otherwise.
// Supported: t_len in {8, 16, 32}, channels in {64, 128, 256}.
extern "C" int vge_temporal_block(int device, const float* x, const float* w1,
                                  const float* w2, const float* gs,
                                  const float* gb, float* out, int batch,
                                  int t_len, int channels, int dilation,
                                  int split_bf16, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (batch == 0) return (int)cudaSuccess;
  err = split_bf16
            ? dispatch<true>(t_len, channels, x, w1, w2, gs, gb, out, 0, batch, dilation, stream)
            : dispatch<false>(t_len, channels, x, w1, w2, gs, gb, out, 0, batch, dilation, stream);
  return (int)err;
}

// K9: x, out [chains, batch, t_len, channels]; w1, w2 [chains, 5, C, C, 2]
// (hi, lo) pairs, "high" only; gs, gb [chains, C].
extern "C" int vge_temporal_block_stacked(int device, const float* x, const float* w1,
                                          const float* w2, const float* gs,
                                          const float* gb, float* out, int chains,
                                          int batch, int t_len, int channels,
                                          int dilation, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (batch == 0 || chains == 0) return (int)cudaSuccess;
  if (chains > 65535) return (int)cudaErrorInvalidValue;
  return (int)dispatch<true>(t_len, channels, x, w1, w2, gs, gb, out, chains, batch, dilation,
                             stream);
}
