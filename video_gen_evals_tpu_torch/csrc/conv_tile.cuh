// Device helpers shared by the fused conv-stage kernels (temporal_block.cu,
// temporal_block_train.cu): a [T, C] conv-input tile in shared memory, read
// as broadcasts, and each thread's output channels for all T rows in
// registers. See temporal_block.cu for the design.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {


constexpr int kTaps = 5;

// Output channels per thread (co, co + C/kCols, ...): 4 at "highest" and 2
// at "high", whose split weights take twice the registers (4 there spills
// and runs 1.6x slower on the H100), and never fewer than 32 threads.
template <int C, bool kSplit>
struct Cols {
  static constexpr int kWant = kSplit ? 2 : 4;
  static constexpr int value = kWant < C / 32 ? kWant : C / 32;
};

__device__ __forceinline__ float gelu(float v) {
  return 0.5f * v * (1.0f + erff(v * 0.70710678118654752440f));
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Sum of v over the block; every thread gets the same value (same order).
template <int kWarps>
__device__ float block_sum(float v, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float total = 0.0f;
#pragma unroll
  for (int i = 0; i < kWarps; ++i) total += red[i];
  __syncthreads();  // red is reused by the next call
  return total;
}

// The thread's columns of a [T, C] conv input into shared memory: fp32
// values, or (hi, lo) bf16 pairs held in fp32 for "high".
template <int T, int C, bool kSplit, int kCols>
__device__ __forceinline__ void store_columns(float* tile, const float (&col)[kCols][T], int co) {
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    const int ch = co + c * (C / kCols);
#pragma unroll
    for (int t = 0; t < T; ++t) {
      if constexpr (kSplit) {
        const float hi = bf16_round(col[c][t]);
        const float lo = bf16_round(col[c][t] - hi);
        reinterpret_cast<float2*>(tile)[t * C + ch] = make_float2(hi, lo);
      } else {
        tile[t * C + ch] = col[c][t];
      }
    }
  }
}

// Weights of input channels ci .. ci+3 of tap j for the thread's output
// channels: fp32, or (hi, lo) pairs for "high".
template <int C, bool kSplit, int kCols>
__device__ __forceinline__ void load_weights(const float* __restrict__ w, int j, int ci, int co,
                                             float (&wv)[kCols][kSplit ? 8 : 4]) {
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const size_t idx = (size_t)(j * C + ci + q) * C + co + c * (C / kCols);
      if constexpr (kSplit) {
        const float2 v = __ldg(reinterpret_cast<const float2*>(w) + idx);
        wv[c][2 * q] = v.x;
        wv[c][2 * q + 1] = v.y;
      } else {
        wv[c][q] = __ldg(w + idx);
      }
    }
  }
}

// acc[c][t] = sum_j sum_ci in[t + (j - 2) * dilation][ci] * w[j][ci][co + c * C/kCols],
// with rows outside [0, T) reading zero.
template <int T, int C, bool kSplit, int kCols>
__device__ __forceinline__ void conv_columns(const float* tile, const float* __restrict__ w,
                                             int co, int dilation, float (&acc)[kCols][T]) {
  constexpr int kW = kSplit ? 8 : 4;
  constexpr int kRow4 = kSplit ? C / 2 : C / 4;  // float4s per tile row
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
#pragma unroll
    for (int t = 0; t < T; ++t) acc[c][t] = 0.0f;
  }
  const float4* tile4 = reinterpret_cast<const float4*>(tile);
  for (int j = 0; j < kTaps; ++j) {
    const int o = (j - kTaps / 2) * dilation;
    if (o >= T || o <= -T) continue;  // the tap lies wholly outside the window
    // output rows t whose input row t + o lies inside the window
    const int lo = o < 0 ? -o : 0;
    const int hi = o > 0 ? T - o : T;
    const uint32_t valid = (uint32_t)(((1ull << (hi - lo)) - 1ull) << lo);
    float wv[kCols][kW], wn[kCols][kW];
    load_weights<C, kSplit, kCols>(w, j, 0, co, wv);
    for (int ci = 0; ci < C; ci += 4) {
      // the next step's weights (this step's again on the last one)
      load_weights<C, kSplit, kCols>(w, j, ci + 4 < C ? ci + 4 : ci, co, wn);
      const int base = o * kRow4 + (kSplit ? ci / 2 : ci / 4);
#pragma unroll
      for (int t = 0; t < T; ++t) {
        if (valid & (1u << t)) {
          if constexpr (kSplit) {
            // (hi, lo) of input channels ci, ci+1 and ci+2, ci+3
            const float4 a01 = tile4[base + t * kRow4];
            const float4 a23 = tile4[base + t * kRow4 + 1];
            const float ahi[4] = {a01.x, a01.z, a23.x, a23.z};
            const float alo[4] = {a01.y, a01.w, a23.y, a23.w};
#pragma unroll
            for (int c = 0; c < kCols; ++c) {
              float s = acc[c][t];
#pragma unroll
              for (int q = 0; q < 4; ++q) {
                s = fmaf(ahi[q], wv[c][2 * q], s);
                s = fmaf(ahi[q], wv[c][2 * q + 1], s);
                s = fmaf(alo[q], wv[c][2 * q], s);
              }
              acc[c][t] = s;
            }
          } else {
            const float4 a4 = tile4[base + t * kRow4];
            const float a[4] = {a4.x, a4.y, a4.z, a4.w};
#pragma unroll
            for (int c = 0; c < kCols; ++c) {
              float s = acc[c][t];
#pragma unroll
              for (int q = 0; q < 4; ++q) s = fmaf(a[q], wv[c][q], s);
              acc[c][t] = s;
            }
          }
        }
      }
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
#pragma unroll
        for (int k = 0; k < kW; ++k) wv[c][k] = wn[c][k];
      }
    }
  }
}

}  // namespace
