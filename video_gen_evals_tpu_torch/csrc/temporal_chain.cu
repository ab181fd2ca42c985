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
// bf16x3, each tap adds hi*whi + hi*wlo + lo*whi in fp32, with hi and lo the
// round-to-nearest-even bf16 split of a value.
//
// Bound on the H100: the bf16 tensor-core rate, S times K3's (3 products of 2
// convs * 5 taps * T * C * C a window: 0.22 ms for 4 stages at [512, 32, 256]
// counting only the rows a shifted tap reaches).
//
// Design: K3 "high"'s tensor-core stage (temporal_block_high_kernel, the body
// of conv_tile.cuh at P = 3) run S times in one block of W = 128 / T windows
// (4 at T = 32): the stage input split into hi and lo planes, conv1 as three
// mma.sync products a term, GELU split back into the planes, conv2, then the
// residual, GELU, GroupNorm and the stage's affine element-wise on the
// accumulators staged over the planes, a window's 2T threads on its float4s.
// The wrapper lays out every stage's weights once a call as bf16 [S, 2 convs,
// 2 planes (hi, lo), 5, C, C] (10.5 MB for 4 stages at C = 256), read from L2
// once per W windows: 1.3 GB a 512-window launch, where the FMA body this
// replaces read 10.7 GB of (hi, lo) fp32 pairs, one window a block.
//
// Order of the sums. Each conv sums the two small products of every term
// (hi*wlo + lo*whi) first and the large one (hi*whi) last
// (tc_conv_small_first), where K3 interleaves the three. The tensor cores
// round each mma's fp32 sum toward zero, about an ulp of the accumulator, and
// a stage's error feeds the next stage: with K3's order 4 stages at [512,
// 32, 256] missed the plain version by 1.4-1.5e-4 (bitwise K3 run 4 times;
// one stage 3-6e-5), with this one by 6.3-6.9e-5 (one stage 1.5-2.7e-5), on
// an H100. The large term's pass streams the hi weight plane alone, 32 input
// channels a stage. The order costs time: 1.03-1.04 ms for 4 stages against
// 0.92 with K3's (more fragment loads, 120 ring stages a conv against 80).
//
// Where a stage's output waits. It is the next stage's conv input and its
// residual, which must stay exact fp32 (not hi + lo); it cannot stay on chip:
// the planes and the weight ring take 216 of 227 KB, an fp32 [128, 256] tile
// is 128 KB, and the 128 accumulators a thread leave no registers for it. So
// each stage writes its output to out, and the next stage reads it back after
// a barrier: the planes through L2 by every thread of the block, the residual
// by the thread that wrote each element (the epilogue's walk is the same in
// every stage). 128 KB a block, ~17 MB for 128 blocks in flight, which stays
// in the 50 MB L2. The read-back goes through L2 only (ld.global.cg): the
// read-only path (__ldg) need not see the block's own writes. Stage 0 reads x.

#include "conv_tile.cuh"

namespace {

constexpr int kMaxStages = 4;

struct Stages {
  int n;
  int dilation[kMaxStages];
};

// w: [S, 2 convs, 2 planes, 5, C, C] bf16; gn_scales, gn_biases [S, C].
template <int T, int C>
__global__ void __launch_bounds__(TcConv<T, C, 3>::kThreads, 1) temporal_chain_tc_kernel(
    const float* __restrict__ x, const __nv_bfloat16* __restrict__ w,
    const float* __restrict__ gn_scales, const float* __restrict__ gn_biases, float* out,
    int batch, Stages stages) {
  using L = TcConv<T, C, 3>;
  using E = TcEpi<T, C>;
  static_assert((size_t)L::kRows / 2 * L::kLdF * 4 <= (size_t)L::kStages * L::kStageElems * 2,
                "half the rows' staging fits the ring");
  static_assert(L::kStageBytes <= (size_t)L::kPlanes * L::kPlaneElems * 2, "staging fits the planes");
  constexpr size_t kPlaneW = (size_t)kTaps * C * C;
  constexpr float inv_n = 1.0f / (float)(T * C);
  extern __shared__ float4 smem_tc[];
  __nv_bfloat16* planes = reinterpret_cast<__nv_bfloat16*>(smem_tc);
  __nv_bfloat16* ring = planes + L::kPlanes * L::kPlaneElems;
  float* red = reinterpret_cast<float*>(ring + L::kStages * L::kStageElems);
  float* ys = reinterpret_cast<float*>(planes);  // conv2's accumulators
  const int win0 = blockIdx.x * L::kWindows;
  const int valid_rows = min(L::kWindows, batch - win0) * T;
  const size_t base = (size_t)win0 * T * C;
  // the thread's window and its place there (TcEpi)
  const int win = threadIdx.x / E::kGroup, j = threadIdx.x % E::kGroup;
  const bool valid = win0 + win < batch;
  const size_t wbase = base + (size_t)win * T * C;
  float* yw = ys + win * T * L::kLdF;
  float acc[L::kMT][L::kNT][4];

#pragma unroll 1
  for (int s = 0; s < stages.n; ++s) {
    const int dilation = s == 0 ? stages.dilation[0]
                         : s == 1 ? stages.dilation[1]
                         : s == 2 ? stages.dilation[2]
                                  : stages.dilation[3];
    const float* in = s == 0 ? x : out;  // the stage input, and its residual
    const __nv_bfloat16* ws = w + (size_t)s * 4 * kPlaneW;
    tc_load_input<T, C, 3, true>(planes, in + base, valid_rows, nullptr);
    __syncthreads();
    tc_conv_small_first<T, C>(acc, planes, ring, ws, kPlaneW, dilation, valid_rows);
    // h = GELU(conv1), split back into the planes
    tc_store_planes<T, C, 3>(planes, reinterpret_cast<float*>(ring), acc,
                             [](float v) { return gelu(v); });
    tc_conv_small_first<T, C>(acc, planes, ring, ws + 2 * kPlaneW, kPlaneW, dilation, valid_rows);

    // z = GELU(conv2 + y), GroupNorm over each window, the stage's affine
    tc_stage_acc<T, C, 3>(ys, acc);
    __syncthreads();
    float sum = 0.0f;
#pragma unroll 4
    for (int k = 0; k < E::kSteps; ++k) {
      const int f = j + E::kGroup * k, r = f / (C / 4), c = (f % (C / 4)) * 4;
      float4 v = *reinterpret_cast<const float4*>(yw + r * L::kLdF + c);
      float4 yv = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (valid) yv = __ldcg(reinterpret_cast<const float4*>(in + wbase + r * C + c));
      v = make_float4(gelu(v.x + yv.x), gelu(v.y + yv.y), gelu(v.z + yv.z), gelu(v.w + yv.w));
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
    if (valid) {
      const float* gs = gn_scales + s * C;
      const float* gb = gn_biases + s * C;
#pragma unroll 4
      for (int k = 0; k < E::kSteps; ++k) {
        const int f = j + E::kGroup * k, r = f / (C / 4), c = (f % (C / 4)) * 4;
        const float4 v = *reinterpret_cast<const float4*>(yw + r * L::kLdF + c);
        const float4 g = __ldg(reinterpret_cast<const float4*>(gs + c));
        const float4 bias = __ldg(reinterpret_cast<const float4*>(gb + c));
        *reinterpret_cast<float4*>(out + wbase + r * C + c) =
            make_float4((v.x - mean) * rstd * g.x + bias.x, (v.y - mean) * rstd * g.y + bias.y,
                        (v.z - mean) * rstd * g.z + bias.z, (v.w - mean) * rstd * g.w + bias.w);
      }
    }
    __syncthreads();  // the stage's output is whole; nobody reads the staging area any more
  }
}

template <int T, int C>
cudaError_t launch(const float* x, const __nv_bfloat16* w, const float* gs, const float* gb,
                   float* out, int batch, Stages stages, int windows_per_block, int smem_bytes,
                   cudaStream_t stream) {
  using L = TcConv<T, C, 3>;
  // the caller's plan (ops/conv_kernel.py::tc_plan) must be this instantiation's
  if (windows_per_block != L::kWindows || smem_bytes != (int)L::kSmem) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(temporal_chain_tc_kernel<T, C>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::kSmem);
  if (err != cudaSuccess) return err;
  const int blocks = (batch + L::kWindows - 1) / L::kWindows;
  temporal_chain_tc_kernel<T, C><<<blocks, L::kThreads, L::kSmem, stream>>>(x, w, gs, gb, out,
                                                                           batch, stages);
  return cudaGetLastError();
}

}  // namespace

// x, out: [batch, t_len, channels]; w: [n_stages, 2 convs, 2 planes (hi, lo),
// 5, C, C] bf16; gs, gb: [n_stages, C]; dilations: n_stages ints.
// Supported: n_stages in 1..4, t_len in {8, 16, 32}, channels in {64, 128,
// 256}. windows_per_block and smem_bytes: the wrapper's plan, which must
// match the instantiation's (else cudaErrorInvalidValue).
extern "C" int vge_temporal_chain(int device, const float* x, const void* w, const float* gs,
                                  const float* gb, float* out, int batch, int t_len, int channels,
                                  int n_stages, const int* dilations, int windows_per_block,
                                  int smem_bytes, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n_stages < 1 || n_stages > kMaxStages) return (int)cudaErrorInvalidValue;
  if (batch == 0) return (int)cudaSuccess;
  Stages stages{n_stages, {1, 1, 1, 1}};
  for (int s = 0; s < n_stages; ++s) stages.dilation[s] = dilations[s];
  const auto* wb = static_cast<const __nv_bfloat16*>(w);
  return (int)with_shape(t_len, channels, [&](auto t, auto c) {
    return launch<decltype(t)::value, decltype(c)::value>(x, wb, gs, gb, out, batch, stages,
                                                          windows_per_block, smem_bytes, stream);
  });
}
