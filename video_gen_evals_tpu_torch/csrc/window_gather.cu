// Window gather of the scoring path (K1), and its 8-row sub-block form (K2).
//
// Replaces: video_gen_evals_tpu/ops/window_kernel.py::pallas_gather_windows_burst
// (K1; ::pallas_gather_windows gives the same output only where the window's
// base row is a multiple of 8, see K2 below).
//
// For window b of video v = video_idx[b]:
//   rows_v = row_limit[v] + 1
//   s      = clip(starts[b], 0, max(rows_v - clip_len, 0))
//   base   = clip(offsets[v] + s, 0, n_rows - clip_len)
//   out[b] = bank[base : base + clip_len, :]
//   out[b, 0, one_pass_raw : one_pass_raw + d_diff] = z0
// The start clip is the sliced/burst form (features.py gather_windows_sliced,
// window_kernel.py:159-161); the outer clip is lax.gather's CLIP mode. Video
// indices outside [0, n_videos) clamp, as JAX's gathers do.
//
// Bound on the H100: bytes. The sentinel-padded bank makes each window one
// contiguous run of clip_len * D floats, so the kernel is a batched copy:
// 2 * B * clip_len * D * 4 bytes read and written (340 MB at B = 512,
// clip_len = 32, D = 2596) against 3.35 TB/s of HBM. The TPU kernel's 8-row and 128-lane contract does
// not apply: offsets and starts are arbitrary and D keeps its true width.
//
// Design: one block per window streams its run with 16-byte loads and stores
// whenever the run and the output window start on 16-byte boundaries (true
// for every base when D % 4 == 0, as for D = 2596 and 5156), scalar ones
// otherwise. After a block barrier the same block overwrites row 0's diff
// block with z0, so the two writes are ordered without a second launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ long long clamp_ll(long long v, long long lo, long long hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__global__ void __launch_bounds__(kThreads) gather_windows_kernel(
    const float* __restrict__ bank, long long n_rows, int d,
    const int* __restrict__ offsets, const int* __restrict__ row_limit,
    int n_videos, const float* __restrict__ z0, int one_pass_raw, int d_diff,
    const int* __restrict__ video_idx, const int* __restrict__ starts,
    int clip_len, float* __restrict__ out) {
  const int b = blockIdx.x;
  const int v = (int)clamp_ll(video_idx[b], 0, n_videos - 1);
  const long long rows_v = (long long)row_limit[v] + 1;
  const long long hi = rows_v - clip_len > 0 ? rows_v - clip_len : 0;
  const long long s = clamp_ll(starts[b], 0, hi);
  const long long base = clamp_ll((long long)offsets[v] + s, 0, n_rows - clip_len);

  const long long n = (long long)clip_len * d;
  const float* src = bank + base * d;
  float* dst = out + (long long)b * n;
  const uintptr_t addr_bits =
      reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(dst);
  if ((n & 3) == 0 && (addr_bits & 15) == 0) {
    const float4* src4 = reinterpret_cast<const float4*>(src);
    float4* dst4 = reinterpret_cast<float4*>(dst);
    const long long n4 = n >> 2;
    for (long long i = threadIdx.x; i < n4; i += blockDim.x) {
      dst4[i] = __ldg(src4 + i);
    }
  } else {
    for (long long i = threadIdx.x; i < n; i += blockDim.x) {
      dst[i] = __ldg(src + i);
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < d_diff; j += blockDim.x) {
    dst[one_pass_raw + j] = z0[j];
  }
}


// K2. Replaces: video_gen_evals_tpu/ops/window_kernel.py::pallas_gather_windows
// (_copy_kernel over a (window, 8-row sub-block) grid).
//
// K1's function with the window's base floored to a multiple of 8 rows, as
// the TPU kernel's 8-row block index does:
//   base    = ((offsets[v] + s) / 8) * 8        (s clipped as in K1)
//   row r0j = clip(base + 8 j, 0, n_rows - 8)   for sub-block j of the window
//   out[b, 8 j : 8 j + 8, :out_dim] = bank[r0j : r0j + 8, :out_dim]
//   out[b, 0, one_pass_raw : one_pass_raw + d_diff] = z0
// A clipped start that is not a multiple of 8 therefore reads from the
// aligned row below it, where K1 reads from the start itself. The per
// sub-block clip keeps every read inside the bank (the clamp a block index
// past the end gets in Pallas' interpret mode). The TPU's 128-lane padding
// of the bank does not carry over: d is the bank's row stride and out_dim
// (<= d) the width written.
//
// Bound on the H100: bytes, as K1 (2 * B * clip_len * out_dim * 4 bytes).
// Design: one block per (window, sub-block), grid (B, clip_len / 8); the
// block copies its 8 rows with 16-byte loads and stores where d, out_dim
// and both pointers allow it, scalar ones otherwise; the block of sub-block 0
// then writes z0 over row 0's diff block behind a block barrier.
__global__ void __launch_bounds__(kThreads) gather_subblock_kernel(
    const float* __restrict__ bank, long long n_rows, int d, int out_dim,
    const int* __restrict__ offsets, const int* __restrict__ row_limit,
    int n_videos, const float* __restrict__ z0, int one_pass_raw, int d_diff,
    const int* __restrict__ video_idx, const int* __restrict__ starts,
    int clip_len, float* __restrict__ out) {
  constexpr int kRows = 8;
  const int b = blockIdx.x;
  const int j = blockIdx.y;
  const int v = (int)clamp_ll(video_idx[b], 0, n_videos - 1);
  const long long rows_v = (long long)row_limit[v] + 1;
  const long long hi = rows_v - clip_len > 0 ? rows_v - clip_len : 0;
  const long long s = clamp_ll(starts[b], 0, hi);
  const long long base = ((long long)offsets[v] + s) / kRows * kRows;
  const long long r0 = clamp_ll(base + (long long)kRows * j, 0, n_rows - kRows);

  const float* src = bank + r0 * d;
  float* dst = out + ((long long)b * clip_len + (long long)kRows * j) * out_dim;
  const uintptr_t addr_bits =
      reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(dst);
  if ((d & 3) == 0 && (out_dim & 3) == 0 && (addr_bits & 15) == 0) {
    const int w4 = out_dim >> 2, d4 = d >> 2;
    const float4* src4 = reinterpret_cast<const float4*>(src);
    float4* dst4 = reinterpret_cast<float4*>(dst);
    for (int i = threadIdx.x; i < kRows * w4; i += blockDim.x) {
      const int r = i / w4;
      dst4[i] = __ldg(src4 + r * d4 + (i - r * w4));
    }
  } else {
    for (int i = threadIdx.x; i < kRows * out_dim; i += blockDim.x) {
      const int r = i / out_dim;
      dst[i] = __ldg(src + (long long)r * d + (i - r * out_dim));
    }
  }
  if (j == 0) {
    __syncthreads();
    for (int k = threadIdx.x; k < d_diff; k += blockDim.x) dst[one_pass_raw + k] = z0[k];
  }
}

}  // namespace

extern "C" int vge_gather_windows(
    int device, const float* bank, long long n_rows, int d,
    const int* offsets, const int* row_limit, int n_videos, const float* z0,
    int one_pass_raw, int d_diff, const int* video_idx, const int* starts,
    int batch, int clip_len, float* out, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (batch == 0) return (int)cudaSuccess;
  gather_windows_kernel<<<batch, kThreads, 0, stream>>>(
      bank, n_rows, d, offsets, row_limit, n_videos, z0, one_pass_raw, d_diff,
      video_idx, starts, clip_len, out);
  return (int)cudaGetLastError();
}

// K2: clip_len % 8 == 0, n_rows >= 8, out_dim <= d.
extern "C" int vge_gather_windows_subblock(
    int device, const float* bank, long long n_rows, int d, int out_dim,
    const int* offsets, const int* row_limit, int n_videos, const float* z0,
    int one_pass_raw, int d_diff, const int* video_idx, const int* starts,
    int batch, int clip_len, float* out, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (clip_len % 8 != 0 || n_rows < 8 || out_dim > d) return (int)cudaErrorInvalidValue;
  if (batch == 0) return (int)cudaSuccess;
  gather_subblock_kernel<<<dim3(batch, clip_len / 8), kThreads, 0, stream>>>(
      bank, n_rows, d, out_dim, offsets, row_limit, n_videos, z0, one_pass_raw, d_diff,
      video_idx, starts, clip_len, out);
  return (int)cudaGetLastError();
}

extern "C" const char* vge_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
