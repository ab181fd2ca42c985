// Device helpers shared by the fused conv-stage kernels (temporal_block.cu,
// temporal_block_train.cu, temporal_chain.cu), two bodies:
// - tc_conv (tensor cores): the conv over several windows a block as bf16
//   mma.sync products with fp32 sums, for K3, K9 and K10 at "high" (bf16x3,
//   three products a term) and K4 at "default" (forward and backward, one
//   product). See the comment above TcConv.
// - fma_conv (CUDA cores): the conv over several windows a block in fp32,
//   weights through a shared-memory ring, register-tiled outer products, for
//   K3 and K4 (forward and backward) at "highest". See the comment above
//   FmaConv; fma_block_kernel is the fused stage forward of K3 and K4 on it.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {


constexpr int kTaps = 5;

__device__ __forceinline__ float gelu(float v) {
  return 0.5f * v * (1.0f + erff(v * 0.70710678118654752440f));
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// ---------------------------------------------------------------------------
// Tensor-core body: acc[r, co] = sum_j sum_ci in[r + (j - 2) d, ci] * w[j, ci, co]
// for the kRows rows of the block's W = kRows / T windows, on mma.sync
// m16n8k16 (bf16 operands, fp32 sums), with P products a term: hi*whi at
// P = 1 (K4 at "default", one rounded plane), hi*whi + hi*wlo + lo*whi at
// P = 3 (K3, K9 and K10 at "high", hi and lo planes; K10 sums the two small
// products first, tc_conv_small_first). Products of bf16 values are exact in
// fp32, so only the order and the rounding of the sums differ from the plain
// versions.
//
// Operands. The conv input sits in shared memory as bf16 planes of kRows
// rows and one zero row, at a pitch of C + 8 elements (ldmatrix's eight
// 16-byte rows then fall in distinct banks). A comes through ldmatrix.x4 into
// registers, and each lane names its own row: the row t + o of its window,
// or the zero row when t + o lies outside [0, T) or the window lies past the
// batch. So a tap's shift never crosses a window and no halo is stored. The
// weights stream through a ring of kStages stages of kKc input channels
// (every plane) by 16-byte cp.async, issued kStages - 1 stages ahead, and
// come to the B operand through ldmatrix.x4.trans. Taps with |o| >= T are
// skipped.
//
// Warps. 8 warps, kWM x kWN over [kRows, C]: each warp owns 64 columns and
// kWarpRows rows (64, 32, 16 at C = 256, 128, 64), kMT x 8 accumulator tiles
// (128 fp32 registers a thread at C = 256). At P = 3 the A fragments of one
// plane at a time are in registers (hi*whi and hi*wlo, then lo*whi). A block
// owns whole windows, so a GroupNorm over a window's rows is a reduction over
// the window's threads (window_sum), after the accumulators have gone to an
// fp32 staging area in shared memory (tc_stage_acc, tc_store_planes) and the
// epilogues run element-wise on it (TcEpi).
//
// Weight traffic: every block reads all the weights of a conv once; W
// windows a block divide the bytes read from L2 a launch by W against one
// window a block (at T = 32, C = 256: W = 4).
template <int T, int C, int P>
struct TcConv {
  static_assert(P == 1 || P == 3, "one or three bf16 products a term");
  static constexpr int kRows = 128;                  // rows a block
  static constexpr int kWindows = kRows / T;         // W
  static constexpr int kPlanes = P == 3 ? 2 : 1;     // hi (and lo) planes of input and weights
  // 8 warps (128 accumulators a thread at C = 256). 16 warps ran K3 8%
  // faster on an H100 but spilled at their 128-register cap.
  static constexpr int kWarps = 8;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kWN = C / 64;                 // warps across the columns
  static constexpr int kWM = kWarps / kWN;           // warps across the rows
  static constexpr int kWarpRows = kRows / kWM;
  static constexpr int kMT = kWarpRows / 16;         // m16 tiles a warp
  static_assert(kMT >= 1, "a warp owns at least 16 rows");
  static constexpr int kNT = 8;                      // n8 tiles a warp
  static constexpr int kLd = C + 8;                  // bf16 elements a shared row
  static constexpr int kPlaneElems = (kRows + 1) * kLd;
  // the weight ring: as deep as the shared memory beside the planes allows
  // (P = 3: 5 stages of 16 input channels; P = 1: 4 stages of 64, whose
  // bytes equal an fp32 [kRows, C + 8] staging area)
  static constexpr int kKc = P == 3 ? 16 : 64;       // input channels a weight stage
  static constexpr int kStages = P == 3 ? 5 : 4;
  static constexpr int kStageElems = kPlanes * kKc * kLd;
  static constexpr int kRedFloats = kWarps;
  static constexpr size_t kSmem =
      (size_t)(kPlanes * kPlaneElems + kStages * kStageElems) * 2 + kRedFloats * 4;
  // the fp32 staging area of the element-wise epilogues (tc_stage_acc)
  static constexpr int kLdF = C + 8;
  static constexpr size_t kStageBytes = (size_t)kRows * kLdF * 4;
};

// The element-wise epilogues: a window's kGroup = 2T threads (thread j of
// the window threadIdx.x / 2T, 256 threads a block) visit its float4s f = j +
// 2T k, k < C / 8: row f / (C / 4), column (f % (C / 4)) * 4, so neighbouring
// threads touch neighbouring 16 bytes. kShare threads share a channel of the
// window (each owns rows slab, slab + kShare, ..., slab = j / (C / 4)); with
// kShare = 1 a thread owns kColGroups float4 columns over all T rows.
template <int T, int C>
struct TcEpi {
  static constexpr int kGroup = 2 * T;
  static constexpr int kSteps = C / 8;
  static constexpr int kShare = 8 * T > C ? 8 * T / C : 1;
  static constexpr int kColGroups = 8 * T > C ? 1 : C / (8 * T);
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}

// 16 bytes, or zeros when !valid (the source is then not read)
__device__ __forceinline__ void cp_async16_zfill(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// two floats as round-to-nearest-even bf16, the first at the lower address
__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// four floats as bf16 (round to nearest even), the first at the lowest address
__device__ __forceinline__ uint2 pack4_bf16(float4 v) {
  return make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
}

// The block's rows of a [rows, C] fp32 input (x points at its first row) into
// the planes: rounded to bf16, or split into hi and lo; also the zero rows.
// Rows from valid_rows on are not read (the lanes' addresses send them to the
// zero row). With xb, the rounded rows also go to device memory. kL2: x is
// read through L2 only (ld.global.cg), for rows the block itself wrote
// earlier in the launch (K10's stage outputs), which the read-only path
// (__ldg) need not see.
template <int T, int C, int P, bool kL2 = false>
__device__ __forceinline__ void tc_load_input(__nv_bfloat16* planes, const float* __restrict__ x,
                                              int valid_rows, __nv_bfloat16* __restrict__ xb) {
  using L = TcConv<T, C, P>;
#pragma unroll 4
  for (int i = threadIdx.x; i < L::kRows * C / 4; i += L::kThreads) {
    const int r = i / (C / 4), c = (i % (C / 4)) * 4;
    if (r < valid_rows) {
      const float4* src = reinterpret_cast<const float4*>(x + (size_t)r * C + c);
      const float4 v = kL2 ? __ldcg(src) : __ldg(src);
      const uint2 hi = make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
      *reinterpret_cast<uint2*>(planes + r * L::kLd + c) = hi;
      if constexpr (L::kPlanes == 2) {
        *reinterpret_cast<uint2*>(planes + L::kPlaneElems + r * L::kLd + c) =
            make_uint2(pack_bf16(v.x - bf16_round(v.x), v.y - bf16_round(v.y)),
                       pack_bf16(v.z - bf16_round(v.z), v.w - bf16_round(v.w)));
      }
      if (xb != nullptr) *reinterpret_cast<uint2*>(xb + (size_t)r * C + c) = hi;
    }
  }
  for (int i = threadIdx.x; i < L::kPlanes * C / 8; i += L::kThreads) {
    const int p = i / (C / 8), c = (i % (C / 8)) * 8;
    *reinterpret_cast<uint4*>(planes + p * L::kPlaneElems + L::kRows * L::kLd + c) =
        make_uint4(0u, 0u, 0u, 0u);
  }
}

// op(accumulator) (the next conv's input) into the planes, split into hi and
// lo, through an fp32 staging area of half the rows at ys: the warps of each
// half of the rows stage their accumulators in turn, and every thread then
// applies op and splits four staged values at a time (which keeps op's
// temporaries few beside the accumulators). The caller has made sure no warp
// still reads the planes or the staging area.
template <int T, int C, int P, typename Op>
__device__ __forceinline__ void tc_store_planes(
    __nv_bfloat16* planes, float* ys,
    const float (&acc)[TcConv<T, C, P>::kMT][TcConv<T, C, P>::kNT][4], Op op) {
  using L = TcConv<T, C, P>;
  constexpr int kHalf = L::kRows / 2;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp / L::kWN;
  const int row0 = (wm % (L::kWM / 2)) * L::kWarpRows + (lane >> 2);  // inside the half
  const int col0 = (warp % L::kWN) * 64 + 2 * (lane & 3);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    if (wm / (L::kWM / 2) == half) {
#pragma unroll
      for (int mt = 0; mt < L::kMT; ++mt) {
#pragma unroll
        for (int nt = 0; nt < L::kNT; ++nt) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            *reinterpret_cast<float2*>(ys + (row0 + mt * 16 + h * 8) * L::kLdF + col0 + nt * 8) =
                make_float2(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
          }
        }
      }
    }
    __syncthreads();
#pragma unroll 2
    for (int f = threadIdx.x; f < kHalf * C / 4; f += L::kThreads) {
      const int r = f / (C / 4), c = (f % (C / 4)) * 4;
      const float4 s = *reinterpret_cast<const float4*>(ys + r * L::kLdF + c);
      const float4 v = make_float4(op(s.x), op(s.y), op(s.z), op(s.w));
      const int at = (half * kHalf + r) * L::kLd + c;
      *reinterpret_cast<uint2*>(planes + at) = pack4_bf16(v);
      if constexpr (L::kPlanes == 2) {
        *reinterpret_cast<uint2*>(planes + L::kPlaneElems + at) = pack4_bf16(
            make_float4(v.x - bf16_round(v.x), v.y - bf16_round(v.y), v.z - bf16_round(v.z),
                        v.w - bf16_round(v.w)));
      }
    }
    __syncthreads();
  }
}

// One weight stage: input channels ci0 .. ci0 + kKc of tap j, kLoad planes.
template <int T, int C, int P, int kLoad, int kKc>
__device__ __forceinline__ void tc_load_stage(__nv_bfloat16* dst, const __nv_bfloat16* __restrict__ w,
                                              size_t w_plane, int j, int ci0) {
  using L = TcConv<T, C, P>;
  constexpr int kPieces = kKc * C / 8;  // 16-byte pieces a plane
#pragma unroll
  for (int i = threadIdx.x; i < kLoad * kPieces; i += L::kThreads) {
    const int p = i / kPieces, e = i % kPieces;
    const int r = e / (C / 8), c = (e % (C / 8)) * 8;
    cp_async16(smem_u32(dst + (p * kKc + r) * L::kLd + c),
               w + p * w_plane + (size_t)(j * C + ci0 + r) * C + c);
  }
}

// Which products of each term a pass of tc_conv_terms adds: all P of them,
// or at P = 3 the two small ones (hi*wlo + lo*whi) or the large one (hi*whi).
enum TcTerms { kAllTerms, kSmallTerms, kLargeTerm };

template <int T, int C, int P>
__device__ __forceinline__ void tc_zero(float (&acc)[TcConv<T, C, P>::kMT][TcConv<T, C, P>::kNT][4]) {
  using L = TcConv<T, C, P>;
#pragma unroll
  for (int mt = 0; mt < L::kMT; ++mt) {
#pragma unroll
    for (int nt = 0; nt < L::kNT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.0f;
    }
  }
}

// acc += the kTerms products of conv(planes, w) over the block's rows (see
// TcConv). w: kPlanes planes of [5, C, C] bf16, w_plane elements apart.
// valid_rows: the rows of windows inside the batch. The large term's pass
// streams the hi weight plane alone, twice the input channels a stage in the
// same ring. Ends with a barrier, after which the planes and the ring are
// free.
template <int T, int C, int P, int kTerms>
__device__ __forceinline__ void tc_conv_terms(
    float (&acc)[TcConv<T, C, P>::kMT][TcConv<T, C, P>::kNT][4], const __nv_bfloat16* planes,
    __nv_bfloat16* ring, const __nv_bfloat16* __restrict__ w, size_t w_plane, int dilation,
    int valid_rows) {
  using L = TcConv<T, C, P>;
  static_assert(kTerms == kAllTerms || P == 3, "a pass of some terms needs the split planes");
  constexpr int kLoad = kTerms == kLargeTerm ? 1 : L::kPlanes;   // weight planes a stage
  constexpr int kKc = L::kKc * L::kPlanes / kLoad;                // input channels a stage
  constexpr int kChunks = C / kKc;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp / L::kWN, wn = warp % L::kWN;
  // taps 2 - m .. 2 + m reach inside the window
  const int m = min(kTaps / 2, (T - 1) / dilation);
  const int n_stages = (2 * m + 1) * kChunks;
  const uint32_t plane_s = smem_u32(planes);
  // the lane's ldmatrix row (A) and column (B) inside a 16 x 16 piece
  const uint32_t b_lane =
      smem_u32(ring) + ((lane & 15) * L::kLd + wn * 64 + (lane >> 4) * 8) * 2;
#pragma unroll
  for (int s = 0; s < L::kStages - 1; ++s) {
    if (s < n_stages)
      tc_load_stage<T, C, P, kLoad, kKc>(ring + s * L::kStageElems, w, w_plane, 2 - m + s / kChunks,
                                         (s % kChunks) * kKc);
    cp_async_commit();
  }
  uint32_t a_row[L::kMT];
  int stage = 0;
  for (int s = 0; s < n_stages; ++s) {
    cp_async_wait<L::kStages - 2>();
    __syncthreads();  // stage s has landed everywhere; stage s - 1 is free
    {
      const int sn = s + L::kStages - 1;
      if (sn < n_stages) {
        const int slot = stage == 0 ? L::kStages - 1 : stage - 1;
        tc_load_stage<T, C, P, kLoad, kKc>(ring + slot * L::kStageElems, w, w_plane,
                                           2 - m + sn / kChunks, (sn % kChunks) * kKc);
      }
      cp_async_commit();
    }
    const int chunk = s % kChunks;
    if (chunk == 0) {  // a new tap: each lane's shifted row, or the zero row
      const int o = (s / kChunks - m) * dilation;
#pragma unroll
      for (int mt = 0; mt < L::kMT; ++mt) {
        const int r = wm * L::kWarpRows + mt * 16 + (lane & 15);
        const int t = r % T;
        const int src = (r < valid_rows && t + o >= 0 && t + o < T) ? r + o : L::kRows;
        a_row[mt] = plane_s + (src * L::kLd + (lane >> 4) * 8) * 2;
      }
    }
#pragma unroll
    for (int kk = 0; kk < kKc / 16; ++kk) {
      const uint32_t a_col = (chunk * kKc + kk * 16) * 2;
      const uint32_t b_step = b_lane + (stage * L::kStageElems + kk * 16 * L::kLd) * 2;
      uint32_t a[L::kMT][4];
#pragma unroll
      for (int mt = 0; mt < L::kMT; ++mt) ldsm_x4(a[mt], a_row[mt] + a_col);
      if constexpr (P == 1 || kTerms == kLargeTerm) {
        // the next 16 columns' weights load ahead of this step's products
        uint32_t b[2][4];
        ldsm_x4_trans(b[0], b_step);
#pragma unroll
        for (int np = 0; np < L::kNT / 2; ++np) {
          if (np + 1 < L::kNT / 2) ldsm_x4_trans(b[(np + 1) & 1], b_step + (np + 1) * 16 * 2);
#pragma unroll
          for (int mt = 0; mt < L::kMT; ++mt) {
            mma_bf16(acc[mt][2 * np], a[mt], b[np & 1][0], b[np & 1][1]);
            mma_bf16(acc[mt][2 * np + 1], a[mt], b[np & 1][2], b[np & 1][3]);
          }
        }
      } else if constexpr (kTerms == kSmallTerms) {
        // hi*wlo, then lo*whi: one A plane in registers at a time
        constexpr uint32_t kLoW = kKc * L::kLd * 2;  // bytes from a stage's hi to its lo plane
#pragma unroll
        for (int np = 0; np < L::kNT / 2; ++np) {
          uint32_t bl[4];
          ldsm_x4_trans(bl, b_step + kLoW + np * 16 * 2);
#pragma unroll
          for (int mt = 0; mt < L::kMT; ++mt) {
            mma_bf16(acc[mt][2 * np], a[mt], bl[0], bl[1]);
            mma_bf16(acc[mt][2 * np + 1], a[mt], bl[2], bl[3]);
          }
        }
#pragma unroll
        for (int mt = 0; mt < L::kMT; ++mt) ldsm_x4(a[mt], a_row[mt] + L::kPlaneElems * 2 + a_col);
#pragma unroll
        for (int np = 0; np < L::kNT / 2; ++np) {
          uint32_t bh[4];
          ldsm_x4_trans(bh, b_step + np * 16 * 2);
#pragma unroll
          for (int mt = 0; mt < L::kMT; ++mt) {
            mma_bf16(acc[mt][2 * np], a[mt], bh[0], bh[1]);
            mma_bf16(acc[mt][2 * np + 1], a[mt], bh[2], bh[3]);
          }
        }
      } else {
        // hi*whi and hi*wlo, then lo*whi: one A plane in registers at a time
        constexpr uint32_t kLoW = kKc * L::kLd * 2;  // bytes from a stage's hi to its lo plane
#pragma unroll
        for (int np = 0; np < L::kNT / 2; ++np) {
          uint32_t bh[4], bl[4];
          ldsm_x4_trans(bh, b_step + np * 16 * 2);
          ldsm_x4_trans(bl, b_step + kLoW + np * 16 * 2);
#pragma unroll
          for (int mt = 0; mt < L::kMT; ++mt) {
            mma_bf16(acc[mt][2 * np], a[mt], bh[0], bh[1]);
            mma_bf16(acc[mt][2 * np + 1], a[mt], bh[2], bh[3]);
          }
#pragma unroll
          for (int mt = 0; mt < L::kMT; ++mt) {
            mma_bf16(acc[mt][2 * np], a[mt], bl[0], bl[1]);
            mma_bf16(acc[mt][2 * np + 1], a[mt], bl[2], bl[3]);
          }
        }
#pragma unroll
        for (int mt = 0; mt < L::kMT; ++mt) ldsm_x4(a[mt], a_row[mt] + L::kPlaneElems * 2 + a_col);
#pragma unroll
        for (int np = 0; np < L::kNT / 2; ++np) {
          uint32_t bh[4];
          ldsm_x4_trans(bh, b_step + np * 16 * 2);
#pragma unroll
          for (int mt = 0; mt < L::kMT; ++mt) {
            mma_bf16(acc[mt][2 * np], a[mt], bh[0], bh[1]);
            mma_bf16(acc[mt][2 * np + 1], a[mt], bh[2], bh[3]);
          }
        }
      }
    }
    stage = stage + 1 == L::kStages ? 0 : stage + 1;
  }
  cp_async_wait<0>();
  __syncthreads();
}

// acc = conv(planes, w), all P products a term (see tc_conv_terms).
template <int T, int C, int P>
__device__ __forceinline__ void tc_conv(float (&acc)[TcConv<T, C, P>::kMT][TcConv<T, C, P>::kNT][4],
                                        const __nv_bfloat16* planes, __nv_bfloat16* ring,
                                        const __nv_bfloat16* __restrict__ w, size_t w_plane,
                                        int dilation, int valid_rows) {
  tc_zero<T, C, P>(acc);
  tc_conv_terms<T, C, P, kAllTerms>(acc, planes, ring, w, w_plane, dilation, valid_rows);
}

// acc = conv(planes, w) at P = 3, the two small products of every term summed
// first and the large one last. The tensor cores round each mma's fp32 sum
// toward zero, an error of about an ulp of the accumulator: here only the 80
// large-term mmas a conv output (C = 256) round at the output's own
// magnitude, and the 160 small-term ones at 2^-8 of it, where tc_conv's
// interleaved order rounds all 240 at the output's magnitude.
template <int T, int C>
__device__ __forceinline__ void tc_conv_small_first(
    float (&acc)[TcConv<T, C, 3>::kMT][TcConv<T, C, 3>::kNT][4], const __nv_bfloat16* planes,
    __nv_bfloat16* ring, const __nv_bfloat16* __restrict__ w, size_t w_plane, int dilation,
    int valid_rows) {
  tc_zero<T, C, 3>(acc);
  tc_conv_terms<T, C, 3, kSmallTerms>(acc, planes, ring, w, w_plane, dilation, valid_rows);
  tc_conv_terms<T, C, 3, kLargeTerm>(acc, planes, ring, w, w_plane, dilation, valid_rows);
}

// The accumulators as fp32 rows of kLdF floats at ys, for the element-wise
// epilogues. The caller has made sure no one still reads that region.
template <int T, int C, int P>
__device__ __forceinline__ void tc_stage_acc(
    float* ys, const float (&acc)[TcConv<T, C, P>::kMT][TcConv<T, C, P>::kNT][4]) {
  using L = TcConv<T, C, P>;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row0 = (warp / L::kWN) * L::kWarpRows + (lane >> 2);
  const int col0 = (warp % L::kWN) * 64 + 2 * (lane & 3);
#pragma unroll
  for (int mt = 0; mt < L::kMT; ++mt) {
#pragma unroll
    for (int nt = 0; nt < L::kNT; ++nt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        *reinterpret_cast<float2*>(ys + (row0 + mt * 16 + h * 8) * L::kLdF + col0 + nt * 8) =
            make_float2(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
      }
    }
  }
}

// The sum of v over the 2T threads of a window (TcEpi); every one of them
// gets the same value, summed in a fixed order. red: a float a warp.
template <int T>
__device__ __forceinline__ float window_sum(float v, float* red) {
  constexpr int kGroup = 2 * T;
#pragma unroll
  for (int off = (kGroup < 32 ? kGroup : 32) / 2; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  if constexpr (kGroup > 32) {  // two warps a window
    const int warp = threadIdx.x >> 5;
    if ((threadIdx.x & 31) == 0) red[warp] = v;
    __syncthreads();
    v = red[warp & ~1] + red[warp | 1];
    __syncthreads();  // red is reused by the next call
  }
  return v;
}

// ---------------------------------------------------------------------------
// FMA body: acc[r, co] = sum_j sum_ci in[r + (j - 2) d, ci] * w[j, ci, co] for
// the kRows = 128 rows of the block's W = 128 / T windows, fp32 products and
// fp32 sums on the CUDA cores (K3, K4's forward and K4's backward at
// "highest").
//
// Bound: the fp32 FMA rate. An SM sub-partition issues one warp instruction a
// cycle, and an FFMA takes a full issue slot, so every shared-memory load
// costs an FMA; each load has to feed many of them.
// - Threads. 256 threads in a 16 x 16 grid (ty, tx); a warp covers 4 ty x 8
//   tx (fma_ty, fma_tx). Thread (ty, tx) owns rows ty + 16 i (i < 8) and the
//   float4 column groups tx * 4 + 64 q (q < C / 64): an 8 x 16 register tile
//   at C = 256 (128 accumulators).
// - The conv input sits in shared memory row-major, [kRows + 1][C + 1] fp32.
//   An input channel costs 8 scalar loads of the input (one a row, at any
//   tap shift) and C / 64 16-byte loads of the weights for 32 C / 64 FMAs
//   (12 loads for 128 FMAs at C = 256); a warp's loads are 4 distinct words
//   and 8 distinct float4s. The odd pitch puts a warp's 4 rows, and its
//   scalar stores of 4 rows x 32 columns, in distinct banks, and it keeps the
//   compiler from merging a row's loads of neighbouring channels into 16-byte
//   loads, whose 32 registers of fragments beside the 128 accumulators made
//   the kernel spill and run 10-13% slower on an H100. Row kRows holds
//   zeros. Each lane resolves, once a tap, row t + o of its own window, or
//   the zero row when t + o lies outside [0, T) or the row lies past the
//   batch: so a tap never crosses a window and no halo is stored. Taps with
//   |o| >= T are skipped.
// - Rows that read the zero row are skipped where a whole warp agrees. At
//   T = 32 a thread's rows are t = ty (even i) and ty + 16 (odd i) of each
//   window, so at a shift o that is a multiple of 4 every lane of a warp finds
//   the same rows inside the window: all, the even ones, the odd ones or none
//   (at d = 8 the taps o = +-16 keep half the rows for every warp, o = +-8
//   for half the warps). fma_conv runs a stage body for that set, decided
//   once a tap; a warp whose lanes differ runs all 8 rows. Warp w holds warp
//   row wy = w / 2 and warp column wx = w % 2, so the two warps on each SM
//   sub-partition (w and w + 4) are warp rows wy and wy + 2: the halved work
//   of the taps o = +-8 falls on every sub-partition alike (1.5 warps' FMAs
//   each), and the stage's barrier waits for none of them.
// - The weights stream through a ring of kStages stages of kKc input channels
//   ([kKc][C] fp32) by 16-byte cp.async, issued kStages - 1 stages ahead, as
//   tc_conv's ring does; every block reads each conv's weights from L2 once per
//   W windows (0.34 GB for K3's 512 windows, 1.34 GB at one window a block).
// - Epilogues in shared memory: the accumulators go to the tile
//   (fma_store_input), whose input the conv no longer needs, and the
//   element-wise epilogues (GELU and its derivative, GroupNorm and its
//   backward) run there (fma_epilogue), a window's 2T threads on whole
//   columns of it, the window's sums by window_sum in a fixed order; the
//   next conv's input is written in place. In registers beside the 128
//   accumulators the erf and exp of the epilogues spilled.
// No atomics and every sum in a fixed order: two calls give the same bits.
template <int T, int C>
struct FmaConv {
  static constexpr int kRows = 128;                  // rows a block
  static constexpr int kWindows = kRows / T;         // W
  static constexpr int kThreads = 256;
  static constexpr int kTX = 16;                     // tx of the 16 x 16 grid
  static constexpr int kRM = 8;                      // rows a thread: ty + 16 i
  static constexpr int kColStep = 4 * kTX;           // columns between a thread's float4s
  static constexpr int kNQ = C / kColStep;           // float4 columns a thread: tx * 4 + kColStep q
  static constexpr int kCols = 4 * kNQ;
  static constexpr int kLd = C + 1;                  // floats a row of the input tile
  // the ring follows the tile, on 16 bytes
  static constexpr int kTileFloats = ((kRows + 1) * kLd + 3) / 4 * 4;
  static constexpr int kKc = 16;                     // input channels a weight stage
  static constexpr int kStages = 4;
  static constexpr int kStageFloats = kKc * C;
  static constexpr int kRedFloats = kThreads / 32;    // window_sum: a float a warp
  static constexpr size_t kSmem = (size_t)(kTileFloats + kStages * kStageFloats + kRedFloats) * 4;
};

// the 16 x 16 grid of 256 threads: warp w is warp column w % 2 (tx / 8) and
// warp row w / 2 (ty / 4); lane l is tx % 8 = l % 8 and ty % 4 = l / 8
__device__ __forceinline__ int fma_wx() { return (threadIdx.x >> 5) & 1; }
__device__ __forceinline__ int fma_wy() { return threadIdx.x >> 6; }
__device__ __forceinline__ int fma_tx() { return (fma_wx() << 3) | (threadIdx.x & 7); }
__device__ __forceinline__ int fma_ty() { return (fma_wy() << 2) | ((threadIdx.x >> 3) & 3); }

// Rows [0, valid_rows) of a [rows, C] fp32 input (x points at its first row)
// into the tile, and the zero row.
template <int T, int C>
__device__ __forceinline__ void fma_load_input(float* in, const float* __restrict__ x, int valid_rows) {
  using L = FmaConv<T, C>;
#pragma unroll 4
  for (int f = threadIdx.x; f < L::kRows * C / 4; f += L::kThreads) {
    const int r = f / (C / 4), c = (f % (C / 4)) * 4;
    if (r < valid_rows) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(x + (size_t)r * C + c));
      float* dst = in + r * L::kLd + c;
      dst[0] = v.x, dst[1] = v.y, dst[2] = v.z, dst[3] = v.w;
    }
  }
  for (int c = threadIdx.x; c < C; c += L::kThreads) in[L::kRows * L::kLd + c] = 0.0f;
}

// The thread's values (row ty + 16 i, column tx * 4 + 64 q + e at [i][4q + e])
// into the tile, as the next conv's input. The caller has made sure no one
// still reads the tile.
template <int T, int C>
__device__ __forceinline__ void fma_store_input(
    float* in, const float (&v)[FmaConv<T, C>::kRM][FmaConv<T, C>::kCols]) {
  using L = FmaConv<T, C>;
  const int tx = fma_tx(), ty = fma_ty();
#pragma unroll
  for (int i = 0; i < L::kRM; ++i) {
#pragma unroll
    for (int c = 0; c < L::kCols; ++c)
      in[(ty + 16 * i) * L::kLd + tx * 4 + L::kColStep * (c / 4) + c % 4] = v[i][c];
  }
}

// One weight stage: input channels ci0 .. ci0 + kKc of tap j, [kKc][C] fp32.
template <int T, int C>
__device__ __forceinline__ void fma_load_stage(float* dst, const float* __restrict__ w, int j, int ci0) {
  using L = FmaConv<T, C>;
  const float* src = w + (size_t)(j * C + ci0) * C;
#pragma unroll
  for (int i = threadIdx.x; i < L::kStageFloats / 4; i += L::kThreads)
    cp_async16(smem_u32(dst + 4 * i), src + 4 * i);
}

// One weight stage's kKc input channels for the rows in kRowSet (bit i: row
// ty + 16 i); src: each row's input row offset in the tile at this tap.
template <int T, int C, unsigned kRowSet>
__device__ __forceinline__ void fma_stage(float (&acc)[FmaConv<T, C>::kRM][FmaConv<T, C>::kCols],
                                          const float* a_chunk, const int (&src)[FmaConv<T, C>::kRM],
                                          const float4* b_stage) {
  using L = FmaConv<T, C>;
  // 8 channels unrolled, not all 16: a stage body of 16 is ~36 KB of code, and
  // warps running different bodies (the row sets) at once thrashed the
  // instruction cache (K3 at d = 4 read 0.70 ms at 16, 0.55 at 8 on an H100)
#pragma unroll 8
  for (int k = 0; k < L::kKc; ++k) {
    float a[L::kRM];
#pragma unroll
    for (int i = 0; i < L::kRM; ++i) {
      if (kRowSet >> i & 1u) a[i] = a_chunk[src[i] + k];
    }
#pragma unroll
    for (int q = 0; q < L::kNQ; ++q) {
      const float4 b = b_stage[k * (C / 4) + L::kTX * q];
#pragma unroll
      for (int i = 0; i < L::kRM; ++i) {
        if (!(kRowSet >> i & 1u)) continue;
        acc[i][4 * q + 0] = fmaf(a[i], b.x, acc[i][4 * q + 0]);
        acc[i][4 * q + 1] = fmaf(a[i], b.y, acc[i][4 * q + 1]);
        acc[i][4 * q + 2] = fmaf(a[i], b.z, acc[i][4 * q + 2]);
        acc[i][4 * q + 3] = fmaf(a[i], b.w, acc[i][4 * q + 3]);
      }
    }
  }
}

// acc = conv(in, w) over the block's rows (see FmaConv). w: [5, C, C] fp32 on
// 16 bytes. valid_rows: the rows of windows inside the batch. Ends with a
// barrier, after which the tile and the ring are free.
template <int T, int C>
__device__ __forceinline__ void fma_conv(float (&acc)[FmaConv<T, C>::kRM][FmaConv<T, C>::kCols],
                                         const float* in, float* ring, const float* __restrict__ w,
                                         int dilation, int valid_rows) {
  using L = FmaConv<T, C>;
  constexpr int kChunks = C / L::kKc;
#pragma unroll
  for (int i = 0; i < L::kRM; ++i) {
#pragma unroll
    for (int c = 0; c < L::kCols; ++c) acc[i][c] = 0.0f;
  }
  const int tx = fma_tx(), ty = fma_ty();
  // taps 2 - m .. 2 + m reach inside the window
  const int m = min(kTaps / 2, (T - 1) / dilation);
  const int n_stages = (2 * m + 1) * kChunks;
#pragma unroll
  for (int s = 0; s < L::kStages - 1; ++s) {
    if (s < n_stages)
      fma_load_stage<T, C>(ring + s * L::kStageFloats, w, 2 - m + s / kChunks, (s % kChunks) * L::kKc);
    cp_async_commit();
  }
  int src[L::kRM];   // the tile offset of the lane's input row of each of its rows at this tap
  unsigned rows = 0xffu;   // the rows the warp runs at this tap (bit i: row ty + 16 i)
  int stage = 0;
  for (int s = 0; s < n_stages; ++s) {
    cp_async_wait<L::kStages - 2>();
    __syncthreads();  // stage s has landed everywhere; stage s - 1 is free
    {
      const int sn = s + L::kStages - 1;
      if (sn < n_stages) {
        const int slot = stage == 0 ? L::kStages - 1 : stage - 1;
        fma_load_stage<T, C>(ring + slot * L::kStageFloats, w, 2 - m + sn / kChunks,
                             (sn % kChunks) * L::kKc);
      }
      cp_async_commit();
    }
    const int chunk = s % kChunks;
    if (chunk == 0) {  // a new tap: the row t + o of the lane's window, or the zero row
      const int o = (s / kChunks - m) * dilation;
      unsigned inside = 0;
#pragma unroll
      for (int i = 0; i < L::kRM; ++i) {
        const int r = ty + 16 * i, t = r % T;
        const bool ok = r < valid_rows && t + o >= 0 && t + o < T;
        src[i] = (ok ? r + o : L::kRows) * L::kLd;
        inside |= (unsigned)ok << i;
      }
      // a set every lane of the warp shares and a body exists for, else all rows
      const unsigned first = __shfl_sync(0xffffffffu, inside, 0);
      rows = __all_sync(0xffffffffu, inside == first) &&
                     (first == 0u || first == 0x55u || first == 0xaau) ? first : 0xffu;
    }
    const float* a_chunk = in + chunk * L::kKc;
    const float4* b_stage = reinterpret_cast<const float4*>(ring + stage * L::kStageFloats) + tx;
    if (rows == 0xffu)
      fma_stage<T, C, 0xffu>(acc, a_chunk, src, b_stage);
    else if (rows == 0x55u)
      fma_stage<T, C, 0x55u>(acc, a_chunk, src, b_stage);
    else if (rows == 0xaau)
      fma_stage<T, C, 0xaau>(acc, a_chunk, src, b_stage);
    stage = stage + 1 == L::kStages ? 0 : stage + 1;
  }
  cp_async_wait<0>();
  __syncthreads();
}

// The element-wise pass of an epilogue over the staged tile: the 2T threads
// of window w = threadIdx.x / 2T visit its T x C elements, thread j =
// threadIdx.x % 2T the columns j + 2T m (m < C / 2T) of every row, so neighbouring threads
// touch neighbouring columns and each thread owns whole columns of its window.
// f(r, c, m): r the row in the block, c the column, m its column index in the
// thread (a constant after unrolling).
template <int T, int C, typename F>
__device__ __forceinline__ void fma_epilogue(F f) {
  constexpr int kGroup = 2 * T;
  static_assert(C % kGroup == 0, "whole columns a thread");
  const int w = threadIdx.x / kGroup, j = threadIdx.x % kGroup;
#pragma unroll 2
  for (int t = 0; t < T; ++t) {
#pragma unroll
    for (int m = 0; m < C / kGroup; ++m) f(w * T + t, j + kGroup * m, m);
  }
}

// The fused stage forward at "highest" on the FMA body, W = 128 / T windows
// a block (K3 with mask == nullptr, K4's forward with its scaled keep mask):
//   d1  = GELU(conv(x, w1)) * mask        (GELU(conv(x, w1)) without a mask)
//   out = GroupNorm1(GELU(conv(d1, w2) + x)) * gn_scale + gn_bias
// w1, w2: [5, C, C] fp32. conv1's accumulators are staged in the tile and d1
// is written there in place, the mask applied before conv2 as K4's plain
// version and train_bwd_fma_kernel apply it; conv2's are staged again, the
// residual x is re-read from device memory, and GELU, the window's mean and
// variance (window_sum, a fixed order) and the affine run on the tile, a
// window's 2T threads on whole columns of it. Writes only out, no atomics:
// two calls give the same bits.
template <int T, int C>
__global__ void __launch_bounds__(FmaConv<T, C>::kThreads, 1) fma_block_kernel(
    const float* __restrict__ x, const float* __restrict__ w1, const float* __restrict__ w2,
    const float* __restrict__ gn_scale, const float* __restrict__ gn_bias,
    const float* __restrict__ mask, float* __restrict__ out, int batch, int dilation) {
  using L = FmaConv<T, C>;
  constexpr float inv_n = 1.0f / (float)(T * C);
  extern __shared__ float4 smem_f[];
  float* in = reinterpret_cast<float*>(smem_f);
  float* ring = in + L::kTileFloats;
  float* red = ring + L::kStages * L::kStageFloats;
  const int win0 = blockIdx.x * L::kWindows;
  const int valid_rows = min(L::kWindows, batch - win0) * T;
  const size_t base = (size_t)win0 * T * C;
  // the thread's window in the epilogues is inside the batch
  const bool valid = win0 + (int)threadIdx.x / (2 * T) < batch;

  fma_load_input<T, C>(in, x + base, valid_rows);
  __syncthreads();
  float acc[L::kRM][L::kCols];
  fma_conv<T, C>(acc, in, ring, w1, dilation, valid_rows);
  // d1 = GELU(conv1) * mask, in place in the tile
  fma_store_input<T, C>(in, acc);
  __syncthreads();
  fma_epilogue<T, C>([&](int r, int c, int) {
    const float h = gelu(in[r * L::kLd + c]);
    in[r * L::kLd + c] = mask != nullptr && valid ? h * __ldg(mask + base + (size_t)r * C + c) : h;
  });
  __syncthreads();
  fma_conv<T, C>(acc, in, ring, w2, dilation, valid_rows);

  // y = GELU(conv2 + x), GroupNorm over each window, on the staged tile
  fma_store_input<T, C>(in, acc);
  __syncthreads();
  float sum = 0.0f;
  fma_epilogue<T, C>([&](int r, int c, int) {
    const float xv = valid ? __ldg(x + base + (size_t)r * C + c) : 0.0f;
    const float v = gelu(in[r * L::kLd + c] + xv);
    in[r * L::kLd + c] = v;
    sum += v;
  });
  const float mean = window_sum<T>(sum, red) * inv_n;
  float sq = 0.0f;
  fma_epilogue<T, C>([&](int r, int c, int) {
    const float dv = in[r * L::kLd + c] - mean;
    sq += dv * dv;
  });
  const float rstd = rsqrtf(window_sum<T>(sq, red) * inv_n + 1e-5f);
  if (!valid) return;
  fma_epilogue<T, C>([&](int r, int c, int) {
    out[base + (size_t)r * C + c] =
        (in[r * L::kLd + c] - mean) * rstd * __ldg(gn_scale + c) + __ldg(gn_bias + c);
  });
}

// One launch of fma_block_kernel over batch windows. windows_per_block and
// smem_bytes: the caller's plan (ops/conv_kernel.py::fma_plan), which must be
// this instantiation's (else cudaErrorInvalidValue).
template <int T, int C>
cudaError_t launch_fma_block(const float* x, const float* w1, const float* w2, const float* gs,
                             const float* gb, const float* mask, float* out, int batch, int dilation,
                             int windows_per_block, int smem_bytes, cudaStream_t stream) {
  using L = FmaConv<T, C>;
  if (windows_per_block != L::kWindows || smem_bytes != (int)L::kSmem) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(fma_block_kernel<T, C>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::kSmem);
  if (err != cudaSuccess) return err;
  const int blocks = (batch + L::kWindows - 1) / L::kWindows;
  fma_block_kernel<T, C><<<blocks, L::kThreads, L::kSmem, stream>>>(x, w1, w2, gs, gb, mask, out,
                                                                    batch, dilation);
  return cudaGetLastError();
}

// f(integral_constant T, integral_constant C) for the built shapes
template <typename F>
cudaError_t with_shape(int t_len, int channels, F&& f) {
  auto by_c = [&](auto t) -> cudaError_t {
    switch (channels) {
      case 64:
        return f(t, std::integral_constant<int, 64>{});
      case 128:
        return f(t, std::integral_constant<int, 128>{});
      case 256:
        return f(t, std::integral_constant<int, 256>{});
      default:
        return cudaErrorInvalidValue;
    }
  };
  switch (t_len) {
    case 8:
      return by_c(std::integral_constant<int, 8>{});
    case 16:
      return by_c(std::integral_constant<int, 16>{});
    case 32:
      return by_c(std::integral_constant<int, 32>{});
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace
