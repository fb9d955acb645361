// Tensor-core helpers of the port's bf16 bodies on Hopper (sm_90a): one
// mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 per product (a bf16
// times a bf16 is exact in f32, and the products are summed in f32), the
// packing of operands into its fragments, and the plan of a ring of
// gathered rows of 2 or 4 bytes (their copies, fill_rows and fill_heads, are
// mma_tf32.cuh's).
//
// Fragments of the m16n8k16 product for the lane with group g = lane / 4 and
// thread-in-group t = lane % 4, two bf16 per 32-bit register, the lower
// column (or k) in the low half:
//   A (16 x 16, row): a0 (g, 2t..2t+1)  a1 (g + 8, 2t..2t+1)  a2 (g, 2t+8..2t+9)  a3 (g + 8, 2t+8..2t+9)
//   B (16 x 8, col):  b0 (k = 2t..2t+1, n = g)   b1 (k = 2t+8..2t+9, n = g)
//   C (16 x 8):       c0, c1 (g, 2t..2t+1)       c2, c3 (g + 8, 2t..2t+1)
// The C tiles of two neighbouring 8-column blocks j = 2kk, 2kk + 1 are the A
// fragment of the next product over those 16 columns, rounded to bf16 and
// packed pairwise with no shuffle: {pack(c[2kk][0], c[2kk][1]), pack(c[2kk][2],
// c[2kk][3]), pack(c[2kk+1][0], c[2kk+1][1]), pack(c[2kk+1][2], c[2kk+1][3])}
// (FlashAttention-2's reuse of the score tile as P's operand; the 3xTF32
// bodies' c_as_a has another map). Conversions are the cuda_bf16.h
// intrinsics: round to nearest even, as XLA's astype(bfloat16). The
// conversions of the rows' type and 1/sqrt(dh) are rows_bf16.cuh's.
#pragma once

#include "mma_tf32.cuh"
#include "rows_bf16.cuh"

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], const uint32_t b[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// two f32 (C values) rounded and packed
__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  return pack_bf16(__float2bfloat16_rn(lo), __float2bfloat16_rn(hi));
}

// elements c and c + 1 of a row p as a packed pair, each 0 at or past lim
template <typename T>
__device__ __forceinline__ uint32_t pair_bf16(const T* p, int c, int lim) {
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.0f);
  return pack_bf16(c < lim ? to_bf16(p[c]) : zero, c + 1 < lim ? to_bf16(p[c + 1]) : zero);
}

// element c of rows p and p + ld as a packed pair (a B fragment down k),
// each 0 where its row is not live or c is at or past lim
template <typename T>
__device__ __forceinline__ uint32_t column_pair_bf16(const T* p, int ld, int c, int lim,
                                                     bool live0, bool live1) {
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.0f);
  return pack_bf16(live0 && c < lim ? to_bf16(p[c]) : zero,
                   live1 && c < lim ? to_bf16(p[ld + c]) : zero);
}

// q times the scale in the rows' type, rounded to bf16: JAX's (q *
// asarray(scale, dtype)).astype(bfloat16); a bf16 product is exact in f32, so
// one rounding gives the bf16 multiply
template <typename T>
__device__ __forceinline__ __nv_bfloat16 scaled_bf16(T q, float scale) {
  return __float2bfloat16_rn(to_f32(q) * scale);
}

// ring_plan (mma_tf32.cuh) for stages of stage_bytes: 3 stages unless 2
// keep more blocks on an SM or 3 exceed a block's shared memory
template <typename Kernel>
int ring_plan_bytes(Kernel kernel, int threads, int s, int d, size_t fixed, size_t stage_bytes,
                    RingPlan& cache) {
  if (cache.threads == threads && cache.s == s && cache.d == d) return 0;
  RingPlan p;
  p.threads = threads; p.s = s; p.d = d;
  int dev = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&p.sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  const size_t top = fixed + 3 * stage_bytes < (size_t)max_smem ? fixed + 3 * stage_bytes
                                                                : (size_t)max_smem;
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)top);
  for (int st = 3; st >= 2 && err == cudaSuccess; --st) {
    if (fixed + st * stage_bytes > top) continue;
    int blocks = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads,
                                                        fixed + st * stage_bytes);
    if (blocks > p.blocks_per_sm) {
      p.blocks_per_sm = blocks;
      p.stages = st;
      p.smem = fixed + st * stage_bytes;
    }
  }
  if (err != cudaSuccess) return (int)err;
  if (p.blocks_per_sm == 0) return (int)cudaErrorInvalidConfiguration;
  cache = p;
  return 0;
}
