// The rows' type of the port's kernels, float or __nv_bfloat16, as every
// bf16 body reads it: the tensor-core bodies (mma_bf16.cuh) and the
// CUDA-core bodies, which keep their working set in f32 and convert each
// value as it is loaded (edge_attention.cu, edge_attention_bwd.cu,
// attention_tiles.cuh, qkv_projection.cu). Conversions are the cuda_bf16.h
// intrinsics: round to nearest even, as XLA's astype(bfloat16).
#pragma once

#include <cuda_bf16.h>

// a value of the rows' type as a bf16 operand: bf16 as it is, f32 rounded
__device__ __forceinline__ __nv_bfloat16 to_bf16(__nv_bfloat16 v) { return v; }
__device__ __forceinline__ __nv_bfloat16 to_bf16(float v) { return __float2bfloat16_rn(v); }

__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(float v) { return v; }

// an f32 value rounded to bf16 and kept in f32: a bf16 operand of a product
// on the CUDA cores, where an f32 FMA of two such values is exact as the
// tensor cores' bf16 product is
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// an f32 value stored in type T (bf16: rounded)
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// 1/sqrt(dh) in the rows' type (JAX's asarray(scale, dtype)): bf16 rows take
// the bf16 scale (1/sqrt(32) is 0.1767578125), f32 rows the f32 one
template <typename T>
__device__ __forceinline__ float head_scale(int dh);
template <>
__device__ __forceinline__ float head_scale<__nv_bfloat16>(int dh) {
  return __bfloat162float(__double2bfloat16(1.0 / sqrt((double)dh)));
}
template <>
__device__ __forceinline__ float head_scale<float>(int dh) {
  return (float)(1.0 / sqrt((double)dh));
}
