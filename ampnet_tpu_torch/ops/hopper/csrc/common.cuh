// Shared helpers of the port's hand-written Hopper kernels. Each source
// builds into its own shared library with a plain C interface, loaded from
// Python with ctypes; every entry point returns the cudaError_t of its
// launches (0 = success) and never synchronises.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

extern "C" const char* ampnet_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
