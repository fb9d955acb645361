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
