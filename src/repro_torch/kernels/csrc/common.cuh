// Shared helpers of the PASTA CUDA kernels (one shared library per source,
// each with a plain C interface loaded through ctypes).
#pragma once

#include <cuda_runtime.h>

// Readable text for the error code a launch function returned.
extern "C" const char* pasta_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Dynamic shared memory above the default 48 KB has to be opted into for
// each kernel before the launch; a refused size surfaces as the launch error.
template <typename Kernel>
static cudaError_t allow_smem(Kernel kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

// Grid-stride loop bounds shared by the kernels.
__device__ __forceinline__ long long first_index() {
  return static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
}

__device__ __forceinline__ long long grid_stride() {
  return static_cast<long long>(gridDim.x) * blockDim.x;
}
