// Shared helpers of the PASTA trace-reduction kernels (one shared library
// per source, each with a plain C interface loaded through ctypes).
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

// Index of the object a record falls into by start alone: the last k with
// starts[k] <= a, or -1 (upper-bound binary search, i.e.
// searchsorted(side="right") - 1).  Empty ranges stay correct because the
// caller then checks a < ends[k] against that one object.
__device__ __forceinline__ int find_object(const int* starts, int k, int a) {
  int lo = 0, hi = k;
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    if (starts[mid] <= a) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo - 1;
}

// Hotness block of a record: (a - base) >> shift with int32 wrap-around and
// an arithmetic shift, as the plain version computes it on int32 tensors.
__device__ __forceinline__ int hot_block(int a, int base, int shift) {
  int d = static_cast<int>(static_cast<unsigned>(a) - static_cast<unsigned>(base));
  return d >> shift;
}

// Grid-stride loop bounds shared by the kernels.
__device__ __forceinline__ long long first_index() {
  return static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
}

__device__ __forceinline__ long long grid_stride() {
  return static_cast<long long>(gridDim.x) * blockDim.x;
}
