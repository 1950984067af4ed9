// Fused trace reduction: one read of each record feeds both accumulators,
// the per-object counts of object_histogram.cu and the [time-bin x block]
// hotness map of hotness_histogram.cu, with the same semantics.
//
// Replaces the TPU kernel `_fused_kernel` of
// src/repro/kernels/trace_aggregate.py (trace_aggregate_pallas), which keeps
// both accumulators resident in VMEM and reduces one-hot operands on the
// MXU.  Here both accumulators, and the object table for the binary search,
// live in shared memory: 12*K + 4*n_tbins*n_blocks bytes, which must fit
// the opt-in limit (ops.can_fuse checks it; larger problems take the two
// separate kernels).  Each thread takes records in a grid-stride loop; each
// block merges its non-zero counts and cells with one global atomic each.
//
// Bound on the card: bytes.  The function reads 8 B per record and 8 B per
// object and writes 4 B per object and per histogram cell.
#include "common.cuh"

__global__ void trace_aggregate_kernel(const int* __restrict__ addrs,
                                       const int* __restrict__ tbins, long long n,
                                       const int* __restrict__ starts,
                                       const int* __restrict__ ends, int k, int base,
                                       int shift, int n_blocks, int n_tbins,
                                       int* __restrict__ counts, int* __restrict__ hist) {
  extern __shared__ int smem[];
  const int cells = n_tbins * n_blocks;
  int* ss = smem;
  int* se = smem + k;
  int* sc = smem + 2 * k;
  int* sh = smem + 3 * k;
  for (int j = threadIdx.x; j < k; j += blockDim.x) {
    ss[j] = starts[j];
    se[j] = ends[j];
    sc[j] = 0;
  }
  for (int j = threadIdx.x; j < cells; j += blockDim.x) sh[j] = 0;
  __syncthreads();
  for (long long i = first_index(); i < n; i += grid_stride()) {
    int a = addrs[i];
    int idx = find_object(ss, k, a);
    if (idx >= 0 && a < se[idx]) atomicAdd(&sc[idx], 1);
    int blk = hot_block(a, base, shift);
    int tb = tbins[i];
    if (blk >= 0 && blk < n_blocks && tb >= 0 && tb < n_tbins)
      atomicAdd(&sh[tb * n_blocks + blk], 1);
  }
  __syncthreads();
  for (int j = threadIdx.x; j < k; j += blockDim.x) {
    int v = sc[j];
    if (v) atomicAdd(&counts[j], v);
  }
  for (int j = threadIdx.x; j < cells; j += blockDim.x) {
    int v = sh[j];
    if (v) atomicAdd(&hist[j], v);
  }
}

// counts and hist must be zeroed by the caller; smem_bytes must be
// 12*k + 4*n_tbins*n_blocks.  Returns the CUDA error of the launch.
extern "C" int trace_aggregate_launch(int device, const void* addrs, const void* tbins,
                                      long long n, const void* starts, const void* ends,
                                      int k, int base, int shift, int n_blocks, int n_tbins,
                                      void* counts, void* hist, int blocks, int threads,
                                      int smem_bytes, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  err = allow_smem(trace_aggregate_kernel, smem_bytes);
  if (err != cudaSuccess) return err;
  trace_aggregate_kernel<<<blocks, threads, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(addrs), static_cast<const int*>(tbins), n,
      static_cast<const int*>(starts), static_cast<const int*>(ends), k, base, shift,
      n_blocks, n_tbins, static_cast<int*>(counts), static_cast<int*>(hist));
  return cudaGetLastError();
}
