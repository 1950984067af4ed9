// [time-bin x block] access hotness over one trace buffer:
//   hist[tb_i, (a_i - base) >> shift] += 1, dropping a record whose block is
//   outside [0, n_blocks) or whose time bin is outside [0, n_tbins).
//
// Replaces the TPU kernel `_kernel` of src/repro/kernels/hotness.py
// (hotness_histogram_pallas), which builds the 2-D histogram as a
// rank-expanding one-hot matmul on the MXU.  Hopper has native atomics, so
// this is a plain histogram: each thread takes records in a grid-stride loop
// and adds one to a privatized int32 hist[n_tbins * n_blocks] in shared
// memory when it fits the opt-in limit, else to global memory with atomics.
// Each block merges its non-zero cells with one global atomic per cell.
//
// Bound on the card: bytes.  The function reads 8 B per record (address and
// time bin) and writes 4 B per histogram cell; the per-record work is a
// subtract, a shift and four compares.
#include "common.cuh"

__global__ void hotness_histogram_kernel(const int* __restrict__ addrs,
                                         const int* __restrict__ tbins, long long n,
                                         int base, int shift, int n_blocks, int n_tbins,
                                         int* __restrict__ hist, int privatize) {
  extern __shared__ int smem[];
  const int cells = n_tbins * n_blocks;
  int* h = hist;
  if (privatize) {
    for (int j = threadIdx.x; j < cells; j += blockDim.x) smem[j] = 0;
    __syncthreads();
    h = smem;
  }
  for (long long i = first_index(); i < n; i += grid_stride()) {
    int blk = hot_block(addrs[i], base, shift);
    int tb = tbins[i];
    if (blk >= 0 && blk < n_blocks && tb >= 0 && tb < n_tbins)
      atomicAdd(&h[tb * n_blocks + blk], 1);
  }
  if (privatize) {
    __syncthreads();
    for (int j = threadIdx.x; j < cells; j += blockDim.x) {
      int v = h[j];
      if (v) atomicAdd(&hist[j], v);
    }
  }
}

// hist must be zeroed by the caller.  smem_bytes == 0 selects the
// global-memory path; otherwise it must be 4*n_tbins*n_blocks.  Returns the
// CUDA error of the launch (0 on success).
extern "C" int hotness_histogram_launch(int device, const void* addrs, const void* tbins,
                                        long long n, int base, int shift, int n_blocks,
                                        int n_tbins, void* hist, int blocks, int threads,
                                        int smem_bytes, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  err = allow_smem(hotness_histogram_kernel, smem_bytes);
  if (err != cudaSuccess) return err;
  hotness_histogram_kernel<<<blocks, threads, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(addrs), static_cast<const int*>(tbins), n, base, shift,
      n_blocks, n_tbins, static_cast<int*>(hist), smem_bytes > 0);
  return cudaGetLastError();
}
