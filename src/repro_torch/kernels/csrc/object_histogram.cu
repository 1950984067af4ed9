// Per-object access counts over one trace buffer:
//   counts[k] = #{i : k = last object with starts[k] <= a_i, a_i < ends[k]}.
//
// Replaces the TPU kernel `_kernel` of src/repro/kernels/trace_aggregate.py
// (object_histogram_pallas), which turns the histogram into a one-hot matmul
// because the TPU has no scatter atomics.  Hopper has native shared-memory
// atomics, so this is a plain histogram: each thread takes records in a
// grid-stride loop, finds its object by binary search over `starts`, and
// adds one to a privatized int32 counts[K] in shared memory (with the object
// table beside it) when 12*K bytes fit; otherwise it searches the table in
// global memory and adds with global atomics.  Each block then merges its
// non-zero counts into global memory with one atomic per object.
//
// Bound on the card: bytes.  The function reads each record once (4 B) and
// the table once (8 B per object) and writes 4 B per object; the binary
// search is log2(K) compares per record, far below the ALU rate.
#include "common.cuh"

__global__ void object_histogram_kernel(const int* __restrict__ addrs, long long n,
                                        const int* __restrict__ starts,
                                        const int* __restrict__ ends, int k,
                                        int* __restrict__ counts, int privatize) {
  extern __shared__ int smem[];
  const int* s = starts;
  const int* e = ends;
  int* c = counts;
  if (privatize) {
    int* ss = smem;
    int* se = smem + k;
    int* sc = smem + 2 * k;
    for (int j = threadIdx.x; j < k; j += blockDim.x) {
      ss[j] = starts[j];
      se[j] = ends[j];
      sc[j] = 0;
    }
    __syncthreads();
    s = ss;
    e = se;
    c = sc;
  }
  for (long long i = first_index(); i < n; i += grid_stride()) {
    int a = addrs[i];
    int idx = find_object(s, k, a);
    if (idx >= 0 && a < e[idx]) atomicAdd(&c[idx], 1);
  }
  if (privatize) {
    __syncthreads();
    for (int j = threadIdx.x; j < k; j += blockDim.x) {
      int v = c[j];
      if (v) atomicAdd(&counts[j], v);
    }
  }
}

// counts must be zeroed by the caller.  smem_bytes == 0 selects the
// global-memory path; otherwise it must be 12*k.  Returns the CUDA error of
// the launch (0 on success).
extern "C" int object_histogram_launch(int device, const void* addrs, long long n,
                                       const void* starts, const void* ends, int k,
                                       void* counts, int blocks, int threads,
                                       int smem_bytes, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  err = allow_smem(object_histogram_kernel, smem_bytes);
  if (err != cudaSuccess) return err;
  object_histogram_kernel<<<blocks, threads, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(addrs), n, static_cast<const int*>(starts),
      static_cast<const int*>(ends), k, static_cast<int*>(counts), smem_bytes > 0);
  return cudaGetLastError();
}
