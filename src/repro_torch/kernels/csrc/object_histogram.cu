// Per-object access counts over one trace buffer:
//   counts[k] = #{i : k = last object with starts[k] <= a_i, a_i < ends[k]}.
//
// Replaces the TPU kernel `_kernel` of src/repro/kernels/trace_aggregate.py
// (object_histogram_pallas), which turns the histogram into a one-hot matmul
// because the TPU has no scatter atomics.  Hopper has native shared-memory
// atomics, so this is a histogram privatized per block.
//
// Bound on the card: bytes (4 B per record and 8 B per object read, 4 B per
// object written), but at the path's buffers (10^3-10^5 records, K of about
// 20) that is well under a microsecond, and the time is the launch and a
// chain of dependent steps.  So where the object table and the counts fit a
// block's shared memory (12*K bytes within the opt-in; ops.object_plan) the
// kernel is the fused kernel's design (trace_aggregate.cu, records.cuh)
// with one accumulator: one launch of a cluster of ops.FUSED_CLUSTER
// blocks; each thread's 16-byte record loads issued before the block loads
// its table and zeroes its counts; the cached object lookup; runs of one
// object merged in registers and flushed per warp.  The merge differs: K
// counts are few, so instead of pushing them to an owning rank through
// distributed shared memory and crossing a second cluster barrier, rank 0
// zeroes `counts` at set-up, every block arrives at the cluster barrier
// once set up and waits only after its reduction, when the others have
// long arrived, and then adds its non-zero counts with global atomics.  So
// `counts` needs no fill and the merge no barrier round trip.  A buffer too
// large for one cluster (ops.fused_plan) takes several, which add into
// counts the caller zeroed.
// Beyond the opt-in (K > 19,370 on an H100; no path has that many objects)
// a grid-stride kernel searches the table in global memory and adds with
// global atomics into zeroed counts.
#include "records.cuh"

namespace {

__global__ void __launch_bounds__(1024, 1)
    object_histogram_cluster_kernel(const int* __restrict__ addrs, long long n,
                                    const int* __restrict__ starts,
                                    const int* __restrict__ ends, int k,
                                    int* __restrict__ counts, int merge) {
  extern __shared__ int4 smem4[];
  // the counts first (16-byte aligned), then the table
  int* cnt = reinterpret_cast<int*>(smem4);
  int* ss = cnt + k;
  int* se = ss + k;

  long long lo, hi;
  block_share(n, lo, hi);
  const bool vec = aligned16(addrs);
  const long long span = static_cast<long long>(blockDim.x) * RECORDS;
  int a[RECORDS];
  int valid = load_column(addrs, lo + threadIdx.x * RECORDS, hi, vec, a);
  for (int j = threadIdx.x; j < k; j += blockDim.x) {
    ss[j] = starts[j];
    se[j] = ends[j];
  }
  zero_shared(smem4, k);
  // one cluster writes counts in full: its rank 0 zeroes them here, and
  // the cluster barrier orders these stores before every block's adds
  if (!merge && cg::this_cluster().block_rank() == 0)
    for (int j = threadIdx.x; j < k; j += blockDim.x) counts[j] = 0;
  cluster_arrive();
  __syncthreads();

  Run run;
  ObjectLookup lookup;
  // the bounds are the same for the whole block, so every lane takes every round
  for (long long r = lo; r < hi; r += span) {
    if (valid) {
#pragma unroll
      for (int j = 0; j < RECORDS; ++j) run.add(cnt, j < valid ? lookup(ss, se, k, a[j]) : -1);
    }
    valid = load_column(addrs, r + span + threadIdx.x * RECORDS, hi, vec, a);
  }
  flush_warp(cnt, run, threadIdx.x & 31);
  __syncthreads();
  // every block arrived after its set-up, long before this wait returns
  cluster_wait();
  for (int j = threadIdx.x; j < k; j += blockDim.x)
    if (cnt[j]) atomicAdd(&counts[j], cnt[j]);
}

__global__ void object_histogram_global_kernel(const int* __restrict__ addrs, long long n,
                                               const int* __restrict__ starts,
                                               const int* __restrict__ ends, int k,
                                               int* __restrict__ counts) {
  for (long long i = first_index(); i < n; i += grid_stride()) {
    const int a = addrs[i];
    const int idx = find_object(starts, k, a);
    if (idx >= 0 && a < ends[idx]) atomicAdd(&counts[idx], 1);
  }
}

}  // namespace

// kind CLUSTER: `blocks` / `cluster` clusters of `cluster` blocks (cluster
// <= 8) of `threads` <= 1024, smem_bytes = 12*k; one cluster writes counts in
// full (zeroes and adds), several add into counts zeroed by the caller.  kind GLOBAL: a grid
// of `blocks` blocks (cluster and smem_bytes are 0) adding into counts
// zeroed by the caller.  Returns the CUDA error of the launch.
extern "C" int object_histogram_launch(int device, const void* addrs, long long n,
                                       const void* starts, const void* ends, int k,
                                       void* counts, int kind, int blocks, int cluster,
                                       int threads, int smem_bytes, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (kind == KIND_CLUSTER) {
    int merge = blocks > cluster;
    void* args[] = {&addrs, &n, &starts, &ends, &k, &counts, &merge};
    return launch(object_histogram_cluster_kernel, args, blocks, cluster, threads, smem_bytes,
                  stream);
  }
  if (kind != KIND_GLOBAL) return cudaErrorInvalidValue;
  void* args[] = {&addrs, &n, &starts, &ends, &k, &counts};
  return launch(object_histogram_global_kernel, args, blocks, 0, threads, 0, stream);
}
