// Fused trace reduction: one read of each record feeds both accumulators,
// the per-object counts of object_histogram.cu and the [time-bin x block]
// hotness map of hotness_histogram.cu, with the same semantics.
//
// Replaces the TPU kernel `_fused_kernel` of
// src/repro/kernels/trace_aggregate.py (trace_aggregate_pallas), which keeps
// both accumulators resident in VMEM and reduces one-hot operands on the
// MXU.  Here each block keeps the object table (for the binary search), the
// counts and the map in shared memory: 12*K + 4*n_tbins*n_blocks bytes,
// which must fit the opt-in limit (ops.can_fuse checks it; larger problems
// take the two separate kernels).
//
// Bound on the card: bytes (8 B per record, 8 B per object read; 4 B per
// object and per cell written), but at the main path's buffers (10^3-10^5
// records, K of about 20, a map of 4 x 2-3k cells) the time is latency and
// fixed cost: the launch, zeroing and merging the map, one load round trip.
// So the design does one launch and few dependent steps:
//  * the blocks of one launch form thread-block clusters of
//    ops.FUSED_CLUSTER blocks of 512 or 1024 threads (ops.fused_plan: the
//    fewer when a block's share takes one round); each thread loads
//    RECORDS records of each column as 16-byte vectors, all issued before
//    any is used and before the block loads its object table and zeroes
//    its map, and the records are shared evenly among the blocks, so a
//    main-path buffer takes one round of loads, overlapped with the set-up;
//  * few shared-memory accesses: the instrumenter emits a buffer's records
//    in runs of consecutive addresses of one tensor, all in one time bin,
//    so a thread keeps the start bounds of its last object lookup in
//    registers and searches the table again only when a record leaves
//    them, merges runs of equal object index and of equal map cell in
//    registers and adds each run once; a warp whose lanes end on the same
//    key adds their sum with one atomic (__reduce_add_sync).  Records in
//    random order degrade to one search and one atomic per record;
//  * after a cluster barrier, each block adds the non-zero values of its
//    map and counts that another rank owns into that rank's copy through
//    distributed shared memory (a buffer touches some 20 objects and
//    cells, so a few dozen remote atomics instead of a pass over every
//    rank's whole map); after a second barrier each rank writes the values
//    it owns, 16 bytes at a time: with one cluster (merge = 0) by plain
//    stores, so the outputs need no zero fill; with several (a buffer too
//    large for one cluster) by global atomics into outputs the wrapper
//    zeroed with one fill.
// The record loads, the lookup cache, the run merging and the merge into the
// owning ranks are records.cuh's, shared with object_histogram.cu and
// hotness_histogram.cu.
#include "records.cuh"

namespace {

__global__ void __launch_bounds__(1024, 1)
    trace_aggregate_kernel(const int* __restrict__ addrs, const int* __restrict__ tbins,
                           long long n, const int* __restrict__ starts,
                           const int* __restrict__ ends, int k, int base, int shift,
                           int n_blocks, int n_tbins, int* __restrict__ counts,
                           int* __restrict__ hist, int merge) {
  extern __shared__ int4 smem4[];
  // the map first, so its groups of four cells are 16-byte aligned; the
  // counts right after it (together the `total` accumulated values), then
  // the object table
  const int cells = n_tbins * n_blocks;
  const int total = cells + k;
  int* acc = reinterpret_cast<int*>(smem4);
  int* cnt = acc + cells;
  int* ss = cnt + k;
  int* se = ss + k;

  // this block's records (block_share); the first round is in flight while
  // the block sets up
  const bool vec = aligned16(addrs) && aligned16(tbins);
  long long lo, hi;
  block_share(n, lo, hi);
  const long long span = static_cast<long long>(blockDim.x) * RECORDS;
  int a[RECORDS], t[RECORDS];
  int valid = load_records(addrs, tbins, lo + threadIdx.x * RECORDS, hi, vec, a, t);
  for (int j = threadIdx.x; j < k; j += blockDim.x) {
    ss[j] = starts[j];
    se[j] = ends[j];
  }
  zero_shared(smem4, total);
  __syncthreads();

  Run objects, cells_run;
  ObjectLookup lookup;
  // the bounds are the same for the whole block, so every lane takes every round
  for (long long r = lo; r < hi; r += span) {
    if (valid) {
#pragma unroll
      for (int j = 0; j < RECORDS; ++j) {
        const bool in = j < valid;
        objects.add(cnt, in ? lookup(ss, se, k, a[j]) : -1);
        cells_run.add(acc, in ? hot_cell(a[j], t[j], base, shift, n_blocks, n_tbins) : -1);
      }
    }
    valid = load_records(addrs, tbins, r + span + threadIdx.x * RECORDS, hi, vec, a, t);
  }
  const int lane = threadIdx.x & 31;
  flush_warp(cnt, objects, lane);
  flush_warp(acc, cells_run, lane);

  cg::this_cluster().sync();
  merge_into_owners(smem4, total, cells, hist, counts, merge);
}

}  // namespace

// Grid: clusters * cluster blocks (cluster <= 8, the portable size) of
// `threads` <= 1024; smem_bytes must be 12*k + 4*n_tbins*n_blocks.
// merge = 0 (one cluster): counts and hist are written in full.  merge =
// 1: they are added to with atomics and must be zeroed by the caller.
// Returns the CUDA error of the launch.
extern "C" int trace_aggregate_launch(int device, const void* addrs, const void* tbins,
                                      long long n, const void* starts, const void* ends,
                                      int k, int base, int shift, int n_blocks, int n_tbins,
                                      void* counts, void* hist, int clusters, int cluster,
                                      int threads, int smem_bytes, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  int merge = clusters > 1;
  void* args[] = {&addrs, &tbins, &n, &starts, &ends, &k, &base, &shift,
                  &n_blocks, &n_tbins, &counts, &hist, &merge};
  return launch(trace_aggregate_kernel, args, clusters * cluster, cluster, threads, smem_bytes,
                stream);
}
