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
#include <cooperative_groups.h>

#include <climits>
#include <cstdint>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int RECORDS = 8;  // records a thread loads per round, per column

// The `valid` records of each column from index i on (all RECORDS of them
// as two 16-byte loads when the columns are aligned and none runs past n).
__device__ __forceinline__ int load_records(const int* __restrict__ addrs,
                                            const int* __restrict__ tbins, long long i,
                                            long long n, bool vec, int (&a)[RECORDS],
                                            int (&t)[RECORDS]) {
  if (vec && i + RECORDS <= n) {
    const int4* av = reinterpret_cast<const int4*>(addrs + i);
    const int4* tv = reinterpret_cast<const int4*>(tbins + i);
    const int4 a0 = __ldg(av), a1 = __ldg(av + 1), t0 = __ldg(tv), t1 = __ldg(tv + 1);
    a[0] = a0.x; a[1] = a0.y; a[2] = a0.z; a[3] = a0.w;
    a[4] = a1.x; a[5] = a1.y; a[6] = a1.z; a[7] = a1.w;
    t[0] = t0.x; t[1] = t0.y; t[2] = t0.z; t[3] = t0.w;
    t[4] = t1.x; t[5] = t1.y; t[6] = t1.z; t[7] = t1.w;
    return RECORDS;
  }
  const int valid = i >= n ? 0 : static_cast<int>(min(n - i, static_cast<long long>(RECORDS)));
#pragma unroll
  for (int j = 0; j < RECORDS; ++j) {
    a[j] = j < valid ? __ldg(addrs + i + j) : 0;
    t[j] = j < valid ? __ldg(tbins + i + j) : 0;
  }
  return valid;
}

// A run of equal keys in one thread's records: table[key] += count once
// the key changes (key < 0: records that count nowhere).
struct Run {
  int key = -1;
  int count = 0;
  __device__ __forceinline__ void add(int* table, int k) {
    if (k != key) {
      if (key >= 0 && count) atomicAdd(&table[key], count);
      key = k;
      count = 0;
    }
    count += k >= 0;
  }
};

// Each lane's last run: one atomic for the whole warp when every lane holds
// the same key (the common case, since a buffer's records come in runs of
// one tensor), else one per lane.  Every lane of the warp calls it.
__device__ __forceinline__ void flush_warp(int* table, const Run& run, int lane) {
  const int first = __shfl_sync(0xffffffffu, run.key, 0);
  if (__all_sync(0xffffffffu, run.key == first)) {
    const int total = __reduce_add_sync(0xffffffffu, run.count);
    if (lane == 0 && first >= 0 && total) atomicAdd(&table[first], total);
  } else if (run.key >= 0 && run.count) {
    atomicAdd(&table[run.key], run.count);
  }
}

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

  // this block's records: an even share of [0, n) in whole rounds of
  // RECORDS; the first round is in flight while the block sets up
  const bool vec = ((reinterpret_cast<uintptr_t>(addrs) | reinterpret_cast<uintptr_t>(tbins)) &
                    15) == 0;
  const long long share = ((n + gridDim.x - 1) / gridDim.x + RECORDS - 1) / RECORDS * RECORDS;
  const long long lo = min(n, blockIdx.x * share);
  const long long hi = min(n, lo + share);
  const long long span = static_cast<long long>(blockDim.x) * RECORDS;
  int a[RECORDS], t[RECORDS];
  int valid = load_records(addrs, tbins, lo + threadIdx.x * RECORDS, hi, vec, a, t);
  for (int j = threadIdx.x; j < k; j += blockDim.x) {
    ss[j] = starts[j];
    se[j] = ends[j];
  }
  for (int g = threadIdx.x; g < cells / 4; g += blockDim.x) smem4[g] = make_int4(0, 0, 0, 0);
  for (int j = cells / 4 * 4 + threadIdx.x; j < total; j += blockDim.x) acc[j] = 0;
  __syncthreads();

  Run objects, cells_run;
  // The last search's answer: idx is the upper-bound result for every a
  // with from <= a < to (starts are sorted), and end its object's end.
  int idx = -1;
  long long from = 1, to = 0;
  int end = 0;
  // the bounds are the same for the whole block, so every lane takes every round
  for (long long r = lo; r < hi; r += span) {
    if (valid) {
#pragma unroll
      for (int j = 0; j < RECORDS; ++j) {
        int obj = -1, cell = -1;
        if (j < valid) {
          if (a[j] < from || a[j] >= to) {
            idx = find_object(ss, k, a[j]);
            from = idx >= 0 ? ss[idx] : LLONG_MIN;
            to = idx + 1 < k ? ss[idx + 1] : LLONG_MAX;
            end = idx >= 0 ? se[idx] : 0;
          }
          if (idx >= 0 && a[j] < end) obj = idx;
          const int blk = hot_block(a[j], base, shift);
          if (blk >= 0 && blk < n_blocks && t[j] >= 0 && t[j] < n_tbins)
            cell = t[j] * n_blocks + blk;
        }
        objects.add(cnt, obj);
        cells_run.add(acc, cell);
      }
    }
    valid = load_records(addrs, tbins, r + span + threadIdx.x * RECORDS, hi, vec, a, t);
  }
  const int lane = threadIdx.x & 31;
  flush_warp(cnt, objects, lane);
  flush_warp(acc, cells_run, lane);

  // rank q owns values [q*per, (q+1)*per), whole groups of four.  Each
  // block adds its non-zero partials of the values others own into the
  // owner's copy (few: a buffer touches some 20 objects and cells), so the
  // owner's copy becomes the sum over the cluster.
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int ranks = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int per = ((total + ranks - 1) / ranks + 3) / 4 * 4;
  for (int g = threadIdx.x; 4 * g < total; g += blockDim.x) {
    const int owner = 4 * g / per;
    if (owner == rank) continue;
    int v[4];
    if (4 * g + 4 <= total) {
      const int4 u = smem4[g];
      v[0] = u.x; v[1] = u.y; v[2] = u.z; v[3] = u.w;
    } else {
      for (int j = 0; j < 4; ++j) v[j] = 4 * g + j < total ? acc[4 * g + j] : 0;
    }
    if (v[0] | v[1] | v[2] | v[3]) {
      int* dst = cluster.map_shared_rank(acc, owner) + 4 * g;
      for (int j = 0; j < 4; ++j)
        if (v[j]) atomicAdd(dst + j, v[j]);
    }
  }
  // after this barrier no block touches another's shared memory
  cluster.sync();

  // the owner writes its values: plain stores with one cluster (merge = 0),
  // atomics of the non-zero ones into zeroed outputs with several
  const bool vec_out = (reinterpret_cast<uintptr_t>(hist) & 15) == 0;
  const int mine_hi = min(total, (rank + 1) * per);
  for (int g = rank * per / 4 + threadIdx.x; 4 * g < mine_hi; g += blockDim.x) {
    if (!merge && vec_out && 4 * g + 4 <= cells) {
      reinterpret_cast<int4*>(hist)[g] = smem4[g];
      continue;
    }
    for (int e = 4 * g; e < min(4 * g + 4, mine_hi); ++e) {
      int* dst = e < cells ? hist + e : counts + (e - cells);
      if (!merge) {
        *dst = acc[e];
      } else if (acc[e]) {
        atomicAdd(dst, acc[e]);
      }
    }
  }
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
  err = allow_smem(trace_aggregate_kernel, smem_bytes);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(clusters * cluster);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem_bytes;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int merge = clusters > 1;
  void* args[] = {&addrs, &tbins, &n, &starts, &ends, &k, &base, &shift,
                  &n_blocks, &n_tbins, &counts, &hist, &merge};
  err = cudaLaunchKernelExC(&cfg, reinterpret_cast<const void*>(trace_aggregate_kernel), args);
  return err != cudaSuccess ? err : cudaGetLastError();
}
