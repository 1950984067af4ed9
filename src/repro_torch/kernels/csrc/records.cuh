// Device code the three trace-reduction kernels share (object_histogram.cu,
// hotness_histogram.cu, trace_aggregate.cu).
//
// The instrumenter emits a buffer's records in runs of consecutive addresses
// of one tensor, all in one time bin, and a buffer holds 10^3-10^5 records.
// At those sizes a kernel's time is its launch and its chain of dependent
// steps, not its bytes, so the kernels are built from these pieces:
//  * load_column / load_records: each thread loads RECORDS records of a
//    column as two 16-byte vectors, issued before the block sets up its
//    accumulators, so the load round trip overlaps the set-up;
//  * ObjectLookup: the last search's start bounds stay in registers and the
//    object table is searched again only when a record leaves them;
//  * Run / flush_warp: runs of equal keys are merged in registers and added
//    once; a warp whose lanes end on the same key adds their sum with one
//    atomic;
//  * merge_into_owners: the blocks of a cluster add their non-zero partials
//    into the rank that owns them through distributed shared memory, and
//    each owner writes its values once, so one cluster writes its output in
//    full and the caller needs no zero fill.
#pragma once

#include <cooperative_groups.h>

#include <climits>
#include <cstdint>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int RECORDS = 8;  // records a thread loads per round, per column (ops.FUSED_RECORDS)

// How a histogram kernel keeps its accumulator (ops.KINDS, by index):
//  KIND_CLUSTER  a whole copy in each block's shared memory; one cluster of
//                blocks shares the records and merges through distributed
//                shared memory; several clusters add into an output zeroed
//                by the caller;
//  KIND_TILES    each block owns one tile of the output in shared memory,
//                reads every record and writes its whole tile;
//  KIND_GLOBAL   global atomics into an output zeroed by the caller.
enum Kind { KIND_CLUSTER = 0, KIND_TILES = 1, KIND_GLOBAL = 2 };

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
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

// Hotness cell t * n_blocks + block of a record, or -1 when it is dropped:
// block (a - base) >> shift with int32 wrap-around and an arithmetic shift,
// as the plain version computes it on int32 tensors, outside [0, n_blocks),
// or time bin t outside [0, n_tbins).
__device__ __forceinline__ int hot_cell(int a, int t, int base, int shift, int n_blocks,
                                        int n_tbins) {
  const int blk = static_cast<int>(static_cast<unsigned>(a) - static_cast<unsigned>(base)) >> shift;
  return blk >= 0 && blk < n_blocks && t >= 0 && t < n_tbins ? t * n_blocks + blk : -1;
}

// [lo, hi) of the records this block takes: an even share of [0, n) in
// whole rounds of RECORDS (ops.fused_shares computes the same).
__device__ __forceinline__ void block_share(long long n, long long& lo, long long& hi) {
  const long long share = ((n + gridDim.x - 1) / gridDim.x + RECORDS - 1) / RECORDS * RECORDS;
  lo = min(n, blockIdx.x * share);
  hi = min(n, lo + share);
}

// The `valid` records of a column from index i on (all RECORDS of them as
// two 16-byte loads when the column is aligned and none runs past n).
__device__ __forceinline__ int load_column(const int* __restrict__ col, long long i, long long n,
                                           bool vec, int (&v)[RECORDS]) {
  if (vec && i + RECORDS <= n) {
    const int4* p = reinterpret_cast<const int4*>(col + i);
    const int4 x0 = __ldg(p), x1 = __ldg(p + 1);
    v[0] = x0.x; v[1] = x0.y; v[2] = x0.z; v[3] = x0.w;
    v[4] = x1.x; v[5] = x1.y; v[6] = x1.z; v[7] = x1.w;
    return RECORDS;
  }
  const int valid = i >= n ? 0 : static_cast<int>(min(n - i, static_cast<long long>(RECORDS)));
#pragma unroll
  for (int j = 0; j < RECORDS; ++j) v[j] = j < valid ? __ldg(col + i + j) : 0;
  return valid;
}

// Both columns (addresses and time bins); vec when both are aligned.
__device__ __forceinline__ int load_records(const int* __restrict__ addrs,
                                            const int* __restrict__ tbins, long long i,
                                            long long n, bool vec, int (&a)[RECORDS],
                                            int (&t)[RECORDS]) {
  load_column(tbins, i, n, vec, t);
  return load_column(addrs, i, n, vec, a);
}

// The last search's answer: idx is the upper-bound result for every a with
// from <= a < to (starts are sorted), and end its object's end.
struct ObjectLookup {
  int idx = -1;
  long long from = 1, to = 0;
  int end = 0;
  // The object that record a counts for, or -1.
  __device__ __forceinline__ int operator()(const int* starts, const int* ends, int k, int a) {
    if (a < from || a >= to) {
      idx = find_object(starts, k, a);
      from = idx >= 0 ? starts[idx] : LLONG_MIN;
      to = idx + 1 < k ? starts[idx + 1] : LLONG_MAX;
      end = idx >= 0 ? ends[idx] : 0;
    }
    return idx >= 0 && a < end ? idx : -1;
  }
};

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

// Zeroes acc[0, total) in shared memory (16-byte aligned), four at a time.
__device__ __forceinline__ void zero_shared(int4* acc4, int total) {
  for (int g = threadIdx.x; g < total / 4; g += blockDim.x) acc4[g] = make_int4(0, 0, 0, 0);
  int* acc = reinterpret_cast<int*>(acc4);
  for (int j = total / 4 * 4 + threadIdx.x; j < total; j += blockDim.x) acc[j] = 0;
}

// The cluster barrier in two halves (PTX barrier.cluster): arrive releases
// the thread's earlier writes; wait returns once every thread of the cluster
// has arrived and acquires their writes.  Every thread calls each once,
// arrive first.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The end of a KIND_CLUSTER kernel, called by every thread once every block of
// the cluster has its accumulated values acc[0, total) (shared memory,
// 16-byte aligned) complete and every block's copy may be added to.  Values
// [0, split) go to out_lo, [split, total) to out_hi.  Rank q owns values
// [q*per, (q+1)*per), whole groups of four: each block adds its non-zero
// partials of the values others own into the owner's copy (few: a buffer
// touches some 20 objects and cells), and after a cluster barrier each
// owner writes its values, with plain stores (16 bytes at a time into an
// aligned out_lo) when merge == 0, else by adding the non-zero ones with
// global atomics into outputs the caller zeroed.
__device__ __forceinline__ void merge_into_owners(int4* acc4, int total, int split,
                                                  int* __restrict__ out_lo,
                                                  int* __restrict__ out_hi, bool merge) {
  int* acc = reinterpret_cast<int*>(acc4);
  cg::cluster_group cluster = cg::this_cluster();
  const int ranks = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int per = ((total + ranks - 1) / ranks + 3) / 4 * 4;
  for (int g = threadIdx.x; 4 * g < total; g += blockDim.x) {
    const int owner = 4 * g / per;
    if (owner == rank) continue;
    int v[4];
    if (4 * g + 4 <= total) {
      const int4 u = acc4[g];
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

  const bool vec_out = aligned16(out_lo);
  const int mine_hi = min(total, (rank + 1) * per);
  for (int g = rank * per / 4 + threadIdx.x; 4 * g < mine_hi; g += blockDim.x) {
    if (!merge && vec_out && 4 * g + 4 <= split) {
      reinterpret_cast<int4*>(out_lo)[g] = acc4[g];
      continue;
    }
    for (int e = 4 * g; e < min(4 * g + 4, mine_hi); ++e) {
      int* dst = e < split ? out_lo + e : out_hi + (e - split);
      if (!merge) {
        *dst = acc[e];
      } else if (acc[e]) {
        atomicAdd(dst, acc[e]);
      }
    }
  }
}

// Launches `kernel` with `args` as blocks / cluster thread-block clusters of
// `cluster` blocks (cluster > 0, at most the portable 8) or as a plain grid
// of `blocks` blocks (cluster == 0), each of `threads` threads with
// `smem_bytes` of dynamic shared memory.  Returns the CUDA error of the
// launch.
template <typename Kernel>
cudaError_t launch(Kernel kernel, void** args, int blocks, int cluster, int threads,
                   int smem_bytes, void* stream) {
  cudaError_t err = allow_smem(kernel, smem_bytes);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem_bytes;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  if (cluster > 0) {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
  err = cudaLaunchKernelExC(&cfg, reinterpret_cast<const void*>(kernel), args);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace
