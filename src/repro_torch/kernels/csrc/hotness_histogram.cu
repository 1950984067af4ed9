// [time-bin x block] access hotness over one trace buffer:
//   hist[tb_i, (a_i - base) >> shift] += 1, dropping a record whose block is
//   outside [0, n_blocks) or whose time bin is outside [0, n_tbins).
//
// Replaces the TPU kernel `_kernel` of src/repro/kernels/hotness.py
// (hotness_histogram_pallas), which builds the 2-D histogram as a
// rank-expanding one-hot matmul on the MXU, each program owning a 512-block
// slice of the map and streaming every record past it.  Hopper has native
// shared-memory atomics, so this is a histogram with the map cell as the key.
//
// Bound on the card: bytes (8 B per record read, 4 B per cell written).  The
// wrapper only calls it where the fused kernel cannot take the problem, and
// ops.hotness_plan picks one of three kernels:
//  * CLUSTER, a map that fits one block's shared memory: the fused kernel's
//    design (trace_aggregate.cu, records.cuh) with the cell as the only key;
//    one cluster writes the map in full, so it needs no fill;
//  * TILES, a larger map (the unfusable fallback's 64 x 32768 cells, 8 MiB):
//    the TPU kernel's own grid.  Each block owns one tile of the map, at
//    most the opt-in shared memory, and zeroes it there while its first
//    records are in flight; it streams every record (8 B each, from L2
//    after the first block) and counts those that land in its tile, runs of
//    one cell merged in registers; then it stores the whole tile with
//    16-byte stores.  Every cell is written once, by its owner, in one
//    launch with no fill: the map's own bytes are the bound;
//  * GLOBAL, where re-reading the trace once per tile would move more bytes
//    than the map itself: a grid-stride kernel adding with global atomics
//    into a map the caller zeroed.
#include "records.cuh"

namespace {

__global__ void __launch_bounds__(1024, 1)
    hotness_histogram_cluster_kernel(const int* __restrict__ addrs,
                                     const int* __restrict__ tbins, long long n, int base,
                                     int shift, int n_blocks, int n_tbins,
                                     int* __restrict__ hist, int merge) {
  extern __shared__ int4 smem4[];
  int* acc = reinterpret_cast<int*>(smem4);
  const int cells = n_tbins * n_blocks;

  long long lo, hi;
  block_share(n, lo, hi);
  const bool vec = aligned16(addrs) && aligned16(tbins);
  const long long span = static_cast<long long>(blockDim.x) * RECORDS;
  int a[RECORDS], t[RECORDS];
  int valid = load_records(addrs, tbins, lo + threadIdx.x * RECORDS, hi, vec, a, t);
  zero_shared(smem4, cells);
  // this block's map is zeroed: the others may add into it
  cluster_arrive();
  __syncthreads();

  Run run;
  // the bounds are the same for the whole block, so every lane takes every round
  for (long long r = lo; r < hi; r += span) {
    if (valid) {
#pragma unroll
      for (int j = 0; j < RECORDS; ++j)
        run.add(acc, j < valid ? hot_cell(a[j], t[j], base, shift, n_blocks, n_tbins) : -1);
    }
    valid = load_records(addrs, tbins, r + span + threadIdx.x * RECORDS, hi, vec, a, t);
  }
  flush_warp(acc, run, threadIdx.x & 31);
  __syncthreads();
  cluster_wait();
  merge_into_owners(smem4, cells, cells, hist, hist, merge);
}

// Block b owns cells [b*tile, (b+1)*tile) of the map (tile a multiple of 4,
// the last tile shorter; ops.tile_cells) and reads every record.
__global__ void __launch_bounds__(1024, 1)
    hotness_histogram_tiles_kernel(const int* __restrict__ addrs,
                                   const int* __restrict__ tbins, long long n, int base,
                                   int shift, int n_blocks, int n_tbins,
                                   int* __restrict__ hist, int tile) {
  extern __shared__ int4 smem4[];
  int* acc = reinterpret_cast<int*>(smem4);
  const int first = blockIdx.x * tile;
  const int mine = min(tile, n_tbins * n_blocks - first);

  const bool vec = aligned16(addrs) && aligned16(tbins);
  const long long span = static_cast<long long>(blockDim.x) * RECORDS;
  int a[RECORDS], t[RECORDS];
  int valid = load_records(addrs, tbins, threadIdx.x * RECORDS, n, vec, a, t);
  zero_shared(smem4, mine);
  __syncthreads();

  Run run;
  // the bounds are the same for the whole block, so every lane takes every round
  for (long long r = 0; r < n; r += span) {
    if (valid) {
#pragma unroll
      for (int j = 0; j < RECORDS; ++j) {
        // the cell's offset in this tile, as unsigned so that one compare
        // drops cells before and after it (and dropped records, cell -1)
        const unsigned off = static_cast<unsigned>(
            (j < valid ? hot_cell(a[j], t[j], base, shift, n_blocks, n_tbins) : -1) - first);
        run.add(acc, off < static_cast<unsigned>(mine) ? static_cast<int>(off) : -1);
      }
    }
    valid = load_records(addrs, tbins, r + span + threadIdx.x * RECORDS, n, vec, a, t);
  }
  flush_warp(acc, run, threadIdx.x & 31);
  __syncthreads();

  int* out = hist + first;
  const int groups = aligned16(out) ? mine / 4 : 0;
  for (int g = threadIdx.x; g < groups; g += blockDim.x)
    reinterpret_cast<int4*>(out)[g] = smem4[g];
  for (int j = 4 * groups + threadIdx.x; j < mine; j += blockDim.x) out[j] = acc[j];
}

__global__ void hotness_histogram_global_kernel(const int* __restrict__ addrs,
                                                const int* __restrict__ tbins, long long n,
                                                int base, int shift, int n_blocks, int n_tbins,
                                                int* __restrict__ hist) {
  for (long long i = first_index(); i < n; i += grid_stride()) {
    const int cell = hot_cell(addrs[i], tbins[i], base, shift, n_blocks, n_tbins);
    if (cell >= 0) atomicAdd(&hist[cell], 1);
  }
}

}  // namespace

// kind CLUSTER: `blocks` / `cluster` clusters of `cluster` blocks (cluster
// <= 8) of `threads` <= 1024, smem_bytes = 4*n_tbins*n_blocks; one cluster
// writes hist in full, several add into hist zeroed by the caller.  kind
// TILES: one block of `threads` per tile of smem_bytes / 4 cells (cluster is
// 0), writing hist in full.  kind GLOBAL: a grid of `blocks` blocks (cluster
// and smem_bytes are 0) adding into hist zeroed by the caller.  Returns the
// CUDA error of the launch.
extern "C" int hotness_histogram_launch(int device, const void* addrs, const void* tbins,
                                        long long n, int base, int shift, int n_blocks,
                                        int n_tbins, void* hist, int kind, int blocks,
                                        int cluster, int threads, int smem_bytes,
                                        void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (kind == KIND_CLUSTER) {
    int merge = blocks > cluster;
    void* args[] = {&addrs, &tbins, &n, &base, &shift, &n_blocks, &n_tbins, &hist, &merge};
    return launch(hotness_histogram_cluster_kernel, args, blocks, cluster, threads, smem_bytes,
                  stream);
  }
  if (kind == KIND_TILES) {
    int tile = smem_bytes / 4;
    void* args[] = {&addrs, &tbins, &n, &base, &shift, &n_blocks, &n_tbins, &hist, &tile};
    return launch(hotness_histogram_tiles_kernel, args, blocks, 0, threads, smem_bytes,
                  stream);
  }
  if (kind != KIND_GLOBAL) return cudaErrorInvalidValue;
  void* args[] = {&addrs, &tbins, &n, &base, &shift, &n_blocks, &n_tbins, &hist};
  return launch(hotness_histogram_global_kernel, args, blocks, 0, threads, 0, stream);
}
