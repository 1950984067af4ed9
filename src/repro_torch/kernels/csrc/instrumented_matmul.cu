// Instrumented matmul: out = x @ w in float32, and one access record per
// 128x128 output tile, [i, j, bytes_read, bytes_written], written once into
// a trace buffer on the device by the block that finishes the tile (the
// paper's in-kernel fine-grained tier, Table II).
//
// Replaces the TPU kernel `_kernel` of
// src/repro/kernels/instrumented_matmul.py (matmul_traced), whose grid step
// (i, j) holds a whole (128, K) row panel of x and (K, 128) column panel of
// w in VMEM and writes its record after the tile.  A Hopper block cannot
// hold 128*K operands at K = 13696, so both bodies below walk K through
// shared memory.  The wrapper (instrumented_matmul.py, `_plan`) picks the
// body from the dtype and the shape:
//
// * wgmma body (bf16, K a multiple of 8, so that TMA can describe the rows
//   of x).  Bound on the card at the main path's M = 128: bytes, the weight
//   stream, (M*K + K*N)*2 + M*N*4 bytes at 3.35 TB/s.  So the design keeps
//   many bytes in flight on every SM and spends no instructions on them: a
//   producer warp issues TMA loads of the x tile (128 x 64, K-major) and
//   the w tile (64 x 128 as two 64-column boxes, N-major) into a ring of
//   STAGES 32 KB stages with mbarrier completion, both with the 128-byte
//   swizzle; two consumer warpgroups each run
//   wgmma.m64n128k16.f32.bf16.bf16 on 64 of the 128 rows (B transposed,
//   since w's tile is N-contiguous) and keep a 64x128 float32 accumulator
//   in registers.  TMA fills the ragged last K slab with zeros.  When N/128
//   tiles are too few to fill the card, K is split S ways (S from `_plan`,
//   the largest S whose clusters of S blocks the card holds all at once, as
//   instrumented_matmul_resident reports: clusters are placed within one
//   GPC, so an H100 holds 66 clusters of 2 but only 30 of 4, not 33) and
//   the S blocks of a tile form one thread-block cluster: each writes
//   its partial tile to its own shared memory, and after a cluster barrier
//   rank r sums rows [r*128/S, (r+1)*128/S) of all S partials through
//   distributed shared memory in rank order 0..S-1 and stores them.  No
//   float atomics, so two calls give the same bits.  The TMA tensor maps
//   are encoded on the host with cuTensorMapEncodeTiled, reached through
//   cudaGetDriverEntryPoint (no -lcuda at link time), and passed as
//   __grid_constant__ parameters.
// * SIMT body (float32 operands, whose tensor-core path would be TF32; and
//   bf16 with K not a multiple of 8): one 128x128 tile per block, K in
//   32-deep slabs, an 8x8 micro-tile of float32 FMA per thread, bf16
//   widened on load; bound by its arithmetic at 67 TFLOP/s of float32.
//
// M and N are multiples of 128 (the wrapper checks), since the record is
// defined per 128x128 tile.
#include <cooperative_groups.h>
#include <cuda.h>  // CUtensorMap and its enums; the encoder is looked up at run time
#include <cuda_bf16.h>

#include <cstdint>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int BM = 128;
constexpr int BN = 128;

// ------------------------------------------------------------- SIMT body
constexpr int SIMT_BK = 32;
constexpr int SIMT_THREADS = 256;
constexpr int TM = 8;  // rows per thread
constexpr int TN = 8;  // columns per thread

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ void write_record(int* trace, long long tile, int i, int j,
                                             int bytes_read, int bytes_written) {
  int* rec = trace + 4 * tile;
  rec[0] = i;
  rec[1] = j;
  rec[2] = bytes_read;
  rec[3] = bytes_written;
}

template <typename T>
__global__ void __launch_bounds__(SIMT_THREADS)
    matmul_traced_simt(const T* __restrict__ x, const T* __restrict__ w,
                       float* __restrict__ out, int* __restrict__ trace, int k, int n,
                       int bytes_read, int bytes_written) {
  // x slab stored transposed (k-major) and padded so the transposing
  // stores of a warp land in distinct banks
  __shared__ float xs[SIMT_BK][BM + 1];
  __shared__ float ws[SIMT_BK][BN];
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const long long row0 = static_cast<long long>(blockIdx.y) * BM;
  const long long col0 = static_cast<long long>(blockIdx.x) * BN;
  const T* xb = x + row0 * k;
  const T* wb = w + col0;

  float acc[TM][TN];
#pragma unroll
  for (int r = 0; r < TM; ++r)
#pragma unroll
    for (int c = 0; c < TN; ++c) acc[r][c] = 0.f;

  for (int k0 = 0; k0 < k; k0 += SIMT_BK) {
    // x: BM x BK, consecutive threads on consecutive k of one row
#pragma unroll
    for (int i = 0; i < BM * SIMT_BK / SIMT_THREADS; ++i) {
      const int e = tid + i * SIMT_THREADS;
      const int r = e / SIMT_BK;
      const int kk = e % SIMT_BK;
      const int kg = k0 + kk;
      xs[kk][r] = kg < k ? widen(xb[static_cast<long long>(r) * k + kg]) : 0.f;
    }
    // w: BK x BN, consecutive threads on consecutive columns of one row
#pragma unroll
    for (int i = 0; i < SIMT_BK * BN / SIMT_THREADS; ++i) {
      const int e = tid + i * SIMT_THREADS;
      const int kk = e / BN;
      const int c = e % BN;
      const int kg = k0 + kk;
      ws[kk][c] = kg < k ? widen(wb[static_cast<long long>(kg) * n + c]) : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < SIMT_BK; ++kk) {
      float a[TM];
      float b[TN];
#pragma unroll
      for (int r = 0; r < TM; ++r) a[r] = xs[kk][ty + 16 * r];
#pragma unroll
      for (int c = 0; c < TN; ++c) b[c] = ws[kk][tx + 16 * c];
#pragma unroll
      for (int r = 0; r < TM; ++r)
#pragma unroll
        for (int c = 0; c < TN; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < TM; ++r)
#pragma unroll
    for (int c = 0; c < TN; ++c)
      out[(row0 + ty + 16 * r) * n + col0 + tx + 16 * c] = acc[r][c];

  if (tid == 0)
    write_record(trace, static_cast<long long>(blockIdx.y) * gridDim.x + blockIdx.x,
                 blockIdx.y, blockIdx.x, bytes_read, bytes_written);
}

// ------------------------------------------------------------ wgmma body
constexpr int BK = 64;                       // 64 bf16 = one 128-byte swizzle row
constexpr int STAGES = 6;
constexpr int CONSUMERS = 2;                 // warpgroups, 64 rows of the tile each
constexpr int WG_THREADS = 128 * (CONSUMERS + 1);  // + one producer warpgroup
constexpr int A_BYTES = BM * BK * 2;         // x tile, 16 KB
constexpr int B_BOX_BYTES = BK * 64 * 2;     // one 64-column box of the w tile, 8 KB
constexpr int STAGE_BYTES = A_BYTES + 2 * B_BOX_BYTES;
constexpr int PART_LD = BN + 4;              // floats per row of the partial tile
constexpr int WG_SMEM = STAGES * STAGE_BYTES + 1024 /* alignment */ + 2 * STAGES * 8;
static_assert(BM * PART_LD * 4 <= STAGES * STAGE_BYTES, "partial tile reuses the ring");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

// Returns once the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar,
                                         int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// Shared-memory matrix descriptor with the 128-byte swizzle; offsets in bytes.
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}

// Keeps the compiler from moving accumulator reads and writes across the
// asynchronous wgmma.
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64x128 float32, this warpgroup's fragment) += A (64x16, K-major) @
// B (16x128, N-major: transpose bit set).
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred acc;\n"
      "setp.ne.b32 acc, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
      "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, acc, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// Grid (S * N/128, M/128), clusters of S along x: block x = tile_n * S + rank.
__global__ void __launch_bounds__(WG_THREADS, 1)
    matmul_traced_wgmma(const __grid_constant__ CUtensorMap x_map,
                        const __grid_constant__ CUtensorMap w_map, float* __restrict__ out,
                        int* __restrict__ trace, int k, int n, int bytes_read,
                        int bytes_written) {
  extern __shared__ uint8_t smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: align the ring to it
  uint8_t* ring = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + STAGES * STAGE_BYTES);
  uint64_t* empty = full + STAGES;

  cg::cluster_group cluster = cg::this_cluster();
  const int split = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int tile_n = blockIdx.x / split;
  const int m0 = blockIdx.y * BM;
  const int n0 = tile_n * BN;
  // this block's K slabs: an even split of ceil(K/BK), never empty (_plan)
  const int slabs = (k + BK - 1) / BK;
  const int per = (slabs + split - 1) / split;
  const int kb0 = rank * per;
  const int kb1 = min(slabs, kb0 + per);

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  float d[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0.f;

  if (wg == CONSUMERS) {
    // producer: one thread keeps the ring full
    if (threadIdx.x == CONSUMERS * 128) {
      for (int kb = kb0, i = 0; kb < kb1; ++kb, ++i) {
        const int s = i % STAGES;
        mbar_wait(&empty[s], ((i / STAGES) & 1) ^ 1);
        uint8_t* st = ring + s * STAGE_BYTES;
        mbar_expect_tx(&full[s], STAGE_BYTES);
        tma_load(st, &x_map, &full[s], kb * BK, m0);
        tma_load(st + A_BYTES, &w_map, &full[s], n0, kb * BK);
        tma_load(st + A_BYTES + B_BOX_BYTES, &w_map, &full[s], n0 + 64, kb * BK);
      }
    }
  } else {
    for (int kb = kb0, i = 0; kb < kb1; ++kb, ++i) {
      const int s = i % STAGES;
      mbar_wait(&full[s], (i / STAGES) & 1);
      const uint8_t* st = ring + s * STAGE_BYTES;
      // x: rows of 128 B, 8-row groups 1024 B apart; this warpgroup's 64 rows
      // start 8 KB in; a 16-deep K step is 32 B along the row
      const uint64_t da = smem_desc(st + wg * 64 * 128, 16, 1024);
      // w: K rows of 128 B per 64-column box, 8-row groups 1024 B apart,
      // the second box 8 KB on; a 16-deep K step is 16 rows = 2048 B
      const uint64_t db = smem_desc(st + A_BYTES, B_BOX_BYTES, 1024);
      fence_acc(d);
      asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_m64n128k16(d, da + 2 * kk, db + 128 * kk);
      asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
      fence_acc(d);
      if (threadIdx.x % 128 == 0) mbar_arrive(&empty[s]);
    }
  }
  // every load has landed and every wgmma has read it: the ring is free
  __syncthreads();

  float* part = reinterpret_cast<float*>(ring);
  if (wg < CONSUMERS) {
    // wgmma's fragment: register pair i of lane l in warp w holds row
    // w*16 + l/4 (+8 for odd i/2), columns (i/4)*8 + (l%4)*2 + {0, 1}
    const int warp = (threadIdx.x % 128) / 32;
    const int lane = threadIdx.x % 32;
    const int row = wg * 64 + warp * 16 + lane / 4;
#pragma unroll
    for (int i = 0; i < 64; i += 2) {
      const int r = row + 8 * ((i / 2) % 2);
      const int c = (i / 4) * 8 + (lane % 4) * 2;
      *reinterpret_cast<float2*>(&part[r * PART_LD + c]) = make_float2(d[i], d[i + 1]);
    }
  }
  cluster.sync();

  // rank r sums its rows of the S partials in rank order and stores them
  const int rows = BM / split;
  const int r0 = rank * rows;
  for (int e = threadIdx.x; e < rows * (BN / 4); e += WG_THREADS) {
    const int r = r0 + e / (BN / 4);
    const int c = (e % (BN / 4)) * 4;
    float4 v = *reinterpret_cast<const float4*>(cluster.map_shared_rank(part, 0) + r * PART_LD + c);
    for (int q = 1; q < split; ++q) {
      const float4 u =
          *reinterpret_cast<const float4*>(cluster.map_shared_rank(part, q) + r * PART_LD + c);
      v.x += u.x;
      v.y += u.y;
      v.z += u.z;
      v.w += u.w;
    }
    *reinterpret_cast<float4*>(&out[static_cast<long long>(m0 + r) * n + n0 + c]) = v;
  }
  if (rank == 0 && threadIdx.x == 0)
    write_record(trace, static_cast<long long>(blockIdx.y) * (n / BN) + tile_n, blockIdx.y,
                 tile_n, bytes_read, bytes_written);
  // no block leaves while another still reads its partial
  cluster.sync();
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) ==
            cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A row-major bf16 (rows, cols) matrix cut into boxes of box_rows x 64
// columns with the 128-byte swizzle; out-of-range elements read as zero.
bool encode(CUtensorMap* map, const void* ptr, long long rows, long long cols, int box_rows) {
  EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 2};
  const cuuint32_t box[2] = {64, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims, strides,
            box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Launch configuration of the wgmma body: grid (split * tiles_n, tiles_m)
// in clusters of `split` blocks along x.  `attr` must outlive `cfg`.
cudaError_t wgmma_config(cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr, int split,
                         int tiles_n, int tiles_m, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      matmul_traced_wgmma, cudaFuncAttributeMaxDynamicSharedMemorySize, WG_SMEM);
  *cfg = {};
  cfg->gridDim = dim3(split * tiles_n, tiles_m);
  cfg->blockDim = dim3(WG_THREADS);
  cfg->dynamicSmemBytes = WG_SMEM;
  cfg->stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = split;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return err;
}

cudaError_t launch_wgmma(const void* x, const void* w, float* out, int* trace, int m, int k,
                         int n, int split, int bytes_read, int bytes_written,
                         cudaStream_t stream) {
  CUtensorMap x_map, w_map;
  if (!encode(&x_map, x, m, k, BM) || !encode(&w_map, w, k, n, BK))
    return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = wgmma_config(&cfg, &attr, split, n / BN, m / BM, stream);
  if (err != cudaSuccess) return err;
  void* args[] = {&x_map, &w_map, &out, &trace, &k, &n, &bytes_read, &bytes_written};
  return cudaLaunchKernelExC(&cfg, reinterpret_cast<const void*>(matmul_traced_wgmma), args);
}

}  // namespace

// How many clusters of `split` blocks of the wgmma body the card holds at
// once, into *count (the split-K rule keeps a product's tiles within it).
// Returns the CUDA error of the query.
extern "C" int instrumented_matmul_resident(int device, int split, int* count) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  err = wgmma_config(&cfg, &attr, split, 1, 1, nullptr);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveClusters(count, reinterpret_cast<const void*>(matmul_traced_wgmma),
                                        &cfg);
}

// x (m, k) and w (k, n), both row-major and of one type (bf16 when
// is_bf16, else float32); m and n multiples of 128.  split = 0 runs the
// SIMT body; split = S >= 1 the wgmma body (bf16, k a multiple of 8, x and
// w 16-byte aligned) with K split S ways over a cluster of S blocks.  out
// (m, n) float32 and trace (m/128 * n/128, 4) int32 are written in full.
// Returns the CUDA error of the launch.
extern "C" int instrumented_matmul_launch(int device, const void* x, const void* w,
                                          void* out, void* trace, int m, int k, int n,
                                          int is_bf16, int split, int bytes_read,
                                          int bytes_written, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  int* t = static_cast<int*>(trace);
  if (split > 0) {
    if (!is_bf16) return cudaErrorInvalidValue;
    err = launch_wgmma(x, w, o, t, m, k, n, split, bytes_read, bytes_written, s);
    return err != cudaSuccess ? err : cudaGetLastError();
  }
  const dim3 grid(n / BN, m / BM);
  if (is_bf16) {
    matmul_traced_simt<__nv_bfloat16><<<grid, SIMT_THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w), o, t, k, n,
        bytes_read, bytes_written);
  } else {
    matmul_traced_simt<float><<<grid, SIMT_THREADS, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w), o, t, k, n, bytes_read,
        bytes_written);
  }
  return cudaGetLastError();
}
