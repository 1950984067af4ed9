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
//   bf16 that TMA cannot describe): float32 FMA, no tensor cores, so it is
//   bound by its arithmetic, 2*M*N*K operations at 67 TFLOP/s of float32.
//   It replaces a first, simple body (one 32-deep slab in flight, K not
//   split) that lost for two causes, and the design answers each:
//   - too few blocks on the narrow products (a 128 x 4096 x 4096 product
//     is 32 tiles on 132 SMs): K is split S ways over blockIdx.z where the
//     tiles leave SMs idle (S from `_simt_plan`, the smallest S with
//     tiles * S >= 0.9 * SMs, balanced slab ranges).  Each split block
//     stores its float32 partial tile into a workspace (S, M, N); a second
//     kernel, matmul_traced_sum, launched by the same entry on the same
//     stream, sums a tile's S partials in split order 0..S-1, stores the
//     tile and writes its record.  No float atomics: two calls give the
//     same bits.
//   - low per-block efficiency: slabs 32 deep go through a ring of
//     SIMT_STAGES shared-memory stages, slab s + SIMT_STAGES - 1 copied
//     while slab s is multiplied.  Where both operands' rows can be
//     described in 16 bytes (float32, K % 4 == 0, 16-byte aligned: the
//     "async" loader) the copies are cp.async: w's rows in 16-byte
//     cp.async.cg copies, n-major as they lie; x's in 4-byte cp.async.ca
//     copies that transpose it to k-major on the way (a 16-byte copy cannot
//     transpose), its k rows padded to BM + 4 floats so that a warp's 32
//     copies (8 k x 4 rows) land in 32 banks.  cp.async's src-size zero
//     fills the ragged last slab.  Every other case (bf16, K % 4 != 0, an
//     unaligned operand: the "scalar" loader) loads and widens with plain
//     loads into the same ring.  256 threads, 8 warps of 32 x 64 outputs, a
//     thread 8 x 8 float32 accumulators as four 4 x 4 blocks: one k step
//     is 4 shared loads of 16 bytes (x's 8 rows, w's 8 columns) per 64 FMA,
//     the fragments double-buffered in registers so that step k+1's loads
//     issue under step k's FMAs.
//   Two stages, not three or four: a stage is 33,280 bytes, and two blocks
//   of two stages (66,560 bytes each) leave more of the SM's 256 KB of L1
//   and shared memory to L1, which x's 4-byte copies go through; on the
//   H100 two stages beat three by 3-5% and four (one block an SM) by 11%
//   (ab_simt_body.py; the cause is not measured).  The cp.async instance
//   takes 127 registers a thread and no spills (nvcc -Xptxas -v), and the
//   SM holds 2 blocks (the occupancy API; instrumented_matmul_simt_info).
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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ------------------------------------------------------------- SIMT body
constexpr int SIMT_BK = 32;                  // K depth of one stage
constexpr int SIMT_STAGES = 2;
constexpr int SIMT_THREADS = 256;
constexpr int XS_LD = BM + 4;                // floats per k row of x's stage (k-major)
constexpr int XS_FLOATS = SIMT_BK * XS_LD;
constexpr int SIMT_STAGE_FLOATS = XS_FLOATS + SIMT_BK * BN;
constexpr int SIMT_SMEM = SIMT_STAGES * SIMT_STAGE_FLOATS * 4;  // 66,560 bytes
constexpr int SUM_THREADS = 1024;

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

// Asynchronous copies of `bytes` (4 or 16) from global to shared memory;
// `full` false copies nothing and fills the destination with zeros.
template <int BYTES>
__device__ __forceinline__ void cp_async(float* dst, const float* src, bool full) {
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(smem_u32(dst)),
                 "l"(src), "r"(full ? 16 : 0)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(smem_u32(dst)),
                 "l"(src), "r"(full ? 4 : 0)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// Returns once at most `PENDING` of this thread's copy groups are in flight.
template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(PENDING) : "memory");
}

__device__ __forceinline__ void lds4(float* d, const float* s) {
  const float4 v = *reinterpret_cast<const float4*>(s);
  d[0] = v.x;
  d[1] = v.y;
  d[2] = v.z;
  d[3] = v.w;
}

// Grid (N/128, M/128, S): block z multiplies K slabs [z*slabs/S,
// (z+1)*slabs/S) of tile (blockIdx.y, blockIdx.x).  With S = 1 it stores
// the tile into dst (the output) and writes its record; with S > 1 it
// stores its partial tile into plane z of dst (the (S, M, N) workspace).
// ASYNC: the cp.async loader (float32, K % 4 == 0, 16-byte aligned).
template <typename T, bool ASYNC>
__global__ void __launch_bounds__(SIMT_THREADS)
    matmul_traced_simt(const T* __restrict__ x, const T* __restrict__ w, float* __restrict__ dst,
                       int* __restrict__ trace, int k, int n, int bytes_read,
                       int bytes_written) {
  extern __shared__ __align__(16) float simt_smem[];
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const long long row0 = static_cast<long long>(blockIdx.y) * BM;
  const int col0 = blockIdx.x * BN;
  const int slabs = (k + SIMT_BK - 1) / SIMT_BK;
  const int kb0 = static_cast<int>(static_cast<long long>(blockIdx.z) * slabs / gridDim.z);
  const int count =
      static_cast<int>(static_cast<long long>(blockIdx.z + 1) * slabs / gridDim.z) - kb0;

  // copies: x element (kt, rt + 8i), i < 16, a warp 8 k x 4 rows (32 banks
  // at the padded pitch); w row 8i + warp (async, 16 bytes a lane) or row
  // 2i + tid/128 (scalar), a warp one contiguous run of a row
  const int kt = 8 * (warp % 4) + lane % 8;
  const int rt = 4 * (warp / 4) + lane / 8;
  auto load = [&](int stage, int kb) {
    float* xs = simt_smem + stage * SIMT_STAGE_FLOATS;
    float* ws = xs + XS_FLOATS;
    const int k0 = kb * SIMT_BK;
    const bool xin = k0 + kt < k;
    // clamped into the operand: a zero-filling copy still names an address
    const T* xsrc = x + (row0 + rt) * k + min(k0 + kt, k - 1);
#pragma unroll
    for (int i = 0; i < BM / 8; ++i) {
      float* d = xs + kt * XS_LD + rt + 8 * i;
      const T* src = xsrc + 8LL * i * k;
      if constexpr (ASYNC)
        cp_async<4>(d, src, xin);
      else
        *d = xin ? widen(*src) : 0.f;
    }
    if constexpr (ASYNC) {
#pragma unroll
      for (int i = 0; i < SIMT_BK / 8; ++i) {
        const int kr = 8 * i + warp;
        const T* src = w + static_cast<long long>(min(k0 + kr, k - 1)) * n + col0 + 4 * lane;
        cp_async<16>(ws + kr * BN + 4 * lane, src, k0 + kr < k);
      }
    } else {
#pragma unroll
      for (int i = 0; i < SIMT_BK / 2; ++i) {
        const int kr = 2 * i + tid / 128;
        const int c = tid % 128;
        ws[kr * BN + c] =
            k0 + kr < k ? widen(w[static_cast<long long>(k0 + kr) * n + col0 + c]) : 0.f;
      }
    }
  };

  // compute: warp (warp/2, warp%2) takes rows 32*(warp/2) + [0, 32) and
  // columns 64*(warp%2) + [0, 64); the thread rows ra + {0..3, 16..19} and
  // columns cb + {0..3, 32..35}
  const int ra = 32 * (warp / 2) + 4 * (lane / 8);
  const int cb = 64 * (warp % 2) + 4 * (lane % 8);
  float acc[8][8];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[r][c] = 0.f;

#pragma unroll
  for (int s = 0; s < SIMT_STAGES - 1; ++s) {
    if (s < count) load(s, kb0 + s);
    if constexpr (ASYNC) cp_async_commit();
  }
  for (int s = 0; s < count; ++s) {
    // slab s has landed for every thread, and every thread is done with
    // slab s - 1, whose stage takes slab s + SIMT_STAGES - 1
    if constexpr (ASYNC) cp_async_wait<SIMT_STAGES - 2>();
    __syncthreads();
    const int next = s + SIMT_STAGES - 1;
    if (next < count) load(next % SIMT_STAGES, kb0 + next);
    if constexpr (ASYNC) cp_async_commit();

    const float* xs = simt_smem + (s % SIMT_STAGES) * SIMT_STAGE_FLOATS + ra;
    const float* ws = simt_smem + (s % SIMT_STAGES) * SIMT_STAGE_FLOATS + XS_FLOATS + cb;
    float a[2][8], b[2][8];
    lds4(a[0], xs);
    lds4(a[0] + 4, xs + 16);
    lds4(b[0], ws);
    lds4(b[0] + 4, ws + 32);
#pragma unroll
    for (int kk = 0; kk < SIMT_BK; ++kk) {
      const int cur = kk % 2;
      if (kk + 1 < SIMT_BK) {
        lds4(a[cur ^ 1], xs + (kk + 1) * XS_LD);
        lds4(a[cur ^ 1] + 4, xs + (kk + 1) * XS_LD + 16);
        lds4(b[cur ^ 1], ws + (kk + 1) * BN);
        lds4(b[cur ^ 1] + 4, ws + (kk + 1) * BN + 32);
      }
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[r][c] = fmaf(a[cur][r], b[cur][c], acc[r][c]);
    }
  }
  if constexpr (ASYNC) cp_async_wait<0>();

  float* tile = dst + blockIdx.z * static_cast<long long>(gridDim.y) * BM * n + row0 * n + col0;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    float* row = tile + static_cast<long long>(ra + r % 4 + 16 * (r / 4)) * n + cb;
    *reinterpret_cast<float4*>(row) = make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
    *reinterpret_cast<float4*>(row + 32) =
        make_float4(acc[r][4], acc[r][5], acc[r][6], acc[r][7]);
  }
  if (gridDim.z == 1 && tid == 0)
    write_record(trace, static_cast<long long>(blockIdx.y) * gridDim.x + blockIdx.x,
                 blockIdx.y, blockIdx.x, bytes_read, bytes_written);
}

// Grid (N/128, M/128): sums the `split` partial tiles of the (split, M, N)
// workspace in split order, stores the tile and writes its record.
__global__ void __launch_bounds__(SUM_THREADS)
    matmul_traced_sum(const float* __restrict__ part, float* __restrict__ out,
                      int* __restrict__ trace, int m, int n, int split, int bytes_read,
                      int bytes_written) {
  const long long plane = static_cast<long long>(m) * n;
  const long long base = static_cast<long long>(blockIdx.y) * BM * n + blockIdx.x * BN;
#pragma unroll 4
  for (int e = threadIdx.x; e < BM * BN / 4; e += SUM_THREADS) {
    const long long at = base + static_cast<long long>(e / (BN / 4)) * n + (e % (BN / 4)) * 4;
    float4 v = *reinterpret_cast<const float4*>(part + at);
    for (int q = 1; q < split; ++q) {
      const float4 u = *reinterpret_cast<const float4*>(part + q * plane + at);
      v.x += u.x;
      v.y += u.y;
      v.z += u.z;
      v.w += u.w;
    }
    *reinterpret_cast<float4*>(out + at) = v;
  }
  if (threadIdx.x == 0)
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

template <typename T>
using SimtKernel = void (*)(const T*, const T*, float*, int*, int, int, int, int);

// The SIMT body's instance, opted into its dynamic shared memory.
template <typename T, bool ASYNC>
cudaError_t simt_kernel(SimtKernel<T>* kern) {
  *kern = matmul_traced_simt<T, ASYNC>;
  return allow_smem(*kern, SIMT_SMEM);
}

template <typename T, bool ASYNC>
cudaError_t launch_simt_body(const void* x, const void* w, float* dst, int* trace, int m, int k,
                             int n, int split, int bytes_read, int bytes_written,
                             cudaStream_t stream) {
  SimtKernel<T> kern;
  cudaError_t err = simt_kernel<T, ASYNC>(&kern);
  if (err != cudaSuccess) return err;
  kern<<<dim3(n / BN, m / BM, split), SIMT_THREADS, SIMT_SMEM, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), dst, trace, k, n, bytes_read,
      bytes_written);
  return cudaGetLastError();
}

// The SIMT body with K split `split` ways (workspace (split, m, n) float32
// when split > 1), then its sum; loader 1 is cp.async, 0 scalar loads.
cudaError_t launch_simt(const void* x, const void* w, float* out, int* trace, float* workspace,
                        int m, int k, int n, int is_bf16, int split, int loader,
                        int bytes_read, int bytes_written, cudaStream_t stream) {
  const bool aligned = (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w)) % 16 == 0;
  if (split < 1 || (split > 1 && workspace == nullptr) || (loader != 0 && loader != 1) ||
      (loader == 1 && (is_bf16 || k % 4 || !aligned)))
    return cudaErrorInvalidValue;
  float* dst = split > 1 ? workspace : out;
  cudaError_t err;
  if (loader == 1)
    err = launch_simt_body<float, true>(x, w, dst, trace, m, k, n, split, bytes_read,
                                        bytes_written, stream);
  else if (is_bf16)
    err = launch_simt_body<__nv_bfloat16, false>(x, w, dst, trace, m, k, n, split, bytes_read,
                                                 bytes_written, stream);
  else
    err = launch_simt_body<float, false>(x, w, dst, trace, m, k, n, split, bytes_read,
                                         bytes_written, stream);
  if (err != cudaSuccess || split == 1) return err;
  matmul_traced_sum<<<dim3(n / BN, m / BM), SUM_THREADS, 0, stream>>>(
      workspace, out, trace, m, n, split, bytes_read, bytes_written);
  return cudaGetLastError();
}

template <typename T, bool ASYNC>
cudaError_t simt_info(int* info) {
  SimtKernel<T> kern;
  cudaError_t err = simt_kernel<T, ASYNC>(&kern);
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kern);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&info[3], kern, SIMT_THREADS, SIMT_SMEM);
  if (err != cudaSuccess) return err;
  info[0] = attr.numRegs;
  info[1] = static_cast<int>(attr.localSizeBytes);
  info[2] = static_cast<int>(attr.sharedSizeBytes) + SIMT_SMEM;
  return cudaSuccess;
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

// What the compiler and the occupancy API say of the SIMT body with this
// operand type and loader: info[0] registers a thread, info[1] bytes a
// thread spills to local memory, info[2] shared memory bytes a block,
// info[3] blocks an SM holds at once.  Returns the CUDA error.
extern "C" int instrumented_matmul_simt_info(int device, int is_bf16, int loader, int* info) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (loader == 1) return is_bf16 ? cudaErrorInvalidValue : simt_info<float, true>(info);
  return is_bf16 ? simt_info<__nv_bfloat16, false>(info) : simt_info<float, false>(info);
}

// x (m, k) and w (k, n), both row-major and of one type (bf16 when
// is_bf16, else float32); m and n multiples of 128.  body 1 runs the wgmma
// body (bf16, k a multiple of 8, x and w 16-byte aligned) with K split
// `split` ways over a cluster of `split` blocks; body 0 the SIMT body with
// K split `split` ways and its loader (1 cp.async: float32, k a multiple
// of 4, x and w 16-byte aligned; 0 scalar loads), summing the partials
// through `workspace`, (split, m, n) float32, when split > 1.  out (m, n)
// float32 and trace (m/128 * n/128, 4) int32 are written in full.  Returns
// the first CUDA error of the launches, or cudaErrorInvalidValue for
// arguments that do not go together.
extern "C" int instrumented_matmul_launch(int device, const void* x, const void* w,
                                          void* out, void* trace, void* workspace, int m,
                                          int k, int n, int is_bf16, int body, int split,
                                          int loader, int bytes_read, int bytes_written,
                                          void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  int* t = static_cast<int*>(trace);
  if (body == 1) {
    if (!is_bf16 || split < 1) return cudaErrorInvalidValue;
    err = launch_wgmma(x, w, o, t, m, k, n, split, bytes_read, bytes_written, s);
    return err != cudaSuccess ? err : cudaGetLastError();
  }
  if (body != 0) return cudaErrorInvalidValue;
  return launch_simt(x, w, o, t, static_cast<float*>(workspace), m, k, n, is_bf16, split, loader,
                     bytes_read, bytes_written, s);
}
