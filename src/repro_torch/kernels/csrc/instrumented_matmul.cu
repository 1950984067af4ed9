// Instrumented matmul: out = x @ w in float32, and one access record per
// 128x128 output tile, [i, j, bytes_read, bytes_written], written by the
// block that computed the tile into a trace buffer on the device (the
// paper's in-kernel fine-grained tier, Table II).
//
// Replaces the TPU kernel `_kernel` of
// src/repro/kernels/instrumented_matmul.py (matmul_traced), whose grid step
// (i, j) holds a whole (128, K) row panel of x and (K, 128) column panel of
// w in VMEM and writes its record after the tile.  A Hopper block cannot
// hold 128*K operands at K = 13696, so each block here owns one 128x128
// output tile (grid (N/128, M/128)) and walks K in slabs of BK = 32 through
// shared memory.  Its 256 threads each keep an 8x8 micro-tile of the sum in
// registers (rows ty + 16*r, columns tx + 16*c, so a warp reads the w slab
// without bank conflicts) and accumulate with float32 FMA; bf16 operands
// are widened to float32 as they are loaded.  The result is
// x.float() @ w.float() summed in another order.  The slab loop masks a K
// that is not a multiple of BK; M and N are multiples of 128 (the wrapper
// checks), since the record is defined per 128x128 tile.
//
// Bound on the card: max(2*M*N*K / peak, (M*K*sx + K*N*sw + M*N*4) / 3.35e12)
// with peak 989e12 for bf16 on the tensor cores (67e12 for float32 FMA).
// At M = 128 tokens the bf16 products are bytes-bound: (128, 4096) @
// (4096, 13696) moves about 120 MB, about 36 us.  This simple kernel uses
// no tensor cores, TMA or pipelining and is limited by float32 FMA and by
// M/128 * N/128 blocks, which leaves most SMs idle at N = 4096.
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 32;
constexpr int THREADS = 256;
constexpr int TM = 8;  // rows per thread
constexpr int TN = 8;  // columns per thread

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__global__ void __launch_bounds__(THREADS)
    matmul_traced_kernel(const T* __restrict__ x, const T* __restrict__ w,
                         float* __restrict__ out, int* __restrict__ trace, int k,
                         int n, int bytes_read, int bytes_written) {
  // x slab stored transposed (k-major) and padded so the transposing
  // stores of a warp land in distinct banks
  __shared__ float xs[BK][BM + 1];
  __shared__ float ws[BK][BN];
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

  for (int k0 = 0; k0 < k; k0 += BK) {
    // x: BM x BK, consecutive threads on consecutive k of one row
#pragma unroll
    for (int i = 0; i < BM * BK / THREADS; ++i) {
      const int e = tid + i * THREADS;
      const int r = e / BK;
      const int kk = e % BK;
      const int kg = k0 + kk;
      xs[kk][r] = kg < k ? widen(xb[static_cast<long long>(r) * k + kg]) : 0.f;
    }
    // w: BK x BN, consecutive threads on consecutive columns of one row
#pragma unroll
    for (int i = 0; i < BK * BN / THREADS; ++i) {
      const int e = tid + i * THREADS;
      const int kk = e / BN;
      const int c = e % BN;
      const int kg = k0 + kk;
      ws[kk][c] = kg < k ? widen(wb[static_cast<long long>(kg) * n + c]) : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
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

  // the tile's access record, one row per block
  if (tid == 0) {
    int* rec = trace + 4 * (static_cast<long long>(blockIdx.y) * gridDim.x + blockIdx.x);
    rec[0] = blockIdx.y;
    rec[1] = blockIdx.x;
    rec[2] = bytes_read;
    rec[3] = bytes_written;
  }
}

}  // namespace

// x (m, k) and w (k, n), both row-major and of one type (bf16 when
// is_bf16, else float32); m and n multiples of 128.  out (m, n) float32 and
// trace (m/128 * n/128, 4) int32 are written in full.  Returns the CUDA
// error of the launch.
extern "C" int instrumented_matmul_launch(int device, const void* x, const void* w,
                                          void* out, void* trace, int m, int k, int n,
                                          int is_bf16, int bytes_read, int bytes_written,
                                          void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const dim3 grid(n / BN, m / BM);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    matmul_traced_kernel<__nv_bfloat16><<<grid, THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
        static_cast<float*>(out), static_cast<int*>(trace), k, n, bytes_read,
        bytes_written);
  } else {
    matmul_traced_kernel<float><<<grid, THREADS, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<float*>(out), static_cast<int*>(trace), k, n, bytes_read,
        bytes_written);
  }
  return cudaGetLastError();
}
