// Batched permuted multiply-reduce over square operands, the materialized
// Mantel baseline (paper Algorithm 5):
//
//   stats[b] = sum_{i,j} x[o_b[i], o_b[j]] * yhat[i, j]
//
// for the B permutation orders o_b of one tile; the wrapper divides by
// 2 ||x - mean(x)||.
//
// Replaces: src/repro/kernels/mantel_corr.py::mantel_corr (_mantel_kernel),
// together with the row and column gathers its wrapper runs in XLA.
//
// Bound on an H100: bytes. Each permutation reads x once (4 n^2 bytes) and
// the launch reads yhat once: 4 n^2 (B + 1) bytes, 30.1 GB at n = 16384 and
// B = 27, 8.97 ms at 3.35 TB/s. The products are 2 B n^2 flops, 0.22 ms at
// the 67 TFLOP/s fp32 rate, so memory is the limit by 40x.
//
// Design: the Pallas kernel takes B pre-gathered (n, n) squares, which XLA
// builds because scalar random access does not vectorize on the TPU's VPU;
// at n = 16384 and B = 27 that buffer is 29 GB and triples the bytes. Here
// the gather is fused. A block owns one row i of yhat and loops over the
// tile's permutations; for each it copies row o_b[i] of x into shared memory
// with coalesced (16-byte where aligned) loads, then walks j contiguously,
// reading x_row[o_b[j]] from shared memory, the order row from global memory
// (B n 4 bytes in all, 1.8 MB at n = 16384: L2-resident) and yhat[i, j]
// (the block's own 4 n-byte row, re-read from L1/L2 for each permutation).
// So x leaves device memory once per permutation, in whole rows. The row
// takes 4 n bytes of shared memory (64 KB at n = 16384, three blocks an SM;
// 185 KB at n = 46340, one block an SM); the wrapper refuses rows that do
// not fit. Each thread sums its share of a row in fp32 (n / 512 products),
// the block reduces in fp64 in a fixed order and writes one partial per
// (i, b); a second kernel sums the n partials of each permutation in a fixed
// order in fp64. No float atomics: the draws are bitwise reproducible.
// Ragged n is masked; nothing is padded.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kFinishThreads = 256;

__global__ void __launch_bounds__(kThreads)
partials_kernel(const float* __restrict__ x, const float* __restrict__ yhat,
                const int* __restrict__ orders, double* __restrict__ partials, int n,
                int num_perms) {
  extern __shared__ __align__(16) float x_row[];
  __shared__ double warp_sums[kWarps];

  const int i = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float* y_row = yhat + static_cast<size_t>(i) * n;
  const bool vec = (n & 3) == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;

  for (int b = 0; b < num_perms; ++b) {
    const int* order = orders + static_cast<size_t>(b) * n;
    const float* src = x + static_cast<size_t>(__ldg(order + i)) * n;
    if (vec) {
      const float4* src4 = reinterpret_cast<const float4*>(src);
      float4* dst4 = reinterpret_cast<float4*>(x_row);
      for (int t = threadIdx.x; t < n / 4; t += kThreads) dst4[t] = __ldg(src4 + t);
    } else {
      for (int t = threadIdx.x; t < n; t += kThreads) x_row[t] = __ldg(src + t);
    }
    __syncthreads();

    float acc = 0.0f;
#pragma unroll 4
    for (int j = threadIdx.x; j < n; j += kThreads) {
      acc = fmaf(x_row[__ldg(order + j)], __ldg(y_row + j), acc);
    }
    const double v = repro::warp_sum(static_cast<double>(acc));
    if (lane == 0) warp_sums[warp] = v;
    // also orders this permutation's reads of x_row before the next staging
    __syncthreads();
    if (threadIdx.x == 0) {
      double total = 0.0;
      for (int w = 0; w < kWarps; ++w) total += warp_sums[w];
      partials[static_cast<size_t>(i) * num_perms + b] = total;
    }
  }
}

// out[b] = sum over rows of partials[row][b]: one block per permutation,
// fixed strided order per thread, fixed tree across threads.
__global__ void __launch_bounds__(kFinishThreads)
finish_kernel(const double* __restrict__ partials, float* __restrict__ out, int rows,
              int num_perms) {
  __shared__ double warp_sums[kFinishThreads / 32];
  const int b = blockIdx.x;
  double v = 0.0;
  for (int r = threadIdx.x; r < rows; r += kFinishThreads) {
    v += partials[static_cast<size_t>(r) * num_perms + b];
  }
  v = repro::warp_sum(v);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    double total = 0.0;
    for (int w = 0; w < kFinishThreads / 32; ++w) total += warp_sums[w];
    out[b] = static_cast<float>(total);
  }
}

}  // namespace

// x, yhat: (n, n) fp32, contiguous; orders: (B, n) int32; partials: (n, B)
// fp64 scratch. 4 n bytes of shared memory a block must fit the opt-in limit.
REPRO_EXPORT int repro_mantel_corr_partials(const float* x, const float* yhat, const int* orders,
                                            double* partials, int n, int num_perms,
                                            cudaStream_t stream) {
  if (n <= 0 || num_perms <= 0) return static_cast<int>(cudaGetLastError());
  const size_t smem = static_cast<size_t>(n) * sizeof(float);
  const cudaError_t err = cudaFuncSetAttribute(
      partials_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  partials_kernel<<<n, kThreads, smem, stream>>>(x, yhat, orders, partials, n, num_perms);
  return static_cast<int>(cudaGetLastError());
}

// partials: (rows, B) fp64; out: (B,) fp32.
REPRO_EXPORT int repro_mantel_corr_finish(const double* partials, float* out, int rows,
                                          int num_perms, cudaStream_t stream) {
  if (num_perms > 0) {
    finish_kernel<<<num_perms, kFinishThreads, 0, stream>>>(partials, out, rows, num_perms);
  }
  return static_cast<int>(cudaGetLastError());
}
