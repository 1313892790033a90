// Batched permuted multiply-reduce over square operands, the materialized
// Mantel baseline (paper Algorithm 5):
//
//   stats[b] = sum_{i,j} x[o_b[i], o_b[j]] * yhat[i, j]
//
// for the B permutation orders o_b of one tile; the wrapper divides by
// 2 ||x - mean(x)||. Any x and yhat: the full square is summed.
//
// Replaces: src/repro/kernels/mantel_corr.py::mantel_corr (_mantel_kernel),
// together with the row and column gathers its wrapper runs in XLA.
//
// Bound on an H100: bytes. Each permutation passes over one operand once
// (4 n^2 bytes) and the launch reads the other once: 4 n^2 (B + 1) bytes,
// 30.1 GB at n = 16384 and B = 27, 8.97 ms at 3.35 TB/s. The products are
// 2 B n^2 flops, 0.22 ms at the 67 TFLOP/s fp32 rate, so memory is the limit
// by 40x.
//
// Design: the Pallas kernel takes B pre-gathered (n, n) squares, which XLA
// builds because scalar random access does not vectorize on the TPU's VPU;
// at n = 16384 and B = 27 that buffer is 29 GB and triples the bytes. Here
// the gather is fused, row-stationary: with pi_b the inverse of o_b,
//
//   stats[b] = sum_r sum_j x[r, o_b[j]] * yhat[pi_b(r), j].
//
// A block holds row r of x in shared memory (4 n bytes: 64 KB at n = 16384,
// three blocks an SM; 227 KB at n = 58112, one) for all B permutations,
// staged once with 16-byte loads. Then, with no barrier between
// permutations, for each b it streams yhat row pi_b(r) and order row b
// (16-bit, from csrc/inverse_orders.cu: 1.8 MB for the tile, L2-resident),
// 16 and 8 bytes a thread when n % 4 == 0, scalar otherwise, and gathers
// x_row[o_b[j]] from shared memory. So yhat leaves device memory once per
// permutation in whole rows and x once a launch, the bound's bytes. Blocks
// stride over the rows of x. Each thread sums its share of a (r, b) row in
// fp32 (n / 512 products), a warp butterfly sums the lanes in fp64, each
// warp keeps its running sum of each b in an fp64 register (lane b % 32,
// slot b / 32), and at the end the block sums its warps in a fixed order and
// writes one partial per (block, b); a second kernel sums the blocks in a
// fixed order in fp64. No float atomics: the draws are bitwise reproducible.
//
// Column-range mode, for the distributed Mantel test, whose ranks each hold
// the columns [c0, c0 + c) of yhat as an (n, c) block:
//
//   stats[b] = sum_i sum_{j in [c0, c0 + c)} x[o_b[i], o_b[j]] * yhat_blk[i, j - c0]
//
// The same walk: row r of x staged whole, yhat_blk row pi_b(r) of length c
// streamed, o_b[c0 : c0 + c] read. The vector path needs c % 4 == 0 and
// c0 % 4 == 0 (16-byte yhat rows, 8-byte order runs); otherwise the scalar
// path runs. The full square is c0 = 0, c = n: the same loops, the same bits.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxPerms = 128;   // B a launch: four slots a lane
constexpr int kSlots = kMaxPerms / 32;
constexpr int kFinishThreads = 256;

__global__ void __launch_bounds__(kThreads)
partials_kernel(const float* __restrict__ x, const float* __restrict__ yhat,
                const int* __restrict__ inv, const unsigned short* __restrict__ orders,
                double* __restrict__ partials, int n, int cols, int c0, int num_perms) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* x_row = reinterpret_cast<float*>(smem);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const bool vec = (cols & 3) == 0 && (c0 & 3) == 0 && (n & 3) == 0 &&
                   (reinterpret_cast<uintptr_t>(yhat) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(orders) & 7) == 0;

  double acc[kSlots];
#pragma unroll
  for (int k = 0; k < kSlots; ++k) acc[k] = 0.0;

  for (int r = blockIdx.x; r < n; r += gridDim.x) {
    __syncthreads();   // the previous row's reads of x_row are done
    repro::stage_run(x_row, x + static_cast<size_t>(r) * n, n, threadIdx.x, kThreads);
    __syncthreads();

    for (int b = 0; b < num_perms; ++b) {
      const size_t row = static_cast<size_t>(b) * n;
      const int i = __ldg(inv + row + r);
      const float* y_row = yhat + static_cast<size_t>(i) * cols;
      const unsigned short* order = orders + row + c0;
      float f = 0.0f;
      if (vec) {
        const float4* y4 = reinterpret_cast<const float4*>(y_row);
        const ushort4* o4 = reinterpret_cast<const ushort4*>(order);
#pragma unroll 4
        for (int q = threadIdx.x; q < cols / 4; q += kThreads) {
          const float4 y = __ldg(y4 + q);
          const ushort4 o = __ldg(o4 + q);
          f = fmaf(y.x, x_row[o.x], f);
          f = fmaf(y.y, x_row[o.y], f);
          f = fmaf(y.z, x_row[o.z], f);
          f = fmaf(y.w, x_row[o.w], f);
        }
      } else {
#pragma unroll 4
        for (int j = threadIdx.x; j < cols; j += kThreads) {
          f = fmaf(__ldg(y_row + j), x_row[__ldg(order + j)], f);
        }
      }
      const double v = repro::warp_allsum(static_cast<double>(f));
#pragma unroll
      for (int k = 0; k < kSlots; ++k) {
        if (k == (b >> 5) && lane == (b & 31)) acc[k] += v;
      }
    }
  }

  // the block's sums: each warp's slots through shared memory, then summed
  // over the warps in a fixed order
  __syncthreads();
  double* red = reinterpret_cast<double*>(smem);
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    const int b = k * 32 + lane;
    if (b < num_perms) red[warp * num_perms + b] = acc[k];
  }
  __syncthreads();
  for (int b = threadIdx.x; b < num_perms; b += kThreads) {
    double total = 0.0;
    for (int w = 0; w < kWarps; ++w) total += red[w * num_perms + b];
    partials[static_cast<size_t>(blockIdx.x) * num_perms + b] = total;
  }
}

// out[b] = sum over blocks of partials[block][b], in a fixed order: a warp
// a permutation.
__global__ void __launch_bounds__(kFinishThreads)
finish_kernel(const double* __restrict__ partials, float* __restrict__ out, int rows,
              int num_perms) {
  repro::sum_rows(partials, out, rows, num_perms, kFinishThreads / 32);
}

size_t shared_bytes(int n, int num_perms) {
  const size_t row = static_cast<size_t>(n) * sizeof(float);
  const size_t red = static_cast<size_t>(kWarps) * num_perms * sizeof(double);
  return row > red ? row : red;
}

}  // namespace

// The blocks one partials launch runs (and the partials it writes): as many
// as the card holds at once, at most n. B <= 128.
REPRO_EXPORT int repro_mantel_corr_grid(int n, int num_perms, int* grid) {
  if (num_perms > kMaxPerms) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(repro::resident_grid(partials_kernel, kThreads,
                                               shared_bytes(n, num_perms), n, grid));
}

// x: (n, n) fp32; yhat: (n, cols) fp32, the columns [c0, c0 + cols) of the
// square (cols = n, c0 = 0 for the square itself); both contiguous; inv:
// (B, n) int32 inverse orders; orders: (B, n) 16-bit orders; partials:
// (grid, B) fp64 scratch, grid from repro_mantel_corr_grid. 4 n bytes of
// shared memory must fit the opt-in limit.
REPRO_EXPORT int repro_mantel_corr_partials(const float* x, const float* yhat, const int* inv,
                                            const unsigned short* orders, double* partials,
                                            int n, int cols, int c0, int num_perms, int grid,
                                            cudaStream_t stream) {
  if (n <= 0 || num_perms <= 0 || grid <= 0) return static_cast<int>(cudaGetLastError());
  if (cols < 0 || c0 < 0 || c0 + cols > n) return static_cast<int>(cudaErrorInvalidValue);
  if (num_perms > kMaxPerms) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = shared_bytes(n, num_perms);
  const cudaError_t err = cudaFuncSetAttribute(
      partials_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  partials_kernel<<<grid, kThreads, smem, stream>>>(x, yhat, inv, orders, partials, n, cols,
                                                    c0, num_perms);
  return static_cast<int>(cudaGetLastError());
}

// partials: (rows, B) fp64; out: (B,) fp32.
REPRO_EXPORT int repro_mantel_corr_finish(const double* partials, float* out, int rows,
                                          int num_perms, cudaStream_t stream) {
  if (num_perms > 0) {
    const int warps = kFinishThreads / 32;
    finish_kernel<<<(num_perms + warps - 1) / warps, kFinishThreads, 0, stream>>>(
        partials, out, rows, num_perms);
  }
  return static_cast<int>(cudaGetLastError());
}
