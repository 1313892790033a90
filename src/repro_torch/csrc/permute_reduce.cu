// Batched permuted gather-reduce over condensed storage, the Mantel null
// loop:
//
//   out[s, b] = sum_k ys[s, k] * xc[tri(orders[b, ii[k]], orders[b, jj[k]])]
//   tri(p, q) = lo (2n - lo - 1) / 2 + (hi - lo - 1),  lo = min, hi = max
//
// Replaces: src/repro/kernels/permute_reduce.py::permute_reduce_kernel
// (_permute_reduce_kernel).
//
// Bound on an H100: bytes. Read once, the inputs are xc, S rows of ys, ii
// and jj (4 m bytes each) plus the B order rows: 2.1 GB at n = 16384, S = 1,
// 0.64 ms. The work as the Pallas kernel lays it out moves
// 4 m (B + 3) + 4 B n bytes per tile (xc gathered once per permutation),
// 18.8 GB, 5.6 ms; and the xc gathers are random, served in 32-byte
// sectors, which can cost up to 8 times their 4 useful bytes.
//
// Design: the Pallas kernel keeps all of xc in VMEM; at n = 16384 xc is
// 537 MB, so here it is gathered from global memory through L2. A block
// owns one (chunk, permutation) pair; the linear block index runs over the
// permutations fastest, so the B blocks of one chunk are resident together
// and the chunk's ys/ii/jj slice comes from device memory once and from L2
// for the other B - 1. The block stages its permutation's order row in
// shared memory (4 n bytes, 64 KB at n = 16384, 185 KB at n = 46340: the
// dynamic shared-memory opt-in), so the two order lookups per entry never
// leave the SM. Index arithmetic is int32, exact for n <= 46340 as in the
// Pallas kernel (the wrapper refuses larger n). Products are accumulated in
// fp64, and no float atomics are used: each block writes one partial per
// (chunk, s, b) after a fixed-order block reduction, and a second kernel
// sums the partials over the chunks in a fixed order, so the result is
// bitwise reproducible. The ragged last chunk is masked in the kernel, so
// nothing is padded in memory.
#include "common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kFinishThreads = 256;

template <int S>
__global__ void __launch_bounds__(kThreads)
partials_kernel(const float* __restrict__ xc, const float* __restrict__ ys,
                const int* __restrict__ ii, const int* __restrict__ jj,
                const int* __restrict__ orders, double* __restrict__ partials,
                int n, long long m, long long ys_stride, int num_perms, int chunk) {
  extern __shared__ int order_row[];
  __shared__ double warp_sums[S][kWarps];

  const int b = static_cast<int>(blockIdx.x % num_perms);
  const long long c = blockIdx.x / num_perms;
  const int* src = orders + static_cast<long long>(b) * n;
  for (int t = threadIdx.x; t < n; t += kThreads) order_row[t] = src[t];
  __syncthreads();

  double acc[S];
#pragma unroll
  for (int s = 0; s < S; ++s) acc[s] = 0.0;

  const int two_n_1 = 2 * n - 1;
  const long long k0 = c * chunk;
  const long long k1 = k0 + chunk < m ? k0 + chunk : m;
  for (long long k = k0 + threadIdx.x; k < k1; k += kThreads) {
    const int oi = order_row[__ldg(ii + k)];
    const int oj = order_row[__ldg(jj + k)];
    const int lo = min(oi, oj);
    const int hi = max(oi, oj);
    const int idx = lo * (two_n_1 - lo) / 2 + (hi - lo - 1);
    const double xv = static_cast<double>(__ldg(xc + idx));
#pragma unroll
    for (int s = 0; s < S; ++s) {
      acc[s] = fma(static_cast<double>(__ldg(ys + s * ys_stride + k)), xv, acc[s]);
    }
  }

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const double v = repro::warp_sum(acc[s]);
    if (lane == 0) warp_sums[s][warp] = v;
  }
  __syncthreads();
  if (threadIdx.x < S) {
    double total = 0.0;
    for (int w = 0; w < kWarps; ++w) total += warp_sums[threadIdx.x][w];
    partials[(c * S + threadIdx.x) * num_perms + b] = total;
  }
}

// out[o] = sum over chunks of partials[chunk][o], o = s * B + b: one block
// per output, fixed strided order per thread, fixed tree across threads.
__global__ void __launch_bounds__(kFinishThreads)
finish_kernel(const double* __restrict__ partials, float* __restrict__ out,
              int num_chunks, int outputs) {
  __shared__ double warp_sums[kFinishThreads / 32];
  const int o = blockIdx.x;
  double v = 0.0;
  for (int c = threadIdx.x; c < num_chunks; c += kFinishThreads) {
    v += partials[static_cast<long long>(c) * outputs + o];
  }
  v = repro::warp_sum(v);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    double total = 0.0;
    for (int w = 0; w < kFinishThreads / 32; ++w) total += warp_sums[w];
    out[o] = static_cast<float>(total);
  }
}

template <int S>
int launch_partials(const float* xc, const float* ys, const int* ii, const int* jj,
                    const int* orders, double* partials, int n, long long m,
                    long long ys_stride, int num_perms, int chunk, int num_chunks,
                    cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(n) * sizeof(int);
  const cudaError_t err = cudaFuncSetAttribute(
      partials_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned blocks = static_cast<unsigned>(num_chunks) * static_cast<unsigned>(num_perms);
  partials_kernel<S><<<blocks, kThreads, smem, stream>>>(xc, ys, ii, jj, orders, partials, n, m,
                                                         ys_stride, num_perms, chunk);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// xc: (m,) fp32; ys: S rows of m fp32 at row stride ys_stride; ii/jj: (m,)
// int32; orders: (B, n) int32; partials: (num_chunks, S, B) fp64 scratch.
// 1 <= S <= 2 (Mantel streams 1 row, partial Mantel 2), num_chunks =
// ceil(m / chunk), num_chunks * B < 2^31.
REPRO_EXPORT int repro_permute_reduce_partials(const float* xc, const float* ys, const int* ii,
                                               const int* jj, const int* orders, double* partials,
                                               int n, long long m, long long ys_stride, int rows,
                                               int num_perms, int chunk, int num_chunks,
                                               cudaStream_t stream) {
  if (num_chunks <= 0 || num_perms <= 0) return static_cast<int>(cudaGetLastError());
  switch (rows) {
    case 1: return launch_partials<1>(xc, ys, ii, jj, orders, partials, n, m, ys_stride,
                                      num_perms, chunk, num_chunks, stream);
    case 2: return launch_partials<2>(xc, ys, ii, jj, orders, partials, n, m, ys_stride,
                                      num_perms, chunk, num_chunks, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// partials: (num_chunks, outputs) fp64; out: (outputs,) fp32.
REPRO_EXPORT int repro_permute_reduce_finish(const double* partials, float* out, int num_chunks,
                                             int outputs, cudaStream_t stream) {
  if (outputs > 0) {
    finish_kernel<<<outputs, kFinishThreads, 0, stream>>>(partials, out, num_chunks, outputs);
  }
  return static_cast<int>(cudaGetLastError());
}
