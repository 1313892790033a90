// Gower double-centering of a distance matrix, in two passes and a
// fixed-order finish (paper Algorithm 2):
//
//   F = E - r_i - r_j + m,   E = -1/2 D*D,
//
// r the row means of E (also its column means, D being symmetric) and m
// its global mean. D and F are fp32, or bf16 with fp32 arithmetic inside.
//
// Replaces: src/repro/kernels/center.py::center_pass1 (_pass1_kernel) and
// center_pass2 (_pass2_kernel).
//
// Bound on an H100: bytes. At n = 16384 (a 1.07 GB fp32 matrix) pass 1
// reads D once, 0.32 ms at 3.35 TB/s; pass 2 reads D and writes F,
// 0.64 ms; the finish moves 2 n floats. A pass 1 that also wrote E, as the
// Pallas kernel does, would be bounded at 0.64 ms and pass 2 would read E
// instead of D, for 1.28 ms in all against 0.96 ms here.
//
// Design: the Pallas pass 1 carries the row sums and the global sum across
// an in-order grid; on Hopper blocks run in no order. So here
//  - pass 1: a warp owns one row and sweeps all its columns with 16-byte
//    loads, each lane keeping one fp32 sum per vector slot; the lanes'
//    sums meet in a fixed butterfly and lane 0 writes the row's sum of E.
//    No atomics, so the result is reproducible bit for bit. E is not
//    written: nothing reads it again.
//  - finish: one block sums the n row sums in a fixed order, in fp64, into
//    the global mean, and writes the row means.
//  - pass 2: forms E from D again in registers and writes F with 16-byte
//    vector accesses; a thread owns one vector of columns, loads their row
//    means once and walks 8 rows. E never reaches device memory.
// A ragged n (not a multiple of the vector width) or a misaligned pointer
// takes the same kernels with scalar accesses; nothing is padded.
//
// Block mode, for the distributed centering: both passes take an (r, c)
// contiguous block of D, pass 1 giving its r row sums and pass 2 its F
// block from r row means and c column means apart. The square call is
// r = c = n with the row means as the column means: the same loops, so
// the same bits.
#include <cstdint>

#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;     // pass 1: rows per block
constexpr int kRowsPerBlock = 8;          // pass 2: rows a thread walks
constexpr int kFinishThreads = 1024;

// V consecutive elements of D (or F) as fp32: one 16-byte access for the
// vector widths (4 fp32, 8 bf16), one element for V = 1.
__device__ __forceinline__ void load_vec(const float* p, float (&v)[4]) {
  const float4 t = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = t.x;
  v[1] = t.y;
  v[2] = t.z;
  v[3] = t.w;
}

__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float2 f = __bfloat1622float2(h[q]);
    v[2 * q] = f.x;
    v[2 * q + 1] = f.y;
  }
}

__device__ __forceinline__ void load_vec(const float* p, float (&v)[1]) { v[0] = __ldg(p); }

__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float (&v)[1]) {
  v[0] = __bfloat162float(p[0]);
}

__device__ __forceinline__ void store_vec(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store_vec(__nv_bfloat16* p, const float (&v)[8]) {
  uint4 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int q = 0; q < 4; ++q) h[q] = __floats2bfloat162_rn(v[2 * q], v[2 * q + 1]);
  *reinterpret_cast<uint4*>(p) = raw;
}

__device__ __forceinline__ void store_vec(float* p, const float (&v)[1]) { p[0] = v[0]; }

__device__ __forceinline__ void store_vec(__nv_bfloat16* p, const float (&v)[1]) {
  p[0] = __float2bfloat16(v[0]);
}

// V consecutive fp32 row means (aligned for V > 1: the column is a multiple of V).
template <int V>
__device__ __forceinline__ void load_means(const float* p, float (&v)[V]) {
  if constexpr (V == 1) {
    v[0] = __ldg(p);
  } else {
#pragma unroll
    for (int q = 0; q < V; q += 4) {
      const float4 t = __ldg(reinterpret_cast<const float4*>(p + q));
      v[q] = t.x;
      v[q + 1] = t.y;
      v[q + 2] = t.z;
      v[q + 3] = t.w;
    }
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
pass1_kernel(const T* __restrict__ d, float* __restrict__ row_sums, int rows, int cols) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;                 // warp-uniform: the whole warp leaves
  const T* src = d + static_cast<size_t>(row) * cols;
  float acc[V];
#pragma unroll
  for (int q = 0; q < V; ++q) acc[q] = 0.0f;
#pragma unroll 4
  for (int c = lane * V; c < cols; c += 32 * V) {
    float v[V];
    load_vec(src + c, v);
#pragma unroll
    for (int q = 0; q < V; ++q) acc[q] = fmaf(v[q], v[q], acc[q]);
  }
  float sum = 0.0f;
#pragma unroll
  for (int q = 0; q < V; ++q) sum += acc[q];
  sum = repro::warp_sum(sum);
  if (lane == 0) row_sums[row] = -0.5f * sum;
}

__global__ void __launch_bounds__(kFinishThreads)
finish_kernel(const float* __restrict__ row_sums, float* __restrict__ row_means,
              float* __restrict__ global_mean, int n) {
  __shared__ double warp_sums[kFinishThreads / 32];
  const float nf = static_cast<float>(n);
  double acc = 0.0;
  for (int i = threadIdx.x; i < n; i += kFinishThreads) {
    const float s = row_sums[i];
    acc += static_cast<double>(s);
    row_means[i] = s / nf;
  }
  acc = repro::warp_sum(acc);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = acc;
  __syncthreads();
  if (warp == 0) {
    double total = warp_sums[lane];
    total = repro::warp_sum(total);
    if (lane == 0) global_mean[0] = static_cast<float>(total / n / n);
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
pass2_kernel(const T* __restrict__ d, const float* __restrict__ row_means,
             const float* __restrict__ col_means, const float* __restrict__ global_mean,
             T* __restrict__ f, int rows, int cols) {
  const int col = (blockIdx.x * kThreads + threadIdx.x) * V;
  if (col >= cols) return;
  float rj[V];
  load_means<V>(col_means + col, rj);
  const float gm = __ldg(global_mean);
  const int row0 = static_cast<int>(blockIdx.y) * kRowsPerBlock;
  const int row_end = min(rows, row0 + kRowsPerBlock);
  for (int row = row0; row < row_end; ++row) {
    const float ri = __ldg(row_means + row);
    const size_t at = static_cast<size_t>(row) * cols + col;
    float v[V];
    load_vec(d + at, v);
#pragma unroll
    for (int q = 0; q < V; ++q) {
      const float e = -0.5f * v[q] * v[q];
      v[q] = ((e - ri) - rj[q]) + gm;
    }
    store_vec(f + at, v);
  }
}

template <typename T>
constexpr int vector_width() {
  return 16 / static_cast<int>(sizeof(T));
}

bool aligned16(const void* p) { return reinterpret_cast<std::uintptr_t>(p) % 16 == 0; }

template <typename T>
bool vectorizable(int n) {
  return n % vector_width<T>() == 0;
}

template <typename T>
int pass1(const void* d, float* row_sums, int rows, int cols, cudaStream_t stream) {
  constexpr int kV = vector_width<T>();
  const T* src = static_cast<const T*>(d);
  const int blocks = (rows + kWarps - 1) / kWarps;
  if (vectorizable<T>(cols) && aligned16(d)) {
    pass1_kernel<T, kV><<<blocks, kThreads, 0, stream>>>(src, row_sums, rows, cols);
  } else {
    pass1_kernel<T, 1><<<blocks, kThreads, 0, stream>>>(src, row_sums, rows, cols);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int pass2(const void* d, const float* row_means, const float* col_means,
          const float* global_mean, void* f, int rows, int cols, cudaStream_t stream) {
  constexpr int kV = vector_width<T>();
  const T* src = static_cast<const T*>(d);
  T* dst = static_cast<T*>(f);
  const unsigned row_blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  if (row_blocks > 65535u) return static_cast<int>(cudaErrorInvalidValue);
  if (vectorizable<T>(cols) && aligned16(d) && aligned16(f) && aligned16(col_means)) {
    const dim3 grid((cols / kV + kThreads - 1) / kThreads, row_blocks);
    pass2_kernel<T, kV><<<grid, kThreads, 0, stream>>>(src, row_means, col_means, global_mean,
                                                       dst, rows, cols);
  } else {
    const dim3 grid((cols + kThreads - 1) / kThreads, row_blocks);
    pass2_kernel<T, 1><<<grid, kThreads, 0, stream>>>(src, row_means, col_means, global_mean,
                                                      dst, rows, cols);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// d: (rows, cols) fp32 (bf16 = 0) or bf16 (bf16 = 1), contiguous; row_sums:
// (rows,) fp32, the row sums of its E. The square matrix is rows = cols = n.
REPRO_EXPORT int repro_center_pass1(const void* d, float* row_sums, int rows, int cols,
                                    int bf16, cudaStream_t stream) {
  if (rows <= 0 || cols < 0) return static_cast<int>(cudaGetLastError());
  return bf16 ? pass1<__nv_bfloat16>(d, row_sums, rows, cols, stream)
              : pass1<float>(d, row_sums, rows, cols, stream);
}

// row_sums: (n,) fp32 in; row_means: (n,) fp32 and global_mean: (1,) fp32 out.
REPRO_EXPORT int repro_center_finish(const float* row_sums, float* row_means, float* global_mean,
                                     int n, cudaStream_t stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  finish_kernel<<<1, kFinishThreads, 0, stream>>>(row_sums, row_means, global_mean, n);
  return static_cast<int>(cudaGetLastError());
}

// d and f: (rows, cols) of one dtype (fp32, or bf16 when bf16 = 1),
// contiguous; row_means (rows,), col_means (cols,) and global_mean (1,) fp32.
// The square matrix is rows = cols = n with col_means = row_means.
REPRO_EXPORT int repro_center_pass2(const void* d, const float* row_means,
                                    const float* col_means, const float* global_mean, void* f,
                                    int rows, int cols, int bf16, cudaStream_t stream) {
  if (rows <= 0 || cols <= 0) return static_cast<int>(cudaGetLastError());
  return bf16 ? pass2<__nv_bfloat16>(d, row_means, col_means, global_mean, f, rows, cols, stream)
              : pass2<float>(d, row_means, col_means, global_mean, f, rows, cols, stream);
}
