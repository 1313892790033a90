// Shared declarations of the port's CUDA sources.
//
// Every entry point is a plain C function bound from Python with ctypes
// (repro_torch/kernels/_build.py): pointers and the stream arrive as
// void-pointer-sized values, sizes as int or long long. Each launches on the
// caller's stream, allocates nothing, does not synchronise, and returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch.
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

#define REPRO_EXPORT extern "C" __attribute__((visibility("default")))

namespace repro {

constexpr unsigned kFullMask = 0xffffffffu;

// Sum of v over the 32 lanes of a warp, in a fixed butterfly order: the
// result does not depend on scheduling, so reductions built on it are
// deterministic.
template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(kFullMask, v, off);
  return v;
}

// Sum of v over the 32 lanes of a warp, left in every lane: a butterfly,
// in which the two lanes of each exchange add the same two values, so every
// lane holds the same bits and the order does not depend on scheduling.
template <typename T>
__device__ __forceinline__ T warp_allsum(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFullMask, v, off);
  return v;
}

// The K values of v, each summed over the 32 lanes of a warp by
// warp_allsum's butterfly, exchanged in lock step so that the K shuffles of
// a round are in flight together.
template <int K>
__device__ __forceinline__ void warp_allsum_each(double (&v)[K]) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int k = 0; k < K; ++k) v[k] += __shfl_xor_sync(kFullMask, v[k], off);
  }
}

// out[o] = sum over r < rows of partials[r * outputs + o], in fp64, for the
// output o owned by this warp (warp `warp` of the block, `warps` a block):
// each lane sums a fixed stride of rows, then warp_sum's fixed tree. The
// finishing kernels of the fixed-order reductions.
__device__ __forceinline__ void sum_rows(const double* __restrict__ partials,
                                         float* __restrict__ out, int rows, int outputs,
                                         int warps) {
  const int o = blockIdx.x * warps + (threadIdx.x >> 5);
  if (o >= outputs) return;
  const int lane = threadIdx.x & 31;
  double v = 0.0;
  for (int r = lane; r < rows; r += 32) v += partials[static_cast<long long>(r) * outputs + o];
  v = warp_sum(v);
  if (lane == 0) out[o] = static_cast<float>(v);
}

// dst[t] = src[t] for t < count, by `nthreads` threads of which this is
// `tid`: a scalar head up to the first 16-byte boundary of src, 16-byte
// loads, a scalar tail. dst is shared memory, written 16 bytes at a time
// where it shares src's alignment.
__device__ __forceinline__ void stage_run(float* dst, const float* __restrict__ src, int count,
                                          int tid, int nthreads) {
  const int head =
      min(count, static_cast<int>(((16 - (reinterpret_cast<uintptr_t>(src) & 15)) & 15) >> 2));
  if (tid < head) dst[tid] = __ldg(src + tid);
  const int vecs = (count - head) >> 2;
  const float4* src4 = reinterpret_cast<const float4*>(src + head);
  float* dst_v = dst + head;
  if ((reinterpret_cast<uintptr_t>(dst_v) & 15) == 0) {
    float4* dst4 = reinterpret_cast<float4*>(dst_v);
    for (int v = tid; v < vecs; v += nthreads) dst4[v] = __ldg(src4 + v);
  } else {
    for (int v = tid; v < vecs; v += nthreads) {
      const float4 q = __ldg(src4 + v);
      dst_v[4 * v] = q.x;
      dst_v[4 * v + 1] = q.y;
      dst_v[4 * v + 2] = q.z;
      dst_v[4 * v + 3] = q.w;
    }
  }
  for (int t = head + 4 * vecs + tid; t < count; t += nthreads) dst[t] = __ldg(src + t);
}

// mbarriers and bulk copies of shared memory (center_matvec.cu, rmsnorm.cu).
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// Expect `bytes` of bulk copies on `bar`, and arrive.
__device__ __forceinline__ void mbar_arrive_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// A bulk copy (the copy engine, 1-D TMA: no thread's registers) of `bytes`, a
// multiple of 16, between 16-byte aligned addresses; completes on `bar`.
__device__ __forceinline__ void copy_bulk(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// Blocks of `kernel` (threads a block, `smem` bytes of dynamic shared memory,
// opted into here) that the card holds at once, capped at `work` items: the
// grid of a kernel whose blocks stride over its items.
template <typename Kernel>
inline cudaError_t resident_grid(Kernel kernel, int threads, size_t smem, int work, int* grid) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem)) !=
      cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *grid = work < per_sm * sms ? work : per_sm * sms;
  return cudaSuccess;
}

}  // namespace repro
