// Shared declarations of the port's CUDA sources.
//
// Every entry point is a plain C function bound from Python with ctypes
// (repro_torch/kernels/_build.py): pointers and the stream arrive as
// void-pointer-sized values, sizes as int or long long. Each launches on the
// caller's stream, allocates nothing, does not synchronise, and returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch.
#pragma once

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

}  // namespace repro
