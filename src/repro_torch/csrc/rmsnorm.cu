// Fused RMSNorm with the '1 + w' scale and fp32 statistics, over the last
// axis of a (rows, d) activation:
//
//   out[r, :] = (x[r, :] * rsqrt(mean(x[r, :]^2) + eps) * (1 + w)).to(x.dtype)
//
// x and out in fp32 or bf16, w (d,) in fp32 or bf16 (the parameter dtype);
// every product in fp32 and one rounding at the store.
//
// Replaces: src/repro/kernels/rmsnorm.py::rmsnorm (_rmsnorm_kernel), the
// TPU twin of the dense decoders' every norm: the block norms and the final
// norm at d = d_model, and under qk-norm the per-head q and k norms at
// d = head_dim.
//
// Bound on an H100: bytes. The kernel reads x once and writes out once:
// 2 rows d bytes per element size, plus w. At qwen3-8b's prefill block norm
// (2048 rows of 4096 in bf16) that is 33.6 MB, 0.0100 ms at 3.35 TB/s; the
// 4 flops an element are 0.0001 ms even at the 67 TFLOP/s fp32 rate.
//
// Design: the Pallas kernel keeps a (64, d) block in VMEM and does the
// statistic and the scale in one sweep. Here a row has one owner, so the
// statistic needs no second pass over device memory: at d <= 256 (the
// qk-norm width of 128) one warp a row, eight rows a block; above it one
// 256-thread block a row. The owner sums x^2 in fp32 over its share of the
// row, reduces with warp shuffles (and, for a block, the eight warp sums in
// shared memory, summed again by one warp's shuffles), then reads its share
// again (from L1: a 4096-wide bf16 row is 8 KB) to scale and store. Every
// sum runs in an order fixed by d alone, with no atomics, so two launches
// give the same bits. Loads and stores are 16 bytes (eight elements) when d
// is a multiple of 8 and the pointers are 16-byte aligned, scalar otherwise.
#include <cstdint>

#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int kBlockThreads = 256;   // block-per-row kernel
constexpr int kWarps = kBlockThreads / 32;
constexpr int kWarpMaxD = 256;       // widest row a warp owns alone
constexpr int kPack = 8;             // elements a 16-byte bf16 load carries

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ void store_one(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_one(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// Eight consecutive elements as floats: two 16-byte loads for fp32, one for
// bf16. p must be 16-byte aligned.
__device__ __forceinline__ void load8(const float* p, float (&v)[kPack]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[kPack]) {
  const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int k = 0; k < kPack / 2; ++k) {
    const float2 f = __bfloat1622float2(h[k]);
    v[2 * k] = f.x;
    v[2 * k + 1] = f.y;
  }
}

__device__ __forceinline__ void store8(float* p, const float (&v)[kPack]) {
  float4* q = reinterpret_cast<float4*>(p);
  q[0] = make_float4(v[0], v[1], v[2], v[3]);
  q[1] = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float (&v)[kPack]) {
  uint4 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int k = 0; k < kPack / 2; ++k) h[k] = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
  *reinterpret_cast<uint4*>(p) = raw;
}

// Sum of x^2 over the elements t, t + g, ... (or packs of eight) of one row,
// in fp32, in a fixed order.
template <typename TX>
__device__ __forceinline__ float sum_squares(const TX* __restrict__ row, int d, int t, int g,
                                             bool vec) {
  float acc = 0.0f;
  if (vec) {
    for (int c = t * kPack; c < d; c += g * kPack) {
      float v[kPack];
      load8(row + c, v);
#pragma unroll
      for (int k = 0; k < kPack; ++k) acc = fmaf(v[k], v[k], acc);
    }
  } else {
    for (int c = t; c < d; c += g) {
      const float v = to_float(row[c]);
      acc = fmaf(v, v, acc);
    }
  }
  return acc;
}

// out = (x * inv) * (1 + w) over the same elements, rounded once.
template <typename TX, typename TW>
__device__ __forceinline__ void scale_store(const TX* __restrict__ row, const TW* __restrict__ w,
                                            TX* __restrict__ out, int d, int t, int g, bool vec,
                                            float inv) {
  if (vec) {
    for (int c = t * kPack; c < d; c += g * kPack) {
      float v[kPack], s[kPack];
      load8(row + c, v);
      load8(w + c, s);
#pragma unroll
      for (int k = 0; k < kPack; ++k) v[k] = (v[k] * inv) * (1.0f + s[k]);
      store8(out + c, v);
    }
  } else {
    for (int c = t; c < d; c += g) {
      store_one(out + c, (to_float(row[c]) * inv) * (1.0f + to_float(w[c])));
    }
  }
}

// d <= kWarpMaxD: one warp a row, kWarps rows a block.
template <typename TX, typename TW>
__global__ void __launch_bounds__(kBlockThreads)
rmsnorm_warp_kernel(const TX* __restrict__ x, const TW* __restrict__ w, TX* __restrict__ out,
                    long long rows, int d, float eps, bool vec) {
  const long long row = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;  // the whole warp leaves together: no shuffle waits on it
  const int lane = threadIdx.x & 31;
  const TX* xr = x + row * d;
  float ss = repro::warp_sum(sum_squares(xr, d, lane, 32, vec));
  ss = __shfl_sync(repro::kFullMask, ss, 0);  // the total sits in lane 0
  const float inv = rsqrtf(ss / static_cast<float>(d) + eps);
  scale_store(xr, w, out + row * d, d, lane, 32, vec, inv);
}

// d > kWarpMaxD: one block a row.
template <typename TX, typename TW>
__global__ void __launch_bounds__(kBlockThreads)
rmsnorm_block_kernel(const TX* __restrict__ x, const TW* __restrict__ w, TX* __restrict__ out,
                     int d, float eps, bool vec) {
  __shared__ float warp_sums[kWarps];
  __shared__ float inv_s;
  const long long row = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const TX* xr = x + row * d;
  const float ss = repro::warp_sum(sum_squares(xr, d, threadIdx.x, kBlockThreads, vec));
  if (lane == 0) warp_sums[warp] = ss;
  __syncthreads();
  if (warp == 0) {
    const float total = repro::warp_sum(lane < kWarps ? warp_sums[lane] : 0.0f);
    if (lane == 0) inv_s = rsqrtf(total / static_cast<float>(d) + eps);
  }
  __syncthreads();
  scale_store(xr, w, out + row * d, d, threadIdx.x, kBlockThreads, vec, inv_s);
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <typename TX, typename TW>
cudaError_t launch(const void* x, const void* w, void* out, long long rows, int d, float eps,
                   cudaStream_t stream) {
  const TX* xp = static_cast<const TX*>(x);
  const TW* wp = static_cast<const TW*>(w);
  TX* op = static_cast<TX*>(out);
  const bool vec = d % kPack == 0 && aligned16(x) && aligned16(w) && aligned16(out);
  if (d <= kWarpMaxD) {
    const long long blocks = (rows + kWarps - 1) / kWarps;
    rmsnorm_warp_kernel<TX, TW><<<static_cast<unsigned>(blocks), kBlockThreads, 0, stream>>>(
        xp, wp, op, rows, d, eps, vec);
  } else {
    rmsnorm_block_kernel<TX, TW><<<static_cast<unsigned>(rows), kBlockThreads, 0, stream>>>(
        xp, wp, op, d, eps, vec);
  }
  return cudaGetLastError();
}

}  // namespace

// x, out: (rows, d) contiguous, of x_dtype; w: (d,) of w_dtype. Dtype codes:
// 0 = fp32, 1 = bf16. rows < 2^31 (one block or warp a row); d >= 1.
REPRO_EXPORT int repro_rmsnorm(const void* x, const void* w, void* out, long long rows, int d,
                               int x_dtype, int w_dtype, float eps, cudaStream_t stream) {
  if (rows <= 0 || d <= 0) return static_cast<int>(cudaGetLastError());
  if (x_dtype == 0 && w_dtype == 0) {
    return static_cast<int>(launch<float, float>(x, w, out, rows, d, eps, stream));
  }
  if (x_dtype == 0 && w_dtype == 1) {
    return static_cast<int>(launch<float, __nv_bfloat16>(x, w, out, rows, d, eps, stream));
  }
  if (x_dtype == 1 && w_dtype == 0) {
    return static_cast<int>(launch<__nv_bfloat16, float>(x, w, out, rows, d, eps, stream));
  }
  if (x_dtype == 1 && w_dtype == 1) {
    return static_cast<int>(
        launch<__nv_bfloat16, __nv_bfloat16>(x, w, out, rows, d, eps, stream));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
