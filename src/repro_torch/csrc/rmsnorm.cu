// Fused RMSNorm with the '1 + w' scale and fp32 statistics, over the last
// axis of a (rows, d) activation, and its backward:
//
//   out[r, :] = (x[r, :] * rsqrt(mean(x[r, :]^2) + eps) * (1 + w)).to(x.dtype)
//
// x and out in fp32 or bf16, w (d,) in fp32 or bf16 (the parameter dtype);
// every product in fp32 and one rounding at the store. The forward can also
// write each row's inverse RMS r (fp32), which the backward reads.
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
//
// Backward (new: the reference differentiates its jnp rmsnorm, so there is
// no Pallas backward to replace). With w' = 1 + w, g = dy * w' and r the
// forward's inverse RMS of the row, all in fp32:
//
//   dx[r, :] = r * g - x * c,   c = (r^3 * sum_j g_j x_j / d) rounded to fp32
//   dw[j]    = sum over rows of (dy * x) * r
//
// The row sum of g x is taken in fp64 (each product of two fp32 values is
// exact in fp64), so it hardly depends on its order; r is the forward's own,
// read from memory. The elementwise products and the difference are rounded
// one at a time (__fmul_rn, __fsub_rn: no contraction into an FMA), as the
// plain version (kernels/rmsnorm_ref.py::rmsnorm_backward_plain) computes
// them, so the two differ only where c rounds differently. dw is a column
// sum over every row: each block takes a fixed run of rows and keeps its
// columns' fp32 sums in shared memory (each column owned by one thread, or
// by one lane of each warp at d <= 256, summed over the block's warps in
// order), writes them as one row of fp32 partials, and a second kernel sums
// the partials of each column in fp64 in a fixed order. The grid depends on
// (rows, d) alone and no float atomic is used, so two launches give the
// same bits.
//
// Backward bound: bytes. It reads x, dy, w and r once and writes dx and dw
// once: at llama3.2-3b's microbatch (1024 rows of 3072 in bf16) 18.9 MB,
// 0.0056 ms at 3.35 TB/s. The partials (at most kBwdMaxBlocks rows of d
// floats, written and read once) are the design's cost above it.
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
                    float* __restrict__ inv_out, long long rows, int d, float eps, bool vec) {
  const long long row = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;  // the whole warp leaves together: no shuffle waits on it
  const int lane = threadIdx.x & 31;
  const TX* xr = x + row * d;
  float ss = repro::warp_sum(sum_squares(xr, d, lane, 32, vec));
  ss = __shfl_sync(repro::kFullMask, ss, 0);  // the total sits in lane 0
  const float inv = rsqrtf(ss / static_cast<float>(d) + eps);
  if (inv_out != nullptr && lane == 0) inv_out[row] = inv;
  scale_store(xr, w, out + row * d, d, lane, 32, vec, inv);
}

// d > kWarpMaxD: one block a row.
template <typename TX, typename TW>
__global__ void __launch_bounds__(kBlockThreads)
rmsnorm_block_kernel(const TX* __restrict__ x, const TW* __restrict__ w, TX* __restrict__ out,
                     float* __restrict__ inv_out, int d, float eps, bool vec) {
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
    if (lane == 0) {
      inv_s = rsqrtf(total / static_cast<float>(d) + eps);
      if (inv_out != nullptr) inv_out[row] = inv_s;
    }
  }
  __syncthreads();
  scale_store(xr, w, out + row * d, d, threadIdx.x, kBlockThreads, vec, inv_s);
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <typename TX, typename TW>
cudaError_t launch(const void* x, const void* w, void* out, float* inv, long long rows, int d,
                   float eps, cudaStream_t stream) {
  const TX* xp = static_cast<const TX*>(x);
  const TW* wp = static_cast<const TW*>(w);
  TX* op = static_cast<TX*>(out);
  const bool vec = d % kPack == 0 && aligned16(x) && aligned16(w) && aligned16(out);
  if (d <= kWarpMaxD) {
    const long long blocks = (rows + kWarps - 1) / kWarps;
    rmsnorm_warp_kernel<TX, TW><<<static_cast<unsigned>(blocks), kBlockThreads, 0, stream>>>(
        xp, wp, op, inv, rows, d, eps, vec);
  } else {
    rmsnorm_block_kernel<TX, TW><<<static_cast<unsigned>(rows), kBlockThreads, 0, stream>>>(
        xp, wp, op, inv, d, eps, vec);
  }
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

// c = r^3 * dot / d in fp64, rounded once to fp32.
__device__ __forceinline__ float bwd_coef(float r, double dot, int d) {
  const double rd = r;
  return static_cast<float>(((rd * rd) * rd) * dot / static_cast<double>(d));
}

// g = dy * (1 + w), each step rounded.
__device__ __forceinline__ float bwd_g(float dy, float w) {
  return __fmul_rn(dy, __fadd_rn(1.0f, w));
}

// dx = r * g - x * c, each step rounded.
__device__ __forceinline__ float bwd_dx(float r, float g, float x, float c) {
  return __fsub_rn(__fmul_rn(r, g), __fmul_rn(x, c));
}

// (dy * x) * r, each step rounded: one row's term of dw.
__device__ __forceinline__ float bwd_dw_term(float dy, float x, float r) {
  return __fmul_rn(__fmul_rn(dy, x), r);
}

// d > kWarpMaxD: one block takes rows [b * rows_per_block, ...) in order, a
// row at a time. Thread t owns the columns t*8 + k + j*2048 (vector) or
// t + j*256 (scalar), and only it touches their dw sums in shared memory.
template <typename TX, typename TW>
__global__ void __launch_bounds__(kBlockThreads)
rmsnorm_bwd_block_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
                         const float* __restrict__ inv, const TX* __restrict__ dy,
                         TX* __restrict__ dx, float* __restrict__ partials, long long rows,
                         int d, long long rows_per_block, bool vec) {
  extern __shared__ float dw_s[];   // d floats
  __shared__ double warp_dots[kWarps];
  __shared__ float coef_s;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  constexpr int kStride = kBlockThreads * kPack;
  if (vec) {
    for (int c = t * kPack; c < d; c += kStride) {
#pragma unroll
      for (int k = 0; k < kPack; ++k) dw_s[c + k] = 0.0f;
    }
  } else {
    for (int c = t; c < d; c += kBlockThreads) dw_s[c] = 0.0f;
  }
  const long long r0 = static_cast<long long>(blockIdx.x) * rows_per_block;
  const long long r1 = min(r0 + rows_per_block, rows);
  for (long long row = r0; row < r1; ++row) {
    const float r = inv[row];
    const TX* xr = x + row * d;
    const TX* gr = dy + row * d;
    double dot = 0.0;
    if (vec) {
      for (int c = t * kPack; c < d; c += kStride) {
        float xv[kPack], gv[kPack], wv[kPack];
        load8(xr + c, xv);
        load8(gr + c, gv);
        load8(w + c, wv);
#pragma unroll
        for (int k = 0; k < kPack; ++k) {
          dot = fma(static_cast<double>(bwd_g(gv[k], wv[k])), static_cast<double>(xv[k]), dot);
          dw_s[c + k] += bwd_dw_term(gv[k], xv[k], r);
        }
      }
    } else {
      for (int c = t; c < d; c += kBlockThreads) {
        const float xv = to_float(xr[c]), gv = to_float(gr[c]);
        dot = fma(static_cast<double>(bwd_g(gv, to_float(w[c]))), static_cast<double>(xv), dot);
        dw_s[c] += bwd_dw_term(gv, xv, r);
      }
    }
    dot = repro::warp_sum(dot);
    if (lane == 0) warp_dots[warp] = dot;
    __syncthreads();
    if (warp == 0) {
      const double total = repro::warp_sum(lane < kWarps ? warp_dots[lane] : 0.0);
      if (lane == 0) coef_s = bwd_coef(r, total, d);
    }
    __syncthreads();
    const float cf = coef_s;
    TX* out = dx + row * d;
    if (vec) {
      // the row's share again, from L1 (x and dy of a 3072-wide bf16 row: 12 KB)
      for (int c = t * kPack; c < d; c += kStride) {
        float xv[kPack], gv[kPack], wv[kPack];
        load8(xr + c, xv);
        load8(gr + c, gv);
        load8(w + c, wv);
#pragma unroll
        for (int k = 0; k < kPack; ++k) xv[k] = bwd_dx(r, bwd_g(gv[k], wv[k]), xv[k], cf);
        store8(out + c, xv);
      }
    } else {
      for (int c = t; c < d; c += kBlockThreads) {
        store_one(out + c,
                  bwd_dx(r, bwd_g(to_float(gr[c]), to_float(w[c])), to_float(xr[c]), cf));
      }
    }
  }
  float* part = partials + static_cast<long long>(blockIdx.x) * d;
  if (vec) {
    for (int c = t * kPack; c < d; c += kStride) {
#pragma unroll
      for (int k = 0; k < kPack; ++k) part[c + k] = dw_s[c + k];
    }
  } else {
    for (int c = t; c < d; c += kBlockThreads) part[c] = dw_s[c];
  }
}

// d <= kWarpMaxD: the block's rows are dealt to its warps in turn (warp v
// takes rows r0 + v, r0 + v + 8, ...). A lane owns the columns lane*8 + k
// (vector) or lane + 32k (scalar), at most eight, and keeps their x, g and dw
// sums in registers; the warps' dw sums are added in warp order at the end.
template <typename TX, typename TW>
__global__ void __launch_bounds__(kBlockThreads)
rmsnorm_bwd_warp_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
                        const float* __restrict__ inv, const TX* __restrict__ dy,
                        TX* __restrict__ dx, float* __restrict__ partials, long long rows,
                        int d, long long rows_per_block, bool vec) {
  __shared__ float warp_dw[kWarps][kWarpMaxD];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float acc[kPack], wv[kPack];
#pragma unroll
  for (int k = 0; k < kPack; ++k) {
    acc[k] = 0.0f;
    const int c = vec ? lane * kPack + k : lane + 32 * k;
    wv[k] = c < d ? to_float(w[c]) : 0.0f;
  }
  const long long r0 = static_cast<long long>(blockIdx.x) * rows_per_block;
  const long long r1 = min(r0 + rows_per_block, rows);
  for (long long row = r0 + warp; row < r1; row += kWarps) {
    const float r = inv[row];
    const TX* xr = x + row * d;
    const TX* gr = dy + row * d;
    float xv[kPack], gv[kPack];
    double dot = 0.0;
    if (vec) {
      if (lane * kPack < d) {
        load8(xr + lane * kPack, xv);
        load8(gr + lane * kPack, gv);
#pragma unroll
        for (int k = 0; k < kPack; ++k) {
          acc[k] += bwd_dw_term(gv[k], xv[k], r);
          gv[k] = bwd_g(gv[k], wv[k]);
          dot = fma(static_cast<double>(gv[k]), static_cast<double>(xv[k]), dot);
        }
      }
    } else {
#pragma unroll
      for (int k = 0; k < kPack; ++k) {
        const int c = lane + 32 * k;
        if (c < d) {
          xv[k] = to_float(xr[c]);
          gv[k] = to_float(gr[c]);
          acc[k] += bwd_dw_term(gv[k], xv[k], r);
          gv[k] = bwd_g(gv[k], wv[k]);
          dot = fma(static_cast<double>(gv[k]), static_cast<double>(xv[k]), dot);
        }
      }
    }
    dot = repro::warp_sum(dot);
    dot = __shfl_sync(repro::kFullMask, dot, 0);   // the total sits in lane 0
    const float cf = bwd_coef(r, dot, d);
    TX* out = dx + row * d;
    if (vec) {
      if (lane * kPack < d) {
#pragma unroll
        for (int k = 0; k < kPack; ++k) xv[k] = bwd_dx(r, gv[k], xv[k], cf);
        store8(out + lane * kPack, xv);
      }
    } else {
#pragma unroll
      for (int k = 0; k < kPack; ++k) {
        const int c = lane + 32 * k;
        if (c < d) store_one(out + c, bwd_dx(r, gv[k], xv[k], cf));
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kPack; ++k) {
    const int c = vec ? lane * kPack + k : lane + 32 * k;
    if (c < d) warp_dw[warp][c] = acc[k];
  }
  __syncthreads();
  const int c = threadIdx.x;   // d <= kWarpMaxD == kBlockThreads: a column a thread
  if (c < d) {
    float s = 0.0f;
#pragma unroll
    for (int v = 0; v < kWarps; ++v) s += warp_dw[v][c];
    partials[static_cast<long long>(blockIdx.x) * d + c] = s;
  }
}

// dw[c] = sum over b < blocks of partials[b, c], in fp64: the block's eight
// warps take 32 columns, warp v the partial rows v, v + 8, ..., then the
// eight warp sums are added in warp order, and the result is rounded to fp32
// and then to w's dtype.
template <typename TW>
__global__ void __launch_bounds__(kBlockThreads)
rmsnorm_bwd_finish_kernel(const float* __restrict__ partials, TW* __restrict__ dw, int blocks,
                          int d) {
  __shared__ double sums[kWarps][32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int c = blockIdx.x * 32 + lane;
  double v = 0.0;
  if (c < d) {
    for (int b = warp; b < blocks; b += kWarps) v += partials[static_cast<long long>(b) * d + c];
  }
  sums[warp][lane] = v;
  __syncthreads();
  if (warp == 0 && c < d) {
    double s = 0.0;
#pragma unroll
    for (int u = 0; u < kWarps; ++u) s += sums[u][lane];
    store_one(dw + c, static_cast<float>(s));
  }
}

template <typename TX, typename TW>
cudaError_t launch_bwd(const void* x, const void* w, const float* inv, const void* dy, void* dx,
                       float* partials, long long rows, int d, long long rows_per_block,
                       cudaStream_t stream) {
  const TX* xp = static_cast<const TX*>(x);
  const TW* wp = static_cast<const TW*>(w);
  const TX* gp = static_cast<const TX*>(dy);
  TX* op = static_cast<TX*>(dx);
  const bool vec = d % kPack == 0 && aligned16(x) && aligned16(w) && aligned16(dy) &&
                   aligned16(dx);
  const long long blocks = (rows + rows_per_block - 1) / rows_per_block;
  if (d <= kWarpMaxD) {
    rmsnorm_bwd_warp_kernel<TX, TW><<<static_cast<unsigned>(blocks), kBlockThreads, 0, stream>>>(
        xp, wp, inv, gp, op, partials, rows, d, rows_per_block, vec);
  } else {
    const size_t smem = static_cast<size_t>(d) * sizeof(float);
    if (smem > 48 * 1024) {   // above the default: opt in
      const cudaError_t err = cudaFuncSetAttribute(rmsnorm_bwd_block_kernel<TX, TW>,
                                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                   static_cast<int>(smem));
      if (err != cudaSuccess) return err;
    }
    rmsnorm_bwd_block_kernel<TX, TW>
        <<<static_cast<unsigned>(blocks), kBlockThreads, smem, stream>>>(
            xp, wp, inv, gp, op, partials, rows, d, rows_per_block, vec);
  }
  return cudaGetLastError();
}

template <typename TW>
cudaError_t launch_bwd_finish(const float* partials, void* dw, int blocks, int d,
                              cudaStream_t stream) {
  rmsnorm_bwd_finish_kernel<TW><<<static_cast<unsigned>((d + 31) / 32), kBlockThreads, 0,
                                  stream>>>(partials, static_cast<TW*>(dw), blocks, d);
  return cudaGetLastError();
}

// fn(TX{}, TW{}) for the dtype codes 0 = fp32, 1 = bf16.
template <typename Fn>
cudaError_t by_dtypes(int x_dtype, int w_dtype, Fn&& fn) {
  if (x_dtype == 0 && w_dtype == 0) return fn(float{}, float{});
  if (x_dtype == 0 && w_dtype == 1) return fn(float{}, __nv_bfloat16{});
  if (x_dtype == 1 && w_dtype == 0) return fn(__nv_bfloat16{}, float{});
  if (x_dtype == 1 && w_dtype == 1) return fn(__nv_bfloat16{}, __nv_bfloat16{});
  return cudaErrorInvalidValue;
}

}  // namespace

// x, out: (rows, d) contiguous, of x_dtype; w: (d,) of w_dtype. Dtype codes:
// 0 = fp32, 1 = bf16. rows < 2^31 (one block or warp a row); d >= 1. inv:
// (rows,) fp32 that receives each row's inverse RMS, or null.
REPRO_EXPORT int repro_rmsnorm(const void* x, const void* w, void* out, float* inv,
                               long long rows, int d, int x_dtype, int w_dtype, float eps,
                               cudaStream_t stream) {
  if (rows <= 0 || d <= 0) return static_cast<int>(cudaGetLastError());
  return static_cast<int>(by_dtypes(x_dtype, w_dtype, [&](auto tx, auto tw) {
    return launch<decltype(tx), decltype(tw)>(x, w, out, inv, rows, d, eps, stream);
  }));
}

// The backward's row kernel: x, dy, dx (rows, d) of x_dtype; w (d,) of
// w_dtype; inv (rows,) fp32, the forward's; partials (ceil(rows /
// rows_per_block), d) fp32, one row a block. d <= 56 * 1024 (the block
// route's dw sums in shared memory).
REPRO_EXPORT int repro_rmsnorm_bwd(const void* x, const void* w, const float* inv,
                                   const void* dy, void* dx, float* partials, long long rows,
                                   int d, long long rows_per_block, int x_dtype, int w_dtype,
                                   cudaStream_t stream) {
  if (rows <= 0 || d <= 0 || rows_per_block <= 0) return static_cast<int>(cudaGetLastError());
  return static_cast<int>(by_dtypes(x_dtype, w_dtype, [&](auto tx, auto tw) {
    return launch_bwd<decltype(tx), decltype(tw)>(x, w, inv, dy, dx, partials, rows, d,
                                                  rows_per_block, stream);
  }));
}

// The backward's column finish: dw (d,) of w_dtype from partials (blocks, d).
REPRO_EXPORT int repro_rmsnorm_bwd_finish(const float* partials, void* dw, int blocks, int d,
                                          int w_dtype, cudaStream_t stream) {
  if (blocks <= 0 || d <= 0) return static_cast<int>(cudaGetLastError());
  if (w_dtype == 0) return static_cast<int>(launch_bwd_finish<float>(partials, dw, blocks, d,
                                                                     stream));
  if (w_dtype == 1) {
    return static_cast<int>(launch_bwd_finish<__nv_bfloat16>(partials, dw, blocks, d, stream));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
