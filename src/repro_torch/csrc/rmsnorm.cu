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
// sum over every row: each block takes a fixed run of rows, keeps its
// columns' fp32 sums (in registers, or in shared memory on the block route),
// and writes them as one row of fp32 partials; after a grid-wide barrier
// each block sums the partials of its columns in fp64 in a fixed order. The
// grid depends on (rows, d) alone and no float atomic is used, so two
// launches give the same bits.
//
// Backward bound: bytes. It reads x, dy, w and r once and writes dx and dw
// once: at llama3.2-3b's microbatch (1024 rows of 3072 in bf16) 18.9 MB,
// 0.0056 ms at 3.35 TB/s; at qwen3's q-norm rows (24576 of 128) 0.0057 ms.
// The partials (at most 114 rows of d floats, written and read once, 1.4 MB
// at d = 3072) stay in L2 and are the design's cost above it.
//
// Backward design: one cooperative launch of at most 114 blocks (the SMs of
// the PCIe H100, so the grid is resident on either card), the grid a
// function of (rows, d) alone; each block writes dx and its partial row,
// meets the grid at a barrier, and finishes dw for its columns, so neither
// a second kernel nor a second host call is made. What bounds a row is the
// chain load -> fp64 sum -> block barrier -> c -> store, so the routes keep
// rows in flight rather than walk them one after another:
//   * d <= 256: 32 warps a block, a half-warp a row at d <= 128 (the
//     qk-norm width: no lane idles), a warp a row above;
//   * 2048 <= d <= 8192, 16-byte aligned, d % 8 == 0 (the dense decoders'
//     widths): row groups of d / 16 threads, each owning two 16-byte
//     chunks, two groups a block up to d = 4096, each taking every other
//     row; a ring of rows in shared memory filled by 1-D TMA, each row held
//     in registers from the sum to the store, the warps of a group meeting
//     on an mbarrier rather than a block barrier (rmsnorm_bwd_ring_kernel);
//   * otherwise a block a run of rows, a row at a time, with the dw sums in
//     shared memory (up to d = 56K).
#include <algorithm>
#include <cstdint>

#include <cooperative_groups.h>
#include <cuda_bf16.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

using repro::copy_bulk;
using repro::mbar_arrive;
using repro::mbar_arrive_expect;
using repro::mbar_init;
using repro::mbar_wait;
using repro::smem_addr;

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

constexpr int kWarpRouteThreads = 1024;   // the warp route's block
constexpr int kHalfWarpMaxD = 128;        // widest row a half-warp owns
constexpr int kRingPacks = 2;             // 16-byte packs a ring-route thread owns
constexpr int kRingMaxThreads = 512;      // the ring route's widest block
constexpr int kRingPairMax = 256;         // widest row group of which a block holds two
constexpr int kRingMinD = 2048;           // the ring route's rows: vector,
constexpr int kRingMaxD = 8192;           //   kRingMinD <= d <= kRingMaxD
constexpr int kRingBytes = 192 * 1024;    // shared memory the ring may fill
constexpr int kMaxStages = 4;             // stages a ring holds at most
constexpr int kDotSlots = 2;              // rows whose warp sums a ring group keeps
constexpr int kFinishLanes = 8;           // row-lanes of the dw finish
constexpr int kBwdMaxBlocks = 114;        // the grid: the SMs of the PCIe H100

// c = r^3 * dot / d in fp64, rounded once to fp32.
__device__ __forceinline__ float bwd_coef(float r, double dot, int d) {
  const double rd = r;
  return static_cast<float>(((rd * rd) * rd) * dot / static_cast<double>(d));
}

// w' = 1 + w, rounded.
__device__ __forceinline__ float bwd_wp(float w) { return __fadd_rn(1.0f, w); }

// g = dy * w', rounded.
__device__ __forceinline__ float bwd_g(float dy, float wp) { return __fmul_rn(dy, wp); }

// dx = r * g - x * c, each step rounded.
__device__ __forceinline__ float bwd_dx(float r, float g, float x, float c) {
  return __fsub_rn(__fmul_rn(r, g), __fmul_rn(x, c));
}

// (dy * x) * r, each step rounded: one row's term of dw.
__device__ __forceinline__ float bwd_dw_term(float dy, float x, float r) {
  return __fmul_rn(__fmul_rn(dy, x), r);
}

// Eight consecutive elements of shared memory as floats; p 16-byte aligned.
__device__ __forceinline__ void lds8(const float* p, float (&v)[kPack]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void lds8(const __nv_bfloat16* p, float (&v)[kPack]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int k = 0; k < kPack / 2; ++k) {
    const float2 f = __bfloat1622float2(h[k]);
    v[2 * k] = f.x;
    v[2 * k + 1] = f.y;
  }
}

// Every kernel below ends the same way: each block has written its row of
// fp32 dw partials, the grid meets at a barrier (the launch is cooperative,
// so every block is resident), and then block b sums the partials of the
// 32-column groups b, b + grid, ...: row-lane u of the first 256 threads
// takes the partial rows u, u + 8, ... of 32 columns, in fp64, and the
// eight lane sums are added in lane order, rounded to fp32 and then to
// w's dtype. The order depends on (rows, d) alone. The partials were
// written in this launch, so they are read through L2 (__ldcg), never
// through the non-coherent path.
template <typename TW>
__device__ __forceinline__ void finish_dw(const float* partials, TW* __restrict__ dw, int blocks,
                                          int d) {
  constexpr int kRowsPerLane = (kBwdMaxBlocks + kFinishLanes - 1) / kFinishLanes;
  __shared__ double sums[kFinishLanes][32];
  cg::this_grid().sync();
  const int lane = threadIdx.x & 31;
  const int u = threadIdx.x >> 5;
  for (int group = blockIdx.x; group * 32 < d; group += gridDim.x) {
    const int c = group * 32 + lane;
    if (u < kFinishLanes) {
      float v[kRowsPerLane];   // every load in flight before the first add
#pragma unroll
      for (int k = 0; k < kRowsPerLane; ++k) {
        const int b = u + k * kFinishLanes;
        v[k] = c < d && b < blocks ? __ldcg(partials + static_cast<long long>(b) * d + c) : 0.0f;
      }
      double s = 0.0;
#pragma unroll
      for (int k = 0; k < kRowsPerLane; ++k) {
        if (u + k * kFinishLanes < blocks) s += v[k];
      }
      sums[u][lane] = s;
    }
    __syncthreads();
    if (u == 0 && c < d) {
      double s = 0.0;
#pragma unroll
      for (int k = 0; k < kFinishLanes; ++k) s += sums[k][lane];
      store_one(dw + c, static_cast<float>(s));
    }
    __syncthreads();
  }
}

// d <= kWarpMaxD, kWarpRouteThreads threads: a row is owned by L lanes, a
// half-warp (two rows a warp) at d <= kHalfWarpMaxD and a warp above, so
// that at the qk-norm width of 128 no lane idles. The block's rows go in
// passes of one row a slot (slot 2v and 2v + 1 are warp v's halves); lane
// `sub` of a row owns the columns sub*8 + k (vector) or sub + L*k (scalar),
// k < 8, loads them itself, and keeps their w' and dw sums in registers.
// With 32 warps a block each SM has 64 rows in flight, and the warps drift
// apart, so one warp's conversions overlap another's loads. (Feeding the
// warps from a ring of chunks filled by TMA was slower on the H100: all
// warps waited on one chunk and then converted at once.) The dw sums of a
// warp's two halves are added in slot order, then the warps' in warp order.
template <typename TX, typename TW>
__global__ void __launch_bounds__(kWarpRouteThreads)
rmsnorm_bwd_warp_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
                        const float* __restrict__ inv, const TX* __restrict__ dy,
                        TX* __restrict__ dx, float* partials, TW* __restrict__ dw, long long rows,
                        int d, long long rows_per_block, bool vec) {
  constexpr int kWarpsHere = kWarpRouteThreads / 32;
  extern __shared__ float warp_dw[];   // [kWarpsHere][d]
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int lanes = d <= kHalfWarpMaxD ? 16 : 32;
  const int sub = lane & (lanes - 1);
  const int per_warp = 32 / lanes;
  const int slots = kWarpsHere * per_warp;
  const int slot = warp * per_warp + lane / lanes;
  auto column = [&](int k) { return vec ? sub * kPack + k : sub + lanes * k; };
  float acc[kPack], wp[kPack];
#pragma unroll
  for (int k = 0; k < kPack; ++k) {
    acc[k] = 0.0f;
    const int c = column(k);
    wp[k] = c < d ? bwd_wp(to_float(w[c])) : 0.0f;
  }
  const long long r0 = static_cast<long long>(blockIdx.x) * rows_per_block;
  const long long r1 = min(r0 + rows_per_block, rows);
  for (long long base = r0; base < r1; base += slots) {   // uniform over the block
    const long long row = base + slot;
    const bool live = row < r1;
    float xv[kPack], gv[kPack];
    float r = 0.0f;
    double dot = 0.0;
    if (live) {
      r = __ldg(inv + row);
      const TX* xr = x + row * d;
      const TX* gr = dy + row * d;
      if (vec) {
        if (sub * kPack < d) {
          load8(xr + sub * kPack, xv);
          load8(gr + sub * kPack, gv);
        }
      } else {
#pragma unroll
        for (int k = 0; k < kPack; ++k) {
          const int c = column(k);
          if (c < d) {
            xv[k] = to_float(__ldg(xr + c));
            gv[k] = to_float(__ldg(gr + c));
          }
        }
      }
#pragma unroll
      for (int k = 0; k < kPack; ++k) {
        if (column(k) < d) {
          acc[k] += bwd_dw_term(gv[k], xv[k], r);
          gv[k] = bwd_g(gv[k], wp[k]);
          dot = fma(static_cast<double>(gv[k]), static_cast<double>(xv[k]), dot);
        }
      }
    }
    // a butterfly over the row's lanes: every lane of the row holds the same bits
    for (int off = lanes / 2; off > 0; off >>= 1) {
      dot += __shfl_xor_sync(repro::kFullMask, dot, off);
    }
    if (live) {
      const float cf = bwd_coef(r, dot, d);
      TX* out = dx + row * d;
      if (vec) {
        if (sub * kPack < d) {
#pragma unroll
          for (int k = 0; k < kPack; ++k) xv[k] = bwd_dx(r, gv[k], xv[k], cf);
          store8(out + sub * kPack, xv);
        }
      } else {
#pragma unroll
        for (int k = 0; k < kPack; ++k) {
          const int c = column(k);
          if (c < d) store_one(out + c, bwd_dx(r, gv[k], xv[k], cf));
        }
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kPack; ++k) {
    // the warp's two halves own the same columns: slot 2v's sum, then 2v + 1's
    const float other = __shfl_xor_sync(repro::kFullMask, acc[k], 16);
    const float sum = lanes == 32 ? acc[k] : (lane < 16 ? acc[k] + other : other + acc[k]);
    const int c = column(k);
    if (lane < lanes && c < d) warp_dw[warp * d + c] = sum;
  }
  __syncthreads();
  const int c = threadIdx.x;
  if (c < d) {
    float s = 0.0f;
#pragma unroll 8
    for (int v = 0; v < kWarpsHere; ++v) s += warp_dw[v * d + c];
    partials[static_cast<long long>(blockIdx.x) * d + c] = s;
  }
  finish_dw(partials, dw, static_cast<int>(gridDim.x), d);
}

// kRingMinD <= d <= kRingMaxD, vector: G groups of T threads (T = d / 16
// rounded up to a warp, each thread owning P = 2 16-byte packs; G = 2 where
// T <= 256, as at llama's d = 3072 and qwen3's 4096, else 1) take the
// block's rows [r0, r0 + R), group g the rows g, g + G, ... in order, so G
// rows are reduced at once. Thread t of a group owns the packs t + j*T, j
// < P, and keeps their w', and their dw sums over its group's rows, in
// registers. Thread 0 keeps a ring of up to four rows of x and dy in shared
// memory full by 1-D TMA copies, each stage completing on its mbarrier; a
// group's first thread refills the stage its row came from. A row goes in
// two halves: each thread reads its packs from the ring into registers and
// sums g x in fp64 (two conversions to fp64 an element, at 16 a clock an
// SM), and each warp's lane 0 writes the warp's sum and arrives on the
// group's mbarrier; once every warp of the group has arrived, each thread
// adds the warps' sums in a fixed tree (all hold the same bits) and writes
// dx from its registers, so x and dy are read from device memory once. What
// bounds a row is this chain, not the bytes: on the H100 (PERF.md) a block
// barrier a row, which held the warps in step, and a deeper ring were both
// slower, and two rows in flight a block, each thread with two packs, was
// fastest. At the end the groups' dw sums are added in group order (the
// block route keeps the same two sums where the two routes meet, so a
// row's dw does not depend on the route).
template <typename TX, typename TW, int G>
__global__ void __launch_bounds__(kRingMaxThreads)
rmsnorm_bwd_ring_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
                        const float* __restrict__ inv, const TX* __restrict__ dy,
                        TX* __restrict__ dx, float* partials, TW* __restrict__ dw, long long rows,
                        int d, long long rows_per_block, int stages) {
  constexpr int P = kRingPacks;
  constexpr int kWarpsMax = (G == 2 ? kRingPairMax : kRingMaxThreads) / 32;   // a group's
  extern __shared__ __align__(128) unsigned char ring[];
  __shared__ __align__(8) uint64_t full[kMaxStages];
  __shared__ __align__(8) uint64_t summed[G][kDotSlots];
  __shared__ double warp_dots[G][kDotSlots][kWarpsMax];
  const int threads = blockDim.x / G;   // a group's
  const int group = threadIdx.x / threads;
  const int t = threadIdx.x - group * threads;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int warps = threads >> 5;
  const int packs = d / kPack;
  const long long r0 = static_cast<long long>(blockIdx.x) * rows_per_block;
  const int count = static_cast<int>(min(r0 + rows_per_block, rows) - r0);
  const uint32_t row_bytes = static_cast<uint32_t>(d) * sizeof(TX);
  const uint32_t stage_bytes = 2 * row_bytes;
  auto request = [&](int j) {   // row r0 + j into stage j % stages
    const int s = j % stages;
    const uint32_t bar = smem_addr(&full[s]);
    const uint32_t dst = smem_addr(ring + static_cast<size_t>(s) * stage_bytes);
    mbar_arrive_expect(bar, stage_bytes);
    copy_bulk(dst, x + (r0 + j) * d, row_bytes, bar);
    copy_bulk(dst + row_bytes, dy + (r0 + j) * d, row_bytes, bar);
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) mbar_init(smem_addr(&full[s]), 1);
    for (int g = 0; g < G; ++g) {
      for (int s = 0; s < kDotSlots; ++s) mbar_init(smem_addr(&summed[g][s]), warps);
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int j = 0; j < min(stages, count); ++j) request(j);
  }
  float wp[P][kPack], acc[P][kPack];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int pack = t + p * threads;
#pragma unroll
    for (int k = 0; k < kPack; ++k) acc[p][k] = 0.0f;
    if (pack < packs) {
      load8(w + pack * kPack, wp[p]);
#pragma unroll
      for (int k = 0; k < kPack; ++k) wp[p][k] = bwd_wp(wp[p][k]);
    }
  }
  float r_next = group < count ? __ldg(inv + r0 + group) : 0.0f;   // a row ahead
  for (int j = group, m = 0; j < count; j += G, ++m) {
    const float r = r_next;
    r_next = j + G < count ? __ldg(inv + r0 + j + G) : 0.0f;
    // the first half: x and dy into registers, the dw terms, g, the warp's
    // fp64 sum of g x into its slot
    float xv[P][kPack], gv[P][kPack];
    const int s = j % stages;
    mbar_wait(smem_addr(&full[s]), static_cast<uint32_t>(j / stages) & 1u);
    const TX* xs = reinterpret_cast<const TX*>(ring + static_cast<size_t>(s) * stage_bytes);
    double dot = 0.0;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int pack = t + p * threads;
      if (pack < packs) {
        lds8(xs + pack * kPack, xv[p]);
        lds8(xs + d + pack * kPack, gv[p]);
#pragma unroll
        for (int k = 0; k < kPack; ++k) {
          acc[p][k] += bwd_dw_term(gv[p][k], xv[p][k], r);
          gv[p][k] = bwd_g(gv[p][k], wp[p][k]);
          dot = fma(static_cast<double>(gv[p][k]), static_cast<double>(xv[p][k]), dot);
        }
      }
    }
    dot = repro::warp_sum(dot);
    const int slot = m % kDotSlots;
    if (lane == 0) {
      warp_dots[group][slot][warp] = dot;
      mbar_arrive(smem_addr(&summed[group][slot]));
    }
    // the second half, once every warp of the group has summed: the warps'
    // sums in a fixed tree, c, the refill of the row's stage, dx
    mbar_wait(smem_addr(&summed[group][slot]), static_cast<uint32_t>(m / kDotSlots) & 1u);
    if (t == 0 && j + stages < count) request(j + stages);
    double v[kWarpsMax];
#pragma unroll
    for (int u = 0; u < kWarpsMax; ++u) v[u] = u < warps ? warp_dots[group][slot][u] : 0.0;
#pragma unroll
    for (int stride = 1; stride < kWarpsMax; stride *= 2) {
#pragma unroll
      for (int u = 0; u + stride < kWarpsMax; u += 2 * stride) {
        if (u + stride < warps) v[u] += v[u + stride];
      }
    }
    const float cf = bwd_coef(r, v[0], d);
    TX* out = dx + (r0 + j) * d;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int pack = t + p * threads;
      if (pack < packs) {
#pragma unroll
        for (int k = 0; k < kPack; ++k) xv[p][k] = bwd_dx(r, gv[p][k], xv[p][k], cf);
        store8(out + pack * kPack, xv[p]);
      }
    }
  }
  float* part = partials + static_cast<long long>(blockIdx.x) * d;
  if (G == 1) {
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int pack = t + p * threads;
      if (pack < packs) store8(part + pack * kPack, acc[p]);
    }
  } else {
    __syncthreads();   // every row read: the ring's memory holds group 1's sums now
    float* second = reinterpret_cast<float*>(ring);
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int pack = t + p * threads;
      if (group == 1 && pack < packs) store8(second + pack * kPack, acc[p]);
    }
    __syncthreads();
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int pack = t + p * threads;
      if (group == 0 && pack < packs) {
        float o[kPack];
        lds8(second + pack * kPack, o);
#pragma unroll
        for (int k = 0; k < kPack; ++k) acc[p][k] += o[k];
        store8(part + pack * kPack, acc[p]);
      }
    }
  }
  finish_dw(partials, dw, static_cast<int>(gridDim.x), d);
}

// Every other d > kWarpMaxD (not a multiple of 8, unaligned, or outside the
// ring's widths): one block of kBlockThreads takes rows [r0, r0 + R) in
// order, a row at a time. Thread t owns the columns t*8 + k + j*2048
// (vector) or t + j*256 (scalar), and only it touches their dw sums in
// shared memory, `groups` sums a column (row j's into sum j % groups, as the
// ring route's groups take them, added in order at the end); the row's
// second pass reads x and dy again (from L1).
template <typename TX, typename TW>
__global__ void __launch_bounds__(kBlockThreads)
rmsnorm_bwd_block_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
                         const float* __restrict__ inv, const TX* __restrict__ dy,
                         TX* __restrict__ dx, float* partials, TW* __restrict__ dw, long long rows,
                         int d, long long rows_per_block, bool vec, int groups) {
  extern __shared__ float dw_sums[];   // [groups][d]
  __shared__ double warp_dots[kWarps];
  __shared__ float coef_s;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  constexpr int kStride = kBlockThreads * kPack;
  for (int c = t; c < groups * d; c += kBlockThreads) dw_sums[c] = 0.0f;
  const long long r0 = static_cast<long long>(blockIdx.x) * rows_per_block;
  const long long r1 = min(r0 + rows_per_block, rows);
  float r_next = __ldg(inv + r0);   // the next row's inverse RMS, loaded a row ahead
  for (long long row = r0; row < r1; ++row) {
    const float r = r_next;
    if (row + 1 < r1) r_next = __ldg(inv + row + 1);
    float* dw_s = dw_sums + ((row - r0) % groups) * d;
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
          dot = fma(static_cast<double>(bwd_g(gv[k], bwd_wp(wv[k]))), static_cast<double>(xv[k]),
                    dot);
          dw_s[c + k] += bwd_dw_term(gv[k], xv[k], r);
        }
      }
    } else {
      for (int c = t; c < d; c += kBlockThreads) {
        const float xv = to_float(xr[c]), gv = to_float(gr[c]);
        dot = fma(static_cast<double>(bwd_g(gv, bwd_wp(to_float(w[c])))), static_cast<double>(xv),
                  dot);
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
      for (int c = t * kPack; c < d; c += kStride) {
        float xv[kPack], gv[kPack], wv[kPack];
        load8(xr + c, xv);
        load8(gr + c, gv);
        load8(w + c, wv);
#pragma unroll
        for (int k = 0; k < kPack; ++k) xv[k] = bwd_dx(r, bwd_g(gv[k], bwd_wp(wv[k])), xv[k], cf);
        store8(out + c, xv);
      }
    } else {
      for (int c = t; c < d; c += kBlockThreads) {
        store_one(out + c, bwd_dx(r, bwd_g(to_float(gr[c]), bwd_wp(to_float(w[c]))),
                                  to_float(xr[c]), cf));
      }
    }
  }
  float* part = partials + static_cast<long long>(blockIdx.x) * d;
  auto finish_column = [&](int c) {
    float sum = dw_sums[c];
    for (int g = 1; g < groups; ++g) sum += dw_sums[g * d + c];
    part[c] = sum;
  };
  if (vec) {
    for (int c = t * kPack; c < d; c += kStride) {
#pragma unroll
      for (int k = 0; k < kPack; ++k) finish_column(c + k);
    }
  } else {
    for (int c = t; c < d; c += kBlockThreads) finish_column(c);
  }
  finish_dw(partials, dw, static_cast<int>(gridDim.x), d);
}

// Launch `kernel` cooperatively (every block resident at once, which the
// grid barrier of finish_dw needs), after opting into `smem` bytes of
// dynamic shared memory and checking that the card holds `blocks` blocks
// at once: a grid it cannot hold is refused with
// cudaErrorCooperativeLaunchTooLarge, never launched.
template <typename... Params, typename... Args>
cudaError_t launch_cooperative(void (*kernel)(Params...), int blocks, int threads, size_t smem,
                               cudaStream_t stream, Args... args) {
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
  if (per_sm * sms < blocks) return cudaErrorCooperativeLaunchTooLarge;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(static_cast<unsigned>(blocks));
  config.blockDim = dim3(static_cast<unsigned>(threads));
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  cudaLaunchAttribute attribute[1];
  attribute[0].id = cudaLaunchAttributeCooperative;
  attribute[0].val.cooperative = 1;
  config.attrs = attribute;
  config.numAttrs = 1;
  return cudaLaunchKernelEx(&config, kernel, args...);
}

// The ring route's geometry at width d (a multiple of 8 in [kRingMinD,
// kRingMaxD]): threads a row group (a warp multiple), row groups a block.
int ring_threads(int d) { return ((d / kPack + kRingPacks - 1) / kRingPacks + 31) / 32 * 32; }
int ring_groups(int d) { return ring_threads(d) <= kRingPairMax ? 2 : 1; }

template <typename TX, typename TW>
cudaError_t launch_bwd(const void* x, const void* w, const float* inv, const void* dy, void* dx,
                       float* partials, void* dw, long long rows, int d,
                       long long rows_per_block, cudaStream_t stream) {
  const TX* xp = static_cast<const TX*>(x);
  const TW* wp = static_cast<const TW*>(w);
  const TX* gp = static_cast<const TX*>(dy);
  TX* op = static_cast<TX*>(dx);
  TW* dwp = static_cast<TW*>(dw);
  const bool vec = d % kPack == 0 && aligned16(x) && aligned16(w) && aligned16(dy) &&
                   aligned16(dx);
  const long long grid = (rows + rows_per_block - 1) / rows_per_block;
  if (grid > kBwdMaxBlocks) return cudaErrorInvalidValue;
  const int blocks = static_cast<int>(grid);
  cudaError_t err;
  if (d <= kWarpMaxD) {
    err = launch_cooperative(rmsnorm_bwd_warp_kernel<TX, TW>, blocks, kWarpRouteThreads,
                             kWarpRouteThreads / 32 * static_cast<size_t>(d) * sizeof(float),
                             stream, xp, wp, inv, gp, op, partials, dwp, rows, d, rows_per_block,
                             vec);
  } else if (vec && d >= kRingMinD && d <= kRingMaxD) {
    const int groups = ring_groups(d);
    const int threads = ring_threads(d);
    const long long stage_bytes = 2LL * d * static_cast<long long>(sizeof(TX));
    long long stages = std::min({rows_per_block, static_cast<long long>(kMaxStages),
                                 static_cast<long long>(kRingBytes) / stage_bytes});
    if (stages < rows_per_block) stages -= stages % groups;   // a group refills its own stages
    const int st = static_cast<int>(std::max(1LL, stages));
    const size_t smem = static_cast<size_t>(st * stage_bytes);
    err = groups == 2
              ? launch_cooperative(rmsnorm_bwd_ring_kernel<TX, TW, 2>, blocks, 2 * threads, smem,
                                   stream, xp, wp, inv, gp, op, partials, dwp, rows, d,
                                   rows_per_block, st)
              : launch_cooperative(rmsnorm_bwd_ring_kernel<TX, TW, 1>, blocks, threads, smem,
                                   stream, xp, wp, inv, gp, op, partials, dwp, rows, d,
                                   rows_per_block, st);
  } else {
    // the ring route's grouping of rows where its widths are, so that dw's
    // sums run in the same order on both routes
    const int groups = d % kPack == 0 && d >= kRingMinD && d <= kRingMaxD ? ring_groups(d) : 1;
    err = launch_cooperative(rmsnorm_bwd_block_kernel<TX, TW>, blocks, kBlockThreads,
                             static_cast<size_t>(groups) * d * sizeof(float), stream, xp, wp, inv,
                             gp, op, partials, dwp, rows, d, rows_per_block, vec, groups);
  }
  if (err != cudaSuccess) return err;
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

// The backward, one cooperative launch: x, dy, dx (rows, d) of x_dtype; w
// and dw (d,) of w_dtype; inv (rows,) fp32, the forward's; partials
// (ceil(rows / rows_per_block), d) fp32 scratch, one row a block, a grid
// the card holds at once (the wrapper caps it at 114 blocks, the SMs of the
// smallest H100). d <= 56 * 1024 (the block route's dw sums in shared
// memory); a grid or a d the card cannot hold is refused.
REPRO_EXPORT int repro_rmsnorm_bwd(const void* x, const void* w, const float* inv,
                                   const void* dy, void* dx, float* partials, void* dw,
                                   long long rows, int d, long long rows_per_block, int x_dtype,
                                   int w_dtype, cudaStream_t stream) {
  if (rows <= 0 || d <= 0 || rows_per_block <= 0) return static_cast<int>(cudaGetLastError());
  return static_cast<int>(by_dtypes(x_dtype, w_dtype, [&](auto tx, auto tw) {
    return launch_bwd<decltype(tx), decltype(tw)>(x, w, inv, dy, dx, partials, dw, rows, d,
                                                  rows_per_block, stream);
  }));
}
