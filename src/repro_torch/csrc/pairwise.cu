// One row panel of pairwise distances, the hot loop of the feature-table
// path:
//
//   out[i, j] = finish(sum_f acc(xi[i, f], x[j, f]))
//
// for xi (bm, d) and x (n, d), fp32, row-major, giving (bm, n) fp32. One
// kernel templated on the metric (enum Kind below, which must agree with
// the `kind` of each metric in repro_torch/dist/metrics.py): Euclidean,
// cityblock, Canberra, Bray-Curtis, Jaccard.
//
// Replaces: src/repro/kernels/pairwise.py::pairwise_panel
// (_pairwise_kernel).
//
// Bound on an H100: instructions, not bytes. Every (i, j, f) term costs a
// few fp32 instructions in the CUDA cores and no byte beyond the two
// operands, which are reused bm and n times. At bm = 256, n = 16384,
// d = 2048 a panel has 8.6e9 terms; Bray-Curtis takes 4 FADDs a term (a-b,
// a+b, and two accumulates with the abs folded into the operand), 3.4e10
// instructions, 1.03 ms at 33.5e12 fp32 instructions/s (the data sheet's
// 67 TFLOP/s counts an FMA as two operations). The same panel's bytes,
// each operand read once and the output written once, take 0.05 ms.
//
// Design: the Pallas kernel keeps the xi panel resident in VMEM and sweeps
// column blocks of x on an in-order grid. Here a block owns a 64 x 64
// output tile and loops over the features itself, 32 at a time: each step
// stages the xi and x tiles in shared memory, transposed (feature-major),
// so that a thread reads its 4 rows and its 4 columns of one feature as
// two 16-byte broadcasts and feeds 16 pair terms from them; the 256
// threads each keep a 4 x 4 patch of accumulators in registers. The next
// step's tiles are read into registers while this step computes. That loop
// replaces the Pallas chunk loop. Accumulation is fp32 in feature order,
// with no tensor cores and no TF32, and Euclidean stays difference-based,
// so the reference's 1e-5 parity holds; d(i, j) and d(j, i) are the same
// expression summed in the same order, so a square assembled from panels
// is exactly symmetric and hollow. `finish` runs in registers and each
// output is written once. Ragged bm, n and d are masked in the kernel: the
// feature tail is zero-filled, since zero features are the identity for
// every metric's accumulators, and nothing is padded in device memory.
#include "common.cuh"

namespace {

constexpr int kTile = 64;                  // output rows and columns of a block
constexpr int kChunk = 32;                 // features staged per step
constexpr int kPatch = 4;                  // each thread: 4 x 4 outputs
constexpr int kSide = kTile / kPatch;      // 16 x 16 threads
constexpr int kThreads = kSide * kSide;
constexpr int kPitch = kTile + 4;          // a multiple of 4: float4 reads stay aligned
constexpr int kLoads = kTile * kChunk / kThreads;  // values of each tile a thread stages

enum Kind { kEuclidean = 0, kCityblock = 1, kCanberra = 2, kBrayCurtis = 3, kJaccard = 4 };

template <int K>
struct Metric;

template <>
struct Metric<kEuclidean> {
  static constexpr int kAcc = 1;
  __device__ __forceinline__ static void add(float a, float b, float* acc) {
    const float t = a - b;
    acc[0] = fmaf(t, t, acc[0]);
  }
  __device__ __forceinline__ static float finish(const float* acc) {
    return sqrtf(fmaxf(acc[0], 0.0f));
  }
};

template <>
struct Metric<kCityblock> {
  static constexpr int kAcc = 1;
  __device__ __forceinline__ static void add(float a, float b, float* acc) {
    acc[0] += fabsf(a - b);
  }
  __device__ __forceinline__ static float finish(const float* acc) { return acc[0]; }
};

template <>
struct Metric<kCanberra> {
  static constexpr int kAcc = 1;
  __device__ __forceinline__ static void add(float a, float b, float* acc) {
    const float den = fabsf(a) + fabsf(b);
    acc[0] += den > 0.0f ? fabsf(a - b) / den : 0.0f;
  }
  __device__ __forceinline__ static float finish(const float* acc) { return acc[0]; }
};

template <>
struct Metric<kBrayCurtis> {
  static constexpr int kAcc = 2;
  __device__ __forceinline__ static void add(float a, float b, float* acc) {
    acc[0] += fabsf(a - b);
    acc[1] += fabsf(a + b);
  }
  __device__ __forceinline__ static float finish(const float* acc) {
    return acc[1] > 0.0f ? acc[0] / acc[1] : 0.0f;
  }
};

template <>
struct Metric<kJaccard> {
  static constexpr int kAcc = 2;
  __device__ __forceinline__ static void add(float a, float b, float* acc) {
    acc[0] += a != b ? 1.0f : 0.0f;
    acc[1] += (a != 0.0f || b != 0.0f) ? 1.0f : 0.0f;
  }
  __device__ __forceinline__ static float finish(const float* acc) {
    return acc[1] > 0.0f ? acc[0] / acc[1] : 0.0f;
  }
};

// At most 128 registers a thread, so that two blocks share an SM.
template <int K>
__global__ void __launch_bounds__(kThreads, 2)
pairwise_panel_kernel(const float* __restrict__ xi, const float* __restrict__ x,
                      float* __restrict__ out, int bm, int n, int d) {
  using M = Metric<K>;
  __shared__ __align__(16) float as[kChunk][kPitch];  // xi tile, feature-major: as[f][row]
  __shared__ __align__(16) float bs[kChunk][kPitch];  // x tile, feature-major: bs[f][col]

  const int tid = threadIdx.x;
  const int tx = tid % kSide;
  const int ty = tid / kSide;
  const int i0 = blockIdx.y * kTile;       // rows of the panel
  const int j0 = blockIdx.x * kTile;       // rows of the table: the output's columns

  float acc[kPatch][kPatch][M::kAcc];
#pragma unroll
  for (int r = 0; r < kPatch; ++r)
#pragma unroll
    for (int c = 0; c < kPatch; ++c)
#pragma unroll
      for (int q = 0; q < M::kAcc; ++q) acc[r][c][q] = 0.0f;

  // A warp reads 32 consecutive features of one row of each operand: one
  // 128-byte line each, when the row is long enough.
  float pa[kLoads];
  float pb[kLoads];
  auto load = [&](int f0) {
#pragma unroll
    for (int t = 0; t < kLoads; ++t) {
      const int idx = tid + t * kThreads;
      const int row = idx / kChunk;
      const int f = f0 + idx % kChunk;
      pa[t] = (i0 + row < bm && f < d) ? __ldg(xi + static_cast<size_t>(i0 + row) * d + f) : 0.0f;
      pb[t] = (j0 + row < n && f < d) ? __ldg(x + static_cast<size_t>(j0 + row) * d + f) : 0.0f;
    }
  };

  load(0);
  for (int f0 = 0; f0 < d; f0 += kChunk) {
#pragma unroll
    for (int t = 0; t < kLoads; ++t) {
      const int idx = tid + t * kThreads;
      as[idx % kChunk][idx / kChunk] = pa[t];
      bs[idx % kChunk][idx / kChunk] = pb[t];
    }
    __syncthreads();

    if (f0 + kChunk < d) load(f0 + kChunk);  // in flight while this step computes

#pragma unroll 4
    for (int f = 0; f < kChunk; ++f) {
      const float4 av = *reinterpret_cast<const float4*>(&as[f][ty * kPatch]);
      const float4 bv = *reinterpret_cast<const float4*>(&bs[f][tx * kPatch]);
      const float a[kPatch] = {av.x, av.y, av.z, av.w};
      const float b[kPatch] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int r = 0; r < kPatch; ++r)
#pragma unroll
        for (int c = 0; c < kPatch; ++c) M::add(a[r], b[c], acc[r][c]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < kPatch; ++r) {
    const int row = i0 + ty * kPatch + r;
    if (row >= bm) continue;
#pragma unroll
    for (int c = 0; c < kPatch; ++c) {
      const int col = j0 + tx * kPatch + c;
      if (col < n) out[static_cast<size_t>(row) * n + col] = M::finish(acc[r][c]);
    }
  }
}

template <int K>
void launch(const float* xi, const float* x, float* out, int bm, int n, int d, dim3 grid,
            cudaStream_t stream) {
  pairwise_panel_kernel<K><<<grid, kThreads, 0, stream>>>(xi, x, out, bm, n, d);
}

}  // namespace

// xi: (bm, d), x: (n, d), out: (bm, n); all fp32, contiguous, on the device.
// kind: the metric (enum Kind). d may be 0 (every distance is then 0).
REPRO_EXPORT int repro_pairwise_panel(const float* xi, const float* x, float* out, int bm, int n,
                                      int d, int kind, cudaStream_t stream) {
  if (bm <= 0 || n <= 0) return static_cast<int>(cudaGetLastError());
  const dim3 grid((n + kTile - 1) / kTile, (bm + kTile - 1) / kTile);
  if (grid.y > 65535u || d < 0) return static_cast<int>(cudaErrorInvalidValue);
  switch (kind) {
    case kEuclidean: launch<kEuclidean>(xi, x, out, bm, n, d, grid, stream); break;
    case kCityblock: launch<kCityblock>(xi, x, out, bm, n, d, grid, stream); break;
    case kCanberra: launch<kCanberra>(xi, x, out, bm, n, d, grid, stream); break;
    case kBrayCurtis: launch<kBrayCurtis>(xi, x, out, bm, n, d, grid, stream); break;
    case kJaccard: launch<kJaccard>(xi, x, out, bm, n, d, grid, stream); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
