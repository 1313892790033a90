// Fused center-matvec for matrix-free PCoA: out = F @ X for the
// Gower-centred F = E - r 1^T - 1 r^T + m with E = -1/2 D*D, never forming
// F or E in device memory.
//
//   out[i, c] = sum_j E[i, j] X[j, c] + (corr[c] - r[i] colsum[c])
//
// with colsum = 1^T X and corr = m 1^T X - r^T X hoisted by the caller on the
// unpadded operands.
//
// Replaces: src/repro/kernels/center_matvec.py::center_matvec
// (_center_matvec_kernel).
//
// Bound on an H100: bytes, narrowly. D is read once: 4 n^2 bytes, 1.07 GB
// at n = 16384, 0.32 ms at 3.35 TB/s. The product is 2 n^2 k flops, 1.1e10
// at k = 20, 0.16 ms at the 67 TFLOP/s fp32 rate of the CUDA cores. So the
// FMA loop has to run at about half the fp32 peak for memory to be the
// limit, and the design spends its effort on keeping shared-memory traffic
// per FMA low.
//
// Design: the Pallas kernel accumulates the output strip across the column
// grid axis, which relies on the TPU's in-order grid. Here one block owns
// BM = 64 output rows and sweeps every column itself, so no sum crosses
// blocks and the result is deterministic. Per step a BM x BN tile of D is
// read coalesced (prefetched into registers one step ahead), squared and
// halved on the way into shared memory, stored transposed so that each
// lane reads its two rows with one 8-byte load; the BN x k tile of X sits
// beside it and is read as float4 broadcasts. Each lane keeps 2 x KP fp32
// accumulators (KP = k rounded up to 4, a template parameter, at most 32),
// fed once per step by a step-local sum, so the long fp32 addition chain is
// n / 64 terms; the four warps split each tile's columns and their partial
// strips are added in a fixed warp order in the epilogue, which then applies
// the rank-1 corrections. fp32 FMA on the CUDA cores, no TF32: tensor-core TF32
// keeps about three digits and the tolerance is 1e-5. Ragged n and k are
// masked (zeros into shared memory, masked stores), never padded in memory.
#include "common.cuh"

namespace {

constexpr int kBM = 64;                    // output rows per block (2 per lane)
constexpr int kBN = 64;                    // D columns per step
constexpr int kWarps = 4;                  // each warp takes kBN / kWarps columns
constexpr int kThreads = kWarps * 32;
constexpr int kColsPerWarp = kBN / kWarps;
constexpr int kPitch = kBM + 2;            // even, so float2 reads stay aligned
constexpr int kLoads = kBM * kBN / kThreads;  // D values each thread stages per step

template <int KP>
__global__ void __launch_bounds__(kThreads)
center_matvec_kernel(const float* __restrict__ d, const float* __restrict__ x,
                     const float* __restrict__ row_means,
                     const float* __restrict__ colsum,
                     const float* __restrict__ corr, float* __restrict__ out,
                     int n, int k) {
  __shared__ __align__(16) float et[kBN][kPitch];  // E tile, transposed: et[j][i]
  __shared__ __align__(16) float xs[kBN][KP];      // X tile
  __shared__ float strip[kBM][KP];                 // epilogue: the block's rows

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int i0 = blockIdx.x * kBM;

  float acc0[KP];
  float acc1[KP];
#pragma unroll
  for (int c = 0; c < KP; ++c) {
    acc0[c] = 0.0f;
    acc1[c] = 0.0f;
  }

  // D tile (kBM x kBN) at column j0: a warp reads 32 consecutive columns of
  // one row, so every load is one 128-byte line.
  float pre[kLoads];
  auto load_tile = [&](int j0) {
#pragma unroll
    for (int t = 0; t < kLoads; ++t) {
      const int idx = tid + t * kThreads;
      const int row = i0 + idx / kBN;
      const int col = j0 + idx % kBN;
      pre[t] = (row < n && col < n) ? __ldg(d + static_cast<size_t>(row) * n + col) : 0.0f;
    }
  };

  load_tile(0);
  for (int j0 = 0; j0 < n; j0 += kBN) {
#pragma unroll
    for (int t = 0; t < kLoads; ++t) {
      const int idx = tid + t * kThreads;
      const float v = pre[t];
      et[idx % kBN][idx / kBN] = -0.5f * v * v;
    }
    for (int idx = tid; idx < kBN * KP; idx += kThreads) {
      const int jj = idx / KP;
      const int c = idx % KP;
      const int col = j0 + jj;
      xs[jj][c] = (col < n && c < k) ? __ldg(x + static_cast<size_t>(col) * k + c) : 0.0f;
    }
    __syncthreads();

    if (j0 + kBN < n) load_tile(j0 + kBN);  // in flight while this step computes

    // This step's 16 columns are summed on their own, then added to the
    // running sums: the long fp32 chain has n/64 terms, not n/4.
    float step0[KP];
    float step1[KP];
#pragma unroll
    for (int c = 0; c < KP; ++c) {
      step0[c] = 0.0f;
      step1[c] = 0.0f;
    }
    const int jbeg = warp * kColsPerWarp;
#pragma unroll 2
    for (int jj = jbeg; jj < jbeg + kColsPerWarp; ++jj) {
      const float2 e = *reinterpret_cast<const float2*>(&et[jj][2 * lane]);
#pragma unroll
      for (int c = 0; c < KP; c += 4) {
        const float4 xv = *reinterpret_cast<const float4*>(&xs[jj][c]);
        step0[c + 0] = fmaf(e.x, xv.x, step0[c + 0]);
        step0[c + 1] = fmaf(e.x, xv.y, step0[c + 1]);
        step0[c + 2] = fmaf(e.x, xv.z, step0[c + 2]);
        step0[c + 3] = fmaf(e.x, xv.w, step0[c + 3]);
        step1[c + 0] = fmaf(e.y, xv.x, step1[c + 0]);
        step1[c + 1] = fmaf(e.y, xv.y, step1[c + 1]);
        step1[c + 2] = fmaf(e.y, xv.z, step1[c + 2]);
        step1[c + 3] = fmaf(e.y, xv.w, step1[c + 3]);
      }
    }
#pragma unroll
    for (int c = 0; c < KP; ++c) {
      acc0[c] += step0[c];
      acc1[c] += step1[c];
    }
    __syncthreads();
  }

  // Partial strips of the four warps, added in warp order 0, 1, 2, 3.
  for (int w = 0; w < kWarps; ++w) {
    if (warp == w) {
#pragma unroll
      for (int c = 0; c < KP; ++c) {
        strip[2 * lane][c] = (w == 0 ? 0.0f : strip[2 * lane][c]) + acc0[c];
        strip[2 * lane + 1][c] = (w == 0 ? 0.0f : strip[2 * lane + 1][c]) + acc1[c];
      }
    }
    __syncthreads();
  }

  for (int idx = tid; idx < kBM * k; idx += kThreads) {
    const int r = idx / k;
    const int c = idx % k;
    const int row = i0 + r;
    if (row < n) {
      out[static_cast<size_t>(row) * k + c] = strip[r][c] + (corr[c] - row_means[row] * colsum[c]);
    }
  }
}

template <int KP>
void launch(const float* d, const float* x, const float* rm, const float* colsum,
            const float* corr, float* out, int n, int k, cudaStream_t stream) {
  const int blocks = (n + kBM - 1) / kBM;
  center_matvec_kernel<KP><<<blocks, kThreads, 0, stream>>>(d, x, rm, colsum, corr, out, n, k);
}

}  // namespace

// d: (n, n), x: (n, k), row_means: (n,), colsum/corr: (k,), out: (n, k);
// all fp32, contiguous, on the device. 1 <= k <= 32.
REPRO_EXPORT int repro_center_matvec(const float* d, const float* x, const float* row_means,
                                     const float* colsum, const float* corr, float* out,
                                     int n, int k, cudaStream_t stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  switch ((k + 3) / 4) {
    case 1: launch<4>(d, x, row_means, colsum, corr, out, n, k, stream); break;
    case 2: launch<8>(d, x, row_means, colsum, corr, out, n, k, stream); break;
    case 3: launch<12>(d, x, row_means, colsum, corr, out, n, k, stream); break;
    case 4: launch<16>(d, x, row_means, colsum, corr, out, n, k, stream); break;
    case 5: launch<20>(d, x, row_means, colsum, corr, out, n, k, stream); break;
    case 6: launch<24>(d, x, row_means, colsum, corr, out, n, k, stream); break;
    case 7: launch<28>(d, x, row_means, colsum, corr, out, n, k, stream); break;
    case 8: launch<32>(d, x, row_means, colsum, corr, out, n, k, stream); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
