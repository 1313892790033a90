// Products of the Gower-centred operator over CONDENSED distances:
// out = F @ X for F = E - r 1^T - 1 r^T + m, E = -1/2 D*D, with D read
// straight from its scipy-layout condensed vector dc (the pair (a, b), a < b,
// at a(2n - a - 1)/2 + b - a - 1) and never formed, nor E or F:
//
//   out[i, c] = -1/2 sum_j fl(D[i, j]^2) X[j, c] + (corr[c] - r[i] colsum[c])
//
// with colsum = 1^T X and corr = m 1^T X - r^T X hoisted by the caller on the
// unpadded operands (center_matvec's corrections). Halving the sum at the end
// gives the bits of summing -1/2 fl(D^2) X: a power of two scales exactly.
//
// Replaces: no Pallas kernel. The reference's CondensedCenteredGramOperator
// gathers each row strip of D from the condensed vector with jnp ops; the
// port did the same with about 22 small torch launches a 256-row strip, 420 a
// product at n = 4743, which left the card idle between them.
//
// Bound on an H100: bytes at narrow k. Every pair is read twice, once for
// each of its rows: 8 m bytes, 90 MB at n = 4743 (m = 11.2 M), 27 us at
// 3.35 TB/s (L2, 50 MB, may serve part of the second read). The products are
// fp32 FMAs on the CUDA cores (no TF32: the configuration states fp32),
// 2 n^2 k operations, 13.4 us at k = 20 and 67 TFLOP/s; at k = 128, 86 us.
//
// Design. A strip of kBM = 64 output rows and up to 32 columns of X (a
// "group"; wider X takes gridDim.y groups, each sweeping D again, mostly from
// L2) is swept over every column of D in stages of 32 columns by a
// thread-block cluster of `split` blocks (1, 2 or 4, the wrapper's
// sweep_split, a function of (n, k) alone), rank q taking stages
// [q T / s, (q + 1) T / s) of the T = ceil(n / 32). A stage is a 64 x 32 tile
// of D and the 32 x TN tile of X beside it, brought in by 4-byte cp.async
// copies (the condensed runs start at any float) into a ring of 4 stages.
// Each tile is read in coalesced runs: above the diagonal a warp copies 32
// consecutive floats of one row (row i's pairs (i, j > i) are contiguous);
// below it, 32 consecutive rows of one column (for a fixed j the pairs
// (j, i > j) are contiguous); the tiles that cross the diagonal element by
// element, with the diagonal and everything past n zero. Shared memory holds
// the tile column-major with a pitch of 65 floats, so that both copy
// patterns and the reads below are free of bank conflicts. Three blocks fit
// an SM up to 20 columns (two above), so a strip's stages are in flight
// for several blocks at once: the copies, not the FMAs, bound the sweep.
// The 8 warps split a stage's 32 columns (warp w takes columns w, w + 8, ..);
// a lane owns rows lane + 32 t (t < 2) and all TN columns: for each of its
// columns it squares 2 D values and multiplies them into 2 x TN fp32 sums by
// the X row, which it reads as float4 broadcasts. Each sum therefore runs
// over the block's stages in order, 4 columns a stage. At the end the warps'
// sums meet in a fixed tree through shared memory ((w0 + w4) + (w2 + w6)) +
// ((w1 + w5) + (w3 + w7)), and then the cluster's ranks in rank order through
// distributed shared memory: ranks 1 .. s-1 store into slots of rank 0's
// ring, which adds them in order and writes the epilogue. No float atomics:
// every output element is summed in an order that depends only on (n, k), so
// two launches give the same bits, and a column's bits do not depend on the
// other columns of X. Index arithmetic is int32, exact for n <= 46340.
#include <cooperative_groups.h>

#include <type_traits>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

using repro::smem_addr;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBM = 64;                        // output rows a strip
constexpr int kRowsPerLane = kBM / 32;         // rows lane + 32 t
constexpr int kBN = 32;                        // D columns (X rows) a stage
constexpr int kColsPerWarp = kBN / kWarps;     // stage columns w + 8 q
constexpr int kPitch = kBM + 1;                // floats between a stage's D columns
constexpr int kRing = 4;                       // stages in flight
constexpr int kGroup = 32;                     // X columns a block takes, at most
constexpr int kMaxSplit = 4;                   // blocks of a strip's cluster, at most
constexpr int kMaxN = 46340;                   // int32-exact triangle indexing

// Floats of one ring stage at TN columns: the D tile, then the X tile (whose
// offset, 8320 bytes, keeps the X rows 16-byte aligned for float4 reads).
__host__ __device__ constexpr int stage_floats(int tn) { return kBN * kPitch + kBN * tn; }
__host__ __device__ constexpr int smem_bytes(int tn) { return kRing * stage_floats(tn) * 4; }
// Blocks an SM holds at once: three up to 20 columns (at most 85 registers
// a thread, 3 x 44 KB of shared memory), two above.
__host__ __device__ constexpr int min_blocks(int tn) { return tn <= 20 ? 3 : 2; }

__device__ __forceinline__ void copy4(uint32_t dst, const float* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void commit_copies() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// The condensed position of the pair (a, b), a < b < n, less b:
// a(2n - a - 1)/2 - a - 1 = a(2n - a - 3)/2 - 1 (a(2n - a - 3) is even, and
// below 2^31 for n <= 46340). The pair lies at run_start(a) + b.
__device__ __forceinline__ int run_start(int a, int n) { return a * (2 * n - a - 3) / 2 - 1; }

// Stage (i0, j0) into `stage`: D[i0:i0+64, j0:j0+32] at column-major pitch
// kPitch, then X[j0:j0+32, c0:c0+TN] row-major, zeros on the diagonal and past
// n and k (a zero-filling copy reads nothing). row_run holds run_start of the
// block's rows.
template <int TN>
__device__ __forceinline__ void issue_stage(float* stage, const int* row_run,
                                            const float* __restrict__ dc,
                                            const float* __restrict__ x, int n, int k, int c0,
                                            int i0, int j0) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const uint32_t ds = smem_addr(stage);
  if (j0 >= i0 + kBM) {
    // above the diagonal: a lane a column, 32 consecutive floats of a row
    const int j = j0 + lane;
#pragma unroll 4
    for (int r = warp; r < kBM; r += kWarps) {
      const bool valid = i0 + r < n && j < n;
      copy4(ds + 4 * (lane * kPitch + r), dc + (valid ? row_run[r] + j : 0), valid);
    }
  } else if (j0 + kBN <= i0) {
    // below it: a lane a row, 32 consecutive rows of a column (a warp's
    // half of its 64-row run)
    const int r = tid % kBM;
    const bool valid = i0 + r < n;
#pragma unroll 4
    for (int c = tid / kBM; c < kBN; c += kThreads / kBM) {
      copy4(ds + 4 * (c * kPitch + r), dc + (valid ? run_start(j0 + c, n) + i0 + r : 0), valid);
    }
  } else {
    // across it: element by element
    const int j = j0 + lane;
    for (int r = warp; r < kBM; r += kWarps) {
      const int i = i0 + r;
      const bool valid = i < n && j < n && i != j;
      const int at = !valid ? 0 : (i < j ? row_run[r] + j : run_start(j, n) + i);
      copy4(ds + 4 * (lane * kPitch + r), dc + at, valid);
    }
  }
  const uint32_t xs = ds + 4 * kBN * kPitch;
  for (int q = tid; q < kBN * TN; q += kThreads) {
    const int jr = q / TN;
    const int cc = q - jr * TN;
    const bool valid = j0 + jr < n && c0 + cc < k;
    copy4(xs + 4 * q, valid ? x + static_cast<size_t>(j0 + jr) * k + c0 + cc : x, valid);
  }
}

template <int TN>
__global__ void __launch_bounds__(kThreads, min_blocks(TN))
condensed_matvec_kernel(const float* __restrict__ dc, const float* __restrict__ x,
                        const float* __restrict__ row_means, const float* __restrict__ colsum,
                        const float* __restrict__ corr, float* __restrict__ out, int n, int k,
                        int split) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int row_run[kBM];   // run_start of the strip's rows
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int strip = blockIdx.x / split;
  const int part = blockIdx.x - strip * split;   // the block's rank in its cluster
  const int i0 = strip * kBM;
  const int c0 = blockIdx.y * kGroup;
  const int stages = (n + kBN - 1) / kBN;
  const int t0 = part * stages / split;
  const int steps = (part + 1) * stages / split - t0;

  if (threadIdx.x < kBM) {   // kBM <= kThreads
    const int i = i0 + threadIdx.x;
    row_run[threadIdx.x] = i < n ? run_start(i, n) : 0;
  }
  __syncthreads();

  float acc[kRowsPerLane][TN];
#pragma unroll
  for (int t = 0; t < kRowsPerLane; ++t) {
#pragma unroll
    for (int c = 0; c < TN; ++c) acc[t][c] = 0.0f;
  }

  // a ring of kRing stages: one group of copies committed a stage (empty
  // past the sweep), so that waiting for all but kRing - 2 groups means
  // stage u has landed
#pragma unroll
  for (int s = 0; s < kRing - 1; ++s) {
    if (s < steps) {
      issue_stage<TN>(smem + s * stage_floats(TN), row_run, dc, x, n, k, c0, i0, (t0 + s) * kBN);
    }
    commit_copies();
  }
  for (int u = 0; u < steps; ++u) {
    wait_copies<kRing - 2>();
    __syncthreads();   // stage u seen by all; stage u - 1's slot free again
    const int next = u + kRing - 1;
    if (next < steps) {
      issue_stage<TN>(smem + (next % kRing) * stage_floats(TN), row_run, dc, x, n, k, c0, i0,
                      (t0 + next) * kBN);
    }
    commit_copies();
    const float* ds = smem + (u % kRing) * stage_floats(TN);
    const float* xs = ds + kBN * kPitch;
#pragma unroll
    for (int q = 0; q < kColsPerWarp; ++q) {
      const int c = warp + kWarps * q;
      float e[kRowsPerLane];
#pragma unroll
      for (int t = 0; t < kRowsPerLane; ++t) {
        const float v = ds[c * kPitch + lane + 32 * t];
        e[t] = __fmul_rn(v, v);
      }
      const float4* xr = reinterpret_cast<const float4*>(xs + c * TN);
#pragma unroll
      for (int g = 0; g < TN / 4; ++g) {
        const float4 xv = xr[g];
#pragma unroll
        for (int t = 0; t < kRowsPerLane; ++t) {
          acc[t][4 * g] = __fmaf_rn(e[t], xv.x, acc[t][4 * g]);
          acc[t][4 * g + 1] = __fmaf_rn(e[t], xv.y, acc[t][4 * g + 1]);
          acc[t][4 * g + 2] = __fmaf_rn(e[t], xv.z, acc[t][4 * g + 2]);
          acc[t][4 * g + 3] = __fmaf_rn(e[t], xv.w, acc[t][4 * g + 3]);
        }
      }
    }
  }
  wait_copies<0>();
  __syncthreads();   // the ring is idle: its bytes hold the sums below

  // the warps' sums in a fixed tree: warps h .. 2h - 1 store into slots
  // 0 .. h - 1, warps 0 .. h - 1 add them, for h = 4, 2, 1. Slot s holds
  // entry (t, c) of lane l at (t TN + c) 32 + l.
  float* slots = smem;
#pragma unroll
  for (int half = kWarps / 2; half >= 1; half /= 2) {
    if (warp >= half && warp < 2 * half) {
      float* slot = slots + (warp - half) * kBM * TN;
#pragma unroll
      for (int t = 0; t < kRowsPerLane; ++t) {
#pragma unroll
        for (int c = 0; c < TN; ++c) slot[(t * TN + c) * 32 + lane] = acc[t][c];
      }
    }
    __syncthreads();
    if (warp < half) {
      const float* slot = slots + warp * kBM * TN;
#pragma unroll
      for (int t = 0; t < kRowsPerLane; ++t) {
#pragma unroll
        for (int c = 0; c < TN; ++c) {
          acc[t][c] = __fadd_rn(acc[t][c], slot[(t * TN + c) * 32 + lane]);
        }
      }
    }
    __syncthreads();
  }

  if (split > 1) {
    // the cluster's sum in rank order: rank q > 0's warp 0 stores its sums
    // into slot q - 1 of rank 0's shared memory, which rank 0 adds in order
    cg::cluster_group cluster = cg::this_cluster();
    const int rank = static_cast<int>(cluster.block_rank());
    cluster_sync();   // every rank's tree is done: rank 0's slots are free
    if (rank > 0 && warp == 0) {
      float* dst = cluster.map_shared_rank(slots, 0) + (rank - 1) * kBM * TN;
#pragma unroll
      for (int t = 0; t < kRowsPerLane; ++t) {
#pragma unroll
        for (int c = 0; c < TN; ++c) dst[(t * TN + c) * 32 + lane] = acc[t][c];
      }
    }
    cluster_sync();   // every slot written; rank 0 alone goes on
    if (rank > 0) return;
    if (warp == 0) {
      for (int q = 1; q < split; ++q) {
        const float* src = slots + (q - 1) * kBM * TN;
#pragma unroll
        for (int t = 0; t < kRowsPerLane; ++t) {
#pragma unroll
          for (int c = 0; c < TN; ++c) {
            acc[t][c] = __fadd_rn(acc[t][c], src[(t * TN + c) * 32 + lane]);
          }
        }
      }
    }
  }
  if (warp != 0) return;

#pragma unroll
  for (int t = 0; t < kRowsPerLane; ++t) {
    const int row = i0 + lane + 32 * t;
    if (row >= n) continue;
    const float rm = row_means[row];
    float* dst = out + static_cast<size_t>(row) * k + c0;
#pragma unroll
    for (int c = 0; c < TN; ++c) {
      if (c0 + c < k) {
        dst[c] = __fadd_rn(__fmul_rn(-0.5f, acc[t][c]),
                           __fsub_rn(corr[c0 + c], __fmul_rn(rm, colsum[c0 + c])));
      }
    }
  }
}

// A launch of a (blocks, groups) grid of kThreads in clusters of `split`
// along x, with `smem` bytes of dynamic shared memory a block; `attribute`,
// which holds the cluster's shape, must outlive the config.
cudaLaunchConfig_t cluster_config(int blocks, int groups, int split, int smem,
                                  cudaStream_t stream, cudaLaunchAttribute* attribute) {
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(static_cast<unsigned>(blocks), static_cast<unsigned>(groups));
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = static_cast<size_t>(smem);
  config.stream = stream;
  attribute->id = cudaLaunchAttributeClusterDimension;
  attribute->val.clusterDim.x = split;
  attribute->val.clusterDim.y = 1;
  attribute->val.clusterDim.z = 1;
  config.attrs = attribute;
  config.numAttrs = 1;
  return config;
}

template <int TN>
int launch(const float* dc, const float* x, const float* rm, const float* colsum,
           const float* corr, float* out, int n, int k, int split, cudaStream_t stream) {
  const auto kernel = condensed_matvec_kernel<TN>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes(TN));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int strips = (n + kBM - 1) / kBM;
  const int groups = (k + kGroup - 1) / kGroup;
  cudaLaunchAttribute attribute = {};
  const cudaLaunchConfig_t config =
      cluster_config(strips * split, groups, split, smem_bytes(TN), stream, &attribute);
  err = cudaLaunchKernelEx(&config, kernel, dc, x, rm, colsum, corr, out, n, k, split);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// Clusters of `split` blocks of the width-TN kernel that the card holds at
// once.
template <int TN>
int resident_clusters(int split, int* clusters) {
  const auto kernel = condensed_matvec_kernel<TN>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes(TN));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attribute = {};
  const cudaLaunchConfig_t config =
      cluster_config(split, 1, split, smem_bytes(TN), nullptr, &attribute);
  return static_cast<int>(cudaOccupancyMaxActiveClusters(clusters, kernel, &config));
}

// fn(std::integral_constant<int, TN>) for the width k columns take: k
// rounded up to 4 up to 32, and 32 (with ceil(k / 32) groups) above.
template <typename Fn>
int by_width(int k, Fn&& fn) {
  switch (k <= kGroup ? (k + 3) / 4 : kGroup / 4) {
    case 1: return fn(std::integral_constant<int, 4>{});
    case 2: return fn(std::integral_constant<int, 8>{});
    case 3: return fn(std::integral_constant<int, 12>{});
    case 4: return fn(std::integral_constant<int, 16>{});
    case 5: return fn(std::integral_constant<int, 20>{});
    case 6: return fn(std::integral_constant<int, 24>{});
    case 7: return fn(std::integral_constant<int, 28>{});
    default: return fn(std::integral_constant<int, 32>{});
  }
}

bool valid_split(int split) { return split == 1 || split == 2 || split == kMaxSplit; }

}  // namespace

// dc: (n(n-1)/2,) condensed distances, x: (n, k), row_means: (n,),
// colsum/corr: (k,), out: (n, k); all fp32, contiguous, on the device.
// 2 <= n <= 46340, 1 <= k <= 128; each strip of 64 rows is swept by a
// cluster of `split` blocks (1, 2 or 4), at most the ceil(n / 32) stages.
REPRO_EXPORT int repro_condensed_matvec(const float* dc, const float* x, const float* row_means,
                                        const float* colsum, const float* corr, float* out,
                                        int n, int k, int split, cudaStream_t stream) {
  if (n < 2 || n > kMaxN || k < 1 || k > 4 * kGroup || !valid_split(split) ||
      split > (n + kBN - 1) / kBN) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return by_width(k, [&](auto tn) {
    return launch<decltype(tn)::value>(dc, x, row_means, colsum, corr, out, n, k, split, stream);
  });
}

// The clusters of `split` blocks that the card holds at once for a launch of
// k columns (cudaOccupancyMaxActiveClusters), into *clusters.
REPRO_EXPORT int repro_condensed_matvec_clusters(int k, int split, int* clusters) {
  if (k < 1 || k > 4 * kGroup || !valid_split(split)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return by_width(k, [&](auto tn) { return resident_clusters<decltype(tn)::value>(split, clusters); });
}
