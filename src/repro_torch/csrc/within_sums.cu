// Within-group rank sums of permuted groupings, ANOSIM's null loop:
//
//   out[b] = sum_{i<j} ranks[tri(i, j)] * [codes[o_b[i]] == codes[o_b[j]]]
//   tri(p, q) = p (2n - p - 1) / 2 + (q - p - 1),  p < q
//
// Replaces no Pallas kernel. The reference runs ANOSIM's tiles through
// permute_reduce (src/repro/kernels/permute_reduce.py), gathering an m-long
// within-group indicator at each permutation's pairs; the port's
// permute_reduce (csrc/permute_reduce.cu) did the same, passing the whole
// rank vector once per permutation: 4 m (B + 1) + 8 n B bytes a tile, 17.7 GB
// at n = 16384, B = 32. The indicator is a function of n group codes, so
// this kernel compares a tile's B x n permuted codes instead and reads the
// ranks once a tile.
//
// Bound on an H100: bytes, by the data sheet. A tile reads the m fp32 ranks
// once (4 m bytes, 537 MB at n = 16384: 0.16 ms) and performs a compare and
// an add a pair and permutation, 2 m B operations (8.6e9 at B = 32), 0.13 ms
// at the card's 67 TFLOP/s for fp32 outside the tensor cores. In practice
// the issue of the compares, selects and integer adds (about three
// instructions a pair and permutation) bounds it.
//
// Design: the pairs (i, j), i < j, are cut into 128 x 128 tiles of the upper
// triangle (row tile a <= column tile c; on a diagonal tile only j > i
// counts). A persistent block walks the tiles in row-major order, striding
// by the grid. For each tile it stages in shared memory the tile's ranks,
// each doubled to an exact integer (the ranks are half-integers: see
// stats/anosim.py), read row by row from their condensed runs with
// coalesced loads, and for each slab of 32 permutations the permuted codes
// of the tile's rows and of its columns, codes[o_b[p]], gathered from the
// 16-bit orders and the n codes (both from L2). Lane l of every warp
// answers for permutation 32 s + l: it holds the codes of 4 rows in
// registers and walks the tile's columns 4 at a time, reading the 4
// columns' codes of its permutation (16 bytes, conflict-free at a row
// stride of 132 words) and each row's 4 doubled ranks (16 bytes, the same
// address in every lane: a broadcast). A matching pair adds its doubled
// rank.
//
// Sums are exact and so independent of their order: 2 rank is an integer
// below 2^31, so two terms sum exactly in 32 bits, and a lane adds each such
// pair into a 64-bit sum. The
// block sums its warps, writes one partial a (block, permutation), and a
// second kernel sums the blocks and halves the total in fp64 and rounds it
// to fp32 once: two launches give the same bits, a permutation's sum does
// not depend on its tile-mates, and the plain version (kernels/
// within_sums_ref.py) gives the same bits too. No atomics.
//
// Index arithmetic is 64-bit where it forms a condensed index; n <= 46340
// (the wrapper refuses larger n), so the 16-bit orders hold every value.
#include "common.cuh"

namespace {

constexpr int kTile = 128;                 // rows and columns of a triangle tile
constexpr int kLanes = 32;                 // permutations a slab: a lane each
constexpr int kMaxPerms = 128;             // permutations a launch: four slabs
constexpr int kSlabs = kMaxPerms / kLanes;
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 4;                   // tile rows a lane walks together
constexpr int kCodeStride = kTile + 4;     // words between two lanes' codes
constexpr int kFinishThreads = 256;

constexpr size_t kRankBytes = sizeof(unsigned) * kTile * kTile;
constexpr size_t kCodeBytes = sizeof(int) * kLanes * kCodeStride;
constexpr size_t kSharedBytes = kRankBytes + 2 * kCodeBytes;
static_assert(kWarps * kMaxPerms * sizeof(unsigned long long) <= kSharedBytes,
              "the block's sums reuse the staging buffers");

// Tiles of the upper triangle, row tiles a <= column tiles c.
__host__ __device__ __forceinline__ int tile_count(int n) {
  const int nt = (n + kTile - 1) / kTile;
  return nt * (nt + 1) / 2;
}

// Move (a, off), the tile at offset `off` of row tile a (column tile a + off),
// forward until off lies within row a; a == nt when the walk is done.
__device__ __forceinline__ void settle(int nt, int& a, int& off) {
  while (a < nt && off >= nt - a) {
    off -= nt - a;
    ++a;
  }
}

__global__ void __launch_bounds__(kThreads, 2)
partials_kernel(const float* __restrict__ ranks, const int* __restrict__ codes,
                const unsigned short* __restrict__ orders,
                unsigned long long* __restrict__ partials, int n, int num_perms) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned* rank2 = reinterpret_cast<unsigned*>(smem);
  int* row_codes = reinterpret_cast<int*>(smem + kRankBytes);
  int* col_codes = reinterpret_cast<int*>(smem + kRankBytes + kCodeBytes);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nt = (n + kTile - 1) / kTile;
  const int slabs = (num_perms + kLanes - 1) / kLanes;

  unsigned long long acc[kSlabs];
#pragma unroll
  for (int k = 0; k < kSlabs; ++k) acc[k] = 0ull;

  int a = 0, off = blockIdx.x;
  settle(nt, a, off);
  for (; a < nt; off += gridDim.x, settle(nt, a, off)) {
    const int i0 = a * kTile;
    const int j0 = (a + off) * kTile;
    __syncthreads();   // the previous tile's reads of the staging buffers are done
    // the tile's doubled ranks: warp w stages rows w + 16 h, lane l the
    // columns l + 32 u, each half of a thread's 32 loads issued before the
    // first is stored; pairs outside the triangle or past n stage 0
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      constexpr int kHalf = kTile / kWarps / 2;   // rows a warp stages a half
      float v[kHalf][kTile / 32];
#pragma unroll
      for (int h = 0; h < kHalf; ++h) {
        const long long i = i0 + warp + kWarps * (kHalf * half + h);
        const long long base = i * (2LL * n - i - 1) / 2 - i - 1;   // tri(i, j) = base + j
#pragma unroll
        for (int u = 0; u < kTile / 32; ++u) {
          const int j = j0 + lane + 32 * u;
          v[h][u] = (i < n && j < n && j > i) ? __ldg(ranks + base + j) : 0.0f;
        }
      }
#pragma unroll
      for (int h = 0; h < kHalf; ++h) {
        const int r = warp + kWarps * (kHalf * half + h);
#pragma unroll
        for (int u = 0; u < kTile / 32; ++u) {
          rank2[r * kTile + lane + 32 * u] = __float2uint_rn(2.0f * v[h][u]);
        }
      }
    }
    for (int s = 0; s < slabs; ++s) {
      if (s > 0) __syncthreads();   // the previous slab's reads of the codes are done
      // the slab's permuted codes of the tile's rows (side 0) and columns
      // (side 1): thread t stages position q = t mod 128 of 16 (side, lane)
      // rows, all 16 order loads issued, then all 16 code loads
      constexpr int kStaged = 2 * kLanes * kTile / kThreads;
      const int qs = threadIdx.x % kTile;
      int code[kStaged];
#pragma unroll
      for (int k = 0; k < kStaged; ++k) {
        const int e = threadIdx.x + kThreads * k;
        const int b = s * kLanes + (e / kTile) % kLanes;
        const int p = (e < kLanes * kTile ? i0 : j0) + qs;
        code[k] = (b < num_perms && p < n)
                      ? static_cast<int>(__ldg(orders + static_cast<long long>(b) * n + p))
                      : -1;
      }
#pragma unroll
      for (int k = 0; k < kStaged; ++k) code[k] = code[k] >= 0 ? __ldg(codes + code[k]) : 0;
#pragma unroll
      for (int k = 0; k < kStaged; ++k) {
        const int e = threadIdx.x + kThreads * k;
        (e < kLanes * kTile ? row_codes : col_codes)[((e / kTile) % kLanes) * kCodeStride + qs] =
            code[k];
      }
      __syncthreads();

      unsigned long long sum = 0ull;
      const int* cc = col_codes + lane * kCodeStride;
      for (int g = warp; g < kTile / kRows; g += kWarps) {
        const int r0 = g * kRows;
        const int4 ci = *reinterpret_cast<const int4*>(row_codes + lane * kCodeStride + r0);
        const int c_row[kRows] = {ci.x, ci.y, ci.z, ci.w};
        const unsigned* rk = rank2 + r0 * kTile;
#pragma unroll 4
        for (int q = 0; q < kTile; q += 4) {
          const int4 cj = *reinterpret_cast<const int4*>(cc + q);
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            const uint4 rv = *reinterpret_cast<const uint4*>(rk + r * kTile + q);
            // each term is below 2^31: a pair sums exactly in 32 bits
            sum += (c_row[r] == cj.x ? rv.x : 0u) + (c_row[r] == cj.y ? rv.y : 0u);
            sum += (c_row[r] == cj.z ? rv.z : 0u) + (c_row[r] == cj.w ? rv.w : 0u);
          }
        }
      }
#pragma unroll
      for (int k = 0; k < kSlabs; ++k) {
        if (k == s) acc[k] += sum;
      }
    }
  }

  // the block's sums: each warp's through shared memory, then over the warps
  __syncthreads();
  unsigned long long* red = reinterpret_cast<unsigned long long*>(smem);
#pragma unroll
  for (int k = 0; k < kSlabs; ++k) {
    const int b = k * kLanes + lane;
    if (b < num_perms) red[warp * num_perms + b] = acc[k];
  }
  __syncthreads();
  for (int b = threadIdx.x; b < num_perms; b += kThreads) {
    unsigned long long total = 0ull;
    for (int w = 0; w < kWarps; ++w) total += red[w * num_perms + b];
    partials[static_cast<long long>(blockIdx.x) * num_perms + b] = total;
  }
}

// out[b] = (sum over blocks of partials[block][b]) / 2, rounded once to fp32:
// a warp a permutation.
__global__ void __launch_bounds__(kFinishThreads)
finish_kernel(const unsigned long long* __restrict__ partials, float* __restrict__ out,
              int num_chunks, int num_perms) {
  const int b = blockIdx.x * (kFinishThreads / 32) + (threadIdx.x >> 5);
  if (b >= num_perms) return;
  const int lane = threadIdx.x & 31;
  unsigned long long v = 0ull;
  for (int k = lane; k < num_chunks; k += 32) v += partials[static_cast<long long>(k) * num_perms + b];
  v = repro::warp_sum(v);
  if (lane == 0) out[b] = __double2float_rn(0.5 * __ull2double_rn(v));
}

}  // namespace

// The blocks one partials launch runs (and the partials it writes): as many
// as the card holds at once, at most the tiles of the triangle.
REPRO_EXPORT int repro_within_sums_grid(int n, int* grid) {
  return static_cast<int>(
      repro::resident_grid(partials_kernel, kThreads, kSharedBytes, tile_count(n), grid));
}

// ranks: (m,) fp32 half-integers; codes: (n,) int32; orders: (B, n) 16-bit
// permutations; partials: (grid, B) 64-bit scratch, grid from
// repro_within_sums_grid. 2 <= n <= 46340, 1 <= B <= 128.
REPRO_EXPORT int repro_within_sums_partials(const float* ranks, const int* codes,
                                            const unsigned short* orders,
                                            unsigned long long* partials, int n, int num_perms,
                                            int grid, cudaStream_t stream) {
  if (grid <= 0 || num_perms <= 0) return static_cast<int>(cudaGetLastError());
  if (num_perms > kMaxPerms) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaFuncSetAttribute(
      partials_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kSharedBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  partials_kernel<<<grid, kThreads, kSharedBytes, stream>>>(ranks, codes, orders, partials, n,
                                                            num_perms);
  return static_cast<int>(cudaGetLastError());
}

// partials: (num_chunks, B) 64-bit; out: (B,) fp32.
REPRO_EXPORT int repro_within_sums_finish(const unsigned long long* partials, float* out,
                                          int num_chunks, int num_perms, cudaStream_t stream) {
  if (num_perms > 0) {
    const int warps = kFinishThreads / 32;
    finish_kernel<<<(num_perms + warps - 1) / warps, kFinishThreads, 0, stream>>>(
        partials, out, num_chunks, num_perms);
  }
  return static_cast<int>(cudaGetLastError());
}
