// Batched permuted gather-reduce over condensed storage, the Mantel null
// loop:
//
//   out[s, b] = sum_{i<j} ys[s, tri(i, j)] * xc[tri(o_b[i], o_b[j])]
//   tri(p, q) = lo (2n - lo - 1) / 2 + (hi - lo - 1),  lo = min, hi = max
//
// Replaces: src/repro/kernels/permute_reduce.py::permute_reduce_kernel
// (_permute_reduce_kernel).
//
// Bound on an H100: bytes. Read once, the inputs are xc and S rows of ys
// (4 m bytes each) plus the B order rows: 4 m (1 + S) + 4 B n bytes, 1.07 GB
// at n = 16384, S = 1, B = 32, 0.32 ms. No design reaches it: some operand
// must be passed over once per permutation. The Pallas kernel keeps xc in
// VMEM and gathers it at random per permutation; on the card those gathers
// come from device memory in 32-byte sectors for 4 useful bytes, 137 GB a
// tile at n = 16384, which held the first port of this kernel at 90 ms.
//
// Design: row-stationary. Write pi_b for the inverse of o_b. Every pair
// i < j is counted once from the side of x's row r = o_b[i]:
//
//   out[s, b] = sum_r sum_{j > pi_b(r)} ys[s, tri(pi_b(r), j)] * x[r, o_b[j]].
//
// A block holds row r of x (the square's row, 4 n bytes of shared memory:
// 64 KB at n = 16384, 185 KB at n = 46340) for all B permutations. The row's
// run, xc[tri(r, r+1) .. tri(r, n-1)], is staged with 16-byte loads after a
// scalar head; its column part, xc[tri(q, r)] for q < r, with scalar loads
// down the triangle, once a tile and not once a permutation (blocks stride
// over the rows in order, so the blocks of neighbouring rows, which read the
// neighbouring floats, run together and share the sectors in L2). Then, with
// no barrier between permutations, for each b the block streams the run of ys
// row i = pi_b(r) and the slice of order row b past i, both contiguous, and
// gathers x_row[o_b[j]] from shared memory. So each permutation passes over
// ys once, coalesced: 4 m (B S + 1) + 8 n B bytes a tile from device memory,
// 17.7 GB, 5.3 ms at n = 16384, S = 1, B = 32, this design's floor. The
// order rows (2 MB as 16-bit values, from csrc/inverse_orders.cu) come from
// L2. The ii/jj triangle maps of the Pallas kernel are not read at all.
//
// The runs are short (n / 2 on average, 16 steps of 512 threads at
// n = 16384), so a thread walks 2 / S permutations' runs together, from the
// earlier start, each run masked until it begins. Thread t takes the
// positions j = t (mod 512), in increasing j, whatever that start: a
// thread's share of a run, and so the fp64 grouping of its sum, must not
// depend on the partner's start, or a row's sums would depend on the other
// rows of its tile. At S = 2 a thread issues the loads of 4
// steps before it multiplies (8 loads of ys and 4 of the orders in flight);
// at S = 1 one step (2 and 2), which measured faster there with this
// assignment. Two blocks of 512 threads fit an SM (64 registers a thread,
// 64 KB of shared memory a block at n = 16384).
//
// Index arithmetic is int32, exact for n <= 46340 (the wrapper refuses
// larger n). Products and sums are fp64: an fp32 product rounds each of the
// m terms, which alone puts a sum that cancels to a small value past the
// reference's atol of 1e-5 at n = 1000. Each thread sums its share of a (r, b) run,
// a warp butterfly sums the lanes, and each warp keeps its running (s, b)
// sums across its rows in registers (lane o % 32, slot o / 32, for output
// o = s B + b). At the end the block sums its warps in a fixed order and
// writes one partial per (block, s, b); a second kernel sums the blocks in a
// fixed order. No float atomics: two launches give the same bits.
#include "common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxOutputs = 128;   // S * B a launch: four slots a lane
constexpr int kSlots = kMaxOutputs / 32;
constexpr int kWalked = 2;         // S * (permutations walked together)
constexpr int kFinishThreads = 256;

// tri(i, i + 1): where row i's run starts in xc. int32-exact for n <= 46340.
__device__ __forceinline__ int run_start(int i, int two_n_1) { return i * (two_n_1 - i) / 2; }

template <int S>
__global__ void __launch_bounds__(kThreads, 2)
partials_kernel(const float* __restrict__ xc, const float* __restrict__ ys, long long ys_stride,
                const int* __restrict__ inv, const unsigned short* __restrict__ orders,
                double* __restrict__ partials, int n, int num_perms) {
  constexpr int G = kWalked / S;   // permutations walked together
  constexpr int kSteps = S == 1 ? 1 : 4;   // steps of the walk whose loads go out together
  extern __shared__ __align__(16) unsigned char smem[];
  float* x_row = reinterpret_cast<float*>(smem);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int two_n_1 = 2 * n - 1;
  const int outputs = S * num_perms;

  double acc[kSlots];
#pragma unroll
  for (int k = 0; k < kSlots; ++k) acc[k] = 0.0;

  for (int r = blockIdx.x; r < n; r += gridDim.x) {
    __syncthreads();   // the previous row's reads of x_row are done
    repro::stage_run(x_row + r + 1, xc + run_start(r, two_n_1), n - 1 - r, threadIdx.x,
                     kThreads);
    for (int q = threadIdx.x; q < r; q += kThreads) {
      x_row[q] = __ldg(xc + run_start(q, two_n_1) + (r - q - 1));
    }
    if (threadIdx.x == 0) x_row[r] = 0.0f;   // never read: o_b[j] != r for j != i
    __syncthreads();

    for (int b0 = 0; b0 < num_perms; b0 += G) {
      // G runs at once, so that G S loads a thread are in flight together:
      // run g covers j > i_g = pi_b(r); thread t walks the positions
      // j = t (mod kThreads) from the earliest run's start, each run masked
      // until it begins (a masked lane adds an exact 0)
      int begin[G], off[G], order_row[G];
      int first = n;
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const int b = b0 + g;
        begin[g] = n;
        off[g] = 0;
        order_row[g] = 0;
        if (b < num_perms) {
          order_row[g] = b * n;   // < 128 * 46340
          const int i = __ldg(inv + order_row[g] + r);
          begin[g] = i + 1;
          off[g] = run_start(i, two_n_1) - i - 1;   // ys index of pair (i, j): off + j
        }
        first = min(first, begin[g]);
      }
      double sums[S * G];
#pragma unroll
      for (int k = 0; k < S * G; ++k) sums[k] = 0.0;
      // kSteps steps of the walk at a time: every load of them is issued
      // before the first product; a masked lane loads nothing and adds an
      // exact 0
      int start = (first & ~(kThreads - 1)) + threadIdx.x;
      if (start < first) start += kThreads;
      for (int j0 = start; j0 < n; j0 += kSteps * kThreads) {
        bool live[kSteps][G];
        unsigned short o[kSteps][G];
        float y[kSteps][S][G];
#pragma unroll
        for (int u = 0; u < kSteps; ++u) {
          const int j = j0 + u * kThreads;
#pragma unroll
          for (int g = 0; g < G; ++g) {
            live[u][g] = j < n && j >= begin[g];
            o[u][g] = live[u][g] ? __ldg(orders + order_row[g] + j) : 0;
#pragma unroll
            for (int s = 0; s < S; ++s) {
              y[u][s][g] = live[u][g] ? __ldg(ys + s * ys_stride + off[g] + j) : 0.0f;
            }
          }
        }
#pragma unroll
        for (int u = 0; u < kSteps; ++u) {
#pragma unroll
          for (int g = 0; g < G; ++g) {
            const float xf = x_row[o[u][g]];
            const double xv = live[u][g] ? static_cast<double>(xf) : 0.0;
#pragma unroll
            for (int s = 0; s < S; ++s) {
              sums[s * G + g] = fma(static_cast<double>(y[u][s][g]), xv, sums[s * G + g]);
            }
          }
        }
      }
      repro::warp_allsum_each(sums);
#pragma unroll
      for (int s = 0; s < S; ++s) {
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const int o = s * num_perms + b0 + g;
#pragma unroll
          for (int k = 0; k < kSlots; ++k) {
            if (b0 + g < num_perms && k == (o >> 5) && lane == (o & 31)) acc[k] += sums[s * G + g];
          }
        }
      }
    }
  }

  // the block's sums: each warp's slots through shared memory, then summed
  // over the warps in a fixed order
  __syncthreads();
  double* red = reinterpret_cast<double*>(smem);
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    const int o = k * 32 + lane;
    if (o < outputs) red[warp * outputs + o] = acc[k];
  }
  __syncthreads();
  for (int o = threadIdx.x; o < outputs; o += kThreads) {
    double total = 0.0;
    for (int w = 0; w < kWarps; ++w) total += red[w * outputs + o];
    partials[static_cast<long long>(blockIdx.x) * outputs + o] = total;
  }
}

// out[o] = sum over blocks of partials[block][o], o = s * B + b, in a fixed
// order: a warp an output.
__global__ void __launch_bounds__(kFinishThreads)
finish_kernel(const double* __restrict__ partials, float* __restrict__ out, int num_chunks,
              int outputs) {
  repro::sum_rows(partials, out, num_chunks, outputs, kFinishThreads / 32);
}

size_t shared_bytes(int n, int outputs) {
  const size_t row = static_cast<size_t>(n) * sizeof(float);
  const size_t red = static_cast<size_t>(kWarps) * outputs * sizeof(double);
  return row > red ? row : red;
}

template <int S>
int grid_for(int n, int num_perms, int* grid) {
  return static_cast<int>(repro::resident_grid(partials_kernel<S>, kThreads,
                                               shared_bytes(n, S * num_perms), n, grid));
}

template <int S>
int launch_partials(const float* xc, const float* ys, long long ys_stride, const int* inv,
                    const unsigned short* orders, double* partials, int n, int num_perms,
                    int grid, cudaStream_t stream) {
  const size_t smem = shared_bytes(n, S * num_perms);
  const cudaError_t err = cudaFuncSetAttribute(
      partials_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  partials_kernel<S><<<grid, kThreads, smem, stream>>>(xc, ys, ys_stride, inv, orders, partials,
                                                       n, num_perms);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The blocks one partials launch runs (and the partials it writes): as many
// as the card holds at once, at most n. 1 <= rows <= 2, rows * B <= 128.
REPRO_EXPORT int repro_permute_reduce_grid(int n, int rows, int num_perms, int* grid) {
  if (rows * num_perms > kMaxOutputs) return static_cast<int>(cudaErrorInvalidValue);
  switch (rows) {
    case 1: return grid_for<1>(n, num_perms, grid);
    case 2: return grid_for<2>(n, num_perms, grid);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// xc: (m,) fp32; ys: S rows of m fp32 at row stride ys_stride; inv: (B, n)
// int32 inverse orders; orders: (B, n) 16-bit orders; partials: (grid, S, B)
// fp64 scratch, grid from repro_permute_reduce_grid. 2 <= n <= 46340.
REPRO_EXPORT int repro_permute_reduce_partials(const float* xc, const float* ys,
                                               long long ys_stride, const int* inv,
                                               const unsigned short* orders, double* partials,
                                               int n, int rows, int num_perms, int grid,
                                               cudaStream_t stream) {
  if (grid <= 0 || num_perms <= 0) return static_cast<int>(cudaGetLastError());
  if (rows * num_perms > kMaxOutputs) return static_cast<int>(cudaErrorInvalidValue);
  switch (rows) {
    case 1: return launch_partials<1>(xc, ys, ys_stride, inv, orders, partials, n, num_perms,
                                      grid, stream);
    case 2: return launch_partials<2>(xc, ys, ys_stride, inv, orders, partials, n, num_perms,
                                      grid, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// partials: (num_chunks, outputs) fp64; out: (outputs,) fp32.
REPRO_EXPORT int repro_permute_reduce_finish(const double* partials, float* out, int num_chunks,
                                             int outputs, cudaStream_t stream) {
  if (outputs > 0) {
    const int warps = kFinishThreads / 32;
    finish_kernel<<<(outputs + warps - 1) / warps, kFinishThreads, 0, stream>>>(
        partials, out, num_chunks, outputs);
  }
  return static_cast<int>(cudaGetLastError());
}
