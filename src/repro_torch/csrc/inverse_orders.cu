// Inverse permutation orders of one tile, and their uint16 copy:
//
//   inv[b, orders[b, i]] = i,   orders16[b, i] = orders[b, i],
//   is_perm[b] = 1 iff row b of orders is a permutation of 0..n-1.
//
// No Pallas kernel of the reference is replaced: the row-stationary
// permute_reduce and mantel_corr kernels (csrc/permute_reduce.cu,
// csrc/mantel_corr.cu) walk the pairs of a permutation from the side of the
// permuted operand, so they need the inverse order, which the TPU kernels
// never formed. A row that is not a permutation would make them read out of
// range or sum a silently wrong value; the old gather kernels needed no such
// guard, so this kernel also decides whether each row is a permutation, and
// the wrapper refuses the tile when one is not.
//
// Bound on an H100: bytes, 10 n a row (orders read, inv and orders16
// written once): 5.2 MB at n = 16384, B = 32, 1.6 us. The kernel moves
// 18 n a row (inv is also set to -1 and read back). One block a row: inv is set to -1, the row scattered into it, and every
// slot checked. n values fill n slots each at least once only if no value
// repeats, so a slot left at -1, or a value out of range, marks the row.
// Each block reads back only what it wrote, which __syncthreads makes
// visible within the block. The uint16 copy halves the order stream that the
// two kernels read once per permutation (n <= 65535; the wrappers cap n
// lower).
#include "common.cuh"

namespace {

constexpr int kThreads = 1024;

__global__ void __launch_bounds__(kThreads)
inverse_kernel(const int* __restrict__ orders, int* inv, unsigned short* __restrict__ orders16,
               int* __restrict__ is_perm, int n) {
  const long long row = static_cast<long long>(blockIdx.x) * n;
  for (int v = threadIdx.x; v < n; v += kThreads) inv[row + v] = -1;
  __syncthreads();
  int bad = 0;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int v = __ldg(orders + row + i);
    if (v < 0 || v >= n) {
      bad = 1;
    } else {
      inv[row + v] = i;
    }
    orders16[row + i] = static_cast<unsigned short>(v);
  }
  __syncthreads();
  for (int v = threadIdx.x; v < n; v += kThreads) bad |= inv[row + v] < 0;
  bad = __syncthreads_or(bad);
  if (threadIdx.x == 0) is_perm[blockIdx.x] = !bad;
}

}  // namespace

// orders: (B, n) int32; inv: (B, n) int32; orders16: (B, n) 16-bit;
// is_perm: (B,) int32. 1 <= n <= 65535.
REPRO_EXPORT int repro_inverse_orders(const int* orders, int* inv, unsigned short* orders16,
                                      int* is_perm, int n, int num_perms, cudaStream_t stream) {
  if (n > 0 && num_perms > 0) {
    inverse_kernel<<<num_perms, kThreads, 0, stream>>>(orders, inv, orders16, is_perm, n);
  }
  return static_cast<int>(cudaGetLastError());
}
