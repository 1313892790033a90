// Fused symmetric + hollow validation of a square fp32 matrix.
//
// Replaces: src/repro/kernels/symhollow.py::symhollow (_symhollow_kernel),
// the tiled form of the fused pass src/repro/core/validation.py:55-61
// (is_sym = all(mat == mat.T), is_hollow = all(diag(mat) == 0)).
//
// Bound on an H100: bytes. Every element is read once and compared once;
// at n = 16384 that is 1.07 GB, 0.32 ms at 3.35 TB/s. There is no
// arithmetic to speak of.
//
// Design: the Pallas kernel walks every (i, j) tile in grid order and
// min-accumulates two flags across grid steps, which relies on the TPU
// running its grid in order. Here a block owns one unordered tile pair:
// block (bi, bj) with bi <= bj stages the partner tile (bj, bi) in shared
// memory (padded pitch, so the transposed read is free of bank conflicts),
// reads its own tile (bi, bj) straight from global memory and compares each
// element with the partner's transpose; blocks with bi > bj exit at once,
// so each off-diagonal element is read exactly once. A diagonal tile is its
// own partner and also checks its diagonal. The ragged edge is masked, so
// no zero-padded copy of the matrix is made. Violations clear the two int32
// flags with atomicAnd, which is order-independent: the result is the same
// whatever order the blocks run in.
//
// NaN semantics are those of `a == b.T`: NaN compares unequal to
// everything, so a NaN anywhere (even on the diagonal) reads as not
// symmetric, and a NaN on the diagonal as not hollow. -0.0 == 0 holds, so a
// negative-zero diagonal counts as hollow.
#include "common.cuh"

namespace {

constexpr int kTile = 32;      // tile edge; one warp spans a tile row
constexpr int kRows = 8;       // warps per block; each covers kTile / kRows rows

__global__ void __launch_bounds__(kTile * kRows)
symhollow_kernel(const float* __restrict__ mat, int n, int* __restrict__ flags) {
  const int bi = blockIdx.y;
  const int bj = blockIdx.x;
  if (bi > bj) return;  // the pair was handled by block (bj, bi)

  __shared__ float partner[kTile][kTile + 1];
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;

  // partner[r][c] = mat[bj*T + r][bi*T + c]
  for (int r = ty; r < kTile; r += kRows) {
    const int row = bj * kTile + r;
    const int col = bi * kTile + tx;
    if (row < n && col < n) partner[r][tx] = mat[static_cast<size_t>(row) * n + col];
  }
  __syncthreads();

  bool sym = true;
  bool hollow = true;
  for (int r = ty; r < kTile; r += kRows) {
    const int row = bi * kTile + r;
    const int col = bj * kTile + tx;
    if (row < n && col < n) {
      const float a = mat[static_cast<size_t>(row) * n + col];
      // mat[col][row] lives at partner[col - bj*T][row - bi*T] = partner[tx][r]
      sym = sym && (a == partner[tx][r]);
      if (row == col) hollow = hollow && (a == 0.0f);
    }
  }

  const int block_sym = __syncthreads_and(sym);
  const int block_hollow = __syncthreads_and(hollow);
  if (tx == 0 && ty == 0) {
    if (!block_sym) atomicAnd(&flags[0], 0);
    if (!block_hollow) atomicAnd(&flags[1], 0);
  }
}

}  // namespace

// flags: int32[2] on the device, set to 1 by the caller; cleared to 0 here
// when the matrix is not symmetric (flags[0]) or not hollow (flags[1]).
REPRO_EXPORT int repro_symhollow(const float* mat, int n, int* flags, cudaStream_t stream) {
  if (n > 0) {
    const int nb = (n + kTile - 1) / kTile;
    symhollow_kernel<<<dim3(nb, nb), dim3(kTile, kRows), 0, stream>>>(mat, n, flags);
  }
  return static_cast<int>(cudaGetLastError());
}
