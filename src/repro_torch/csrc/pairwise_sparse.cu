// Bray-Curtis row panels summed over each row's nonzeros: the sparse-support
// route of the feature-table production.
//
//   out[r, j] = sum_f |a_f - b_f| / sum_f |a_f + b_f|,   a = x[row0 + r], b = x[j]
//
// for the rows [row0, row0 + bm) of an (n, d) fp32 table against all n of its
// rows, the table given as its compressed copy: row offsets (n + 1), and the
// feature index and value of each nonzero, features ascending within a row.
// (bm, n) fp32 out, the layout of csrc/pairwise.cu's panel; 0 where both sums
// are 0 (two all-zero samples), and exactly 0 on the diagonal j = row0 + r.
//
// Replaces no Pallas kernel. src/repro/kernels/pairwise.py::pairwise_panel is
// dense; its counterpart, csrc/pairwise.cu, stays the route for every other
// metric, for dense tables and for square outputs. This kernel is added for
// count tables that are mostly zeros (a 16S OTU table holds about 1%
// nonzero), where the dense panel spends ~99% of its terms on features that
// neither sample holds.
//
// The arithmetic. For any signs, the zeros of b add nothing to
//   sum_f |a_f - b_f| = A + sum_{f in supp b} (|a_f - b_f| - |a_f|),
//   sum_f |a_f + b_f| = A + sum_{f in supp b} (|a_f + b_f| - |a_f|),   A = sum_f |a_f|.
// Each lane sums over its share of b's nonzeros P = sum |a - v|, Q = sum |a + v|
// and Z = sum |a|, and the pair's two sums are A + (P - Z) and A + (Q - Z). On
// integer counts below 2^24 every partial sum is exact in fp32, so a distance
// is bit for bit the dense kernel's (one rounding, the division). Otherwise
// the sums are rounded in another order than the dense kernel's; a pair whose
// sum |a + b| is 0 only by cancellation (signed values, a = -b) then carries
// that rounding instead of reading 0.
//
// Bound on an H100: the stream of the compressed copy, not the arithmetic. A
// panel row group of R rows reads every nonzero of the table (8 bytes: index
// and value) and the row offsets, from L2 when the copy fits it (2.8M
// nonzeros, 22 MB, at the HMP V3-V5 table's 4743 x 45383 and 1.3% nonzero).
// Each nonzero feeds R pairs through two shared-memory loads and 5 fp32 adds
// a pair. With R = 4 a production streams n / 4 x 22 MB = 26 GB: measured on
// an H100 at 0.338 ms a 256-row panel (64 row groups, 1.4 GB, about 4.1 TB/s
// from L2), 6.4 ms a production, against 0.105 ms a panel for its adds at
// the fp32 instruction rate.
//
// Design. A block holds R rows of the panel (R = 4, 2 or 1, the most whose
// union of nonzeros fits shared memory, chosen by the wrapper) and a chunk of
// the table's rows (the output's columns), as many chunks as fill the card.
// The held rows are kept as a slot table, one 16-bit slot a feature (0: held
// by none of the R rows), and a value vector of R floats a slot; slot 0 is a
// vector of zeros, so a feature no held row has reads zeros without a
// branch. A warp takes a table row b at a time, its lanes striding over b's
// nonzeros four at a time (eight loads in flight a lane): the slot of each
// feature, the slot's R values in one vector load, 5 adds for each held row.
// The lanes' sums are reduced by a fixed butterfly and lane r writes row r's
// distance. Sums run in a fixed order (lane strides, then the butterfly), with
// no float atomics, so two runs give the same bits; the one atomic, which
// numbers the slots as the held rows are inserted, moves no value between
// sums. No TF32 and no tensor cores.
#include "common.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;  // nonzeros a lane loads before it uses them

// Bytes of the slot table for d features: 2 a feature, padded to 16 so that
// the value vectors after it are 16-byte aligned.
__host__ __device__ inline size_t slot_bytes(int d) {
  return (static_cast<size_t>(d) * 2 + 15) / 16 * 16;
}

template <int R>
__device__ __forceinline__ void held_values(const float* held, int s, float (&a)[R]) {
  if constexpr (R == 4) {
    const float4 t = reinterpret_cast<const float4*>(held)[s];
    a[0] = t.x;
    a[1] = t.y;
    a[2] = t.z;
    a[3] = t.w;
  } else if constexpr (R == 2) {
    const float2 t = reinterpret_cast<const float2*>(held)[s];
    a[0] = t.x;
    a[1] = t.y;
  } else {
    a[0] = held[s];
  }
}

template <int R>
__device__ __forceinline__ void add_nonzero(const float* held, const unsigned short* slot, int f,
                                            float v, float (&p)[R], float (&q)[R],
                                            float (&z)[R]) {
  float a[R];
  held_values<R>(held, slot[f], a);
#pragma unroll
  for (int k = 0; k < R; ++k) {
    p[k] += fabsf(a[k] - v);
    q[k] += fabsf(a[k] + v);
    z[k] += fabsf(a[k]);
  }
}

// cap: slots the value vectors have room for, slot 0 included (at least 1 +
// the nonzeros of the R held rows). chunk: table rows a block takes.
template <int R>
__global__ void __launch_bounds__(kThreads, 1)
pairwise_sparse_kernel(const int* __restrict__ offsets, const int* __restrict__ indices,
                       const float* __restrict__ values, float* __restrict__ out, int row0,
                       int bm, int n, int d, int chunk) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned short* slot = reinterpret_cast<unsigned short*>(smem);
  float* held = reinterpret_cast<float*>(smem + slot_bytes(d));  // [slot][R]
  __shared__ float row_abs[R];      // A of each held row
  __shared__ float warp_part[kWarps];
  __shared__ int used;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int r0 = blockIdx.y * R;    // the block's first panel row
  const int rows = min(R, bm - r0);

  uint4* words = reinterpret_cast<uint4*>(smem);
  for (int t = tid; t < static_cast<int>(slot_bytes(d) / 16); t += kThreads)
    words[t] = make_uint4(0u, 0u, 0u, 0u);
  if (tid < R) {
    held[tid] = 0.0f;               // slot 0: the zero vector
    row_abs[tid] = 0.0f;
  }
  if (tid == 0) used = 1;
  __syncthreads();

  // The held rows, one at a time: a row's features are distinct, so no two
  // threads touch one slot within a row, and the barrier between rows lets
  // each row see the slots the rows before it took.
  for (int k = 0; k < rows; ++k) {
    const int e0 = offsets[row0 + r0 + k];
    const int e1 = offsets[row0 + r0 + k + 1];
    float part = 0.0f;
    for (int e = e0 + tid; e < e1; e += kThreads) {
      const int f = indices[e];
      const float a = values[e];
      int s = slot[f];
      if (s == 0) {
        s = atomicAdd(&used, 1);
        slot[f] = static_cast<unsigned short>(s);
#pragma unroll
        for (int q = 0; q < R; ++q) held[s * R + q] = 0.0f;
      }
      held[s * R + k] = a;
      part += fabsf(a);
    }
    part = repro::warp_sum(part);
    if (lane == 0) warp_part[warp] = part;
    __syncthreads();
    if (tid == 0) {
      float sum = 0.0f;
      for (int w = 0; w < kWarps; ++w) sum += warp_part[w];
      row_abs[k] = sum;
    }
    __syncthreads();
  }

  const int j_end = min(n, (blockIdx.x + 1) * chunk);
  for (int j = blockIdx.x * chunk + warp; j < j_end; j += kWarps) {
    const int e0 = __ldg(offsets + j);
    const int e1 = __ldg(offsets + j + 1);
    float p[R], q[R], z[R];
#pragma unroll
    for (int k = 0; k < R; ++k) p[k] = q[k] = z[k] = 0.0f;
    int e = e0;
    for (; e + 32 * kUnroll <= e1; e += 32 * kUnroll) {
      int f[kUnroll];
      float v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        f[u] = __ldg(indices + e + 32 * u + lane);
        v[u] = __ldg(values + e + 32 * u + lane);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) add_nonzero<R>(held, slot, f[u], v[u], p, q, z);
    }
    for (int t = e + lane; t < e1; t += 32)
      add_nonzero<R>(held, slot, __ldg(indices + t), __ldg(values + t), p, q, z);

    float mine = 0.0f;
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const float num = repro::warp_allsum(p[k] - z[k]);
      const float den = repro::warp_allsum(q[k] - z[k]);
      const float a = row_abs[k];
      const float dist = (a + den) > 0.0f ? (a + num) / (a + den) : 0.0f;
      if (lane == k) mine = row0 + r0 + k == j ? 0.0f : dist;
    }
    if (lane < rows) out[static_cast<size_t>(r0 + lane) * n + j] = mine;
  }
}

template <int R>
cudaError_t launch(const int* offsets, const int* indices, const float* values, float* out,
                   int row0, int bm, int n, int d, int cap, cudaStream_t stream) {
  const size_t smem = slot_bytes(d) + static_cast<size_t>(cap) * R * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(pairwise_sparse_kernel<R>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, pairwise_sparse_kernel<R>,
                                                           kThreads, smem)) != cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  // As many column chunks as leave no held row group without a resident
  // block: the blocks of one launch run in one wave where they can.
  const int groups = (bm + R - 1) / R;
  const int chunks = max(1, min(n, per_sm * sms / groups));
  const int chunk = (n + chunks - 1) / chunks;
  const dim3 grid((n + chunk - 1) / chunk, groups);
  pairwise_sparse_kernel<R><<<grid, kThreads, smem, stream>>>(offsets, indices, values, out,
                                                              row0, bm, n, d, chunk);
  return cudaGetLastError();
}

}  // namespace

// offsets: (n + 1,) int32; indices: (nnz,) int32, each in [0, d); values:
// (nnz,) fp32; out: (bm, n) fp32; all contiguous on the device. The panel is
// the rows [row0, row0 + bm) of the table. rows: R, 1, 2 or 4; cap: slots of
// R floats, at least 1 + the most nonzeros R rows of the table hold, and at
// most 65536 (the slots are 16-bit); the slot table and the value vectors
// must fit the opt-in limit of shared memory.
REPRO_EXPORT int repro_pairwise_sparse_panel(const int* offsets, const int* indices,
                                             const float* values, float* out, int row0, int bm,
                                             int n, int d, int rows, int cap,
                                             cudaStream_t stream) {
  if (bm <= 0 || n <= 0) return static_cast<int>(cudaGetLastError());
  if (row0 < 0 || row0 + bm > n || d < 0 || cap < 1 || cap > 65536 ||
      (bm + rows - 1) / rows > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  switch (rows) {
    case 1: err = launch<1>(offsets, indices, values, out, row0, bm, n, d, cap, stream); break;
    case 2: err = launch<2>(offsets, indices, values, out, row0, bm, n, d, cap, stream); break;
    case 4: err = launch<4>(offsets, indices, values, out, row0, bm, n, d, cap, stream); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}
