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
// the wrapper refuses the tile when one is not. The uint16 copy halves the
// order stream that the two kernels read once per permutation; n is held to
// what 16 bits index by the wrapper (kernels/inverse_orders.py::MAX_N, n <=
// 65536), the one place the limit is set.
//
// Bound on an H100: bytes, 10 n a row (orders read, inv and orders16
// written once): 5.2 MB at n = 16384, B = 32, 1.6 us at 3.35 TB/s.
//
// Design: a row is spread over a thread-block cluster of C blocks (C in
// {1, 2, 4, 8}, from the wrapper's plan: enough blocks to reach 128 SMs,
// each slice within the 48 KB of shared memory a block gets without opting
// in), so the row's inverse lies in the cluster's distributed shared
// memory: block `rank` owns the slots [lo(rank), lo(rank + 1)), lo(r) =
// ceil(r n / C), in its own shared memory. Each block reads the whole
// order row with 16-byte loads (from device memory once for the cluster,
// from L2 for the other blocks: C·4n bytes of L2 a row, 8 MB at the main
// path's tile), the first of them in flight while it sets its slots to -1,
// stores each i whose value v falls in its slice into slot v - lo(rank),
// and writes the 16-bit copy of its own share of positions. n in-range
// values fill n slots only if none repeats, so a value out of range, or a
// slot still -1 when the block writes its slots of inv with 16-byte
// stores, marks the row: an integer OR into rank 0's shared word through
// distributed shared memory, order-free, so the flag is deterministic;
// after the cluster barrier rank 0 writes is_perm. Device memory sees the
// bound's 10 n a row and nothing else. A cluster design that scattered each
// i into the owner's slot through distributed shared memory was about twice
// as slow on the H100 (PERF.md): each remote 4-byte store is a transaction
// of the SM-to-SM network, where L2 streams the row to every block in
// 16-byte loads.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kBatch = 8;   // 16-byte loads a thread has in flight: a 16384-wide row at once

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Leading elements before the first 16-byte boundary of p, at most count.
__device__ __forceinline__ int head16(const void* p, int count) {
  return min(count, static_cast<int>(((16 - (reinterpret_cast<uintptr_t>(p) & 15)) & 15) >> 2));
}

__global__ void __launch_bounds__(kThreads)
inverse_cluster_kernel(const int* __restrict__ orders, int* __restrict__ inv,
                       unsigned short* __restrict__ orders16, int* __restrict__ is_perm, int n) {
  extern __shared__ int slots[];   // this block's slice of the row's inverse
  __shared__ int bad_s;            // rank 0's is the row's flag
  cg::cluster_group cluster = cg::this_cluster();
  const int c = static_cast<int>(cluster.num_blocks());
  const int shift = __ffs(c) - 1;  // c is a power of two
  const int rank = static_cast<int>(cluster.block_rank());
  const int t = threadIdx.x;
  const long long row = static_cast<long long>(blockIdx.x >> shift) * n;
  const int lo = (rank * n + c - 1) >> shift;   // ceil(rank n / c)
  const unsigned count = static_cast<unsigned>((((rank + 1) * n + c - 1) >> shift) - lo);
  const int* src = orders + row;
  unsigned short* dst16 = orders16 + row;
  const int head = head16(src, n);
  const int vecs = (n - head) >> 2;
  const int4* src4 = reinterpret_cast<const int4*>(src + head);
  int4 v4[kBatch];
  auto load = [&](int q0) {
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int q = q0 + t + j * kThreads;
      v4[j] = q < vecs ? __ldg(src4 + q) : make_int4(0, 0, 0, 0);
    }
  };
  load(0);   // the row's first loads fly while the slots are set
  for (unsigned s = t; s < count; s += kThreads) slots[s] = -1;
  if (t == 0) bad_s = 0;
  cluster_arrive();   // rank 0's word is 0 before any block ORs into it
  __syncthreads();

  int bad = 0;
  auto take = [&](int i, int v) {   // slot of value v, if this block owns it
    const unsigned s = static_cast<unsigned>(v - lo);
    if (s < count) {
      slots[s] = i;
    } else {
      bad |= static_cast<unsigned>(v) >= static_cast<unsigned>(n);
    }
  };
  auto copy16 = [&](int i, int4 v) {   // the 16-bit copy of this block's positions
    const unsigned a = static_cast<unsigned>(i - lo);
    unsigned short* p = dst16 + i;
    if (a < count && a + 3 < count && (reinterpret_cast<uintptr_t>(p) & 7) == 0) {
      *reinterpret_cast<uint2*>(p) =
          make_uint2((static_cast<unsigned>(v.x) & 0xFFFFu) | (static_cast<unsigned>(v.y) << 16),
                     (static_cast<unsigned>(v.z) & 0xFFFFu) | (static_cast<unsigned>(v.w) << 16));
    } else if (a + 3 < count + 3) {   // the four positions meet the share
      const int e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (a + k < count) p[k] = static_cast<unsigned short>(e[k]);
      }
    }
  };
  if (t < head) {
    const int v = __ldg(src + t);
    take(t, v);
    if (static_cast<unsigned>(t - lo) < count) dst16[t] = static_cast<unsigned short>(v);
  }
  for (int q0 = 0; q0 < vecs; q0 += kBatch * kThreads) {
    if (q0 > 0) load(q0);
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int q = q0 + t + j * kThreads;
      if (q < vecs) {
        const int i = head + 4 * q;
        take(i, v4[j].x);
        take(i + 1, v4[j].y);
        take(i + 2, v4[j].z);
        take(i + 3, v4[j].w);
        copy16(i, v4[j]);
      }
    }
  }
  const int tail = head + 4 * vecs + t;
  if (tail < n) {
    const int v = __ldg(src + tail);
    take(tail, v);
    if (static_cast<unsigned>(tail - lo) < count) dst16[tail] = static_cast<unsigned short>(v);
  }
  __syncthreads();   // every value of this block's slice placed

  // inv from the slots; a slot left at -1 means a value repeated
  int* out = inv + row + lo;
  const int ohead = head16(out, static_cast<int>(count));
  const int ovecs = (static_cast<int>(count) - ohead) >> 2;
  if (t < ohead) {
    const int v = slots[t];
    bad |= v < 0;
    out[t] = v;
  }
  int4* out4 = reinterpret_cast<int4*>(out + ohead);
  for (int q = t; q < ovecs; q += kThreads) {
    const int* s = slots + ohead + 4 * q;
    const int4 v = make_int4(s[0], s[1], s[2], s[3]);
    bad |= (v.x | v.y | v.z | v.w) < 0;
    out4[q] = v;
  }
  for (int e = ohead + 4 * ovecs + t; e < static_cast<int>(count); e += kThreads) {
    const int v = slots[e];
    bad |= v < 0;
    out[e] = v;
  }
  cluster_wait();
  if (bad) atomicOr(cluster.map_shared_rank(&bad_s, 0), 1);
  cluster_arrive();
  cluster_wait();   // every block's flag in rank 0's word
  if (rank == 0 && t == 0) is_perm[blockIdx.x >> shift] = !bad_s;
}

}  // namespace

REPRO_EXPORT int repro_inverse_orders(const int* orders, int* inv, unsigned short* orders16,
                                      int* is_perm, int n, int num_perms, int cluster,
                                      cudaStream_t stream) {
  if (n <= 0 || num_perms <= 0) return static_cast<int>(cudaGetLastError());
  if (cluster < 1 || cluster > 8 || (cluster & (cluster - 1)) != 0 || cluster > n ||
      n > 65536) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(static_cast<unsigned>(num_perms) * cluster);
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = static_cast<size_t>((n + cluster - 1) / cluster) * sizeof(int);
  config.stream = stream;
  cudaLaunchAttribute attribute[1];
  attribute[0].id = cudaLaunchAttributeClusterDimension;
  attribute[0].val.clusterDim.x = cluster;
  attribute[0].val.clusterDim.y = 1;
  attribute[0].val.clusterDim.z = 1;
  config.attrs = attribute;
  config.numAttrs = 1;
  const cudaError_t err =
      cudaLaunchKernelEx(&config, inverse_cluster_kernel, orders, inv, orders16, is_perm, n);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
