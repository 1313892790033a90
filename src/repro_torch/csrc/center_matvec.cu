// Fused center-matvec for matrix-free PCoA: out = F @ X for the
// Gower-centred F = E - r 1^T - 1 r^T + m with E = -1/2 D*D, never forming
// F or E in device memory.
//
//   out[i, c] = sum_j E[i, j] X[j, c] + (corr[c] - r[i] colsum[c])
//
// with colsum = 1^T X and corr = m 1^T X - r^T X hoisted by the caller on the
// unpadded operands.
//
// Block mode, for the distributed matvec: D may be an (r, c) block, X then
// (c, k) and out (r, k); with r, colsum and corr zero the kernel gives the
// block's E_blk @ X_col and nothing else. The square call is r = c = n, the
// same loops, so the same bits.
//
// Replaces: src/repro/kernels/center_matvec.py::center_matvec
// (_center_matvec_kernel).
//
// Bound on an H100: D is read once, 4 r c bytes: 1.07 GB for the square at
// n = 16384, 0.32 ms at 3.35 TB/s, and 0.27 GB for an (8192, 8192) block,
// 0.08 ms. The products run on the tensor cores in 3xTF32: 3 x 2 r c k
// operations at 495 TFLOP/s, 0.07 ms for the square at k = 20 (bytes bound
// there), 0.42 ms at k = 128 (operations bound), 0.10 ms for the (8192,
// 8192) block at k = 128. On the CUDA cores in fp32 the square's products
// would take 1.03 ms at k = 128.
//
// Design. A strip of BM = 128 output rows is swept, over every column of D,
// by a thread-block cluster of s blocks, one an SM (s from the wrapper's
// sweep_split, a function of (r, c, k) alone: s = 1 where the strips fill
// the card, as the square's 128 strips at n = 16384 do, 2 to 8 where they
// leave SMs idle, as the 64 strips of an (8192, 8192) block do). Rank q of
// the cluster sweeps stages [q T / s, (q + 1) T / s) of the T = ceil(c / 32)
// stages. A producer warp keeps a ring of 4 to 6 stages full,
// each a 128 x 32 tile of D and the 32 x k rows of X beside it: one tensor
// copy (TMA) for the D tile and one bulk copy for the X rows where their rows
// are 16-byte multiples, 4-byte cp.async copies otherwise (the copy engine
// moves a tile for one instruction; one warp issuing cp.async copies of D
// could not keep enough bytes in flight). Each stage arrives on an mbarrier
// ("full"). Three splitter warps split the stage's X tile, once, into tf32
// hi and lo parts in a double-buffered buffer, one stage ahead of the MMA
// warps, with their own mbarrier pair (split by the MMA warps themselves,
// between barriers, the X tile held every MMA warp up each stage).
// Eight MMA warps square and halve their D values as they read them out of
// shared memory, split them in registers and run mma.sync m16n8k8 tf32:
// e_lo x_hi + e_hi x_lo + e_hi x_hi (3xTF32, about fp32's accuracy; plain
// TF32 keeps three digits and misses the 1e-5 tolerance). The MMA and
// splitter warps release each stage to the producer ("empty"). An MMA warp
// owns 16 rows and every column up to 64 columns; above that 32 rows and
// half the columns, so that each B fragment it loads from shared memory
// serves two MMA row tiles. A stage's 12 products accumulate in fp32 from
// zero and are added to the rank's running sums, so its fp32 chain has at
// most T / s terms. Then the cluster sums in a fixed order through
// distributed shared memory: after a cluster barrier (every rank's ring is
// idle), ranks 1 .. s-1 store their sums into slots of their own in rank
// 0's ring, a second barrier (release, acquire) publishes them, and rank 0
// adds slots 1, 2, .., s-1 to its own sums in that order and runs the
// epilogue; no block exits while another may still write its shared memory.
// Device memory sees what the s = 1 launch reads: the strip's D rows and X
// once between the cluster's ranks. Every output element is summed in an
// order that depends only on (r, c, k): two launches give the same bits.
// Up to 128 columns a launch; k is padded to the MMA width in registers and
// shared memory only (masked loads and stores), never in device memory.
//
// Within each 8-column k-step the kernel maps the MMA's k index t to column
// 2t and t + 4 to 2t + 1 (A and B alike, so the product is the same): a lane
// then reads its four A values as two float2 and its B values, hi and lo of
// both rows, as one float4. The D tile's row pitch (40 floats: the tensor
// copy's box is 8 columns wider than the stage) and the split buffer's (k
// padded + 2 float4) make those loads free of bank conflicts.
#include <cooperative_groups.h>
#include <cuda.h>

#include <type_traits>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

using repro::copy_bulk;
using repro::mbar_arrive;
using repro::mbar_arrive_expect;
using repro::mbar_init;
using repro::mbar_wait;
using repro::smem_addr;

constexpr int kBM = 128;                      // output rows a block
constexpr int kBN = 32;                       // D columns (X rows) a stage
constexpr int kMmaWarps = kBM / 16;           // 16 rows a warp at narrow k
constexpr int kMmaThreads = kMmaWarps * 32;
constexpr int kSplitWarps = 3;                // warps that split the X tiles
constexpr int kSplitters = kSplitWarps * 32;
constexpr int kProducerWarp = kMmaWarps + kSplitWarps;
constexpr int kThreads = (kProducerWarp + 1) * 32;
constexpr int kPitch = kBN + 8;               // D tile row pitch, floats
constexpr int kPairs = kBN / 2;               // X row pairs (2t, 2t + 1) a stage
constexpr int kMaxSplit = 8;                  // blocks of a strip's cluster, at most

// MMA row tiles (16 rows) an MMA warp owns at NT n-tiles: two above 8
// n-tiles, where pairs of warps then split the n-tiles evenly.
__host__ __device__ constexpr int m_tiles(int nt) { return nt > 8 ? 2 : 1; }

// Stages of the ring at NT n-tiles: as many as shared memory holds.
__host__ __device__ constexpr int ring_stages(int nt) { return nt > 8 ? 4 : 6; }

// Byte offsets into dynamic shared memory, for k columns padded to kp and a
// ring of `stages`.
struct Layout {
  int d_ring, x_ring, x_split, total;
  __host__ __device__ Layout(int k, int kp, int stages) {
    d_ring = 128;                               // after 2 stages + 4 mbarriers
    x_ring = d_ring + stages * kBM * kPitch * 4;
    x_split = x_ring + stages * kBN * k * 4;                   // multiple of 16
    total = x_split + 2 * kPairs * (kp + 2) * 16;
  }
  // whether the slots of a cluster of `split` fit in the bytes after the
  // mbarriers, which the sweep leaves idle: split - 1 blocks' 128 x kp sums
  __host__ __device__ static bool holds_slots(const Layout& lay, int kp, int split) {
    return (split - 1) * kBM * kp * 4 <= lay.total - lay.d_ring;
  }
};

// Every thread of the cluster arrives, then waits for every other: what
// each wrote to shared memory (its own or another block's) before arriving
// is seen by every thread after the wait.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// Arrive on `bar` once every cp.async this thread has issued has landed.
__device__ __forceinline__ void mbar_arrive_on_copies(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}

// The box of `map` at (column c, row r) into shared memory at `dst` (128-byte
// aligned) by the copy engine, zeros where the box leaves the tensor;
// completes on `bar`.
__device__ __forceinline__ void copy_tile(uint32_t dst, const CUtensorMap& map, int c, int r,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(&map)), "r"(c), "r"(r), "r"(bar)
      : "memory");
}

// A copy of 4 bytes by this thread; `valid` false writes a zero and reads
// nothing.
__device__ __forceinline__ void copy4(uint32_t dst, const float* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

// v = hi + lo with hi = tf32(v) and lo = tf32(v - hi), both rounded to
// nearest (ties away from zero); v - hi is exact in fp32.
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(v));
  const float rest = __fsub_rn(v, __uint_as_float(hi));
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(rest));
}

// c += a (16 x 8, row) x b (8 x 8, col) on the tensor cores, fp32 sums.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The producer warp: the block's stages t0 .. t0 + steps - 1, stage t in
// ring slot (t - t0) % S holding D[i0:i0+128, 32t:32t+40]
// (8 columns more than the stage uses, the row pitch that keeps the MMA
// warps' loads free of bank conflicts) and X[32t:32t+32, :]. Two routes
// for each operand, chosen per launch:
// - "tma": where its rows are a multiple of 16 bytes at a 16-byte aligned
//   address. D by one tensor copy a stage (n % 4 == 0), zeros past n; X by
//   one bulk copy a stage (k % 4 == 0), its rows being contiguous.
// - "cp.async": 4-byte copies by the warp's lanes otherwise, D zero-filled
//   past n.
// X rows past n are left stale and masked by the splitters. Each stage's
// "full" barrier counts 33 arrivals: lane 0's, which also expects the bytes
// of the stage's copy-engine copies, and one from each lane when its cp.async
// copies have landed.
template <int S>
__device__ __forceinline__ void produce(const CUtensorMap& dmap, const float* __restrict__ d,
                                        const float* __restrict__ x, unsigned char* smem,
                                        const Layout& lay, int rows, int cols_d, int k, int i0,
                                        int t0, int steps, bool d_tma, bool x_tma) {
  const int lane = threadIdx.x & 31;
  const uint32_t bars = smem_addr(smem);
  for (int u = 0; u < steps; ++u) {
    const int slot = u % S;
    if (u >= S) mbar_wait(bars + 8 * (S + slot), ((u / S) - 1) & 1);
    const uint32_t full = bars + 8 * slot;
    const int j0 = (t0 + u) * kBN;
    const int cols = min(kBN, cols_d - j0);   // D columns, and X rows, of the stage
    const uint32_t dt = smem_addr(smem + lay.d_ring) + slot * kBM * kPitch * 4;
    const uint32_t xt = smem_addr(smem + lay.x_ring) + slot * kBN * k * 4;
    const float* xs = x + static_cast<size_t>(j0) * k;
    if (lane == 0) {
      const uint32_t d_bytes = d_tma ? kBM * kPitch * 4 : 0;
      const uint32_t x_bytes = x_tma ? cols * k * 4 : 0;
      mbar_arrive_expect(full, d_bytes + x_bytes);
      if (d_tma) copy_tile(dt, dmap, j0, i0, full);
      if (x_tma) copy_bulk(xt, xs, x_bytes, full);
    }
    if (!d_tma) {
      // a warp copies 32 consecutive floats of a row at a time
      for (int q = lane; q < kBM * kBN; q += 32) {
        const int row = q / kBN;
        const int c = q % kBN;
        const bool valid = i0 + row < rows && c < cols;
        copy4(dt + (row * kPitch + c) * 4,
              valid ? d + static_cast<size_t>(i0 + row) * cols_d + j0 + c : d, valid);
      }
    }
    if (!x_tma) {
      for (int v = lane; v < cols * k; v += 32) copy4(xt + 4 * v, xs + v, true);
    }
    mbar_arrive_on_copies(full);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// kCluster false: one block a strip (split is 1), the cluster's sum
// compiled out.
template <int NT, bool kCluster>
__global__ void __launch_bounds__(kThreads, 1)
center_matvec_kernel(const __grid_constant__ CUtensorMap dmap, const float* __restrict__ d,
                     const float* __restrict__ x,
                     const float* __restrict__ row_means, const float* __restrict__ colsum,
                     const float* __restrict__ corr, float* __restrict__ out, int rows,
                     int cols, int k, int d_tma, int x_tma, int cluster_blocks) {
  constexpr int KP = 8 * NT;          // columns padded to the MMA width
  constexpr int kSplitPitch = KP + 2;  // float4 a row pair of the split X tile
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int S = ring_stages(NT);
  const Layout lay(k, KP, S);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  // strip blockIdx.x / split; rank blockIdx.x % split of its cluster (the
  // cluster's own block rank), which sweeps stages [t0, t0 + steps)
  const int split = kCluster ? cluster_blocks : 1;
  const int strip = blockIdx.x / split;
  const int rank = blockIdx.x - strip * split;
  const int i0 = strip * kBM;
  const int stages = (cols + kBN - 1) / kBN;
  const int t0 = rank * stages / split;
  const int steps = (rank + 1) * stages / split - t0;
  // mbarriers: full[S] and empty[S] of the D/X ring, then
  // split_full[2] and split_empty[2] of the split X tiles
  const uint32_t bars = smem_addr(smem);
  const uint32_t split_bars = bars + 16 * S;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(bars + 8 * s, 33);                             // see produce()
      mbar_init(bars + 8 * (S + s), kMmaWarps + kSplitWarps);  // a warp each
    }
    for (int s = 0; s < 2; ++s) {
      mbar_init(split_bars + 8 * s, kSplitWarps);
      mbar_init(split_bars + 8 * (2 + s), kMmaWarps);
    }
  }
  __syncthreads();

  const float* d_ring = reinterpret_cast<const float*>(smem + lay.d_ring);
  const float* x_ring = reinterpret_cast<const float*>(smem + lay.x_ring);
  float4* x_split = reinterpret_cast<float4*>(smem + lay.x_split);

  if (warp == kProducerWarp) {
    produce<S>(dmap, d, x, smem, lay, rows, cols, k, i0, t0, steps, d_tma != 0, x_tma != 0);
    if (kCluster) {   // the cluster's two barriers of the sum below
      cluster_sync();
      cluster_sync();
    }
    return;
  }
  if (warp >= kMmaWarps) {
    // the splitters: stage t's X tile into split buffer t % 2, entry (p, c)
    // holding hi(X[2p, c]), hi(X[2p+1, c]), lo(X[2p, c]), lo(X[2p+1, c]),
    // zero past the D columns and k; one stage ahead of the MMA warps
    const int stid = threadIdx.x - kMmaWarps * 32;
    const bool x_vec = k % 4 == 0;
    for (int u = 0; u < steps; ++u) {
      const int slot = u % S;
      const int j0 = (t0 + u) * kBN;
      mbar_wait(bars + 8 * slot, (u / S) & 1);
      if (u >= 2) mbar_wait(split_bars + 8 * (2 + (u & 1)), ((u >> 1) - 1) & 1);
      const float* xr = x_ring + slot * kBN * k;
      float4* xs = x_split + (u & 1) * kPairs * kSplitPitch;
      // four columns at a time: one float4 of each of the two rows where k
      // % 4 == 0 (the rows then start 16-byte aligned), scalars otherwise
      constexpr int kQuads = kPairs * KP / 4;
#pragma unroll 4
      for (int q = stid; q < kQuads; q += kSplitters) {
        const int p = q / (KP / 4);
        const int c = 4 * (q - p * (KP / 4));
        const int j = j0 + 2 * p;
        float v[2][4];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float* row = xr + (2 * p + h) * k + c;
          if (j + h < cols && x_vec && c < k) {
            const float4 f = *reinterpret_cast<const float4*>(row);
            v[h][0] = f.x, v[h][1] = f.y, v[h][2] = f.z, v[h][3] = f.w;
          } else {
#pragma unroll
            for (int e = 0; e < 4; ++e) v[h][e] = (j + h < cols && c + e < k) ? row[e] : 0.0f;
          }
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          uint32_t h0, l0, h1, l1;
          split_tf32(v[0][e], h0, l0);
          split_tf32(v[1][e], h1, l1);
          xs[p * kSplitPitch + c + e] = make_float4(__uint_as_float(h0), __uint_as_float(h1),
                                                    __uint_as_float(l0), __uint_as_float(l1));
        }
      }
      __syncwarp();
      if (lane == 0) {
        mbar_arrive(bars + 8 * (S + slot));   // done with the X rows of the ring
        mbar_arrive(split_bars + 8 * (u & 1));   // split tile u is ready
      }
    }
    if (kCluster) {
      cluster_sync();
      cluster_sync();
    }
    return;
  }

  // the MMA warps: warp (rg, cg) owns rows 16 MT rg .. + 16 MT of the block
  // and n-tiles WNT cg .. + WNT: one MMA row tile a warp at narrow k, two
  // (each B fragment loaded once for both) at wide k, where the split X
  // tile's reads from shared memory would otherwise dominate
  constexpr int MT = m_tiles(NT);
  constexpr int WNT = NT / MT;
  const int rg = warp / MT;
  const int cg = warp % MT;
  const int g = lane >> 2;   // MMA group: rows g and g + 8, column g of B
  const int tq = lane & 3;   // thread in group: k indices tq and tq + 4

  float acc[MT][WNT][4];
#pragma unroll
  for (int m = 0; m < MT; ++m) {
#pragma unroll
    for (int nt = 0; nt < WNT; ++nt) {
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[m][nt][r] = 0.0f;
    }
  }

  for (int u = 0; u < steps; ++u) {
    const int slot = u % S;
    mbar_wait(bars + 8 * slot, (u / S) & 1);
    mbar_wait(split_bars + 8 * (u & 1), (u >> 1) & 1);
    const float4* xs = x_split + (u & 1) * kPairs * kSplitPitch;

    // this warp's rows against the stage's 32 columns: 4 k-steps of 8
    const float* dt = d_ring + slot * kBM * kPitch + (rg * 16 * MT + g) * kPitch + 2 * tq;
    const float4* xb = xs + tq * kSplitPitch + cg * WNT * 8 + g;
    float step[MT][WNT][4];
#pragma unroll
    for (int m = 0; m < MT; ++m) {
#pragma unroll
      for (int nt = 0; nt < WNT; ++nt) {
#pragma unroll
        for (int r = 0; r < 4; ++r) step[m][nt][r] = 0.0f;
      }
    }
#pragma unroll
    for (int ks = 0; ks < kBN / 8; ++ks) {
      uint32_t ahi[MT][4], alo[MT][4];
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const float* a = dt + 16 * m * kPitch + 8 * ks;
        const float2 top = *reinterpret_cast<const float2*>(a);
        const float2 bot = *reinterpret_cast<const float2*>(a + 8 * kPitch);
        // a0 (g, tq), a1 (g + 8, tq), a2 (g, tq + 4), a3 (g + 8, tq + 4)
        const float dv[4] = {top.x, bot.x, top.y, bot.y};
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          split_tf32(__fmul_rn(__fmul_rn(-0.5f, dv[r]), dv[r]), ahi[m][r], alo[m][r]);
        }
      }
#pragma unroll
      for (int nt = 0; nt < WNT; ++nt) {
        const float4 b = xb[ks * 4 * kSplitPitch + 8 * nt];
        const uint32_t bh0 = __float_as_uint(b.x), bh1 = __float_as_uint(b.y);
        const uint32_t bl0 = __float_as_uint(b.z), bl1 = __float_as_uint(b.w);
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          mma_tf32(step[m][nt], alo[m], bh0, bh1);
          mma_tf32(step[m][nt], ahi[m], bl0, bl1);
          mma_tf32(step[m][nt], ahi[m], bh0, bh1);
        }
      }
    }
    __syncwarp();
    if (lane == 0) {
      mbar_arrive(bars + 8 * (S + slot));   // the ring slot may be refilled
      mbar_arrive(split_bars + 8 * (2 + (u & 1)));   // and the split tile
    }
#pragma unroll
    for (int m = 0; m < MT; ++m) {
#pragma unroll
      for (int nt = 0; nt < WNT; ++nt) {
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[m][nt][r] = __fadd_rn(acc[m][nt][r], step[m][nt][r]);
      }
    }
  }

  if (kCluster) {
    // the cluster's sum in rank order: slot q - 1 of rank 0's ring holds
    // rank q's sums, float4 (m, nt) of MMA thread i at (m WNT + nt) 256 + i.
    // The rank and the cluster's size are read anew from the cluster's
    // registers, so no register holds them over the sweep.
    constexpr int kSlot = MT * WNT * kMmaThreads;   // float4 a slot
    cg::cluster_group cluster = cg::this_cluster();
    const int my_rank = static_cast<int>(cluster.block_rank());
    float4* slots = reinterpret_cast<float4*>(smem + lay.d_ring);
    cluster_sync();   // every rank's sweep is done: rank 0's ring is idle
    if (my_rank > 0) {
      float4* dst = cluster.map_shared_rank(slots, 0) + (my_rank - 1) * kSlot;
#pragma unroll
      for (int m = 0; m < MT; ++m) {
#pragma unroll
        for (int nt = 0; nt < WNT; ++nt) {
          dst[(m * WNT + nt) * kMmaThreads + threadIdx.x] =
              make_float4(acc[m][nt][0], acc[m][nt][1], acc[m][nt][2], acc[m][nt][3]);
        }
      }
    }
    cluster_sync();   // every slot written; rank 0 alone goes on
    if (my_rank > 0) return;
    const int blocks = static_cast<int>(cluster.num_blocks());
    for (int q = 1; q < blocks; ++q) {
      const float4* src = slots + (q - 1) * kSlot;
#pragma unroll
      for (int m = 0; m < MT; ++m) {
#pragma unroll
        for (int nt = 0; nt < WNT; ++nt) {
          const float4 v = src[(m * WNT + nt) * kMmaThreads + threadIdx.x];
          acc[m][nt][0] = __fadd_rn(acc[m][nt][0], v.x);
          acc[m][nt][1] = __fadd_rn(acc[m][nt][1], v.y);
          acc[m][nt][2] = __fadd_rn(acc[m][nt][2], v.z);
          acc[m][nt][3] = __fadd_rn(acc[m][nt][3], v.w);
        }
      }
    }
  }

  // c0, c1: row g, columns 2 tq and 2 tq + 1 of each n-tile; c2, c3: row g + 8
#pragma unroll
  for (int m = 0; m < MT; ++m) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = i0 + rg * 16 * MT + 16 * m + 8 * half + g;
      if (row >= rows) continue;
      const float rm = row_means[row];
#pragma unroll
      for (int nt = 0; nt < WNT; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = (cg * WNT + nt) * 8 + 2 * tq + e;
          if (c < k) {
            out[static_cast<size_t>(row) * k + c] = __fadd_rn(
                acc[m][nt][2 * half + e], __fsub_rn(corr[c], __fmul_rn(rm, colsum[c])));
          }
        }
      }
    }
  }
}

// cuTensorMapEncodeTiled from the driver, found through the runtime so that
// the library needs no link to libcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

cudaError_t encode_tiled(EncodeTiled* fn) {
  static EncodeTiled cached = nullptr;
  if (cached == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || ptr == nullptr) return cudaErrorNotSupported;
    cached = reinterpret_cast<EncodeTiled>(ptr);
  }
  *fn = cached;
  return cudaSuccess;
}

// D (rows x cols fp32, row pitch 4 cols bytes) as a tensor of boxes of kBM
// rows by kPitch columns.
cudaError_t d_tensor_map(const float* d, int rows, int cols, CUtensorMap* map) {
  EncodeTiled encode = nullptr;
  const cudaError_t err = encode_tiled(&encode);
  if (err != cudaSuccess) return err;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * sizeof(float)};
  const cuuint32_t box[2] = {kPitch, kBM};
  const cuuint32_t steps[2] = {1, 1};
  const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(d), dims,
                              strides, box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// A launch of `grid` blocks of kThreads in clusters of `split` along x, with
// `smem` bytes of dynamic shared memory a block; `attribute`, which holds the
// cluster's shape, must outlive the config.
cudaLaunchConfig_t cluster_config(int grid, int split, int smem, cudaStream_t stream,
                                  cudaLaunchAttribute* attribute) {
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(static_cast<unsigned>(grid));
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

template <int NT>
int launch(const float* d, const float* x, const float* rm, const float* colsum,
           const float* corr, float* out, int rows, int cols, int k, int split,
           cudaStream_t stream) {
  const Layout lay(k, 8 * NT, ring_stages(NT));
  if (split > (cols + kBN - 1) / kBN || !Layout::holds_slots(lay, 8 * NT, split)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto kernel =
      split == 1 ? center_matvec_kernel<NT, false> : center_matvec_kernel<NT, true>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, lay.total);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int d_tma = cols % 4 == 0 && reinterpret_cast<uintptr_t>(d) % 16 == 0;
  const int x_tma = k % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  CUtensorMap dmap = {};
  if (d_tma && (err = d_tensor_map(d, rows, cols, &dmap)) != cudaSuccess) {
    return static_cast<int>(err);
  }
  const int strips = (rows + kBM - 1) / kBM;
  if (split == 1) {
    kernel<<<strips, kThreads, lay.total, stream>>>(
        dmap, d, x, rm, colsum, corr, out, rows, cols, k, d_tma, x_tma, 1);
    return static_cast<int>(cudaGetLastError());
  }
  cudaLaunchAttribute attribute = {};
  const cudaLaunchConfig_t config =
      cluster_config(strips * split, split, lay.total, stream, &attribute);
  err = cudaLaunchKernelEx(&config, kernel, dmap, d, x, rm, colsum, corr, out,
                           rows, cols, k, d_tma, x_tma, split);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// Clusters of `split` blocks of the width-NT kernel that the card holds at
// once.
template <int NT>
int resident_clusters(int k, int split, int* clusters) {
  const Layout lay(k, 8 * NT, ring_stages(NT));
  cudaError_t err = cudaFuncSetAttribute(center_matvec_kernel<NT, true>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, lay.total);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attribute = {};
  const cudaLaunchConfig_t config = cluster_config(split, split, lay.total, nullptr, &attribute);
  return static_cast<int>(
      cudaOccupancyMaxActiveClusters(clusters, center_matvec_kernel<NT, true>, &config));
}

// fn(std::integral_constant<int, NT>) for the instantiated width NT (n-tiles
// of 8 columns) that k columns take: the next one up.
template <typename Fn>
int by_width(int k, Fn&& fn) {
  const int tiles = (k + 7) / 8;
  if (tiles <= 1) return fn(std::integral_constant<int, 1>{});
  if (tiles <= 2) return fn(std::integral_constant<int, 2>{});
  if (tiles <= 3) return fn(std::integral_constant<int, 3>{});
  if (tiles <= 4) return fn(std::integral_constant<int, 4>{});
  if (tiles <= 6) return fn(std::integral_constant<int, 6>{});
  if (tiles <= 8) return fn(std::integral_constant<int, 8>{});
  if (tiles <= 12) return fn(std::integral_constant<int, 12>{});
  return fn(std::integral_constant<int, 16>{});
}

bool valid_split(int split) {
  return split >= 1 && split <= kMaxSplit && (split & (split - 1)) == 0;
}

}  // namespace

// d: (rows, cols), x: (cols, k), row_means: (rows,), colsum/corr: (k,),
// out: (rows, k); all fp32, contiguous, on the device. 1 <= k <= 128. The
// square matrix is rows = cols = n. Each strip of 128 rows is swept by a
// cluster of `split` blocks: 1, 2, 4 or 8, at most the ceil(cols / 32)
// stages, and with the slots of its sum within shared memory.
REPRO_EXPORT int repro_center_matvec(const float* d, const float* x, const float* row_means,
                                     const float* colsum, const float* corr, float* out,
                                     int rows, int cols, int k, int split, cudaStream_t stream) {
  if (rows <= 0 || cols <= 0) return static_cast<int>(cudaGetLastError());
  if (k < 1 || k > 128 || !valid_split(split)) return static_cast<int>(cudaErrorInvalidValue);
  return by_width(k, [&](auto nt) {
    return launch<decltype(nt)::value>(d, x, row_means, colsum, corr, out, rows, cols, k, split,
                                       stream);
  });
}

// The clusters of `split` blocks that the card holds at once for a launch of
// k columns (cudaOccupancyMaxActiveClusters), into *clusters.
REPRO_EXPORT int repro_center_matvec_clusters(int k, int split, int* clusters) {
  if (k < 1 || k > 128 || !valid_split(split)) return static_cast<int>(cudaErrorInvalidValue);
  return by_width(k, [&](auto nt) {
    return resident_clusters<decltype(nt)::value>(k, split, clusters);
  });
}
