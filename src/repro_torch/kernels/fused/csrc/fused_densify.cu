// fused_densify: jagged trait arena -> dense right-aligned (B, L, T) int32
// block, with the timestamp column delta-decoded in-window to exact int64.
//
// Replaces the TPU kernel src/repro/kernels/fused/fused.py:fused_densify_kernel
// (pl.pallas_call at fused.py:70, body _kernel at fused.py:32).
//
// What it computes, per row b of the batch: the L positions ending at
// offsets[b+1] of the stacked (N, T) int32 arena. Position j is valid iff
// j >= L - min(len_b, L), len_b = offsets[b+1] - offsets[b]; invalid
// positions are zero (right alignment, the featurizer's truncation rule keeps
// the LAST L elements). If ts_col >= 0 that column holds window-relative
// deltas: it becomes the inclusive prefix sum of the valid deltas plus the
// row's int64 base, written exactly to ts_out (B, L) int64 and, wrapped to
// int32, into the int32 block (the JAX device batch's value).
//
// Bound on an H100: memory. Each call writes B*L*T*4 bytes of int32 lanes
// plus B*L*8 bytes of int64 timestamps, and reads the kept
// B*min(len,L)*T*4 arena bytes plus offsets and bases. At B=32, L=2048, T=4
// that is about 2.3 MB, under 1 us at 3.35 TB/s, below one launch's own
// latency; at B=1024 about 75 MB, about 23 us.
//
// Design. The TPU kernel DMAs a fixed L-row window from a front-padded,
// 128-lane-padded arena into VMEM, one grid step a row in order; both pads were
// TPU DMA artifacts and are gone: a thread reads the arena only where its
// position is valid (source row >= offsets[b] is implied), so positions in a
// row's invalid prefix are never read. One block a row would take 32 of the 132
// SMs at B=32 and walk L in serial tiles, one HBM round trip and one scan a
// tile: bound by latency. So a row is split over the S blocks (ranks) of one
// thread-block cluster, S = 1, 2, 4 or 8 (the portable limit), chosen so that
// the grid holds about two blocks an SM and no rank has fewer positions than a
// block has threads: S=8 at B=32, L=2048 (256 blocks); S=1 at B=1024 and at
// L=100. Rank r owns a contiguous chunk of the row, and each thread K of its
// positions (K = 1, 2, 4 or 8, a template parameter, the least that covers the
// chunk): a thread issues all K loads before any scan or store, so a block pays
// one HBM round trip. Within a tile, warp w owns 32*K consecutive positions and
// lane l the positions 32k + l of them, so each load and store of a warp covers
// 32 neighbouring positions: a position's T lanes move as one 16-byte word when
// T is a multiple of 4 and the arena and the output are 16-byte aligned (T=4 on
// the main path: 512 contiguous bytes a warp), else lane by lane; the int64
// timestamps go out 256 contiguous bytes a warp. (Giving a thread K consecutive
// positions instead spreads a warp's 16-byte accesses over 32*K*16 bytes; at
// B=1024, K=8 that ran at half this layout's rate on an H100.) The in-window
// cumsum: the warp scans its K rows of 32 deltas in order (shuffles, a carry
// from row to row), and the warps' totals pass through shared memory once (one
// __syncthreads, two buffers used in turn). Rank r then writes its total into
// slot r of every later rank's shared memory through distributed shared memory;
// one cluster.sync() publishes the slots, and each rank adds the totals of
// ranks 0..r-1 from its own slots in rank order, so timestamps above 2^31
// decode exactly, with no atomics, the same every run. A rank's shared memory
// is written only before the barrier it waits on, so no rank stays resident for
// another once its stores go out. (Every rank arrives on a first cluster
// barrier as it starts and waits on it before its first remote write, as
// distributed shared memory requires.) A chunk longer than K*threads is walked
// in tiles with an int64 carry; when S > 1 a pre-pass over the rank's timestamp
// column gives its total first. With ts_col < 0 there is no scan and no
// exchange between ranks.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;        // the most threads a block takes
constexpr int MAX_WARPS = THREADS / 32;
constexpr int MAX_K = 8;            // the most positions a thread holds
constexpr int MAX_CLUSTER = 8;      // the portable cluster size
constexpr int TARGET_BLOCKS = 264;  // two blocks on each of the 132 SMs

// How a launch lays out its grid; a function of the shapes and pointers.
struct Plan {
  int S;        // blocks (ranks) of the cluster that split a row
  int K;        // positions a thread holds
  int threads;  // threads of a block, a multiple of 32
  int chunk;    // positions a rank owns
  int vec;      // 1: a position's lanes move as 16-byte words
};

Plan make_plan(int B, int L, int T, const void* arena, const void* out) {
  Plan p;
  p.S = 1;
  while (p.S < MAX_CLUSTER && (long long)B * 2 * p.S <= TARGET_BLOCKS &&
         L / (2 * p.S) >= THREADS) {
    p.S *= 2;
  }
  p.chunk = (L + p.S - 1) / p.S;
  p.K = 1;
  while (p.K < MAX_K && (long long)p.K * THREADS < p.chunk) p.K *= 2;
  const int need = (p.chunk + p.K - 1) / p.K;
  p.threads = need >= THREADS ? THREADS : (need + 31) / 32 * 32;
  p.vec = T % 4 == 0 && reinterpret_cast<uintptr_t>(arena) % 16 == 0 &&
          reinterpret_cast<uintptr_t>(out) % 16 == 0;
  return p;
}

// Inclusive scan of x over the warp's lanes.
__device__ __forceinline__ long long warp_inclusive_scan(long long x) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const long long y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  return x;
}

// The sum of the totals of the warps before this thread's, given each
// warp's total (the same in all its lanes); *total receives the block's.
// Every thread of the block must call it; `sums` must not be written again
// before every thread has passed the next __syncthreads (the caller
// alternates two buffers).
__device__ long long warps_before(long long warp_total, long long* sums,
                                  long long* total) {
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  if ((threadIdx.x & 31) == 0) sums[warp] = warp_total;
  __syncthreads();
  long long before = 0;
  long long all = 0;
  for (int q = 0; q < warps; ++q) {
    const long long s = sums[q];  // a broadcast read
    if (q < warp) before += s;
    all += s;
  }
  *total = all;
  return before;
}

// Arrive on the cluster barrier that says every rank has started (the
// kernel's first statement when ranks exchange totals); ranks_before waits
// on it before its first write to another rank's shared memory.
__device__ __forceinline__ void cluster_arrive_started() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

// The sum of the totals of ranks 0..rank-1 of this cluster, in rank order.
// Rank r writes its total into slot r of every later rank's `totals`
// through distributed shared memory (threads r+1..S-1 of the block, one
// rank each), cluster.sync() makes the writes visible, and each rank adds
// the slots of its own shared memory. A rank's shared memory is written
// only before the barrier it waits on, so no rank has to stay resident for
// another afterwards. Every thread of every rank calls it once.
__device__ long long ranks_before(cg::cluster_group& cluster,
                                  long long* totals, long long total,
                                  int rank, int S) {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  const int q = static_cast<int>(threadIdx.x);
  if (q > rank && q < S) *cluster.map_shared_rank(totals + rank, q) = total;
  cluster.sync();
  long long c = 0;
  for (int r = 0; r < rank; ++r) c += totals[r];
  return c;
}

__device__ __forceinline__ int32_t lane_of(const int4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

__device__ __forceinline__ void set_lane(int4& v, int c, int32_t x) {
  if (c == 0) {
    v.x = x;
  } else if (c == 1) {
    v.y = x;
  } else if (c == 2) {
    v.z = x;
  } else {
    v.w = x;
  }
}

// The int32 the timestamp column holds: the low 32 bits of the int64.
__device__ __forceinline__ int32_t wrap32(long long ts) {
  return static_cast<int32_t>(static_cast<uint32_t>(
      static_cast<unsigned long long>(ts)));
}

// One block is rank `rank` of row b's cluster. A tile of its chunk is
// K * blockDim.x positions: warp w owns the 32 * K consecutive ones from
// tile + 32 * K * w, and lane l of it the K positions p0 + 32 * k, so every
// load and store of a warp covers 32 neighbouring positions.
template <int K, bool VEC>
__global__ void __launch_bounds__(THREADS)
fused_densify_kernel(const int32_t* __restrict__ arena,
                     const int32_t* __restrict__ offsets,
                     const int64_t* __restrict__ bases, int L, int T,
                     int ts_col, int S, int chunk,
                     int32_t* __restrict__ out,
                     int64_t* __restrict__ ts_out) {
  __shared__ long long warp_sums[2][MAX_WARPS];  // alternated tile by tile
  __shared__ long long totals[MAX_CLUSTER];  // slot r: rank r's, r < rank
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const bool exchange = ts_col >= 0 && S > 1;
  if (exchange) cluster_arrive_started();
  const long long b = blockIdx.x / S;
  const long long start = offsets[b];
  const long long end = offsets[b + 1];
  const long long len = end - start < L ? end - start : L;
  const long long first = L - len;   // first valid position
  const bool ts = ts_col >= 0;
  const long long base = ts ? bases[b] : 0;
  const long long row = b * L;       // position p is out row row + p
  const long long shift = end - L;   // ... and arena row shift + p
  const long long lo64 = (long long)rank * chunk;
  const int lo = lo64 < L ? static_cast<int>(lo64) : L;  // [lo, hi): rank's
  const int hi = L - lo < chunk ? L : lo + chunk;
  const int tile_len = K * static_cast<int>(blockDim.x);
  const bool single = chunk <= tile_len;  // the same for every rank
  const int W = T >> 2;                   // 16-byte words a position
  const int hw = ts ? ts_col >> 2 : 0;    // the word held across the scan
  const int4* a4 = reinterpret_cast<const int4*>(arena);
  int4* o4 = reinterpret_cast<int4*>(out);
  const int warp_pos = (threadIdx.x >> 5) * 32 * K + (threadIdx.x & 31);
  long long carry = 0;

  if (exchange && !single) {
    // several tiles: the rank's total first, from its timestamp lane alone
    long long s = 0;
    for (long long p = (lo > first ? lo : first) + threadIdx.x; p < hi;
         p += blockDim.x) {
      s += arena[(shift + p) * T + ts_col];
    }
    long long total;
    warps_before(__shfl_sync(0xffffffffu, warp_inclusive_scan(s), 31),
                 warp_sums[1], &total);
    carry = ranks_before(cluster, totals, total, rank, S);
  }

  int parity = 0;
  for (int tile = lo;; tile += tile_len, parity ^= 1) {
    const int p0 = tile + warp_pos;  // the thread's k-th position: p0 + 32k
    int32_t d[K];
    int4 held[K];
    // 1. every load of the tile before any scan or store
    if constexpr (VEC) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int p = p0 + 32 * k;
        held[k] = make_int4(0, 0, 0, 0);
        if (p < hi && p >= first) held[k] = a4[(shift + p) * W + hw];
      }
      for (int w = 0; w < W; ++w) {  // the other words pass straight through
        if (w == hw) continue;
        int4 r[K];
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const int p = p0 + 32 * k;
          r[k] = make_int4(0, 0, 0, 0);
          if (p < hi && p >= first) r[k] = a4[(shift + p) * W + w];
        }
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const int p = p0 + 32 * k;
          if (p < hi) o4[(row + p) * W + w] = r[k];
        }
      }
#pragma unroll
      for (int k = 0; k < K; ++k) d[k] = ts ? lane_of(held[k], ts_col & 3) : 0;
    } else {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int p = p0 + 32 * k;
        d[k] = ts && p < hi && p >= first ? arena[(shift + p) * T + ts_col]
                                          : 0;
      }
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int p = p0 + 32 * k;
        if (p >= hi) continue;
        const bool valid = p >= first;
        for (int t = 0; t < T; ++t) {
          if (t == ts_col) continue;
          out[(row + p) * T + t] = valid ? arena[(shift + p) * T + t] : 0;
        }
      }
    }
    // 2. the scan: the warp's K rows of 32 positions in order, then the
    // warps' totals, the earlier ranks' totals and the earlier tiles'
    long long v[K];
    if (ts) {
      long long run = 0;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const long long x = warp_inclusive_scan(d[k]);
        v[k] = run + x;
        run += __shfl_sync(0xffffffffu, x, 31);
      }
      long long total;
      const long long before = warps_before(run, warp_sums[parity], &total);
      if (exchange && single) {
        carry = ranks_before(cluster, totals, total, rank, S);
      }
      const long long offset = base + carry + before;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        v[k] = p0 + 32 * k >= first ? offset + v[k] : 0;
      }
      carry += total;
    }
    // 3. the stores
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int p = p0 + 32 * k;
      if (p >= hi) continue;
      if constexpr (VEC) {
        if (ts) set_lane(held[k], ts_col & 3, wrap32(v[k]));
        o4[(row + p) * W + hw] = held[k];
      } else {
        if (ts) out[(row + p) * T + ts_col] = wrap32(v[k]);
      }
      if (ts) ts_out[row + p] = v[k];
    }
    if (tile + tile_len >= hi) break;
  }
}

template <int K, bool VEC>
cudaError_t launch(const Plan& p, const void* arena, const void* offsets,
                   const void* bases, void* out, void* ts_out, int B, int L,
                   int T, int ts_col, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  // the S ranks of a row are neighbours in x, so a cluster is one row
  cfg.gridDim = dim3((unsigned)(p.S * B), 1, 1);
  cfg.blockDim = dim3((unsigned)p.threads, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.S;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(
      &cfg, fused_densify_kernel<K, VEC>, (const int32_t*)arena,
      (const int32_t*)offsets, (const int64_t*)bases, L, T, ts_col, p.S,
      p.chunk, (int32_t*)out, (int64_t*)ts_out);
}

template <bool VEC>
cudaError_t launch_k(const Plan& p, const void* arena, const void* offsets,
                     const void* bases, void* out, void* ts_out, int B, int L,
                     int T, int ts_col, cudaStream_t stream) {
  switch (p.K) {
    case 1:
      return launch<1, VEC>(p, arena, offsets, bases, out, ts_out, B, L, T,
                            ts_col, stream);
    case 2:
      return launch<2, VEC>(p, arena, offsets, bases, out, ts_out, B, L, T,
                            ts_col, stream);
    case 4:
      return launch<4, VEC>(p, arena, offsets, bases, out, ts_out, B, L, T,
                            ts_col, stream);
    default:
      return launch<MAX_K, VEC>(p, arena, offsets, bases, out, ts_out, B, L,
                                T, ts_col, stream);
  }
}

}  // namespace

extern "C" {

// Launch on `stream`; returns a cudaError_t (0 on success). The caller
// guarantees B > 0, L > 0, T > 0, a non-empty arena, offsets that are a
// non-decreasing partition of its rows, and contiguous tensors; bases and
// ts_out may be null when ts_col < 0.
int fused_densify_launch(const void* arena, const void* offsets,
                         const void* bases, void* out, void* ts_out, int B,
                         int L, int T, int ts_col, void* stream) {
  const Plan p = make_plan(B, L, T, arena, out);
  const cudaStream_t s = (cudaStream_t)stream;
  const cudaError_t err =
      p.vec ? launch_k<true>(p, arena, offsets, bases, out, ts_out, B, L, T,
                             ts_col, s)
            : launch_k<false>(p, arena, offsets, bases, out, ts_out, B, L, T,
                              ts_col, s);
  const cudaError_t last = cudaGetLastError();
  return (int)(err != cudaSuccess ? err : last);
}

// How a launch of this shape lays out its grid (for tests and reports):
// plan[0] the cluster size S, plan[1] the positions K a thread holds,
// plan[2] the threads of a block, plan[3] the positions a rank owns,
// plan[4] 1 when a position's lanes move as 16-byte words, else 0.
void fused_densify_plan(int B, int L, int T, const void* arena,
                        const void* out, int* plan) {
  const Plan p = make_plan(B, L, T, arena, out);
  plan[0] = p.S;
  plan[1] = p.K;
  plan[2] = p.threads;
  plan[3] = p.chunk;
  plan[4] = p.vec;
}

const char* cuda_error_string(int status) {
  return cudaGetErrorString((cudaError_t)status);
}

}  // extern "C"
