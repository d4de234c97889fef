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
// plus B*L*8 bytes of int64 timestamps, and reads at most the kept
// B*min(len,L)*T*4 arena bytes plus offsets and bases. At B=32, L=2048, T=4
// that is about 1.5 MiB, under 1 us at 3.35 TB/s, so launch overhead
// dominates at the main path's shapes.
//
// Design. The TPU kernel DMAs a fixed L-row window from a front-padded,
// 128-lane-padded arena into VMEM; both pads were TPU DMA artifacts and are
// gone: a thread reads the arena only where its position is valid (source row
// >= offsets[b] is implied), and writes its T lanes of the (B, L, T) output
// directly (16 contiguous bytes for T=4; neighbouring threads write
// neighbouring positions, so stores coalesce). One block per row walks the
// window in tiles of BLOCK positions. The TPU grid carried nothing between
// rows, and the in-window cumsum becomes a block-wide inclusive scan
// (warp shuffles, then a scan of the per-warp totals) carried across tiles in
// int64, so timestamps above 2^31 decode exactly. A simple, correct first
// version: no TMA or cp.async, and B blocks fill only B of the 132 SMs.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int BLOCK = 256;
constexpr int WARPS = BLOCK / 32;

// Inclusive scan of x over the block; *total receives the block's sum.
// Every thread of the block must call it.
__device__ long long block_inclusive_scan(long long x, long long* warp_sums,
                                          long long* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    long long y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    long long s = lane < WARPS ? warp_sums[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      long long y = __shfl_up_sync(0xffffffffu, s, o);
      if (lane >= o) s += y;
    }
    if (lane < WARPS) warp_sums[lane] = s;
  }
  __syncthreads();
  if (warp > 0) x += warp_sums[warp - 1];
  *total = warp_sums[WARPS - 1];
  __syncthreads();  // warp_sums is reused by the next tile
  return x;
}

__global__ void __launch_bounds__(BLOCK)
fused_densify_kernel(const int32_t* __restrict__ arena,
                     const int32_t* __restrict__ offsets,
                     const int64_t* __restrict__ bases, int L, int T,
                     int ts_col, int32_t* __restrict__ out,
                     int64_t* __restrict__ ts_out) {
  __shared__ long long warp_sums[WARPS];
  const int b = blockIdx.x;
  const long long start = offsets[b];
  const long long end = offsets[b + 1];
  const long long len = end - start < L ? end - start : L;
  const long long first = L - len;          // first valid position
  const long long base = ts_col >= 0 ? bases[b] : 0;
  long long carry = 0;
  for (int tile = 0; tile < L; tile += BLOCK) {
    const int j = tile + threadIdx.x;
    const bool in = j < L;
    const bool valid = in && j >= first;
    const long long src = end - L + j;      // >= start whenever valid
    int32_t* o = out + ((long long)b * L + j) * T;
    long long delta = 0;
    for (int t = 0; t < T; ++t) {
      const int32_t v = valid ? arena[src * T + t] : 0;
      if (t == ts_col) {
        delta = v;
      } else if (in) {
        o[t] = v;
      }
    }
    if (ts_col >= 0) {
      long long tile_total;
      const long long inc = block_inclusive_scan(delta, warp_sums, &tile_total);
      if (in) {
        const long long ts = valid ? base + carry + inc : 0;
        o[ts_col] = (int32_t)(uint32_t)(unsigned long long)ts;
        ts_out[(long long)b * L + j] = ts;
      }
      carry += tile_total;
    }
  }
}

}  // namespace

extern "C" {

// Launch on `stream`; returns cudaGetLastError() (0 on success). The caller
// guarantees B > 0, L > 0, T > 0 and a non-empty arena; bases and ts_out may
// be null when ts_col < 0.
int fused_densify_launch(const void* arena, const void* offsets,
                         const void* bases, void* out, void* ts_out, int B,
                         int L, int T, int ts_col, void* stream) {
  fused_densify_kernel<<<B, BLOCK, 0, (cudaStream_t)stream>>>(
      (const int32_t*)arena, (const int32_t*)offsets, (const int64_t*)bases,
      L, T, ts_col, (int32_t*)out, (int64_t*)ts_out);
  return (int)cudaGetLastError();
}

const char* cuda_error_string(int status) {
  return cudaGetErrorString((cudaError_t)status);
}

}  // extern "C"
