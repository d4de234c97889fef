// delta_decode: row-wise inclusive prefix sum of (B, N) deltas plus the row
// base, in int32 (wrapping) or int64 (exact).
//
// Replaces the TPU kernel
// src/repro/kernels/delta_decode/delta_decode.py:40 delta_decode_kernel
// (pl.pallas_call at delta_decode.py:51, body _kernel at :28).
//
// What it computes, for each row b and column j < N:
//   out[b, j] = bases[b] + sum_{k <= j} deltas[b, k]
// in the inputs' integer width. The int32 path wraps in two's complement, bit
// for bit as jnp.cumsum(..., dtype=int32) + bases does; it is computed in
// uint32_t, since signed overflow is undefined in C++. The int64 path is the
// same scan in 64-bit words, exact for every timestamp an int64 holds.
//
// Bound on an H100: memory. A call reads B*N deltas and B bases and writes
// B*N sums, one add an element. At B=32, N=2048 int32 that is 0.5 MB,
// 0.000157 ms at 3.35 TB/s, so launch overhead dominates at that shape.
//
// Design. The TPU kernel's grid runs in order, so a VMEM scratch carries the
// running sum from one 128-column block to the next; and since it carries in
// int32 only, its wrapper decodes int64 arenas window-relative and re-adds
// the base on the host. Blocks on the card run in no order, so the carry
// lives inside one block: one block per row walks the row in tiles of
// THREADS * ITEMS columns; each thread scans its ITEMS consecutive columns
// sequentially, a block-wide inclusive scan (warp shuffles, then a scan of
// the per-warp totals) adds the threads' totals, and the tile's total is
// carried to the next tile. The int64 path carries natively, so no host
// fallback is needed. A simple first version: B blocks fill only B of the
// 132 SMs.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ITEMS = 4;  // consecutive columns a thread scans in a tile

// Inclusive scan of x over the block, in the unsigned word U (wrapping);
// *total receives the block's sum. Every thread of the block must call it.
template <typename U>
__device__ U block_inclusive_scan(U x, U* warp_sums, U* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const U y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    U s = lane < WARPS ? warp_sums[lane] : U(0);
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const U y = __shfl_up_sync(0xffffffffu, s, o);
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

// T is the element type (int32_t or int64_t), U its unsigned twin, in which
// every add is done.
template <typename T, typename U>
__global__ void __launch_bounds__(THREADS)
delta_decode_kernel(const T* __restrict__ deltas, const T* __restrict__ bases,
                    int N, T* __restrict__ out) {
  __shared__ U warp_sums[WARPS];
  const long long row = (long long)blockIdx.x * N;
  const T* d = deltas + row;
  T* o = out + row;
  U carry = static_cast<U>(bases[blockIdx.x]);
  for (int tile = 0; tile < N; tile += THREADS * ITEMS) {
    const int c0 = tile + threadIdx.x * ITEMS;
    U part[ITEMS];
    U run = 0;
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      run += c0 + k < N ? static_cast<U>(d[c0 + k]) : U(0);
      part[k] = run;
    }
    U tile_total;
    const U inc = block_inclusive_scan<U>(run, warp_sums, &tile_total);
    const U before = carry + (inc - run);  // sum of every earlier column
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      if (c0 + k < N) o[c0 + k] = static_cast<T>(before + part[k]);
    }
    carry += tile_total;
  }
}

template <typename T, typename U>
int launch(const void* deltas, const void* bases, int B, int N, void* out,
           cudaStream_t stream) {
  delta_decode_kernel<T, U><<<B, THREADS, 0, stream>>>(
      (const T*)deltas, (const T*)bases, N, (T*)out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch on `stream`; returns a cudaError_t (0 on success). `deltas` is a
// contiguous (B, N) and `bases` a (B,) tensor, both int32 (wide = 0) or both
// int64 (wide = 1); `out` is a contiguous (B, N) buffer of the same type. The
// caller guarantees B > 0 and N > 0.
int delta_decode_launch(const void* deltas, const void* bases, int B, int N,
                        int wide, void* out, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (wide) {
    return launch<int64_t, unsigned long long>(deltas, bases, B, N, out, s);
  }
  return launch<int32_t, uint32_t>(deltas, bases, B, N, out, s);
}

const char* cuda_error_string(int status) {
  return cudaGetErrorString((cudaError_t)status);
}

}  // extern "C"
