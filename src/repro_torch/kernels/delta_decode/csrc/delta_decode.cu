// delta_decode: row-wise inclusive prefix sum of (B, N) deltas plus the row
// base, in int32 (wrapping) or int64 (exact).
//
// Replaces the TPU kernel
// src/repro/kernels/delta_decode/delta_decode.py:40 delta_decode_kernel
// (pl.pallas_call at delta_decode.py:51, body _kernel at :28).
//
// What it computes, for each row b and column j < N:
//   out[b, j] = bases[b] + sum_{k <= j} deltas[b, k]
// in int64 if either input is int64, else in int32. The deltas and the bases
// are each read in their own width (int32 or int64) and an int32 input is
// sign-extended inside the kernel, so mixed inputs are one launch and no
// cast. The int32 path wraps in two's complement, bit for bit as
// jnp.cumsum(..., dtype=int32) + bases does; it is computed in uint32_t,
// since signed overflow is undefined in C++. The int64 path is the same scan
// in 64-bit words, exact for every timestamp an int64 holds. Rows may be
// strided (a column slice x[:, k:] is read in place); columns are unit-stride.
//
// Bound on an H100: memory. A call reads B*N deltas and B bases and writes
// B*N sums, one add an element. At B=32, N=2048 int32 that is 0.5 MB,
// 0.000157 ms at 3.35 TB/s, so the launch's own latency dominates at that
// shape; at B=1024, 16.8 MB, 0.005 ms.
//
// Design. The TPU kernel's grid runs in order, so a VMEM scratch carries the
// running sum from one 128-column block to the next; and since it carries in
// int32 only, its wrapper decodes int64 arenas window-relative and re-adds
// the base on the host. Blocks on the card run in no order, so the carry
// lives inside one block: one block per row walks the row in tiles of
// THREADS * ITEMS columns; each thread scans its ITEMS consecutive columns
// sequentially, a block-wide inclusive scan (warp shuffles, then a scan of
// the per-warp totals) adds the threads' totals, and the tile's total is
// carried to the next tile. A thread reads its ITEMS columns as one 16-byte
// vector (two for int64) and writes them the same way when every row of both
// the deltas and the output starts 16-byte aligned, so a warp's access covers
// a contiguous span; otherwise (N not a multiple of the vector, a slice that
// starts mid-row, a row's ragged end) it falls back to scalar accesses. The
// int64 path carries natively, so no host fallback is needed. At B=32 one
// block per row costs about one launch's latency on the device, which is
// under a tenth of a call; a scan split over several blocks would buy at most
// a microsecond there.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ITEMS = 4;  // consecutive columns a thread scans in a tile

// ITEMS values of X read or written as 16-byte accesses.
template <typename X>
struct alignas(16) Items {
  X v[ITEMS];
};

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

// DIn and BIn are the deltas' and the bases' types (int32_t or int64_t), T
// the output's, U its unsigned twin, in which every add is done: a signed
// input converts to U by sign extension, then wraps modulo 2^bits(U).
template <typename DIn, typename BIn, typename T, typename U, bool VECTOR>
__global__ void __launch_bounds__(THREADS)
delta_decode_kernel(const DIn* __restrict__ deltas, long long d_stride,
                    const BIn* __restrict__ bases, long long b_stride, int N,
                    T* __restrict__ out) {
  __shared__ U warp_sums[WARPS];
  const DIn* d = deltas + (long long)blockIdx.x * d_stride;
  T* o = out + (long long)blockIdx.x * N;
  U carry = static_cast<U>(static_cast<T>(bases[blockIdx.x * b_stride]));
  for (int tile = 0; tile < N; tile += THREADS * ITEMS) {
    const int c0 = tile + threadIdx.x * ITEMS;
    const bool whole = VECTOR && c0 + ITEMS <= N;
    DIn x[ITEMS];
    if (whole) {
      const Items<DIn> in = *reinterpret_cast<const Items<DIn>*>(d + c0);
#pragma unroll
      for (int k = 0; k < ITEMS; ++k) x[k] = in.v[k];
    } else {
#pragma unroll
      for (int k = 0; k < ITEMS; ++k) x[k] = c0 + k < N ? d[c0 + k] : DIn(0);
    }
    U part[ITEMS];
    U run = 0;
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      run += static_cast<U>(static_cast<T>(x[k]));
      part[k] = run;
    }
    U tile_total;
    const U inc = block_inclusive_scan<U>(run, warp_sums, &tile_total);
    const U before = carry + (inc - run);  // sum of every earlier column
    if (whole) {
      Items<T> res;
#pragma unroll
      for (int k = 0; k < ITEMS; ++k) res.v[k] = static_cast<T>(before + part[k]);
      *reinterpret_cast<Items<T>*>(o + c0) = res;
    } else {
#pragma unroll
      for (int k = 0; k < ITEMS; ++k) {
        if (c0 + k < N) o[c0 + k] = static_cast<T>(before + part[k]);
      }
    }
    carry += tile_total;
  }
}

// Whether every row of both the deltas and the output starts 16-byte
// aligned, so that a thread's ITEMS columns move as 16-byte vectors.
bool vector_rows(const void* deltas, long long d_stride, int d_bytes, int N,
                 const void* out, int out_bytes) {
  return reinterpret_cast<uintptr_t>(deltas) % 16 == 0 &&
         (d_stride * d_bytes) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(out) % 16 == 0 &&
         ((long long)N * out_bytes) % 16 == 0;
}

template <typename DIn, typename BIn, typename T, typename U>
int launch(const void* deltas, long long d_stride, const void* bases,
           long long b_stride, int B, int N, void* out, cudaStream_t stream) {
  if (vector_rows(deltas, d_stride, sizeof(DIn), N, out, sizeof(T))) {
    delta_decode_kernel<DIn, BIn, T, U, true><<<B, THREADS, 0, stream>>>(
        (const DIn*)deltas, d_stride, (const BIn*)bases, b_stride, N, (T*)out);
  } else {
    delta_decode_kernel<DIn, BIn, T, U, false><<<B, THREADS, 0, stream>>>(
        (const DIn*)deltas, d_stride, (const BIn*)bases, b_stride, N, (T*)out);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch on `stream`; returns a cudaError_t (0 on success). `deltas` is a
// (B, N) tensor with unit column stride and row stride `d_stride`, int32
// (d_wide 0) or int64 (1); `bases` a (B,) tensor with stride `b_stride`,
// int32 (b_wide 0) or int64 (1); `out` a contiguous (B, N) buffer, int64 if
// either input is, else int32. The caller guarantees B > 0 and N > 0.
int delta_decode_launch(const void* deltas, long long d_stride, int d_wide,
                        const void* bases, long long b_stride, int b_wide,
                        int B, int N, void* out, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  using U64 = unsigned long long;
  if (d_wide && b_wide) {
    return launch<int64_t, int64_t, int64_t, U64>(deltas, d_stride, bases,
                                                  b_stride, B, N, out, s);
  }
  if (d_wide) {
    return launch<int64_t, int32_t, int64_t, U64>(deltas, d_stride, bases,
                                                  b_stride, B, N, out, s);
  }
  if (b_wide) {
    return launch<int32_t, int64_t, int64_t, U64>(deltas, d_stride, bases,
                                                  b_stride, B, N, out, s);
  }
  return launch<int32_t, int32_t, int32_t, uint32_t>(deltas, d_stride, bases,
                                                     b_stride, B, N, out, s);
}

// 1 if a launch with these pointers and strides moves 16-byte vectors.
int delta_decode_vector_path(const void* deltas, long long d_stride,
                             int d_wide, int N, const void* out, int out_wide) {
  return vector_rows(deltas, d_stride, d_wide ? 8 : 4, N, out,
                     out_wide ? 8 : 4);
}

const char* cuda_error_string(int status) {
  return cudaGetErrorString((cudaError_t)status);
}

}  // extern "C"
