// grouped_gemm: the products of a mixture-of-experts layer's routed experts,
// one weight matrix a group of rows, over groups whose lengths only the card
// knows (bf16 operands, float32 sums, bf16 results).
//
// Replaces no TPU kernel. The reference's MoE (src/repro/models/moe.py
// _moe_inner) gives every expert a fixed capacity and runs one batched
// product over (E, cap, d), dropping the pairs past the capacity. A dropless
// layer has as many rows an expert as the router sends it, so the row counts
// are data: a batched product would need them on the host, which is a sync in
// the middle of the layer. Here the group boundaries are read on the card.
//
// Three forms, one kernel (`mode`). The rows of group g are
// [off[g], off[g + 1]) of the row arrays (`off` on the card, int64,
// off[0] = 0, nondecreasing, off[groups] <= rows); rows past off[groups] are
// neither read nor written. W is (groups, K, N):
//   FWD (0):  C[r, :] = A[r, :] @ W[g]          A (rows, K), C (rows, N)
//   DX  (1):  C[r, :] = A[r, :] @ W[g]^T        A (rows, N), C (rows, K)
//   DW  (2):  C[g]    = A[g's rows]^T @ D[g's rows]
//                                                A (rows, K), D (rows, N),
//                                                C (groups, K, N)
// DX and DW are FWD's gradients with respect to A and to W. A group with no
// rows gets a zero DW.
//
// Bound on an H100: the tensor cores. Each form does 2 * off[groups] * K * N
// operations and reads each operand once at least (2 bytes an element); at
// the MoE layer of DeepSeek-V2-Lite (K = 2048, N = 2 * 1408 or K = 1408,
// N = 2048) an expert's 1,536 rows give 1,536 * 2048 * 2816 * 2 = 17.7 GFLOP
// against 18 MB, some 1,000 operations a byte: above the 295 at which bf16
// products leave the memory behind, so 989.4 TFLOP/s is the bound.
//
// Design, right and simple first: one block computes a 128 x 128 tile of C
// with 8 warps, each 64 x 32 of it as 4 x 2 WMMA fragments of 16 x 16
// (mma.sync through nvcuda::wmma, bf16 in, float32 sums), two blocks an SM.
// The reduction steps 32 at a time through a ring of 4 shared-memory
// stages: cp.async keeps the next 3 steps' tiles in flight (16-byte copies,
// zero-filled past a group's end) while one is multiplied. Each operand is
// kept in shared memory as it lies in device memory, and the
// fragments are loaded row- or column-major to match, so no form transposes
// anything. FWD and DX give a block one row tile of one group: a block finds
// its group by walking the groups' tile counts (the grid has one block for
// every tile there could be, ceil(rows / 128) + groups, and the spare ones
// return at once). DW gives a block one tile of one group's (K, N) result
// and walks that group's rows. No wgmma, TMA or clusters yet (later work).

#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace {

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

constexpr int FWD = 0, DX = 1, DW = 2;
constexpr int BM = 128, BN = 128, BK = 32, PAD = 8;
constexpr int THREADS = 256;               // 8 warps: 2 along M, 4 along N
constexpr int WM = 64, WN = 32;            // a warp's part of the tile
constexpr int FM = WM / 16, FN = WN / 16;  // its fragments
// one buffer of an operand, the larger of its two layouts (elements)
constexpr int A_ELEMS = (BM * (BK + PAD) > BK * (BM + PAD)) ? BM * (BK + PAD)
                                                            : BK * (BM + PAD);
constexpr int B_ELEMS = (BK * (BN + PAD) > BN * (BK + PAD)) ? BK * (BN + PAD)
                                                            : BN * (BK + PAD);
constexpr int STAGES = 4;                  // reduction steps in shared memory
constexpr int SMEM_BYTES = STAGES * (A_ELEMS + B_ELEMS) * 2;
static_assert(2 * SMEM_BYTES <= 227 * 1024, "two blocks an SM");
static_assert(BM == BN, "a DW piece's A and D columns share an index");
static_assert(THREADS / 32 * 16 * 16 * 4 <= SMEM_BYTES, "epilogue scratch");

struct Args {
  const bf16* a;              // A
  const bf16* b;              // W (FWD, DX) or D (DW)
  bf16* c;
  const long long* off;       // groups + 1 row offsets
  long long rows;             // rows of A (and of C or D)
  int groups, k, n;           // W's (K, N)
};

// The operands' layouts in shared memory: A as it lies for FWD and DX (a row
// of the tile after another, row-major), as it lies for DW too (there the
// tile's rows are A's columns: column-major); W column-major for DX only.
template <int MODE>
struct Layout {
  typedef typename std::conditional<MODE == DW, wmma::col_major,
                                    wmma::row_major>::type A;
  typedef typename std::conditional<MODE == DX, wmma::col_major,
                                    wmma::row_major>::type B;
  static constexpr int LDA = MODE == DW ? BM + PAD : BK + PAD;
  static constexpr int LDB = MODE == DX ? BK + PAD : BN + PAD;
};

// One 16-byte piece from device memory into shared memory, in flight until
// the group it is committed with is waited for; `ok` false fills zeros and
// reads nothing (`gmem` then only has to be a valid address).
__device__ __forceinline__ void copy16(bf16* smem, const bf16* gmem, bool ok) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void wait_pending() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The tiles of the reduction step starting at `k0` (a reduction index: a
// column of A for FWD/DX, a row of the group for DW) into one stage of
// shared memory, each as it lies in device memory: two 16-byte pieces of
// the A tile and two of the B tile a thread, zero past a group's end.
template <int MODE>
__device__ __forceinline__ void issue(const Args& p, int g, long long row_end,
                                      long long row0, int m0, int n0,
                                      long long k0, bf16* sa, bf16* sb) {
  typedef Layout<MODE> L;
  const int t = threadIdx.x;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = t + i * THREADS;   // 512 pieces of 8 elements a tile
    if (MODE == DW) {
      // A tile: BK rows of the group x BM of A's columns (K); the D tile:
      // the same rows x BN of D's columns
      const int kr = c / (BM / 8), mc = (c % (BM / 8)) * 8;
      const long long r = k0 + kr;
      const bool ok = r < row_end;
      copy16(sa + kr * L::LDA + mc, ok && m0 + mc < p.k
             ? p.a + r * p.k + m0 + mc : p.a, ok && m0 + mc < p.k);
      copy16(sb + kr * L::LDB + mc, ok && n0 + mc < p.n
             ? p.b + r * p.n + n0 + mc : p.b, ok && n0 + mc < p.n);
    } else {
      // A tile: BM rows x BK reduction columns (K for FWD, N for DX)
      const int lda = MODE == FWD ? p.k : p.n;
      const int m = c / (BK / 8), kc = (c % (BK / 8)) * 8;
      const long long r = row0 + m;
      copy16(sa + m * L::LDA + kc, r < row_end ? p.a + r * lda + k0 + kc
                                               : p.a, r < row_end);
      const bf16* w = p.b + (long long)g * p.k * p.n;
      if (MODE == FWD) {
        // W tile: BK rows of W (K) x BN columns (N)
        const int kr = c / (BN / 8), nc = (c % (BN / 8)) * 8;
        const bool ok = n0 + nc < p.n;
        copy16(sb + kr * L::LDB + nc, ok ? w + (k0 + kr) * p.n + n0 + nc : w,
               ok);
      } else {
        // W^T tile: BN rows of W (the output's K) x BK of its columns (N)
        const bool ok = n0 + m < p.k;
        copy16(sb + m * L::LDB + kc,
               ok ? w + (long long)(n0 + m) * p.n + k0 + kc : w, ok);
      }
    }
  }
}

template <int MODE>
__device__ __forceinline__ void multiply(
    const bf16* sa, const bf16* sb, int wm, int wn,
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> (&acc)[FM][FN]) {
  typedef Layout<MODE> L;
#pragma unroll
  for (int kk = 0; kk < BK; kk += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, typename L::A> fa[FM];
    wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, typename L::B> fb[FN];
#pragma unroll
    for (int i = 0; i < FM; ++i) {
      const int m = wm * WM + i * 16;
      wmma::load_matrix_sync(fa[i], MODE == DW ? sa + kk * L::LDA + m
                                               : sa + m * L::LDA + kk,
                             L::LDA);
    }
#pragma unroll
    for (int j = 0; j < FN; ++j) {
      const int n = wn * WN + j * 16;
      wmma::load_matrix_sync(fb[j], MODE == DX ? sb + n * L::LDB + kk
                                               : sb + kk * L::LDB + n,
                             L::LDB);
    }
#pragma unroll
    for (int i = 0; i < FM; ++i)
#pragma unroll
      for (int j = 0; j < FN; ++j)
        wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
  }
}

template <int MODE>
__device__ void tile(const Args& p, unsigned char* smem) {
  int g;
  long long row0, row_end;  // FWD/DX: the tile's rows; DW: the group's
  int m0, n0;               // the tile's first row (DW: of K) and column
  const long long rows = p.rows;
  if (MODE == DW) {
    g = blockIdx.z;
    row0 = min(p.off[g], rows);
    row_end = min(p.off[g + 1], rows);
    m0 = blockIdx.x * BM;
  } else {
    long long t = blockIdx.x;
    for (g = 0; g < p.groups; ++g) {
      const long long lo = min(p.off[g], rows), hi = min(p.off[g + 1], rows);
      const long long tiles = hi > lo ? (hi - lo + BM - 1) / BM : 0;
      if (t < tiles) {
        row0 = lo + t * BM;
        row_end = hi;
        break;
      }
      t -= tiles;
    }
    if (g == p.groups) return;   // a spare block: no tile left
    m0 = 0;
  }
  n0 = blockIdx.y * BN;

  bf16* const stage0 = reinterpret_cast<bf16*>(smem);
  constexpr int STAGE = A_ELEMS + B_ELEMS;   // a stage: A's tile, then B's
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / (BN / WN), wn = warp % (BN / WN);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FM][FN];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  // reduction steps: K / BK (FWD), N / BK (DX), the group's rows (DW);
  // STAGES - 1 of them in flight ahead of the one multiplied, one commit
  // group a step (empty past the end, so that the counts stay even)
  const long long red = MODE == FWD ? p.k : (MODE == DX ? p.n : row_end - row0);
  const long long steps = (red + BK - 1) / BK;
  const long long kbase = MODE == DW ? row0 : 0;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < steps)
      issue<MODE>(p, g, row_end, row0, m0, n0, kbase + s * BK,
                  stage0 + s * STAGE, stage0 + s * STAGE + A_ELEMS);
    commit();
  }
  for (long long s = 0; s < steps; ++s) {
    wait_pending<STAGES - 2>();
    __syncthreads();   // step s has landed; step s - 1's stage is free
    const long long next = s + STAGES - 1;
    if (next < steps) {
      bf16* const st = stage0 + (int)(next % STAGES) * STAGE;
      issue<MODE>(p, g, row_end, row0, m0, n0, kbase + next * BK, st,
                  st + A_ELEMS);
    }
    commit();
    const bf16* const cur = stage0 + (int)(s % STAGES) * STAGE;
    multiply<MODE>(cur, cur + A_ELEMS, wm, wn, acc);
  }
  wait_pending<0>();
  __syncthreads();     // the stages are free for the epilogue's scratch

  // epilogue: each fragment through the warp's 16 x 16 float scratch, then
  // 8 bf16 a lane in one 16-byte store, rows past the end left alone
  float* scratch = reinterpret_cast<float*>(smem) + warp * 256;
  const int out_n = MODE == DX ? p.k : p.n;   // C's columns
  bf16* c = MODE == DW ? p.c + (long long)g * p.k * p.n : p.c;
  const int er = lane / 2, ec = (lane % 2) * 8;
#pragma unroll
  for (int i = 0; i < FM; ++i) {
#pragma unroll
    for (int j = 0; j < FN; ++j) {
      wmma::store_matrix_sync(scratch, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const long long r = (MODE == DW ? (long long)m0 : row0) + wm * WM +
                          i * 16 + er;
      const int col = n0 + wn * WN + j * 16 + ec;
      const bool ok = (MODE == DW ? r < p.k : r < row_end) && col < out_n;
      if (ok) {
        __align__(16) bf16 v[8];
#pragma unroll
        for (int e = 0; e < 8; ++e)
          v[e] = __float2bfloat16(scratch[er * 16 + ec + e]);
        *reinterpret_cast<uint4*>(c + r * out_n + col) =
            *reinterpret_cast<const uint4*>(v);
      }
      __syncwarp();
    }
  }
}

__global__ void __launch_bounds__(THREADS, 2) grouped_gemm_kernel(Args p,
                                                                  int mode) {
  extern __shared__ __align__(128) unsigned char smem[];
  if (mode == FWD) {
    tile<FWD>(p, smem);
  } else if (mode == DX) {
    tile<DX>(p, smem);
  } else {
    tile<DW>(p, smem);
  }
}

}  // namespace

extern "C" {

// One launch of `mode` on `stream`; returns a cudaError_t (0 on success).
// Pointers are the card's, 16-byte aligned; `a`, `b`, `c` as in the header
// (b is W for FWD and DX, D for DW); `off` holds groups + 1 int64 offsets;
// K and N are multiples of 32. C's rows past off[groups] are not written.
int grouped_gemm_launch(const void* a, const void* b, void* c,
                        const void* off, long long rows, int groups, int k,
                        int n, int mode, void* stream) {
  if (groups <= 0 || k <= 0 || n <= 0 || k % BK != 0 || n % BK != 0 ||
      rows < 0 || mode < FWD || mode > DW) {
    return (int)cudaErrorInvalidValue;
  }
  const Args p{(const bf16*)a, (const bf16*)b, (bf16*)c,
               (const long long*)off, rows, groups, k, n};
  dim3 grid;
  if (mode == DW) {
    grid = dim3((k + BM - 1) / BM, (n + BN - 1) / BN, groups);
  } else {
    // one block for every row tile there could be: each group's last tile
    // may be partial, so at most ceil(rows / BM) + groups of them
    const long long tiles = (rows + BM - 1) / BM + groups;
    const int out_n = mode == DX ? k : n;
    if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    grid = dim3((unsigned)tiles, (out_n + BN - 1) / BN, 1);
  }
  static bool sized = false;   // the dynamic shared memory allowed, once
  if (!sized) {
    const cudaError_t err = cudaFuncSetAttribute(
        grouped_gemm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    sized = true;
  }
  grouped_gemm_kernel<<<grid, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
      p, mode);
  return (int)cudaGetLastError();
}

const char* cuda_error_string(int status) {
  return cudaGetErrorString((cudaError_t)status);
}

}  // extern "C"
