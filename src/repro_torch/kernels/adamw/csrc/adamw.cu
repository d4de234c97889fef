// adamw: one AdamW step over every float32 leaf of a model in two launches,
// a norm pass and an update pass, whatever the number of leaves.
//
// Replaces no TPU kernel. The reference's AdamW (src/repro/train/optimizer.py
// adamw_update) is jnp code that XLA fuses into one loop a leaf; run eagerly,
// the same arithmetic took about fifteen elementwise passes a leaf, each with
// its own launch and leaf-sized temporaries (m / bc1, v / bc2, the update).
//
// What it computes, for each leaf's elements, in float32:
//   gnorm = s * ||g||  over every leaf (or s * the caller's norm)
//   scale = s * min(1, clip / (gnorm + 1e-9))   (s alone when clip <= 0)
//   g <- g * scale
//   m <- b1 * m + (1 - b1) * g
//   v <- b2 * v + (1 - b2) * g * g
//   u  = (m / bc1) / (sqrt(v / bc2) + eps) + decay * p
//   p <- p - lr * u
// where s is the gradients' scale (1/n for a sum over n microbatches) and
// decay the leaf's weight decay (0 for a leaf outside the decay mask). The
// gradients are read and never written.
//
// Bound on an H100: memory. The norm pass reads g (4 B a parameter); the
// update pass reads p, g, m and v and writes p, m and v (28 B): 32 B a
// parameter, 3.35e12 B/s. At DLRM-UIH's 1,536,883,841 parameters that is
// 49.2 GB, 14.7 ms; at DCN-v2's 418,755,440, 13.4 GB, 4.0 ms.
//
// Design: each byte is streamed once a pass, and nothing is written beside
// the state. The leaves are cut into chunks of `chunk` elements; a table of
// leaves (pointers, length, first chunk, decay, alignment) built on the
// host lets a block find a chunk's leaf by binary search. Both passes run
// the same grid of at most `n_partials` blocks, each block walking the
// chunks blockIdx.x, blockIdx.x + gridDim.x, ... A thread moves four
// consecutive elements of each array as one 16-byte access where that
// array's leaf starts 16-byte aligned (one flag an array: a parameter that
// is a view into a flat buffer may not be), else as four 4-byte accesses;
// a length that is not a multiple of 4 ends in single elements. The norm
// pass sums squares in float32 within a chunk and in float64 across chunks,
// and each block writes its sum to partials[blockIdx.x]: no atomics, so the
// norm is the same from run to run. The update pass's blocks each reduce
// those partials in one fixed order to the global norm and form the scale
// on the card, so the host never waits for the norm.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int P_ALIGNED = 1, G_ALIGNED = 2, M_ALIGNED = 4, V_ALIGNED = 8;

// One row of the host's leaf table (56 bytes; ops.py's LEAF dtype).
struct Leaf {
  float* p;
  const float* g;
  float* m;
  float* v;
  long long n;       // elements
  long long chunk0;  // the index of its first chunk among all leaves'
  float decay;       // weight decay, 0 outside the decay mask
  int aligned;       // *_ALIGNED bits: the array starts 16-byte aligned
};
static_assert(sizeof(Leaf) == 56, "Leaf must match ops.py's LEAF dtype");

// The step's scalars, passed by value.
struct Step {
  float grad_scale, clip, lr, b1, omb1, b2, omb2, bc1, bc2, eps;
};

__device__ __forceinline__ float4 load4(const float* x, bool vec) {
  if (vec) return *reinterpret_cast<const float4*>(x);
  return make_float4(x[0], x[1], x[2], x[3]);
}

__device__ __forceinline__ void store4(float* x, float4 y, bool vec) {
  if (vec) {
    *reinterpret_cast<float4*>(x) = y;
  } else {
    x[0] = y.x;
    x[1] = y.y;
    x[2] = y.z;
    x[3] = y.w;
  }
}

// The leaf that holds chunk c: the last row whose chunk0 <= c.
__device__ __forceinline__ int find_leaf(const Leaf* leaves, int n_leaves,
                                         long long c) {
  int lo = 0, hi = n_leaves - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (leaves[mid].chunk0 <= c) lo = mid; else hi = mid - 1;
  }
  return lo;
}

// Sum of x over the block, in a fixed order; the result is in thread 0.
// Every thread of the block must call it.
__device__ double block_sum(double x, double* warp_sums) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
  if (lane == 0) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    x = lane < WARPS ? warp_sums[lane] : 0.0;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
  }
  return x;
}

__global__ void __launch_bounds__(THREADS)
adamw_norm_kernel(const Leaf* __restrict__ leaves, int n_leaves,
                  long long n_chunks, long long chunk,
                  double* __restrict__ partials) {
  __shared__ double warp_sums[WARPS];
  double acc = 0.0;
  for (long long c = blockIdx.x; c < n_chunks; c += gridDim.x) {
    const Leaf& L = leaves[find_leaf(leaves, n_leaves, c)];
    const float* g = L.g;
    const bool vec = L.aligned & G_ALIGNED;
    const long long lo = (c - L.chunk0) * chunk;
    const long long hi = lo + chunk < L.n ? lo + chunk : L.n;
    const long long hi4 = lo + ((hi - lo) & ~3LL);
    float part = 0.f;
#pragma unroll 4
    for (long long i = lo + 4 * threadIdx.x; i < hi4; i += 4 * THREADS) {
      const float4 x = load4(g + i, vec);
      part = fmaf(x.x, x.x, part);
      part = fmaf(x.y, x.y, part);
      part = fmaf(x.z, x.z, part);
      part = fmaf(x.w, x.w, part);
    }
    for (long long i = hi4 + threadIdx.x; i < hi; i += THREADS) {
      part = fmaf(g[i], g[i], part);
    }
    acc += (double)part;
  }
  acc = block_sum(acc, warp_sums);
  if (threadIdx.x == 0) partials[blockIdx.x] = acc;
}

__device__ __forceinline__ void adam(float& p, float g, float& m, float& v,
                                     float decay, float scale,
                                     const Step& s) {
  g *= scale;
  m = fmaf(s.omb1, g, s.b1 * m);
  v = fmaf(s.omb2, g * g, s.b2 * v);
  const float u = fmaf(decay, p, (m / s.bc1) / (sqrtf(v / s.bc2) + s.eps));
  p -= s.lr * u;
}

__global__ void __launch_bounds__(THREADS)
adamw_update_kernel(const Leaf* __restrict__ leaves, int n_leaves,
                    long long n_chunks, long long chunk,
                    const double* __restrict__ partials, int n_partials,
                    const float* __restrict__ given, Step s,
                    float* __restrict__ norm_out) {
  __shared__ double warp_sums[WARPS];
  __shared__ float shared_scale;
  float gnorm;
  if (given == nullptr) {
    double x = 0.0;
    for (int i = threadIdx.x; i < n_partials; i += THREADS) x += partials[i];
    x = block_sum(x, warp_sums);
    gnorm = (float)((double)s.grad_scale * sqrt(x));
  } else {
    gnorm = s.grad_scale * given[0];
  }
  if (threadIdx.x == 0) {
    shared_scale = s.clip > 0.f
                       ? s.grad_scale * fminf(1.f, s.clip / (gnorm + 1e-9f))
                       : s.grad_scale;
    if (blockIdx.x == 0) norm_out[0] = gnorm;
  }
  __syncthreads();
  const float scale = shared_scale;
  for (long long c = blockIdx.x; c < n_chunks; c += gridDim.x) {
    const Leaf& L = leaves[find_leaf(leaves, n_leaves, c)];
    float* const p = L.p;
    const float* const g = L.g;
    float* const m = L.m;
    float* const v = L.v;
    const float decay = L.decay;
    const bool vp = L.aligned & P_ALIGNED, vg = L.aligned & G_ALIGNED;
    const bool vm = L.aligned & M_ALIGNED, vv = L.aligned & V_ALIGNED;
    const long long lo = (c - L.chunk0) * chunk;
    const long long hi = lo + chunk < L.n ? lo + chunk : L.n;
    const long long hi4 = lo + ((hi - lo) & ~3LL);
    for (long long i = lo + 4 * threadIdx.x; i < hi4; i += 4 * THREADS) {
      float4 pp = load4(p + i, vp);
      const float4 gg = load4(g + i, vg);
      float4 mm = load4(m + i, vm);
      float4 vv4 = load4(v + i, vv);
      adam(pp.x, gg.x, mm.x, vv4.x, decay, scale, s);
      adam(pp.y, gg.y, mm.y, vv4.y, decay, scale, s);
      adam(pp.z, gg.z, mm.z, vv4.z, decay, scale, s);
      adam(pp.w, gg.w, mm.w, vv4.w, decay, scale, s);
      store4(p + i, pp, vp);
      store4(m + i, mm, vm);
      store4(v + i, vv4, vv);
    }
    for (long long i = hi4 + threadIdx.x; i < hi; i += THREADS) {
      adam(p[i], g[i], m[i], v[i], decay, scale, s);
    }
  }
}

}  // namespace

extern "C" {

// Launch both passes on `stream` (only the update pass when `given`, a
// one-element float32 norm of the gradients as handed, is not null);
// returns a cudaError_t (0 on success). `leaves` is the device copy of
// `n_leaves` Leaf rows covering `n_chunks` chunks of `chunk` elements (a
// multiple of 4 * THREADS); `partials` holds at least `n_partials` doubles,
// which also bounds the grid; `norm_out` receives gnorm (one float32).
int adamw_launch(const void* leaves, int n_leaves, long long n_chunks,
                 long long chunk, void* partials, int n_partials,
                 const void* given, float grad_scale, float clip, float lr,
                 float b1, float omb1, float b2, float omb2, float bc1,
                 float bc2, float eps, void* norm_out, void* stream) {
  if (chunk <= 0 || chunk % (4 * THREADS) != 0 || n_partials <= 0 ||
      (n_chunks > 0 && n_leaves <= 0)) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t st = (cudaStream_t)stream;
  const int grid =
      (int)(n_chunks < 1 ? 1 : (n_chunks < n_partials ? n_chunks : n_partials));
  const Leaf* table = (const Leaf*)leaves;
  if (given == nullptr) {
    adamw_norm_kernel<<<grid, THREADS, 0, st>>>(table, n_leaves, n_chunks,
                                                chunk, (double*)partials);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const Step s{grad_scale, clip, lr, b1, omb1, b2, omb2, bc1, bc2, eps};
  adamw_update_kernel<<<grid, THREADS, 0, st>>>(
      table, n_leaves, n_chunks, chunk, (const double*)partials, grid,
      (const float*)given, s, (float*)norm_out);
  return (int)cudaGetLastError();
}

const char* cuda_error_string(int status) {
  return cudaGetErrorString((cudaError_t)status);
}

}  // extern "C"
