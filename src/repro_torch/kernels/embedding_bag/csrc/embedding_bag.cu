// embedding_bag: masked, weighted bag sum of clamped-id table rows.
//
// Replaces the TPU kernel
// src/repro/kernels/embedding_bag/embedding_bag.py:57 embedding_bag_kernel
// (pl.pallas_call at embedding_bag.py:67, body _kernel at :24).
//
// What it computes, for each bag b of B:
//   out[b] = sum_l w[b, l] * table[clamp(ids[b, l], 0, V - 1)]
// a (B, D) result in the table's dtype (float32 or bf16). The weight w is the
// mask cast to the table's dtype by the wrapper, so a float mask weights
// positions. The id is clamped before its row is read: padded lanes carry
// arbitrary ids under weight 0 and must never address memory outside the
// table. A masked row is multiplied by its zero weight, not skipped, as the
// TPU kernel does, so a non-finite row turns the bag NaN in both.
//
// Bound on an H100: memory. A call reads B*L*D*itemsize bytes of gathered
// rows plus the ids and weights, and writes B*D*itemsize. At the serving
// shape (B=32, L=100, D=256 float32) that is 3.3 MB, about 1 us at
// 3.35 TB/s. The rows are random, so each is its own D*itemsize-byte read and
// what matters is how many row reads are in flight at once.
//
// Design. The TPU kernel fetches one row at a time by double-buffered DMA
// into VMEM and accumulates in the table's dtype; its lane pad of D to 128 was
// a DMA artifact and is gone. Here one block serves one (bag, D-chunk):
// threadIdx.x walks the row in 16-byte vectors (4 float32 or 8 bf16 values;
// one value a thread when D is not a multiple of that or the table is not
// 16-byte aligned), and threadIdx.y splits the bag's L positions into TY
// interleaved groups, each unrolled by 4, so up to 4*TY rows per thread column
// are in flight. The clamped ids and the weights are staged in shared memory
// a tile at a time. Each group accumulates in float32; the groups' partial
// sums are added in a fixed order through shared memory and rounded once to
// the table's dtype. A simple first version: no TMA or cp.async, and only B
// blocks (times the D chunks) share the 132 SMs.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;  // a block: TX vector lanes x TY position groups
constexpr int UNROLL = 4;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch rounds
}

// VEC values of T read or written as one access (16 bytes when VEC > 1).
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS)
embedding_bag_kernel(const T* __restrict__ table,
                     const int32_t* __restrict__ ids,
                     const T* __restrict__ weights, T* __restrict__ out,
                     int L, int D, int V) {
  __shared__ int32_t s_ids[THREADS];
  __shared__ float s_w[THREADS];
  __shared__ float s_acc[THREADS * VEC];
  using P = Pack<T, VEC>;
  const int tx = blockDim.x;
  const int ty = blockDim.y;
  const int tid = threadIdx.y * tx + threadIdx.x;
  const int b = blockIdx.x;
  const int vcol = blockIdx.y * tx + threadIdx.x;  // this thread's vector
  const bool active = vcol < D / VEC;
  const int32_t* bag_ids = ids + (long long)b * L;
  const T* bag_w = weights + (long long)b * L;

  float acc[VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) acc[v] = 0.f;

  for (int tile = 0; tile < L; tile += THREADS) {
    const int n = L - tile < THREADS ? L - tile : THREADS;
    if (tid < n) {
      const int32_t id = bag_ids[tile + tid];
      s_ids[tid] = id < 0 ? 0 : (id >= V ? V - 1 : id);  // clamp first
      s_w[tid] = to_f32(bag_w[tile + tid]);
    }
    __syncthreads();
    if (active) {
      int j = threadIdx.y;
      for (; j + (UNROLL - 1) * ty < n; j += UNROLL * ty) {
        P r[UNROLL];
        float w[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          const int p = j + u * ty;
          r[u] = reinterpret_cast<const P*>(table +
                                            (long long)s_ids[p] * D)[vcol];
          w[u] = s_w[p];
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
#pragma unroll
          for (int v = 0; v < VEC; ++v) acc[v] += to_f32(r[u].v[v]) * w[u];
        }
      }
      for (; j < n; j += ty) {
        const P r =
            reinterpret_cast<const P*>(table + (long long)s_ids[j] * D)[vcol];
        const float w = s_w[j];
#pragma unroll
        for (int v = 0; v < VEC; ++v) acc[v] += to_f32(r.v[v]) * w;
      }
    }
    __syncthreads();  // the next tile overwrites s_ids and s_w
  }

#pragma unroll
  for (int v = 0; v < VEC; ++v) s_acc[tid * VEC + v] = acc[v];
  __syncthreads();
  if (threadIdx.y == 0 && active) {
    P o;
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      float s = 0.f;
      for (int g = 0; g < ty; ++g) {
        s += s_acc[(g * tx + threadIdx.x) * VEC + v];
      }
      o.v[v] = from_f32<T>(s);
    }
    reinterpret_cast<P*>(out + (long long)b * D)[vcol] = o;
  }
}

template <typename T, int VEC>
int launch(const void* table, const void* ids, const void* weights, void* out,
           int B, int L, int D, int V, cudaStream_t stream) {
  const int nvec = D / VEC;
  int tx = 32;  // vector lanes: the least power of two >= nvec, 32..THREADS
  while (tx < nvec && tx < THREADS) tx *= 2;
  const dim3 block(tx, THREADS / tx);
  const dim3 grid(B, (nvec + tx - 1) / tx);
  embedding_bag_kernel<T, VEC><<<grid, block, 0, stream>>>(
      (const T*)table, (const int32_t*)ids, (const T*)weights, (T*)out, L, D,
      V);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* table, const void* ids, const void* weights,
             void* out, int B, int L, int D, int V, cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  const bool aligned = (reinterpret_cast<uintptr_t>(table) % 16 == 0) &&
                       (reinterpret_cast<uintptr_t>(out) % 16 == 0);
  if (aligned && D % VEC == 0) {
    return launch<T, VEC>(table, ids, weights, out, B, L, D, V, stream);
  }
  return launch<T, 1>(table, ids, weights, out, B, L, D, V, stream);
}

}  // namespace

extern "C" {

// Launch on `stream`; returns a cudaError_t (0 on success). dtype 0 is
// float32, 1 is bf16; ids are int32 and weights are in the table's dtype, all
// contiguous. The caller guarantees B > 0, L > 0, D > 0 and V > 0.
int embedding_bag_launch(const void* table, const void* ids,
                         const void* weights, void* out, int B, int L, int D,
                         int V, int dtype, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    return dispatch<float>(table, ids, weights, out, B, L, D, V, s);
  }
  if (dtype == 1) {
    return dispatch<__nv_bfloat16>(table, ids, weights, out, B, L, D, V, s);
  }
  return (int)cudaErrorInvalidValue;
}

const char* cuda_error_string(int status) {
  return cudaGetErrorString((cudaError_t)status);
}

}  // extern "C"
