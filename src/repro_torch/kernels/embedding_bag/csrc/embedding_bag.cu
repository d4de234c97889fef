// embedding_bag: masked, weighted bag sum (or mean) of clamped-id table rows.
//
// Replaces the TPU kernel
// src/repro/kernels/embedding_bag/embedding_bag.py:57 embedding_bag_kernel
// (pl.pallas_call at embedding_bag.py:67, body _kernel at :24), together with
// the mean combiner its wrapper applies (ops.py:26-33).
//
// What it computes, for each bag b of B, in the table's dtype T (float32 or
// bf16):
//   out[b] = round_T( sum_l round_T(w[b, l]) * table[clamp(id[b, l], 0, V-1)] )
// and for the mean combiner
//   out[b] = round_T( out[b] / round_T(max(sum_l w[b, l], 1)) ).
// It reads the caller's dtypes: ids as int32 or int64 and the mask w as bool,
// float32 or bf16, so a call is one launch. An int64 id keeps its low 32
// bits as a signed int32 before the clamp, as ids.to(int32) wraps, so
// 2^32 + 5 reads row 5. The id is clamped before its row is read: padded
// lanes carry arbitrary ids under weight 0 and must never address memory
// outside the table. A masked row is multiplied by its zero weight, not
// skipped, as the TPU kernel does, so a non-finite row turns the bag NaN in
// both. The mean's mask sum is an exact count for a bool mask (rounded to T
// afterwards: a bf16 count of 1935 is 1936) and is taken in float32 and
// rounded to the mask's dtype for a float mask.
//
// Bound on an H100: memory. A call reads B*L*D*itemsize bytes of gathered
// rows plus the ids and the mask, and writes B*D*itemsize. At the serving
// shape (B=32, L=100, D=256 float32) that is 3.3 MB, about 1 us at
// 3.35 TB/s; at L=2048, 67 MB, 20 us. The rows are random, so each is its
// own D*itemsize-byte read, and what bounds the kernel is how many bytes of
// rows are in flight at once: hiding HBM latency at 3.35 TB/s takes about
// 2-4 MB card-wide.
//
// Design. The TPU kernel fetches one row at a time by double-buffered DMA
// into VMEM and accumulates in the table's dtype; its lane pad of D to 128 was
// a DMA artifact and is gone. Here a bag's L positions are split over the S
// blocks of one thread-block cluster (S = 1, 2, 4 or 8, the portable limit),
// chosen so that the grid holds about two blocks an SM (264 on 132 SMs) and
// each block keeps at least 16 positions: S=8 at B=32, L=2048; S=4 at B=32,
// L=100; S=1 when B times the D chunks fills the card alone. Each block
// serves one (bag, rank, D-chunk): threadIdx.x walks the row in 16-byte
// vectors (4 float32 or 8 bf16 values; one value a thread when D is not a
// multiple of that or the table is not 16-byte aligned), and threadIdx.y
// splits the block's positions into TY interleaved groups, each unrolled by 4
// with the ragged end predicated, so up to 4*TY row reads per thread column
// are in flight. The clamped ids and the weights are staged in shared memory
// a tile at a time. Each group accumulates in float32, and the groups'
// partials are added in a fixed order in shared memory. Then cluster.sync():
// rank 0 reads the other ranks' partials (and, for the mean, their mask sums)
// through distributed shared memory, adds them in rank order, applies the
// mean, rounds once to T and writes. A last cluster.sync() keeps every block
// resident until rank 0 has read its shared memory. No float atomics: the
// result does not change from run to run. Rows are register loads; a
// cp.async.bulk ring in shared memory is the next step if this falls short.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;  // a block: TX vector lanes x TY position groups
constexpr int WARPS = THREADS / 32;
constexpr int UNROLL = 4;
constexpr int MAX_CLUSTER = 8;      // the portable cluster size
constexpr int TARGET_BLOCKS = 264;  // two blocks on each of the 132 SMs
constexpr int MIN_POSITIONS = 16;   // the least share of a bag a block takes

enum MaskKind { MASK_BOOL = 0, MASK_F32 = 1, MASK_BF16 = 2 };

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

// x rounded to T and back: the value a tensor of dtype T holds.
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

// The id at i as ids.to(int32) gives it: an int64 keeps its low 32 bits.
__device__ __forceinline__ int32_t load_id(const void* ids, long long i,
                                           int wide) {
  if (wide) {
    const unsigned long long x = static_cast<const unsigned long long*>(ids)[i];
    return static_cast<int32_t>(static_cast<uint32_t>(x));
  }
  return static_cast<const int32_t*>(ids)[i];
}

// The mask value at i, exactly, as a float.
__device__ __forceinline__ float load_mask(const void* mask, long long i,
                                           int kind) {
  if (kind == MASK_BOOL) {
    return static_cast<const uint8_t*>(mask)[i] ? 1.f : 0.f;
  }
  if (kind == MASK_F32) return static_cast<const float*>(mask)[i];
  return __bfloat162float(static_cast<const __nv_bfloat16*>(mask)[i]);
}

// VEC values of T read or written as one access (16 bytes when VEC > 1).
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS)
embedding_bag_kernel(const T* __restrict__ table, const void* __restrict__ ids,
                     const void* __restrict__ mask, T* __restrict__ out, int L,
                     int D, int V, int S, int id_wide, int mask_kind,
                     int mean) {
  __shared__ int32_t s_ids[THREADS];
  __shared__ float s_w[THREADS];
  __shared__ float s_acc[THREADS * VEC];  // group partials; [x*VEC] the sum
  __shared__ float s_msum[WARPS + 1];     // warp mask sums; [WARPS] the sum
  using P = Pack<T, VEC>;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int tx = blockDim.x;
  const int ty = blockDim.y;
  const int tid = threadIdx.y * tx + threadIdx.x;
  const long long b = blockIdx.x / S;
  const int vcol = blockIdx.y * tx + threadIdx.x;  // this thread's vector
  const bool active = vcol < D / VEC;
  const long long bag = b * L;
  const int share = (L + S - 1) / S;  // this rank's positions: [lo, hi)
  const int lo = min(L, rank * share);
  const int hi = min(L, lo + share);

  float acc[VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) acc[v] = 0.f;
  float msum = 0.f;  // the mask values this thread staged

  for (int tile = lo; tile < hi; tile += THREADS) {
    const int n = min(THREADS, hi - tile);
    if (tid < n) {
      const int32_t id = load_id(ids, bag + tile + tid, id_wide);
      s_ids[tid] = id < 0 ? 0 : (id >= V ? V - 1 : id);  // clamp first
      const float m = load_mask(mask, bag + tile + tid, mask_kind);
      s_w[tid] = round_to<T>(m);  // the weight in the table's dtype
      msum += m;
    }
    __syncthreads();
    if (active) {
      for (int j = threadIdx.y; j < n; j += UNROLL * ty) {
        P r[UNROLL];
        float w[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          const int p = j + u * ty;
          if (p < n) {
            r[u] = reinterpret_cast<const P*>(table +
                                              (long long)s_ids[p] * D)[vcol];
            w[u] = s_w[p];
          } else {  // past the share's end: no position, nothing read
#pragma unroll
            for (int v = 0; v < VEC; ++v) r[u].v[v] = from_f32<T>(0.f);
            w[u] = 0.f;
          }
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
#pragma unroll
          for (int v = 0; v < VEC; ++v) acc[v] += to_f32(r[u].v[v]) * w[u];
        }
      }
    }
    __syncthreads();  // the next tile overwrites s_ids and s_w
  }

  // This block's partial: the groups' sums in group order, in place in
  // group 0's slots; for the mean, the block's mask sum in warp order.
#pragma unroll
  for (int v = 0; v < VEC; ++v) s_acc[tid * VEC + v] = acc[v];
  if (mean) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      msum += __shfl_down_sync(0xffffffffu, msum, o);
    }
    if ((tid & 31) == 0) s_msum[tid >> 5] = msum;
  }
  __syncthreads();
  if (threadIdx.y == 0 && active) {
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      float s = 0.f;
      for (int g = 0; g < ty; ++g) s += s_acc[(g * tx + threadIdx.x) * VEC + v];
      s_acc[threadIdx.x * VEC + v] = s;
    }
  }
  if (mean && tid == 0) {
    float s = 0.f;
    for (int w = 0; w < WARPS; ++w) s += s_msum[w];
    s_msum[WARPS] = s;
  }
  cluster.sync();  // every rank's partial is in its shared memory

  if (rank == 0 && threadIdx.y == 0 && active) {
    float s[VEC];
#pragma unroll
    for (int v = 0; v < VEC; ++v) s[v] = s_acc[threadIdx.x * VEC + v];
    for (int r = 1; r < S; ++r) {
      const float* part = cluster.map_shared_rank(s_acc, r);
#pragma unroll
      for (int v = 0; v < VEC; ++v) s[v] += part[threadIdx.x * VEC + v];
    }
    P o;
    if (mean) {
      float m = s_msum[WARPS];
      for (int r = 1; r < S; ++r) m += cluster.map_shared_rank(s_msum, r)[WARPS];
      if (mask_kind == MASK_BF16) m = round_to<__nv_bfloat16>(m);
      // max(sum, 1) as torch.clamp gives it (a NaN stays NaN), then in T
      const float denom = round_to<T>(m < 1.f ? 1.f : m);
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        o.v[v] = from_f32<T>(__fdiv_rn(round_to<T>(s[v]), denom));
      }
    } else {
#pragma unroll
      for (int v = 0; v < VEC; ++v) o.v[v] = from_f32<T>(s[v]);
    }
    reinterpret_cast<P*>(out + b * D)[vcol] = o;
  }
  cluster.sync();  // no block leaves while rank 0 reads its shared memory
}

// The block's vector lanes: the least power of two >= nvec, 32..THREADS.
int lanes(int nvec) {
  int tx = 32;
  while (tx < nvec && tx < THREADS) tx *= 2;
  return tx;
}

// The cluster size: the largest power of two up to MAX_CLUSTER that keeps
// the grid within TARGET_BLOCKS and each block at MIN_POSITIONS or more.
int cluster_size(int B, int chunks, int L) {
  int s = 1;
  while (s < MAX_CLUSTER &&
         (long long)B * chunks * (2 * s) <= TARGET_BLOCKS &&
         L / (2 * s) >= MIN_POSITIONS) {
    s *= 2;
  }
  return s;
}

// Whether rows move as 16-byte vectors of VEC values: D a multiple of VEC
// and both the table and the output 16-byte aligned.
bool vector_rows(const void* table, const void* out, int D, int vec) {
  return reinterpret_cast<uintptr_t>(table) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(out) % 16 == 0 && D % vec == 0;
}

template <typename T, int VEC>
int launch(const void* table, const void* ids, const void* mask, void* out,
           int B, int L, int D, int V, int id_wide, int mask_kind, int mean,
           cudaStream_t stream) {
  const int tx = lanes(D / VEC);
  const int chunks = (D / VEC + tx - 1) / tx;
  const int S = cluster_size(B, chunks, L);

  cudaLaunchConfig_t cfg = {};
  // the S ranks of a bag are neighbours in x, so a cluster is one bag
  cfg.gridDim = dim3((unsigned)(S * B), (unsigned)chunks, 1);
  cfg.blockDim = dim3(tx, THREADS / tx, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = S;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, embedding_bag_kernel<T, VEC>, (const T*)table, ids, mask, (T*)out,
      L, D, V, S, id_wide, mask_kind, mean);
  const cudaError_t last = cudaGetLastError();
  return (int)(err != cudaSuccess ? err : last);
}

template <typename T>
int dispatch(const void* table, const void* ids, const void* mask, void* out,
             int B, int L, int D, int V, int id_wide, int mask_kind, int mean,
             cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  if (vector_rows(table, out, D, VEC)) {
    return launch<T, VEC>(table, ids, mask, out, B, L, D, V, id_wide,
                          mask_kind, mean, stream);
  }
  return launch<T, 1>(table, ids, mask, out, B, L, D, V, id_wide, mask_kind,
                      mean, stream);
}

}  // namespace

extern "C" {

// Launch on `stream`; returns a cudaError_t (0 on success). dtype 0 is a
// float32 table, 1 bf16; ids are int32 (id_wide 0) or int64 (1); mask_kind
// 0 is bool, 1 float32, 2 bf16; mean 1 applies the mean combiner. All
// tensors are contiguous. The caller guarantees B > 0, L > 0 (at most 2^24
// for the mean, whose float count is exact up to there), D > 0 and V > 0.
int embedding_bag_launch(const void* table, const void* ids, const void* mask,
                         void* out, int B, int L, int D, int V, int dtype,
                         int id_wide, int mask_kind, int mean, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (mask_kind < MASK_BOOL || mask_kind > MASK_BF16) {
    return (int)cudaErrorInvalidValue;
  }
  if (dtype == 0) {
    return dispatch<float>(table, ids, mask, out, B, L, D, V, id_wide,
                           mask_kind, mean, s);
  }
  if (dtype == 1) {
    return dispatch<__nv_bfloat16>(table, ids, mask, out, B, L, D, V, id_wide,
                                   mask_kind, mean, s);
  }
  return (int)cudaErrorInvalidValue;
}

// How a launch of this shape lays out its grid (for tests and reports):
// plan[0] the cluster size S, plan[1] the values a thread reads at a time
// (16 bytes' worth, or 1 on the scalar path), plan[2] the D-chunks.
void embedding_bag_plan(int B, int L, int D, int dtype, const void* table,
                        const void* out, int* plan) {
  const int vec = dtype == 0 ? 4 : 8;
  plan[1] = vector_rows(table, out, D, vec) ? vec : 1;
  const int tx = lanes(D / plan[1]);
  plan[2] = (D / plan[1] + tx - 1) / tx;
  plan[0] = cluster_size(B, plan[2], L);
}

const char* cuda_error_string(int status) {
  return cudaGetErrorString((cudaError_t)status);
}

}  // extern "C"
