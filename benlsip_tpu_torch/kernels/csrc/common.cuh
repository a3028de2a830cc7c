// Shared declarations of the hand-written Hopper kernels.
//
// Every kernel is exported through a plain C function that takes raw device
// pointers, the sizes and a cudaStream_t (as void*), launches on that stream
// without synchronising, and returns cudaGetLastError() as an int (0 = the
// launch was accepted).  The Python wrappers in ../batched_linalg.py load
// the library with ctypes and raise on a non-zero return.
//
// The five small kernels (all but blocked_qr.cu) are instantiated for
// float, double and __nv_bfloat16.  A bf16 kernel loads its operands,
// converts them to float, does all of its arithmetic in float and rounds
// each output once (round to nearest even, as Tensor.to(torch.bfloat16)
// does): the storage type T and the compute type compute_t<T> are kept
// apart by the trait below, and load/store convert between them.
//
// The two fused kernels also have a split form for one instance of large n:
// a thread-block cluster of S blocks per instance, each block over its own
// slice of the n columns, the partial sums reduced in a fixed tree (warp,
// block, then the cluster's blocks in rank order through distributed shared
// memory).  The helpers at the end of this file are that tree and the
// cluster launch.
#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define BENLSIP_API extern "C" __attribute__((visibility("default")))

namespace benlsip {

// Threads per block of the one-thread-per-instance kernels.
constexpr int kThreads = 128;

// Largest factor dimension of the unrolled kernels (the JAX gate,
// benlsip_tpu/ops/cholesky.py _PALLAS_MAX_M and ops/qr.py _PALLAS_MAX_N).
constexpr int kMaxDim = 16;

inline int blocks_for(int work, int per_block) {
  return (work + per_block - 1) / per_block;
}

// Warps per block of the one-warp-per-instance kernels: small blocks, so
// that a batch of 64 instances still spreads over 16 SMs.
constexpr int kWarpsPerBlock = 4;

// Index of entry (i, j), j <= i, of a lower triangle packed by rows.
__host__ __device__ constexpr int tri(int i, int j) { return i * (i + 1) / 2 + j; }

// The type a kernel computes in for storage type T: T itself, float for bf16.
template <typename T>
struct Compute {
  using type = T;
};
template <>
struct Compute<__nv_bfloat16> {
  using type = float;
};
template <typename T>
using compute_t = typename Compute<T>::type;

template <typename T>
__device__ __forceinline__ T load(const T* p) {
  return *p;
}
__device__ __forceinline__ float load(const __nv_bfloat16* p) { return __bfloat162float(*p); }

template <typename T>
__device__ __forceinline__ void store(T* p, compute_t<T> v) {
  *p = v;
}
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// Sum of v over the 32 lanes of a full warp; every lane gets the same bits
// (each butterfly step adds the same two values in both lanes of a pair).
// T is a compute type (float or double): bf16 is never shuffled.
template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) v += __shfl_xor_sync(0xffffffffu, v, offset);
  return v;
}

// reg on the diagonal (when non-zero), then Cholesky-Banachiewicz in place
// on the packed lower triangle c, in the order of cholesky.cu: IEEE sqrt and
// no pivot clamp, so a non-SPD pivot gives NaN from its column on (the
// library is built without --use_fast_math).  C is a compute type.
template <typename C, int M>
__device__ __forceinline__ void cholesky_in_place(C* c, C reg) {
  if (reg != C(0)) {
#pragma unroll
    for (int i = 0; i < M; ++i) c[tri(i, i)] = c[tri(i, i)] + reg;
  }
#pragma unroll
  for (int j = 0; j < M; ++j) {
    C acc = c[tri(j, j)];
#pragma unroll
    for (int q = 0; q < j; ++q) acc = acc - c[tri(j, q)] * c[tri(j, q)];
    const C d = sqrt(acc);
    c[tri(j, j)] = d;
    const C inv_d = C(1) / d;
#pragma unroll
    for (int i = j + 1; i < M; ++i) {
      C s = c[tri(i, j)];
#pragma unroll
      for (int q = 0; q < j; ++q) s = s - c[tri(i, q)] * c[tri(j, q)];
      c[tri(i, j)] = s * inv_d;
    }
  }
}

// ---------------------------------------------------------------------------
// The split form: one thread-block cluster per instance
// ---------------------------------------------------------------------------

// Threads of one block of the split form, and its warps.
constexpr int kSplitThreads = 256;
constexpr int kSplitWarps = kSplitThreads / 32;
// Most blocks in a cluster: 8 is portable, 16 needs the non-portable opt-in.
constexpr int kMaxCluster = 16;
constexpr int kPortableCluster = 8;

// Columns of a cluster block's slice of n: ceil(n / S) rounded up to whole
// warps, so that every row's loads stay coalesced.
__host__ __device__ constexpr int split_width(int n, int S) { return ((n + S - 1) / S + 31) / 32 * 32; }

// First column and end of block `rank`'s slice; a block past the end gets
// an empty slice (and sums to 0).
__device__ __forceinline__ int2 split_slice(int n, int S, int rank) {
  const int j0 = min(n, rank * split_width(n, S));
  return make_int2(j0, min(n, j0 + split_width(n, S)));
}

// Sum over the block of K values a thread: each value over its warp by
// warp_sum, then the warps' sums added in warp order by threads e < K into
// out[e].  scratch holds kSplitWarps * K values; both are shared memory.
// Ends with out[] written by its own threads only (no barrier after).
template <typename C, int K>
__device__ __forceinline__ void block_sum(const C (&v)[K], C* scratch, C* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int e = 0; e < K; ++e) {
    const C s = warp_sum(v[e]);
    if (lane == (e & 31)) scratch[warp * K + e] = s;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < K; e += kSplitThreads) {
    C acc = scratch[e];
    for (int w = 1; w < kSplitWarps; ++w) acc += scratch[w * K + e];
    out[e] = acc;
  }
}

// out[e] = the sum of part[e] over the cluster's blocks, read through
// distributed shared memory in rank order (0, 1, ..., S-1), for e < K, by
// threads e < K.  Every block that calls it gets the same bits.  The caller
// brackets it with cluster.sync(): before, so that every partial is
// written; after, so that no block leaves while its partial is read.
template <typename C>
__device__ __forceinline__ void cluster_rank_sum(cooperative_groups::cluster_group& cluster, C* part,
                                                 C* out, int K) {
  const unsigned S = cluster.num_blocks();
  for (int e = threadIdx.x; e < K; e += kSplitThreads) {
    C acc = *cluster.map_shared_rank(part + e, 0u);
    for (unsigned r = 1; r < S; ++r) acc += *cluster.map_shared_rank(part + e, r);
    out[e] = acc;
  }
}

// Launch `kernel` on a grid of S * B blocks of kSplitThreads in clusters of
// S (blockIdx.x / S is the instance), with `smem` bytes of dynamic shared
// memory.  A refused launch (no cluster of S fits, too much shared memory)
// returns its error; the last-error state is cleared either way, so that a
// refusal does not surface at a later launch.
template <typename... KArgs, typename... Args>
cudaError_t launch_cluster(void (*kernel)(KArgs...), int S, int B, size_t smem, cudaStream_t stream,
                           Args... args) {
  cudaError_t rc = cudaSuccess;
  if (S > kPortableCluster) {
    rc = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }
  if (rc == cudaSuccess && smem > 48 * 1024) {
    rc = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  }
  if (rc == cudaSuccess) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(static_cast<unsigned>(S) * static_cast<unsigned>(B));
    cfg.blockDim = dim3(kSplitThreads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = static_cast<unsigned>(S);
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    rc = cudaLaunchKernelEx(&cfg, kernel, args...);
  }
  const cudaError_t last = cudaGetLastError();
  return rc != cudaSuccess ? rc : last;
}

}  // namespace benlsip
