// Fused masked Gram matrix and Cholesky factor, one launch per call site:
//
//   L = chol(A Z A^T + reg I),   Z = diag(not fixed)
//
// for A (B, m, n) and a bool mask (B, n) of the fixed columns, as the
// active set keeps it; L (B, m, m) is lower with zeros above the diagonal.
//
// Redesign for the H100 of the Pallas TPU kernel `batched_cholesky` /
// `_cholesky_kernel` (benlsip_tpu/kernels/batched_linalg.py:44,74).  On the
// TPU the m x m factorisation was the kernel and XLA fused the mask, the
// product A Z A^T and the jitter around it under jit.  Eager PyTorch ran
// them as five to eight launches and wrote a masked (B, m, n) copy of A to
// device memory on the way, even for a batch that shares one A.  Here the
// whole call site is the kernel, and the factorisation is its last step.
//
// Two forms, chosen by the wrapper's plan (`fused_plan(m, n, dtype)` in
// ../batched_linalg.py: blocks per instance, a function of the shape and
// never of B, so that one lane gets the same bits in any batch):
//
// The warp form (plan 1; every n of configs 1, 2, 3 and 5, n <= 192).
// What bounds it: launch latency.  The bytes are A (once if shared), the
// mask and the factor: 10 KB at (512, m=1, n=3), 26-316 KB at
// (64, m=6, n=192), i.e. at most 0.1 us at 3.35 TB/s, and about
// B*m*(m+1)*n flops.  So the design is one launch with nothing in between:
//
//  * one warp owns one instance; its lanes stride over n (coalesced reads
//    of A's rows and of the mask) and accumulate the m(m+1)/2 masked dot
//    products of the lower triangle in registers;
//  * A is addressed through its batch stride in elements, so a shared A
//    (stride 0) is read in place and no masked copy is ever written;
//  * the sums are reduced with __shfl_xor_sync, which leaves the same
//    triangle in every lane, and reg is added to the diagonal;
//  * every lane runs the unrolled Cholesky-Banachiewicz of cholesky.cu on
//    that triangle in registers (M a template parameter, 1..16), with the
//    same contract: IEEE sqrt, no pivot clamp, so a non-SPD pivot gives NaN
//    from that column on, in its own instance only (the library is built
//    without --use_fast_math);
//  * the M*M entries of L are written round-robin by the lanes.
// Blocks hold four warps so that B = 64 still spreads over 16 SMs.  The
// warp's work is aat::warp_triangle and aat::factor_and_store of
// masked_aat.cuh, which the minor-loop kernel (minor_loop_r.cu) calls on its
// operands in shared memory: one copy of the arithmetic, the same bits in
// both kernels.
//
// The split form (plan S >= 2; one instance of large n, config 4's
// (1, 8, 10240)).  There one warp on one SM strides 320 times over the
// columns, each trip a dependent chain of memory latencies: 171 us for
// 0.34 MB.  What bounds the split form: latency again, now of one cluster
// launch, two cluster barriers and ceil(n / (S * 256)) trips of loads (a
// few microseconds), against a byte bound of 0.1 us.  So:
//
//  * a thread-block cluster of S blocks per instance, each block over its
//    own slice of the columns (split_slice in common.cuh), 256 threads each,
//    so n = 10,240 on 16 blocks is 2-3 columns a thread; the loads of a trip
//    are issued together (the loop is unrolled and only the sums are
//    predicated on the mask);
//  * each block reduces its threads' triangles (warp shuffles, then shared
//    memory in warp order), cluster.sync(), and block 0 adds the S partial
//    triangles in rank order through distributed shared memory; a second
//    cluster.sync() keeps every block resident until that read is done;
//  * one warp of block 0 then runs the same jitter, Cholesky and stores as
//    the warp form.
// No atomics and a fixed tree: two calls give the same bits.  The batch
// stride of A is read as in the warp form.
//
// In bf16 the sums, the jitter and the factorisation run in float (reg is
// rounded to float, as the float kernel rounds it) and L is rounded once.
#include "masked_aat.cuh"

namespace {

namespace cg = cooperative_groups;
using benlsip::kSplitThreads;
using benlsip::kSplitWarps;
using benlsip::kWarpsPerBlock;
using benlsip::load;
using benlsip::tri;

// Add the masked products of column j of a (row stride n) to the packed
// lower triangle c.  The loads are unconditional; only the sums are skipped
// for a fixed column, so that an unrolled loop issues a trip's loads together.
template <typename T, int M>
__device__ __forceinline__ void add_column(benlsip::compute_t<T> (&c)[M * (M + 1) / 2], const T* a,
                                           const unsigned char* fx, int n, int j) {
  using C = benlsip::compute_t<T>;
  const bool is_free = fx[j] == 0;
  C col[M];
#pragma unroll
  for (int i = 0; i < M; ++i) col[i] = load(a + static_cast<size_t>(i) * n + j);
  if (is_free) {
#pragma unroll
    for (int i = 0; i < M; ++i) {
#pragma unroll
      for (int k = 0; k <= i; ++k) c[tri(i, k)] += col[i] * col[k];
    }
  }
}

template <typename T, int M>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
masked_aat_cholesky_kernel(const T* __restrict__ A, long long strideA,
                           const unsigned char* __restrict__ fixed, benlsip::compute_t<T> reg,
                           T* __restrict__ L, int B, int n) {
  using C = benlsip::compute_t<T>;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (b >= B) return;  // uniform across the warp
  const T* a = A + static_cast<size_t>(b) * strideA;
  const unsigned char* fx = fixed + static_cast<size_t>(b) * n;

  // Lower triangle of A Z A^T, packed: c[tri(i, k)] = sum_j free_j a_ij a_kj.
  C c[M * (M + 1) / 2];
  benlsip::aat::warp_triangle<T, M>(c, a, fx, n, lane);
  // Every lane holds the same triangle, and so the same factor.
  benlsip::aat::factor_and_store<T, M>(c, reg, L + static_cast<size_t>(b) * M * M, lane);
}

template <typename T, int M>
__global__ void __launch_bounds__(kSplitThreads)
masked_aat_cholesky_split_kernel(const T* __restrict__ A, long long strideA,
                                 const unsigned char* __restrict__ fixed, benlsip::compute_t<T> reg,
                                 T* __restrict__ L, int n) {
  using C = benlsip::compute_t<T>;
  constexpr int K = M * (M + 1) / 2;
  __shared__ C scratch[kSplitWarps * K];
  __shared__ C part[K];
  cg::cluster_group cluster = cg::this_cluster();
  const int S = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.x / S;
  const T* a = A + static_cast<size_t>(b) * strideA;
  const unsigned char* fx = fixed + static_cast<size_t>(b) * n;
  const int2 slice = benlsip::split_slice(n, S, rank);

  C c[K];
#pragma unroll
  for (int e = 0; e < K; ++e) c[e] = C(0);
#pragma unroll (M <= 8 ? 4 : 2)
  for (int j = slice.x + static_cast<int>(threadIdx.x); j < slice.y; j += kSplitThreads) {
    add_column<T, M>(c, a, fx, n, j);
  }
  benlsip::block_sum<C, K>(c, scratch, part);
  cluster.sync();  // every block's partial triangle is in its shared memory
  if (rank == 0) benlsip::cluster_rank_sum(cluster, part, scratch, K);
  cluster.sync();  // block 0 has read them all; the others may leave
  if (rank != 0 || threadIdx.x >= 32) return;
#pragma unroll
  for (int e = 0; e < K; ++e) c[e] = scratch[e];
  benlsip::aat::factor_and_store<T, M>(c, reg, L + static_cast<size_t>(b) * M * M, static_cast<int>(threadIdx.x));
}

template <typename T>
int launch(const T* A, long long strideA, const unsigned char* fixed, double reg, T* L, int B, int M,
           int n, int blocks, void* stream) {
  if (B <= 0 || M < 1 || M > benlsip::kMaxDim || n < 1 || strideA < 0 || blocks < 1 ||
      blocks > benlsip::kMaxCluster) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  using C = benlsip::compute_t<T>;
  const C creg = static_cast<C>(reg);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (blocks > 1) {
    switch (M) {
#define BENLSIP_CASE(MM)                                                                             \
  case MM:                                                                                           \
    return static_cast<int>(benlsip::launch_cluster(masked_aat_cholesky_split_kernel<T, MM>, blocks, \
                                                    B, 0, s, A, strideA, fixed, creg, L, n));
      BENLSIP_CASE(1) BENLSIP_CASE(2) BENLSIP_CASE(3) BENLSIP_CASE(4)
      BENLSIP_CASE(5) BENLSIP_CASE(6) BENLSIP_CASE(7) BENLSIP_CASE(8)
      BENLSIP_CASE(9) BENLSIP_CASE(10) BENLSIP_CASE(11) BENLSIP_CASE(12)
      BENLSIP_CASE(13) BENLSIP_CASE(14) BENLSIP_CASE(15) BENLSIP_CASE(16)
#undef BENLSIP_CASE
    }
  }
  const int grid = benlsip::blocks_for(B, kWarpsPerBlock);
  switch (M) {
#define BENLSIP_CASE(MM)                                                      \
  case MM:                                                                    \
    masked_aat_cholesky_kernel<T, MM><<<grid, 32 * kWarpsPerBlock, 0, s>>>(   \
        A, strideA, fixed, creg, L, B, n);                                    \
    break;
    BENLSIP_CASE(1) BENLSIP_CASE(2) BENLSIP_CASE(3) BENLSIP_CASE(4)
    BENLSIP_CASE(5) BENLSIP_CASE(6) BENLSIP_CASE(7) BENLSIP_CASE(8)
    BENLSIP_CASE(9) BENLSIP_CASE(10) BENLSIP_CASE(11) BENLSIP_CASE(12)
    BENLSIP_CASE(13) BENLSIP_CASE(14) BENLSIP_CASE(15) BENLSIP_CASE(16)
#undef BENLSIP_CASE
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// blocks: the plan, 1 for the warp form, 2..16 for a cluster of that many
// blocks per instance.
BENLSIP_API int benlsip_masked_aat_cholesky_f32(const float* A, long long strideA,
                                                const unsigned char* fixed, double reg, float* L,
                                                int B, int M, int n, int blocks, void* stream) {
  return launch<float>(A, strideA, fixed, reg, L, B, M, n, blocks, stream);
}

BENLSIP_API int benlsip_masked_aat_cholesky_f64(const double* A, long long strideA,
                                                const unsigned char* fixed, double reg, double* L,
                                                int B, int M, int n, int blocks, void* stream) {
  return launch<double>(A, strideA, fixed, reg, L, B, M, n, blocks, stream);
}

BENLSIP_API int benlsip_masked_aat_cholesky_bf16(const __nv_bfloat16* A, long long strideA,
                                                 const unsigned char* fixed, double reg,
                                                 __nv_bfloat16* L, int B, int M, int n, int blocks,
                                                 void* stream) {
  return launch<__nv_bfloat16>(A, strideA, fixed, reg, L, B, M, n, blocks, stream);
}
