// Fused masked tangent projection, one launch per call site:
//
//   out = Z r - Z A^T (L L^T)^{-1} A Z r,   Z = diag(!fixed)
//
// for A (B, m, n), L (B, m, m) lower, fixed (B, n) bool, r (B, n).
//
// Redesign for the H100 of the Pallas TPU kernel `batched_cho_solve` /
// `_cho_solve_kernel` (benlsip_tpu/kernels/batched_linalg.py:101,119).  On the
// TPU the m x m solve was the kernel and XLA fused its neighbours (the mask,
// the two small products with A, the subtraction) under jit.  Eager PyTorch
// fuses nothing: the same projection was seven to eight launches, each with
// a round trip through device memory for a few KB.  So the unit worth a
// kernel here is the whole projection, and the solve lives in its middle.
//
// Two forms, chosen by the wrapper's plan (`fused_plan(m, n, dtype)` in
// ../batched_linalg.py: blocks per instance, a function of the shape and
// never of B, so that one lane gets the same bits in any batch):
//
// The warp form (plan 1; every n of configs 1, 2, 3 and 5, n <= 192).
// What bounds it: launch latency.  The bytes are A (once if the batch shares
// it), L, r, the mask and the output: 25 KB at (512, m=1, n=3) and 0.12-0.41
// MB at (64, m=6, n=192), i.e. well under a microsecond at 3.35 TB/s, and
// about 4*B*m*n flops.  The design therefore minimises launches (one) and
// keeps every intermediate out of device memory:
//
//  * one warp owns one instance; its lanes stride over n, so the reads of
//    A's rows, r and the mask and the writes of the output are coalesced;
//  * A is addressed through its batch stride in elements, so a batch that
//    shares one (m, n) matrix (stride 0) is read in place, never expanded;
//  * the m dot products of A Z r are reduced with __shfl_xor_sync, which
//    leaves the same sums in every lane;
//  * every lane then runs the m x m forward and backward substitution
//    redundantly in registers (M is a template parameter, 1..16, so both
//    loops unroll), in the order of cho_solve.cu and with a division by the
//    diagonal: a NaN factor gives a NaN row in its own instance only;
//  * each lane writes its own entries of rz - free * (A^T w).
// Blocks hold four warps so that B = 64 still spreads over 16 SMs.  The
// warp's work is the device function tangent::project_warp of
// project_tangent.cuh, which the minor-iteration kernel
// (minor_direction_r.cu) calls on its operands in shared memory: one copy
// of the arithmetic, the same bits in both kernels.
//
// The split form (plan S >= 2; one instance of large n, config 4's
// (1, 8, 10240), where one warp strode 320 times over the columns in two
// passes: 171 us for 0.42 MB).  What bounds it: the latency of one cluster
// launch, two cluster barriers and two passes of ceil(n / (S * 256)) trips
// of loads, against a byte bound of 0.13 us.  Still one launch:
//
//  * a thread-block cluster of S blocks per instance, each block over its
//    own slice of the columns (split_slice in common.cuh), 256 threads each;
//  * each block forms its partial A Z r (m sums) and reduces it (warp
//    shuffles, then shared memory in warp order); cluster.sync();
//  * every block adds the S partials in rank order through distributed
//    shared memory, so every block holds the same bits, and a second
//    cluster.sync() keeps every block resident until all have read;
//  * every thread runs the m x m substitutions redundantly, as in the warp
//    form, and writes its own columns of the output;
//  * the first pass keeps the block's slice of A in shared memory (M rows
//    of ceil(n / S) columns rounded up to a warp: 20 KB at config 4), and
//    the second pass reads it there; a slice that does not fit in
//    kStageBytes is read again from device memory, where the same SM read
//    it microseconds before (0.33 MB of A against 50 MB of L2).  Both give
//    the same bits; staged was 7-14% less device time at n = 10,240 and
//    40,960 (PERF.md), and benlsip_project_tangent_reread_f32 keeps the
//    other variant measurable.
// No atomics and a fixed tree: two calls give the same bits.
//
// In bf16 every sum, the solve and the subtraction run in float and each
// output entry is rounded once.
//
// The Unmasked variant writes sigma = r - A^T w with the same w (the
// projection multipliers of `binding_bounds_coupled`): only the input is
// masked, the output is not.
#include "project_tangent.cuh"

namespace {

namespace cg = cooperative_groups;
using benlsip::kSplitThreads;
using benlsip::kSplitWarps;
using benlsip::kWarpsPerBlock;
using benlsip::load;
using benlsip::store;
using benlsip::tangent::cho_solve;

template <typename T, int M, bool Unmasked>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
project_tangent_kernel(const T* __restrict__ A, long long strideA, const T* __restrict__ L,
                       const unsigned char* __restrict__ fixed, const T* __restrict__ R,
                       T* __restrict__ Out, int B, int n) {
  const int b = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (b >= B) return;  // uniform across the warp
  benlsip::tangent::project_warp<T, M, Unmasked>(
      A + static_cast<size_t>(b) * strideA, L + static_cast<size_t>(b) * M * M,
      fixed + static_cast<size_t>(b) * n, R + static_cast<size_t>(b) * n, Out + static_cast<size_t>(b) * n, n,
      static_cast<int>(threadIdx.x & 31));
}

// Bytes of A a block may keep in shared memory for its second pass.
constexpr size_t kStageBytes = 200 * 1024;

// staged (uniform): the first pass keeps the block's slice of A in dynamic
// shared memory (M rows of the slice's width) and the second pass reads it
// there, else from device memory; each thread reads back only the entries
// it wrote, so no barrier is needed between the two.
template <typename T, int M, bool Unmasked>
__global__ void __launch_bounds__(kSplitThreads)
project_tangent_split_kernel(const T* __restrict__ A, long long strideA, const T* __restrict__ L,
                             const unsigned char* __restrict__ fixed, const T* __restrict__ R,
                             T* __restrict__ Out, int n, bool staged) {
  using C = benlsip::compute_t<T>;
  __shared__ C scratch[kSplitWarps * M];
  __shared__ C part[M];
  __shared__ C tot[M];
  extern __shared__ __align__(16) unsigned char staged_bytes[];
  cg::cluster_group cluster = cg::this_cluster();
  const int S = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.x / S;
  const unsigned char* fx = fixed + static_cast<size_t>(b) * n;
  const T* r = R + static_cast<size_t>(b) * n;
  T* out = Out + static_cast<size_t>(b) * n;
  const int2 slice = benlsip::split_slice(n, S, rank);
  // Row i, local column jj of this block's slice: a[i * ld + jj].
  const T* a = A + static_cast<size_t>(b) * strideA + slice.x;
  T* keep = reinterpret_cast<T*>(staged_bytes);
  const int width = slice.y - slice.x;

  // t = A Z r over this block's columns; loads unconditional, sums predicated.
  C t[M];
#pragma unroll
  for (int i = 0; i < M; ++i) t[i] = C(0);
#pragma unroll 4
  for (int jj = static_cast<int>(threadIdx.x); jj < width; jj += kSplitThreads) {
    const int j = slice.x + jj;
    const bool is_free = fx[j] == 0;
    const C rj = load(r + j);
    C col[M];
#pragma unroll
    for (int i = 0; i < M; ++i) {
      const T v = a[static_cast<size_t>(i) * n + jj];
      if (staged) keep[i * width + jj] = v;
      col[i] = load(&v);
    }
    if (is_free) {
#pragma unroll
      for (int i = 0; i < M; ++i) t[i] += col[i] * rj;
    }
  }
  benlsip::block_sum<C, M>(t, scratch, part);
  cluster.sync();  // every block's partial is in its shared memory
  benlsip::cluster_rank_sum(cluster, part, tot, M);
  cluster.sync();  // every block has read every partial; tot is visible block-wide

  C w[M];
#pragma unroll
  for (int i = 0; i < M; ++i) t[i] = tot[i];
  cho_solve<T, M>(L + static_cast<size_t>(b) * M * M, t, w);

  // The second pass; called once with the staged slice and once with A, so
  // that each inlined copy reads through its own address space.
  auto second_pass = [&](const T* src, size_t ld) {
#pragma unroll 4
    for (int jj = static_cast<int>(threadIdx.x); jj < width; jj += kSplitThreads) {
      const int j = slice.x + jj;
      const bool is_fixed = fx[j] != 0;
      C s = C(0);
#pragma unroll
      for (int i = 0; i < M; ++i) s += load(src + i * ld + jj) * w[i];
      store(out + j, (!Unmasked && is_fixed) ? C(0) : load(r + j) - s);
    }
  };
  if (staged) {
    second_pass(keep, static_cast<size_t>(width));
  } else {
    second_pass(a, static_cast<size_t>(n));
  }
}

// reread: the split form's second pass reads A from device memory even
// where its slice fits in shared memory (the measurement's other variant).
template <typename T, bool Unmasked>
int launch(const T* A, long long strideA, const T* L, const unsigned char* fixed, const T* R,
           T* Out, int B, int M, int n, int blocks, void* stream, bool reread = false) {
  if (B <= 0 || M < 1 || M > benlsip::kMaxDim || n < 1 || strideA < 0 || blocks < 1 ||
      blocks > benlsip::kMaxCluster || (reread && blocks == 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (blocks > 1) {
    const size_t slice_bytes = static_cast<size_t>(M) * benlsip::split_width(n, blocks) * sizeof(T);
    const bool staged = !reread && slice_bytes <= kStageBytes;
    const size_t smem = staged ? slice_bytes : 0;
    switch (M) {
#define BENLSIP_CASE(MM)                                                                          \
  case MM:                                                                                        \
    return static_cast<int>(benlsip::launch_cluster(project_tangent_split_kernel<T, MM, Unmasked>, \
                                                    blocks, B, smem, s, A, strideA, L, fixed, R,  \
                                                    Out, n, staged));
      BENLSIP_CASE(1) BENLSIP_CASE(2) BENLSIP_CASE(3) BENLSIP_CASE(4)
      BENLSIP_CASE(5) BENLSIP_CASE(6) BENLSIP_CASE(7) BENLSIP_CASE(8)
      BENLSIP_CASE(9) BENLSIP_CASE(10) BENLSIP_CASE(11) BENLSIP_CASE(12)
      BENLSIP_CASE(13) BENLSIP_CASE(14) BENLSIP_CASE(15) BENLSIP_CASE(16)
#undef BENLSIP_CASE
    }
  }
  const int grid = benlsip::blocks_for(B, kWarpsPerBlock);
  switch (M) {
#define BENLSIP_CASE(MM)                                                          \
  case MM:                                                                        \
    project_tangent_kernel<T, MM, Unmasked><<<grid, 32 * kWarpsPerBlock, 0, s>>>( \
        A, strideA, L, fixed, R, Out, B, n);                                      \
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

// unmasked_output = 0: the projection P r; != 0: sigma = r - A^T w.
// blocks: the plan, 1 for the warp form, 2..16 for a cluster of that many
// blocks per instance.
BENLSIP_API int benlsip_project_tangent_f32(const float* A, long long strideA, const float* L,
                                            const unsigned char* fixed, const float* R, float* Out,
                                            int B, int M, int n, int unmasked_output, int blocks,
                                            void* stream) {
  return unmasked_output
             ? launch<float, true>(A, strideA, L, fixed, R, Out, B, M, n, blocks, stream)
             : launch<float, false>(A, strideA, L, fixed, R, Out, B, M, n, blocks, stream);
}

BENLSIP_API int benlsip_project_tangent_f64(const double* A, long long strideA, const double* L,
                                            const unsigned char* fixed, const double* R,
                                            double* Out, int B, int M, int n, int unmasked_output,
                                            int blocks, void* stream) {
  return unmasked_output
             ? launch<double, true>(A, strideA, L, fixed, R, Out, B, M, n, blocks, stream)
             : launch<double, false>(A, strideA, L, fixed, R, Out, B, M, n, blocks, stream);
}

BENLSIP_API int benlsip_project_tangent_bf16(const __nv_bfloat16* A, long long strideA,
                                             const __nv_bfloat16* L, const unsigned char* fixed,
                                             const __nv_bfloat16* R, __nv_bfloat16* Out, int B,
                                             int M, int n, int unmasked_output, int blocks,
                                             void* stream) {
  return unmasked_output
             ? launch<__nv_bfloat16, true>(A, strideA, L, fixed, R, Out, B, M, n, blocks, stream)
             : launch<__nv_bfloat16, false>(A, strideA, L, fixed, R, Out, B, M, n, blocks, stream);
}

// The split form with its second pass reading A from device memory even
// where the slice fits in shared memory (float only, blocks >= 2): the
// other variant of the measurement in PERF.md, on no path.
BENLSIP_API int benlsip_project_tangent_reread_f32(const float* A, long long strideA,
                                                   const float* L, const unsigned char* fixed,
                                                   const float* R, float* Out, int B, int M, int n,
                                                   int unmasked_output, int blocks, void* stream) {
  return unmasked_output
             ? launch<float, true>(A, strideA, L, fixed, R, Out, B, M, n, blocks, stream, true)
             : launch<float, false>(A, strideA, L, fixed, R, Out, B, M, n, blocks, stream, true);
}
