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
//
// Blocks hold four warps so that B = 64 still spreads over 16 SMs.  In
// bf16 the sums, the jitter and the factorisation run in float (reg is
// rounded to float, as the float kernel rounds it) and L is rounded once.
#include "common.cuh"

namespace {

using benlsip::kWarpsPerBlock;
using benlsip::load;
using benlsip::store;
using benlsip::tri;
using benlsip::warp_sum;

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
  T* l = L + static_cast<size_t>(b) * M * M;

  // Lower triangle of A Z A^T, packed: c[tri(i, k)] = sum_j free_j a_ij a_kj.
  C c[M * (M + 1) / 2];
#pragma unroll
  for (int e = 0; e < M * (M + 1) / 2; ++e) c[e] = C(0);
  for (int j = lane; j < n; j += 32) {
    if (fx[j]) continue;
    C col[M];
#pragma unroll
    for (int i = 0; i < M; ++i) col[i] = load(a + static_cast<size_t>(i) * n + j);
#pragma unroll
    for (int i = 0; i < M; ++i) {
#pragma unroll
      for (int k = 0; k <= i; ++k) c[tri(i, k)] += col[i] * col[k];
    }
  }
#pragma unroll
  for (int e = 0; e < M * (M + 1) / 2; ++e) c[e] = warp_sum(c[e]);
  if (reg != C(0)) {
#pragma unroll
    for (int i = 0; i < M; ++i) c[tri(i, i)] = c[tri(i, i)] + reg;
  }

  // Cholesky-Banachiewicz in place, the order of cholesky.cu.
#pragma unroll
  for (int j = 0; j < M; ++j) {
    C acc = c[tri(j, j)];
#pragma unroll
    for (int q = 0; q < j; ++q) acc = acc - c[tri(j, q)] * c[tri(j, q)];
    // No pivot clamping: sqrt of a negative pivot is NaN.
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

  // Every lane holds the same factor; entry e is written by lane e % 32.
#pragma unroll
  for (int i = 0; i < M; ++i) {
#pragma unroll
    for (int j = 0; j < M; ++j) {
      if (lane == ((i * M + j) & 31)) store(l + i * M + j, j <= i ? c[tri(i, j)] : C(0));
    }
  }
}

template <typename T>
int launch(const T* A, long long strideA, const unsigned char* fixed, double reg, T* L, int B, int M,
           int n, void* stream) {
  if (B <= 0 || M < 1 || M > benlsip::kMaxDim || n < 1 || strideA < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int blocks = benlsip::blocks_for(B, kWarpsPerBlock);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (M) {
#define BENLSIP_CASE(MM)                                                        \
  case MM:                                                                      \
    masked_aat_cholesky_kernel<T, MM><<<blocks, 32 * kWarpsPerBlock, 0, s>>>(   \
        A, strideA, fixed, static_cast<benlsip::compute_t<T>>(reg), L, B, n);   \
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

BENLSIP_API int benlsip_masked_aat_cholesky_f32(const float* A, long long strideA,
                                                const unsigned char* fixed, double reg, float* L,
                                                int B, int M, int n, void* stream) {
  return launch<float>(A, strideA, fixed, reg, L, B, M, n, stream);
}

BENLSIP_API int benlsip_masked_aat_cholesky_f64(const double* A, long long strideA,
                                                const unsigned char* fixed, double reg, double* L,
                                                int B, int M, int n, void* stream) {
  return launch<double>(A, strideA, fixed, reg, L, B, M, n, stream);
}

BENLSIP_API int benlsip_masked_aat_cholesky_bf16(const __nv_bfloat16* A, long long strideA,
                                                 const unsigned char* fixed, double reg,
                                                 __nv_bfloat16* L, int B, int M, int n,
                                                 void* stream) {
  return launch<__nv_bfloat16>(A, strideA, fixed, reg, L, B, M, n, stream);
}
