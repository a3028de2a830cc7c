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
//
// Blocks hold four warps so that B = 64 still spreads over 16 SMs.
//
// In bf16 every sum, the solve and the subtraction run in float and each
// output entry is rounded once.
//
// The Unmasked variant writes sigma = r - A^T w with the same w (the
// projection multipliers of `binding_bounds_coupled`): only the input is
// masked, the output is not.
#include "common.cuh"

namespace {

using benlsip::kWarpsPerBlock;
using benlsip::load;
using benlsip::store;
using benlsip::warp_sum;

template <typename T, int M, bool Unmasked>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
project_tangent_kernel(const T* __restrict__ A, long long strideA, const T* __restrict__ L,
                       const unsigned char* __restrict__ fixed, const T* __restrict__ R,
                       T* __restrict__ Out, int B, int n) {
  using C = benlsip::compute_t<T>;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (b >= B) return;  // uniform across the warp
  const T* a = A + static_cast<size_t>(b) * strideA;
  const T* l = L + static_cast<size_t>(b) * M * M;
  const unsigned char* fx = fixed + static_cast<size_t>(b) * n;
  const T* r = R + static_cast<size_t>(b) * n;
  T* out = Out + static_cast<size_t>(b) * n;

  // t = A Z r: per-lane partial sums over the free columns, then a warp sum.
  C t[M];
#pragma unroll
  for (int i = 0; i < M; ++i) t[i] = C(0);
  for (int j = lane; j < n; j += 32) {
    if (fx[j]) continue;
    const C rj = load(r + j);
#pragma unroll
    for (int i = 0; i < M; ++i) t[i] += load(a + static_cast<size_t>(i) * n + j) * rj;
  }
#pragma unroll
  for (int i = 0; i < M; ++i) t[i] = warp_sum(t[i]);

  // w = (L L^T)^{-1} t, the substitutions of cho_solve.cu, in every lane.
  C y[M];
#pragma unroll
  for (int i = 0; i < M; ++i) {
    C acc = t[i];
#pragma unroll
    for (int k = 0; k < i; ++k) acc = acc - load(l + i * M + k) * y[k];
    y[i] = acc / load(l + i * M + i);
  }
  C w[M];
#pragma unroll
  for (int i = M - 1; i >= 0; --i) {
    C acc = y[i];
#pragma unroll
    for (int k = i + 1; k < M; ++k) acc = acc - load(l + k * M + i) * w[k];
    w[i] = acc / load(l + i * M + i);
  }

  for (int j = lane; j < n; j += 32) {
    const bool is_fixed = fx[j] != 0;
    if (!Unmasked && is_fixed) {
      store(out + j, C(0));
      continue;
    }
    C s = C(0);
#pragma unroll
    for (int i = 0; i < M; ++i) s += load(a + static_cast<size_t>(i) * n + j) * w[i];
    store(out + j, load(r + j) - s);
  }
}

template <typename T, bool Unmasked>
int launch(const T* A, long long strideA, const T* L, const unsigned char* fixed, const T* R,
           T* Out, int B, int M, int n, void* stream) {
  if (B <= 0 || M < 1 || M > benlsip::kMaxDim || n < 1 || strideA < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int blocks = benlsip::blocks_for(B, kWarpsPerBlock);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (M) {
#define BENLSIP_CASE(MM)                                                          \
  case MM:                                                                        \
    project_tangent_kernel<T, MM, Unmasked><<<blocks, 32 * kWarpsPerBlock, 0, s>>>( \
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
BENLSIP_API int benlsip_project_tangent_f32(const float* A, long long strideA, const float* L,
                                            const unsigned char* fixed, const float* R, float* Out,
                                            int B, int M, int n, int unmasked_output,
                                            void* stream) {
  return unmasked_output ? launch<float, true>(A, strideA, L, fixed, R, Out, B, M, n, stream)
                         : launch<float, false>(A, strideA, L, fixed, R, Out, B, M, n, stream);
}

BENLSIP_API int benlsip_project_tangent_f64(const double* A, long long strideA, const double* L,
                                            const unsigned char* fixed, const double* R,
                                            double* Out, int B, int M, int n, int unmasked_output,
                                            void* stream) {
  return unmasked_output ? launch<double, true>(A, strideA, L, fixed, R, Out, B, M, n, stream)
                         : launch<double, false>(A, strideA, L, fixed, R, Out, B, M, n, stream);
}

BENLSIP_API int benlsip_project_tangent_bf16(const __nv_bfloat16* A, long long strideA,
                                             const __nv_bfloat16* L, const unsigned char* fixed,
                                             const __nv_bfloat16* R, __nv_bfloat16* Out, int B,
                                             int M, int n, int unmasked_output, void* stream) {
  return unmasked_output
             ? launch<__nv_bfloat16, true>(A, strideA, L, fixed, R, Out, B, M, n, stream)
             : launch<__nv_bfloat16, false>(A, strideA, L, fixed, R, Out, B, M, n, stream);
}
