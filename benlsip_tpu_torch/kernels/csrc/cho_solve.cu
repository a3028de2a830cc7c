// Batched solve of (L L^T) x = b for small lower-triangular factors L.
//
// Replaces the Pallas TPU kernel `batched_cho_solve` / `_cho_solve_kernel`
// (benlsip_tpu/kernels/batched_linalg.py:101,119).  Same arithmetic in the
// same order: unrolled forward substitution L y = b, then backward
// substitution L^T x = y, each entry divided by the diagonal.
//
// What bounds it on the H100: launch latency.  It runs in every tangent
// projection of the f32 bulk solve with M = m (1 for the exponential-fit
// family): B*(M*M + 2M)*4 bytes and ~2*B*M^2 flops per call.  The TPU
// kernel put the batch on the vector lanes in a batch-last layout; here one
// thread owns one instance, M is a template parameter (1..16) so both
// substitutions unroll and y, x stay in registers, and the caller's
// row-major (B, M, M) / (B, M) layout is read directly.
#include "common.cuh"

namespace {

using benlsip::kThreads;

template <typename T, int M>
__global__ void __launch_bounds__(kThreads)
cho_solve_kernel(const T* __restrict__ L, const T* __restrict__ rhs, T* __restrict__ X, int B) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const T* l = L + static_cast<size_t>(b) * M * M;
  const T* r = rhs + static_cast<size_t>(b) * M;
  T* x = X + static_cast<size_t>(b) * M;

  T y[M];
#pragma unroll
  for (int i = 0; i < M; ++i) {
    T acc = r[i];
#pragma unroll
    for (int k = 0; k < i; ++k) acc = acc - l[i * M + k] * y[k];
    y[i] = acc / l[i * M + i];
  }
  T z[M];
#pragma unroll
  for (int i = M - 1; i >= 0; --i) {
    T acc = y[i];
#pragma unroll
    for (int k = i + 1; k < M; ++k) acc = acc - l[k * M + i] * z[k];
    z[i] = acc / l[i * M + i];
  }
#pragma unroll
  for (int i = 0; i < M; ++i) x[i] = z[i];
}

template <typename T>
int launch(const T* L, const T* rhs, T* X, int B, int M, void* stream) {
  if (B <= 0 || M < 1 || M > benlsip::kMaxDim) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = benlsip::blocks_for(B, kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (M) {
#define BENLSIP_CASE(MM) \
  case MM:               \
    cho_solve_kernel<T, MM><<<blocks, kThreads, 0, s>>>(L, rhs, X, B); \
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

BENLSIP_API int benlsip_cho_solve_f32(const float* L, const float* rhs, float* X, int B, int M,
                                      void* stream) {
  return launch<float>(L, rhs, X, B, M, stream);
}

BENLSIP_API int benlsip_cho_solve_f64(const double* L, const double* rhs, double* X, int B, int M,
                                      void* stream) {
  return launch<double>(L, rhs, X, B, M, stream);
}
