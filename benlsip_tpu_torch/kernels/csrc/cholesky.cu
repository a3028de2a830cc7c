// Batched lower Cholesky factorisation of B small SPD matrices.
//
// Replaces the Pallas TPU kernel `batched_cholesky` / `_cholesky_kernel`
// (benlsip_tpu/kernels/batched_linalg.py:44,74).  Same arithmetic in the
// same order: unrolled Cholesky-Banachiewicz, the pivot is an IEEE sqrt
// with no clamping (a non-SPD pivot gives NaN, as LAPACK's failure signal
// does), and the sub-diagonal entries are scaled by 1/d.
//
// What bounds it on the H100: nothing but launch latency and occupancy.
// The solver factors A Z A^T with M = m (1 for the exponential-fit
// family), so one call moves B*M*M*4 bytes (4 KB at B=1024) and does
// B*M^3/3 flops.  The TPU kernel put the batch on the 128-wide vector
// lanes in an (M, M, B) layout; here the batch maps to threads instead:
// one thread per instance, M a template parameter (1..16) so the loops
// unroll fully and the packed lower triangle (M(M+1)/2 values) lives in
// registers.  The layout stays the caller's row-major (B, M, M); the loads
// of one warp are strided by M*M, which costs nothing measurable at these
// sizes and saves the transposes the TPU layout needed.  In bf16 the
// triangle is held and computed in float and L is rounded once at the end.
#include "common.cuh"

namespace {

using benlsip::kThreads;
using benlsip::load;
using benlsip::store;
using benlsip::tri;

template <typename T, int M>
__global__ void __launch_bounds__(kThreads)
cholesky_kernel(const T* __restrict__ K, T* __restrict__ L, int B) {
  using C = benlsip::compute_t<T>;
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const T* k = K + static_cast<size_t>(b) * M * M;
  T* l = L + static_cast<size_t>(b) * M * M;

  C c[M * (M + 1) / 2];
#pragma unroll
  for (int j = 0; j < M; ++j) {
    C acc = load(k + j * M + j);
#pragma unroll
    for (int q = 0; q < j; ++q) acc = acc - c[tri(j, q)] * c[tri(j, q)];
    // No pivot clamping: sqrt of a negative pivot is NaN (IEEE sqrt; the
    // library is built without --use_fast_math).
    const C d = sqrt(acc);
    c[tri(j, j)] = d;
    const C inv_d = C(1) / d;
#pragma unroll
    for (int i = j + 1; i < M; ++i) {
      C s = load(k + i * M + j);
#pragma unroll
      for (int q = 0; q < j; ++q) s = s - c[tri(i, q)] * c[tri(j, q)];
      c[tri(i, j)] = s * inv_d;
    }
  }
#pragma unroll
  for (int i = 0; i < M; ++i) {
#pragma unroll
    for (int j = 0; j < M; ++j) store(l + i * M + j, j <= i ? c[tri(i, j)] : C(0));
  }
}

template <typename T>
int launch(const T* K, T* L, int B, int M, void* stream) {
  if (B <= 0 || M < 1 || M > benlsip::kMaxDim) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = benlsip::blocks_for(B, kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (M) {
#define BENLSIP_CASE(MM) \
  case MM:               \
    cholesky_kernel<T, MM><<<blocks, kThreads, 0, s>>>(K, L, B); \
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

BENLSIP_API int benlsip_cholesky_f32(const float* K, float* L, int B, int M, void* stream) {
  return launch<float>(K, L, B, M, stream);
}

BENLSIP_API int benlsip_cholesky_f64(const double* K, double* L, int B, int M, void* stream) {
  return launch<double>(K, L, B, M, stream);
}

BENLSIP_API int benlsip_cholesky_bf16(const __nv_bfloat16* K, __nv_bfloat16* L, int B, int M,
                                      void* stream) {
  return launch<__nv_bfloat16>(K, L, B, M, stream);
}

BENLSIP_API const char* benlsip_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
