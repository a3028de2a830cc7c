// Batched thin QR by modified Gram-Schmidt: A (B, D, N) -> Q (B, D, N), R (B, N, N).
//
// Replaces the Pallas TPU kernel `batched_thin_qr` / `_mgs_qr_kernel`
// (benlsip_tpu/kernels/batched_linalg.py:147,170).  Same arithmetic in the
// same order: for each column j, project out the earlier (already
// normalised) columns one at a time (r_kj = q_k . v, v -= q_k r_kj), then
// normalise by sqrt(max(v . v, tiny)), so R has a positive diagonal and a
// zero column never divides by zero.
//
// What bounds it on the H100: launch latency and the serial column loop.
// On the certification path it factors [JZ; D] at (B, 35, 3) and W^T at
// (B, 3, 1): about B*D*N*12 bytes and 2*B*D*N^2 flops per call.  The TPU
// kernel kept the batch on the vector lanes and reduced over D on the
// sublanes; here one warp owns one instance, the D rows are spread over its
// 32 lanes (a lane handles rows lane, lane+32, ...), and each dot product
// is a warp reduction with __shfl_xor_sync.  Column j of Q is written to
// global memory, updated in place and read back for the later columns, so
// register use does not grow with D (up to 2048) or N (up to 16).  Every
// lane touches only its own rows, so no block-level synchronisation is
// needed.
//
// In bf16 the columns are computed in float: the wrapper passes a float
// workspace W of A's shape, the kernel runs on W exactly as the float
// kernel runs on Q, and writes each finished column of Q and each entry of
// R rounded once to bf16.  For float and double W is Q itself.
#include <limits>
#include <type_traits>

#include "common.cuh"

namespace {

using benlsip::kWarpsPerBlock;
using benlsip::load;
using benlsip::store;
using benlsip::warp_sum;

template <typename T>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
mgs_qr_kernel(const T* __restrict__ A, T* Q, T* __restrict__ R,
              benlsip::compute_t<T>* W, int B, int D, int N, benlsip::compute_t<T> tiny) {
  using C = benlsip::compute_t<T>;
  constexpr bool kRounds = !std::is_same<T, C>::value;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (b >= B) return;  // uniform across the warp
  const size_t off = static_cast<size_t>(b) * D * N;
  const T* a = A + off;
  C* q = W + off;  // the columns in the compute type (Q itself unless T rounds)
  T* qo = Q + off;
  T* r = R + static_cast<size_t>(b) * N * N;

  for (int j = 0; j < N; ++j) {
    for (int i = lane; i < D; i += 32) q[i * N + j] = load(a + i * N + j);
    for (int k = 0; k < j; ++k) {
      C s = C(0);
      for (int i = lane; i < D; i += 32) s += q[i * N + k] * q[i * N + j];
      s = warp_sum(s);
      if (lane == 0) store(r + k * N + j, s);
      for (int i = lane; i < D; i += 32) q[i * N + j] = q[i * N + j] - q[i * N + k] * s;
    }
    C ss = C(0);
    for (int i = lane; i < D; i += 32) {
      const C v = q[i * N + j];
      ss += v * v;
    }
    ss = warp_sum(ss);
    // max(ss, tiny) with NaN propagating, as jnp.maximum / torch.maximum do.
    const C nrm = sqrt((ss > tiny || ss != ss) ? ss : tiny);
    if (lane == 0) {
      store(r + j * N + j, nrm);
      for (int k = j + 1; k < N; ++k) store(r + k * N + j, C(0));
    }
    for (int i = lane; i < D; i += 32) {
      const C v = q[i * N + j] / nrm;
      q[i * N + j] = v;
      if (kRounds) store(qo + i * N + j, v);
    }
  }
}

template <typename T>
int launch(const T* A, T* Q, T* R, benlsip::compute_t<T>* W, int B, int D, int N, void* stream) {
  using C = benlsip::compute_t<T>;
  if constexpr (std::is_same<T, C>::value) W = Q;
  if (B <= 0 || N < 1 || N > benlsip::kMaxDim || D < N || W == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int blocks = benlsip::blocks_for(B, kWarpsPerBlock);
  mgs_qr_kernel<T><<<blocks, 32 * kWarpsPerBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      A, Q, R, W, B, D, N, std::numeric_limits<C>::min());
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// work: a float workspace of B*D*N entries for bf16; ignored (may be null)
// for float and double, whose columns are computed in Q itself.
BENLSIP_API int benlsip_thin_qr_f32(const float* A, float* Q, float* R, void* work, int B, int D,
                                    int N, void* stream) {
  return launch<float>(A, Q, R, nullptr, B, D, N, stream);
}

BENLSIP_API int benlsip_thin_qr_f64(const double* A, double* Q, double* R, void* work, int B,
                                    int D, int N, void* stream) {
  return launch<double>(A, Q, R, nullptr, B, D, N, stream);
}

BENLSIP_API int benlsip_thin_qr_bf16(const __nv_bfloat16* A, __nv_bfloat16* Q, __nv_bfloat16* R,
                                     void* work, int B, int D, int N, void* stream) {
  return launch<__nv_bfloat16>(A, Q, R, static_cast<float*>(work), B, D, N, stream);
}
