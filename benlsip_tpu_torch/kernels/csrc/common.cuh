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
#pragma once

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

}  // namespace benlsip
