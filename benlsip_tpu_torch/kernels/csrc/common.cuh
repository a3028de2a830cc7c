// Shared declarations of the hand-written Hopper kernels.
//
// Every kernel is exported through a plain C function that takes raw device
// pointers, the sizes and a cudaStream_t (as void*), launches on that stream
// without synchronising, and returns cudaGetLastError() as an int (0 = the
// launch was accepted).  The Python wrappers in ../batched_linalg.py load
// the library with ctypes and raise on a non-zero return.
#pragma once

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

}  // namespace benlsip
