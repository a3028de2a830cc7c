// Device code of the masked Gram factor L = chol(A Z A^T + reg I),
// Z = diag(!fixed), shared by masked_aat_cholesky.cu (its warp form, one
// warp an instance, where the design is described; the split form factors
// with factor_and_store too) and minor_loop_r.cu (the minor loop, whose block
// re-factors each new active set with one of its warps on operands in
// shared memory).  One copy of the arithmetic, so both give the same bits
// on the same operands.
#pragma once

#include "common.cuh"

namespace benlsip {
namespace aat {

// The packed lower triangle of A Z A^T over one warp, a the instance's
// (M, n) rows of A and fx its n mask bytes: the lanes stride over the
// columns and add each free column's products, then warp sums leave the
// same triangle in every lane.  All 32 lanes of the warp call it.
template <typename T, int M>
__device__ __forceinline__ void warp_triangle(compute_t<T> (&c)[M * (M + 1) / 2], const T* __restrict__ a,
                                              const unsigned char* __restrict__ fx, int n, int lane) {
  using C = compute_t<T>;
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
}

// reg on the diagonal, then Cholesky-Banachiewicz in place (common.cuh),
// the order of cholesky.cu; then entry e of the row-major (M, M) factor l,
// zeros above the diagonal, is written by lane e % 32 of the warp.
template <typename T, int M>
__device__ __forceinline__ void factor_and_store(compute_t<T> (&c)[M * (M + 1) / 2], compute_t<T> reg, T* l,
                                                 int lane) {
  using C = compute_t<T>;
  cholesky_in_place<C, M>(c, reg);
#pragma unroll
  for (int i = 0; i < M; ++i) {
#pragma unroll
    for (int j = 0; j < M; ++j) {
      if (lane == ((i * M + j) & 31)) store(l + i * M + j, j <= i ? c[tri(i, j)] : C(0));
    }
  }
}

}  // namespace aat
}  // namespace benlsip
