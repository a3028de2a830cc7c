// Device code of the masked tangent projection shared by three kernels:
// project_tangent.cu (the projection's own warp form, one warp an instance,
// where the design is described) and the minor-iteration kernels
// (minor_iteration.cuh: minor_direction_r.cu and minor_loop_r.cu, whose
// block projects each CG residual, and the loop's reduced gradients, with
// its warps on operands in shared memory).  One copy of the arithmetic, so
// all give the same bits on the same operands.
#pragma once

#include "common.cuh"

namespace benlsip {
namespace tangent {

// w = (L L^T)^{-1} t, the substitutions of cho_solve.cu.
template <typename T, int M>
__device__ __forceinline__ void cho_solve(const T* l, const compute_t<T> (&t)[M], compute_t<T> (&w)[M]) {
  using C = compute_t<T>;
  C y[M];
#pragma unroll
  for (int i = 0; i < M; ++i) {
    C acc = t[i];
#pragma unroll
    for (int k = 0; k < i; ++k) acc = acc - load(l + i * M + k) * y[k];
    y[i] = acc / load(l + i * M + i);
  }
#pragma unroll
  for (int i = M - 1; i >= 0; --i) {
    C acc = y[i];
#pragma unroll
    for (int k = i + 1; k < M; ++k) acc = acc - load(l + k * M + i) * w[k];
    w[i] = acc / load(l + i * M + i);
  }
}

// One warp projects one instance: out_j = (Z r - Z A^T (L L^T)^{-1} A Z r)_j,
// Z = diag(!fixed) (Unmasked: out = r - A^T w for the same w), with a the
// instance's (M, n) rows of A, l its (M, M) lower factor, fx its n mask
// bytes and r its n-vector, each out_j handed to emit(j, out_j) by the lane
// that owns column j; `lane` is the calling thread's lane, and all 32 lanes
// of the warp call it.  The lanes stride over the n columns; the M dot
// products of A Z r are warp sums (the same bits in every lane), the
// substitutions run in every lane.
template <typename T, int M, bool Unmasked, typename Emit>
__device__ __forceinline__ void project_warp_emit(const T* __restrict__ a, const T* __restrict__ l,
                                                  const unsigned char* __restrict__ fx, const T* __restrict__ r,
                                                  int n, int lane, Emit&& emit) {
  using C = compute_t<T>;
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

  // w = (L L^T)^{-1} t in every lane.
  C w[M];
  cho_solve<T, M>(l, t, w);

  for (int j = lane; j < n; j += 32) {
    const bool is_fixed = fx[j] != 0;
    if (!Unmasked && is_fixed) {
      emit(j, C(0));
      continue;
    }
    C s = C(0);
#pragma unroll
    for (int i = 0; i < M; ++i) s += load(a + static_cast<size_t>(i) * n + j) * w[i];
    emit(j, load(r + j) - s);
  }
}

// project_warp_emit with each out_j stored to out (an n-vector that must
// not alias r).
template <typename T, int M, bool Unmasked>
__device__ __forceinline__ void project_warp(const T* __restrict__ a, const T* __restrict__ l,
                                             const unsigned char* __restrict__ fx, const T* __restrict__ r,
                                             T* __restrict__ out, int n, int lane) {
  project_warp_emit<T, M, Unmasked>(a, l, fx, r, n, lane, [out](int j, compute_t<T> v) { store(out + j, v); });
}

}  // namespace tangent
}  // namespace benlsip
