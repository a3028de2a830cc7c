// The dual Newton of the exact polyhedral projection, one launch per call:
//
//   v = argmin 1/2 |v - x|^2  s.t.  A v = b,  l <= v <= u
//
// for A (B, m, n), b (B, m), l, u, x (B, n), solved in its dual by the damped
// semismooth Newton iteration of ops/polyproject.py: F(lam) = A clip(x -
// A^T lam, l, u) - b, the Newton matrix K = A D A^T + reg I with D the
// columns strictly inside their bounds, the exact line search on the concave
// dual, the monotone safeguard and the stall / cold-restart rescue.  Every
// instance runs its own iteration to its own exit; nothing goes back to the
// host between trips.
//
// Redesign for the H100 of the Pallas TPU kernel `batched_cho_solve` /
// `_cho_solve_kernel` (benlsip_tpu/kernels/batched_linalg.py:101,119) at its
// busiest remaining call site, the dual Newton of the JAX package's
// benlsip_tpu/ops/polyproject.py:162.  On the TPU the m x m solve was the
// kernel and XLA fused the ~200 small operations of a trip around it inside
// one while loop.  Eager PyTorch ran each trip as ~200 launches, the solve
// kernel one of them, plus one host sync to decide the next trip; a graph
// replay ran the same ~200 kernels under a conditional WHILE node.  Here the
// whole loop is the kernel: the factorisation (the body of cholesky.cu, in
// registers), the forward and backward substitution of cho_solve.cu, the
// line search, the safeguard and the exit test.
//
// What bounds it: latency.  A trip is three passes over A and ~150 short
// reductions over n (the bracket's 41 or 61 points and 17 points a section
// round), so the design keeps every value in registers, reduces without
// atomics in a fixed order (a lane's bits do not depend on its batch or its
// neighbours), and picks one of three layouts by the wrapper's plan
// (`newton_plan(m, n, dtype)` in ../batched_linalg.py, a function of the
// shape only):
//
//  * plan 0, the warp form with the grid on the lanes (n <= 32; configs 1, 2
//    and 5 at n = 3): one warp per instance.  The passes over A put column j
//    on lane j and reduce with warp_sum; the line search puts one grid point
//    on each lane, which evaluates phi(t) over the n columns in column order
//    (shuffled from their lanes).  The bracket's powers of two take two
//    rounds of 32 lanes and its first point with phi <= 0 is the lowest set
//    bit of a ballot; a section round takes 17 lanes and its count of
//    phi > 0 is the popcount of a ballot;
//  * plan 1, the warp form with the columns on the lanes (32 < n < 512;
//    config 3 at n = 192): one warp per instance, the lanes stride over the
//    columns, and each grid point's phi is a per-lane partial reduced by
//    warp_sum (41 or 61 points in one round, then 17 a section round);
//  * plan S >= 2, the split form (n >= 512; config 4 at n = 10,240): a
//    thread-block cluster of S blocks per instance, each block over its own
//    slice of the columns (split_slice in common.cuh); each reduction sums a
//    vector of partials over the block (warps, then the warps in order) and
//    then over the cluster's blocks in rank order through distributed shared
//    memory, read by every block, so the whole cluster holds the same bits
//    and takes the same branches.  The block sums are double-buffered, so a
//    reduction costs one cluster barrier.
// In every form each thread keeps the z and w = A^T dlam of its own columns
// in a workspace in device memory (2 n values an instance, read back only
// by the thread that wrote them), so the line search reads two values a
// column and never A.  A batch-shared A (stride 0) is read in place.
//
// The factor of K keeps the rules of masked_aat_cholesky.cu (IEEE sqrt, no
// pivot clamp: NaN from a non-SPD pivot on, in its own instance only); the
// solve divides by the diagonal as cho_solve.cu does.  An instance whose
// `active` entry is 0 runs no trip: v = clip(x - A^T lam0, l, u), lam = lam0
// (0 for a cold start), 0 trips, as the plain loop leaves such a lane.
//
// In bf16 every value is loaded into float, the iteration runs in float with
// the tolerances and line-search geometry the caller gives for bf16, and v
// and lam are rounded once.
#include "polyhedron_newton.cuh"

namespace {

using namespace benlsip::newton;
using benlsip::kWarpsPerBlock;

template <typename T, int M>
__global__ void __launch_bounds__(32 * kWarpsPerBlock) polyhedron_newton_kernel(const Args<T> p, bool lanes) {
  const int b = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (b >= p.B) return;  // uniform across the warp
  WarpTeam<benlsip::compute_t<T>> team{static_cast<int>(threadIdx.x & 31), 0, p.n};
  newton<T, M>(team, p, b, lanes);
}

template <typename T>
int launch(const Args<T>& p, int M, int plan, void* stream) {
  if (p.B <= 0 || M < 1 || M > benlsip::kMaxDim || p.n < 1 || p.strideA < 0 || p.max_iter < 0 ||
      p.grow_pows < 0 || p.grow_pows > kMaxGrid - 1 || p.n_section < 0 || plan < 0 ||
      plan > benlsip::kMaxCluster || (plan == 0 && p.n > kLanesMaxN)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (plan > 1) return static_cast<int>(launch_split<T>(p, M, plan, s));
  const int grid = benlsip::blocks_for(p.B, kWarpsPerBlock);
  switch (M) {
#define BENLSIP_CASE(MM)                                                                     \
  case MM:                                                                                   \
    polyhedron_newton_kernel<T, MM><<<grid, 32 * kWarpsPerBlock, 0, s>>>(p, plan == 0);      \
    break;
    BENLSIP_CASE(1) BENLSIP_CASE(2) BENLSIP_CASE(3) BENLSIP_CASE(4)
    BENLSIP_CASE(5) BENLSIP_CASE(6) BENLSIP_CASE(7) BENLSIP_CASE(8)
    BENLSIP_CASE(9) BENLSIP_CASE(10) BENLSIP_CASE(11) BENLSIP_CASE(12)
    BENLSIP_CASE(13) BENLSIP_CASE(14) BENLSIP_CASE(15) BENLSIP_CASE(16)
#undef BENLSIP_CASE
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int entry(const T* A, long long strideA, const T* b, const T* l, const T* u, const T* x, const T* lam0,
          const unsigned char* active, double tol, double reg, int max_iter, int grow_pows, int n_section, T* v,
          T* lam, int* iters, benlsip::compute_t<T>* ws, int B, int M, int n, int plan, void* stream) {
  using C = benlsip::compute_t<T>;
  const Args<T> p{A, strideA, b, l, u, x, lam0, active, v, lam, iters, ws,
                  B, n, max_iter, grow_pows, n_section, static_cast<C>(tol), static_cast<C>(reg)};
  return launch<T>(p, M, plan, stream);
}

}  // namespace

// lam0 and active may be null (a cold start; every instance).  ws: 2 * B * n
// values of the compute type (float for bf16).  plan: 0 the warp form with
// the grid on the lanes (n <= 32), 1 the warp form with the columns on the
// lanes, 2..16 a cluster of that many blocks per instance.
BENLSIP_API int benlsip_polyhedron_newton_f32(const float* A, long long strideA, const float* b, const float* l,
                                              const float* u, const float* x, const float* lam0,
                                              const unsigned char* active, double tol, double reg, int max_iter,
                                              int grow_pows, int n_section, float* v, float* lam, int* iters,
                                              float* ws, int B, int M, int n, int plan, void* stream) {
  return entry<float>(A, strideA, b, l, u, x, lam0, active, tol, reg, max_iter, grow_pows, n_section, v, lam,
                      iters, ws, B, M, n, plan, stream);
}

BENLSIP_API int benlsip_polyhedron_newton_bf16(const __nv_bfloat16* A, long long strideA, const __nv_bfloat16* b,
                                               const __nv_bfloat16* l, const __nv_bfloat16* u,
                                               const __nv_bfloat16* x, const __nv_bfloat16* lam0,
                                               const unsigned char* active, double tol, double reg, int max_iter,
                                               int grow_pows, int n_section, __nv_bfloat16* v, __nv_bfloat16* lam,
                                               int* iters, float* ws, int B, int M, int n, int plan,
                                               void* stream) {
  return entry<__nv_bfloat16>(A, strideA, b, l, u, x, lam0, active, tol, reg, max_iter, grow_pows, n_section, v,
                              lam, iters, ws, B, M, n, plan, stream);
}
