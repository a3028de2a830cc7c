// The minor iteration of solver/inner.minor_iterate on the materialized
// Gauss-Newton operator R (R^T R = H, ops/al.with_r_factor_cholqr2 or
// with_r_factor), one launch per minor iteration, each instance to its own
// exit:
//
//   1. the free-variable box w_l, w_u from x, s, delta and the bounds;
//   2. solver/cg.projected_cg: v0 = P(g), the tolerances, and every CG trip
//      until the instance's status leaves CG_RUNNING (it caps itself at
//      2 (n - m - #fixed) trips);
//   3. solver/cg.linesearch along the CG direction w;
//   4. w <- alpha w unless the CG ended on negative curvature.
//
// for R (B, k, n), A (B, m, n), L (B, m, m) the lower factor of A Z A^T,
// fixed (B, n), x, s, g, xl, xu (B, n) and delta (B,), float32 only.
//
// It replaces no TPU kernel: the JAX package's CG is plain lax.while_loop
// code that XLA fuses.  Eager PyTorch ran each CG trip as ~85 launches and a
// host sync, and a graph replay ran the same ~85 nodes under a conditional
// WHILE node (with the carry's copies and the guard), ~180 nodes a minor
// iteration in all; at ~1.9 us a node that was the bulk's time, not its
// bytes or its flops.  Here the minor iteration is one node.  Its device
// code is minor::iteration (minor_iteration.cuh), which minor_loop_r.cu
// runs once a trip of the whole minor loop.
//
// What bounds it: per instance, R (147 KB at n = 192) read once from device
// memory, and 4 k n flops a CG trip (R p, then R^T (R p)) plus 2 k n for the
// line search: ~0.15 MFLOP a trip, against 67 TFLOP/s over the card.  The
// trips of one instance are a chain of dependent reductions, so the design
// keeps one instance on one SM with everything on chip:
//
//  * one block of 256 threads an instance (B = 64 fills 64 of 132 SMs); R,
//    the rows of A, L, the mask and the vectors the warps share (p, R p,
//    the residual and its projection) in dynamic shared memory for the whole
//    launch, R copied in once by cp.async while the first projection runs;
//  * thread j owns column j (n <= 256), so w, r, p, H p, g and the box of
//    column j stay in its registers, and every elementwise update is one
//    instruction a thread, in the order and rounding of the plain version's
//    torch ops (this source is built with --fmad=false);
//  * R p: each warp takes rows in groups of four, its lanes over the
//    columns (conflict-free reads of R's rows), warp sums; R^T u: thread j
//    down column j (conflict-free, u broadcast) with four accumulators; both
//    in float32 fused multiply-add (fmaf), no TF32;
//  * the projections P(g) and P(r) run in one warp through
//    tangent::project_warp (project_tangent.cuh), the device function of the
//    project_tangent kernel, on the operands in shared memory;
//  * each scalar of a trip (p^T H p, p^T p, the step to the box, r^T v) is
//    a block reduction in a fixed tree (warp sums, then the warps in order),
//    read back by every thread, so every thread holds the same bits and
//    takes the same branches; no atomics: two calls give the same bits, and
//    a lane's bits do not depend on its batch (the plan is one block an
//    instance whatever B).
// An instance whose status is not CG_RUNNING at entry, or that is not
// active, runs no trip and returns what the plain version returns: w = 0,
// its entry status, 0 iterations.  The outputs equal the plain version's
// up to float32 summation order (the matrix products and the sums).
#include "minor_iteration.cuh"

namespace {

namespace mi = benlsip::minor;

struct Params {
  const float* R;
  const float* A;
  long long strideA;              // A's batch stride in elements (0: one A for the batch)
  const float* L;
  const unsigned char* fixed;
  const float* x;
  const float* s;
  const float* g;
  const float* xl;
  long long strideXl;             // the bounds' batch strides (0: shared)
  const float* xu;
  long long strideXu;
  const float* delta;
  const unsigned char* active;    // null: every instance
  float kappa2;
  float atol;                     // the curvature test's (sqrt(eps))
  float bound_atol;               // factor_to_boundary's: |p_i| below it does not bind
  float* w;
  int* status;
  int* iters;
  int k, n;
};

template <int M>
__global__ void __launch_bounds__(mi::kThreads) minor_direction_r_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.x, j = threadIdx.x;
  const int n = p.n, k = p.k;
  const mi::Block sh = mi::carve(smem, k, M, n);

  // R into shared memory, asynchronously where it is 16-byte aligned, while
  // A, L and the first projection are read.
  const bool async = mi::load_r(sh, p.R + static_cast<size_t>(b) * k * n, k, n);
  const float* Ag = p.A + static_cast<size_t>(b) * p.strideA;
  for (int q = j; q < M * n; q += mi::kThreads) sh.As[q] = Ag[q];
  for (int q = j; q < M * M; q += mi::kThreads) sh.Ls[q] = p.L[static_cast<size_t>(b) * M * M + q];

  mi::Column c{};
  if (j < n) {
    const size_t o = static_cast<size_t>(b) * n + j;
    c = mi::Column{p.x[o], p.s[o], p.g[o], p.xl[static_cast<size_t>(b) * p.strideXl + j],
                   p.xu[static_cast<size_t>(b) * p.strideXu + j], p.delta[b], p.fixed[o] != 0};
  }
  const bool active = p.active == nullptr || p.active[b] != 0;
  const mi::Step st = mi::iteration<M>(sh, c, k, n, active, mi::Tolerances{p.kappa2, p.atol, p.bound_atol}, async);
  if (j < n) p.w[static_cast<size_t>(b) * n + j] = st.w;
  if (j == 0) {
    p.status[b] = st.status;
    p.iters[b] = st.iters;
  }
}

template <int M>
cudaError_t launch_m(const Params& p, int B, size_t smem, cudaStream_t s) {
  cudaError_t rc = cudaSuccess;
  if (smem > 48 * 1024) {
    rc = cudaFuncSetAttribute(minor_direction_r_kernel<M>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
  }
  if (rc == cudaSuccess) minor_direction_r_kernel<M><<<B, mi::kThreads, smem, s>>>(p);
  const cudaError_t last = cudaGetLastError();
  return rc != cudaSuccess ? rc : last;
}

}  // namespace

// w (B, n), status (B,) int32 and iters (B,) int32 of one minor iteration
// per instance; active may be null (every instance).  atol is the
// negative-curvature test's tolerance, bound_atol factor_to_boundary's, and
// smem the caller's count of the block's shared memory, refused unless it is
// this source's (so the two layouts cannot drift apart unseen).
BENLSIP_API int benlsip_minor_direction_r_f32(const float* R, const float* A, long long strideA, const float* L,
                                              const unsigned char* fixed, const float* x, const float* s,
                                              const float* g, const float* xl, long long strideXl, const float* xu,
                                              long long strideXu, const float* delta, const unsigned char* active,
                                              double kappa2, double atol, double bound_atol, float* w, int* status,
                                              int* iters, int B, int k, int M, int n, long long smem_expected,
                                              void* stream) {
  const size_t smem = mi::smem_bytes(k, M, n);
  if (B <= 0 || k < 1 || M < 1 || M > benlsip::kMaxDim || n < 1 || n > mi::kThreads || strideA < 0 ||
      strideXl < 0 || strideXu < 0 || smem > mi::kMaxSmem || static_cast<long long>(smem) != smem_expected) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Params p{R, A, strideA, L, fixed, x, s, g, xl, strideXl, xu, strideXu, delta, active,
                 static_cast<float>(kappa2), static_cast<float>(atol), static_cast<float>(bound_atol),
                 w, status, iters, k, n};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (M) {
#define BENLSIP_CASE(MM) \
  case MM:               \
    return static_cast<int>(launch_m<MM>(p, B, smem, st));
    BENLSIP_CASE(1) BENLSIP_CASE(2) BENLSIP_CASE(3) BENLSIP_CASE(4)
    BENLSIP_CASE(5) BENLSIP_CASE(6) BENLSIP_CASE(7) BENLSIP_CASE(8)
    BENLSIP_CASE(9) BENLSIP_CASE(10) BENLSIP_CASE(11) BENLSIP_CASE(12)
    BENLSIP_CASE(13) BENLSIP_CASE(14) BENLSIP_CASE(15) BENLSIP_CASE(16)
#undef BENLSIP_CASE
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
