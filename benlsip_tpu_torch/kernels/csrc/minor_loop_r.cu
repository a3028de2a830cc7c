// The whole minor loop of solver/inner.inner_step on the materialized
// Gauss-Newton operator R (R^T R = H), one launch per inner step (one a
// trust-region trip), each instance looping to its own exit
// (j <= max_minor, not approx_solved, no negative-curvature stop).  A trip:
//
//   1. the minor iteration (box, projected CG, line search) of
//      minor_direction_r.cu, through the same device code
//      (minor::iteration, minor_iteration.cuh);
//   2. s <- s + w and g_minor = R^T (R s) + g;
//   3. step_active_bounds at x, s, delta, united with the fixed set, and
//      whether the union leaves room for the m equalities (`fits`); where it
//      does not, the fixed set becomes active_bounds_at(x + s) and the
//      instance leaves the loop after this trip;
//   4. the factor L = chol(A Z A^T + reg I) of the new free set, as
//      make_active_set computes it (aat::warp_triangle and factor_and_store,
//      masked_aat.cuh, the masked_aat_cholesky kernel's device code);
//   5. the reduced-gradient norms |P(-g)| and |P(-g_minor)| through the
//      project_tangent kernel's warp code (project_tangent.cuh), and the
//      approx_solved test |P(-g_minor)| <= kappa3 |P(-g)|.
//
// for R (B, k, n), A (B, m, n), the entry carry L (B, m, m), fixed (B, n),
// s and g_minor (B, n), x, g, xl, xu (B, n), delta (B,), the lanes that run
// at entry (B,) and max_minor (B,), float32 only.  Outputs: s, g_minor,
// fixed and L after the loop, the trips and CG trips a lane, and the last
// trip's CG status (CG_RUNNING where no trip ran).  solver/inner computes
// the model reduction from s after it, as it did.
//
// It replaces no TPU kernel: the JAX package's minor loop is plain
// lax.while_loop code that XLA fuses.  In a graph replay the loop was a
// conditional WHILE node whose body ran 69 nodes a trip: one
// minor_direction_r launch (~32 us) and 68 small kernels and copies (the
// product with H, the bound masks, the re-factor, two projections, the
// carry's selects) at ~3 us each, and eagerly one host sync a trip.  Here
// the loop is one node.
//
// What bounds it: per instance, R (147 KB at n = 192) read once from device
// memory, then per trip the CG's 4 k n flops a CG trip and 2 k n for the line
// search (minor_direction_r.cu), 4 k n for R^T (R s), and ~m^2 n for the
// re-factor and 8 m n for the two projections: ~0.3-1 MFLOP a trip at
// config 3's shape, against 67 TFLOP/s over the card.  The trips and the CG
// trips inside them are one chain of dependent block reductions per
// instance, so the time is latency: that chain's barriers, shuffles and
// shared-memory round trips, not bytes or flops.
//
// Why one block an instance: the chain cannot be split across blocks
// without a grid-wide barrier a reduction, and one block of 256 threads
// holds an instance's whole state on one SM (R and A in shared memory,
// column j's x, s, g, g_minor, w, r, p and box in thread j's registers), so
// no trip touches device memory; B = 64 instances fill 64 of the 132 SMs.
// The layout of shared memory is minor_direction_r's (minor::carve; the
// same byte count, so the two kernels take the same shapes): the loop's own
// steps reuse its vectors (p for s, then the two reduced gradients; the
// residual buffer for -g) and its second reduction site for the two norms.
// Step 3 runs elementwise in every thread, its count by
// __syncthreads_count; step 4 in warp 0; step 5 in warps 0 and 1 side by
// side.  Block reductions in a fixed tree and no atomics:
// two calls give the same bits, and a lane's bits do not depend on its batch
// (one block an instance whatever B).  This source is built with
// --fmad=false: each elementwise update is the plain version's torch op,
// rounded alike; the outputs equal the plain version's up to float32
// summation order (the products with R and the norms), and the factor is
// the masked_aat_cholesky kernel's, bit for bit, on the same mask.
//
// An instance that does not run at entry runs no trip, reads no R, and
// returns its entry carry, 0 trips, 0 CG trips and CG_RUNNING.
#include "masked_aat.cuh"
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
  const float* g;                 // the inner step's gradient
  const float* g_minor;           // the model gradient at s, g + H s
  const float* xl;
  long long strideXl;             // the bounds' batch strides (0: shared)
  const float* xu;
  long long strideXu;
  const float* delta;
  const unsigned char* run;       // the lanes that run at entry; null: every instance
  const int* max_minor;           // each lane's cap on its trips
  float kappa2;                   // the CG's relative tolerance
  float kappa3;                   // approx_solved's
  float atol;                     // the curvature test's (sqrt(eps))
  float bound_atol;               // factor_to_boundary's: |p_i| below it does not bind
  float fix_atol;                 // the bound masks' (inner_step's atol)
  float reg;                      // the factor's jitter (chol_reg)
  float* s_out;
  float* g_minor_out;
  unsigned char* fixed_out;
  float* L_out;
  int* iters;
  int* cg_iters;
  int* status;
  int k, n;
};

template <int M>
__global__ void __launch_bounds__(mi::kThreads) minor_loop_r_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.x, j = threadIdx.x, lane = j & 31, warp = j >> 5;
  const int n = p.n, k = p.k;
  const mi::Block sh = mi::carve(smem, k, M, n);
  const bool run0 = p.run == nullptr || p.run[b] != 0;

  // R into shared memory for a lane that runs, asynchronously where it is
  // 16-byte aligned, while A, L and the first projection are read.
  const bool async = run0 && mi::load_r(sh, p.R + static_cast<size_t>(b) * k * n, k, n);
  const float* Ag = p.A + static_cast<size_t>(b) * p.strideA;
  for (int q = j; q < M * n; q += mi::kThreads) sh.As[q] = Ag[q];
  for (int q = j; q < M * M; q += mi::kThreads) sh.Ls[q] = p.L[static_cast<size_t>(b) * M * M + q];

  // Column j's carry (c.g is g_minor, the gradient the minor iteration
  // reads) and the inner step's gradient.
  const bool col = j < n;
  const size_t o = static_cast<size_t>(b) * n + j;
  mi::Column c{};
  float g = 0.f;
  if (col) {
    c = mi::Column{p.x[o], p.s[o], p.g_minor[o], p.xl[static_cast<size_t>(b) * p.strideXl + j],
                   p.xu[static_cast<size_t>(b) * p.strideXu + j], p.delta[b], p.fixed[o] != 0};
    g = p.g[o];
  }
  const int max_minor = p.max_minor[b];
  const mi::Tolerances tol{p.kappa2, p.atol, p.bound_atol};
  float* norms = sh.red + mi::kWarps * 3;   // the second reduction site

  int trips = 0, cg_total = 0, status = mi::kRunning;
  bool run = run0;
  while (run) {   // uniform over the block
    // 1. The minor iteration.
    const mi::Step st = mi::iteration<M>(sh, c, k, n, true, tol, async);

    // 2. s += w, g_minor = R^T (R s) + g (hv, then the add).
    if (col) {
      c.s = c.s + st.w;
      sh.ps[j] = c.s;
    }
    __syncthreads();
    mi::r_times(sh.Rs, sh.ps, sh.us, k, n);
    __syncthreads();

    // 3. step_active_bounds, its union with the fixed set, and fits.
    bool uni = false;
    if (col) {
      c.g = mi::rt_times(sh.Rs, sh.us, j, k, n) + g;
      const float s_l = mi::nan_max(c.xl - c.x, -c.dl), s_u = mi::nan_min(c.xu - c.x, c.dl);
      uni = c.fixd || (c.s - s_l <= p.fix_atol) || (s_u - c.s <= p.fix_atol);
    }
    const bool fits = M + __syncthreads_count(uni) <= n;
    if (col) {
      if (fits) {
        c.fixd = uni;
      } else {   // active_bounds_at(x + s)
        const float xs = c.x + c.s;
        c.fixd = (xs - c.xl <= p.fix_atol) || (c.xu - xs <= p.fix_atol);
      }
      sh.fx[j] = c.fixd;
      sh.rn[j] = -g;
      sh.ps[j] = -c.g;
    }
    __syncthreads();

    // 4. The factor of the new free set (make_active_set), in warp 0.
    if (warp == 0) {
      float t[M * (M + 1) / 2];
      benlsip::aat::warp_triangle<float, M>(t, sh.As, sh.fx, n, lane);
      benlsip::aat::factor_and_store<float, M>(t, p.reg, sh.Ls, lane);
    }
    __syncthreads();

    // 5. |P(-g)| in warp 0 and |P(-g_minor)| in warp 1, then approx_solved.
    if (warp < 2) {
      float sq = 0.f;
      benlsip::tangent::project_warp_emit<float, M, false>(sh.As, sh.Ls, sh.fx, warp == 0 ? sh.rn : sh.ps, n, lane,
                                                           [&sq](int, float v) { sq += v * v; });
      sq = benlsip::warp_sum(sq);
      if (lane == 0) norms[warp] = sq;
    }
    __syncthreads();
    const float nrg = sqrtf(norms[0]), nrgm = sqrtf(norms[1]);
    const bool approx_solved = fits ? nrgm <= p.kappa3 * nrg : true;

    ++trips;
    cg_total += st.iters;
    status = st.status;
    run = trips + 1 <= max_minor && !approx_solved && status != mi::kNegCurv;
  }

  if (col) {
    p.s_out[o] = c.s;
    p.g_minor_out[o] = c.g;
    p.fixed_out[o] = c.fixd;
  }
  // Each thread reads back the entries of L it loaded, or those warp 0
  // wrote before the last barrier.
  for (int q = j; q < M * M; q += mi::kThreads) p.L_out[static_cast<size_t>(b) * M * M + q] = sh.Ls[q];
  if (j == 0) {
    p.iters[b] = trips;
    p.cg_iters[b] = cg_total;
    p.status[b] = status;
  }
}

template <int M>
cudaError_t launch_m(const Params& p, int B, size_t smem, cudaStream_t s) {
  cudaError_t rc = cudaSuccess;
  if (smem > 48 * 1024) {
    rc = cudaFuncSetAttribute(minor_loop_r_kernel<M>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
  }
  if (rc == cudaSuccess) minor_loop_r_kernel<M><<<B, mi::kThreads, smem, s>>>(p);
  const cudaError_t last = cudaGetLastError();
  return rc != cudaSuccess ? rc : last;
}

}  // namespace

// The minor loop of one inner step per instance; run may be null (every
// instance runs at entry).  atol is the negative-curvature test's
// tolerance, bound_atol factor_to_boundary's, fix_atol the bound masks',
// reg the factor's jitter, and smem the caller's count of the block's shared
// memory, refused unless it is this source's (minor_direction_r's layout).
BENLSIP_API int benlsip_minor_loop_r_f32(const float* R, const float* A, long long strideA, const float* L,
                                         const unsigned char* fixed, const float* x, const float* s, const float* g,
                                         const float* g_minor, const float* xl, long long strideXl, const float* xu,
                                         long long strideXu, const float* delta, const unsigned char* run,
                                         const int* max_minor, double kappa2, double kappa3, double atol,
                                         double bound_atol, double fix_atol, double reg, float* s_out,
                                         float* g_minor_out, unsigned char* fixed_out, float* L_out, int* iters,
                                         int* cg_iters, int* status, int B, int k, int M, int n,
                                         long long smem_expected, void* stream) {
  const size_t smem = mi::smem_bytes(k, M, n);
  if (B <= 0 || k < 1 || M < 1 || M > benlsip::kMaxDim || n < 1 || n > mi::kThreads || strideA < 0 ||
      strideXl < 0 || strideXu < 0 || smem > mi::kMaxSmem || static_cast<long long>(smem) != smem_expected) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Params p{R, A, strideA, L, fixed, x, s, g, g_minor, xl, strideXl, xu, strideXu, delta, run, max_minor,
                 static_cast<float>(kappa2), static_cast<float>(kappa3), static_cast<float>(atol),
                 static_cast<float>(bound_atol), static_cast<float>(fix_atol), static_cast<float>(reg),
                 s_out, g_minor_out, fixed_out, L_out, iters, cg_iters, status, k, n};
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
