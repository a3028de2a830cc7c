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
// bytes or its flops.  Here the minor iteration is one node.
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
#include <cfloat>
#include <cstdint>

#include "project_tangent.cuh"

namespace {

using benlsip::warp_sum;

constexpr int kThreads = 256;   // one column a thread: n <= kThreads
constexpr int kWarps = kThreads / 32;
constexpr int kRedFloats = 4 * kWarps * 3;   // four reduction sites of up to three values
// The CG statuses of solver/status.py.
constexpr int kRunning = 0, kSolved = 1, kBoundHit = 2, kNegCurv = 3, kMaxIter = 4;

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

__device__ __forceinline__ float inf() { return __int_as_float(0x7f800000); }

// torch.minimum / torch.maximum: NaN if either operand is NaN.
__device__ __forceinline__ float nan_min(float a, float b) {
  if (a != a || b != b) return a + b;
  return a < b ? a : b;
}
__device__ __forceinline__ float nan_max(float a, float b) {
  if (a != a || b != b) return a + b;
  return a > b ? a : b;
}

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) v = nan_min(v, __shfl_xor_sync(0xffffffffu, v, offset));
  return v;
}

// Each of the K values over the block, the first NS summed and the rest
// min-reduced: over the warp, then the warps' results in warp order, read
// from red (kWarps * K floats) by every thread, which then holds the same
// bits.  One barrier; red must not be written again before the next one.
template <int NS, int K>
__device__ __forceinline__ void block_reduce(float (&v)[K], float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int e = 0; e < K; ++e) {
    v[e] = e < NS ? warp_sum(v[e]) : warp_min(v[e]);
    if (lane == 0) red[warp * K + e] = v[e];
  }
  __syncthreads();
#pragma unroll
  for (int e = 0; e < K; ++e) {
    float acc = red[e];
    for (int w = 1; w < kWarps; ++w) acc = e < NS ? acc + red[w * K + e] : nan_min(acc, red[w * K + e]);
    v[e] = acc;
  }
}

// u = R v for R (k, n) row-major in shared memory: each warp over rows
// warp * 4 + kWarps * 4 * q .. + 3, its lanes over the columns, warp sums.
__device__ __forceinline__ void r_times(const float* Rs, const float* v, float* u, int k, int n) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i0 = warp * 4; i0 < k; i0 += kWarps * 4) {
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int j = lane; j < n; j += 32) {
      const float vj = v[j];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (i0 + q < k) acc[q] = fmaf(Rs[(i0 + q) * n + j], vj, acc[q]);
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float t = warp_sum(acc[q]);
      if (lane == 0 && i0 + q < k) u[i0 + q] = t;
    }
  }
}

// (R^T u)_j down column j of R, four accumulators.
__device__ __forceinline__ float rt_times(const float* Rs, const float* u, int j, int k, int n) {
  float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
  int i = 0;
  for (; i + 3 < k; i += 4) {
    a0 = fmaf(Rs[i * n + j], u[i], a0);
    a1 = fmaf(Rs[(i + 1) * n + j], u[i + 1], a1);
    a2 = fmaf(Rs[(i + 2) * n + j], u[i + 2], a2);
    a3 = fmaf(Rs[(i + 3) * n + j], u[i + 3], a3);
  }
  for (; i < k; ++i) a0 = fmaf(Rs[i * n + j], u[i], a0);
  return (a0 + a1) + (a2 + a3);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

template <int M>
__global__ void __launch_bounds__(kThreads) minor_direction_r_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.x, j = threadIdx.x, lane = j & 31, warp = j >> 5;
  const int n = p.n, k = p.k;
  float* Rs = smem;            // k * n: R, row-major
  float* As = Rs + k * n;      // M * n: the rows of A
  float* Ls = As + M * n;      // M * M: L
  float* ps = Ls + M * M;      // n: p (the line search: w)
  float* rn = ps + n;          // n: the vector to project
  float* vn = rn + n;          // n: its projection
  float* us = vn + n;          // k: R p (R w)
  float* red = us + k;         // kRedFloats: four reduction sites
  unsigned char* fx = reinterpret_cast<unsigned char*>(red + kRedFloats);   // n: the mask

  // R into shared memory, asynchronously where it is 16-byte aligned.
  const float* Rg = p.R + static_cast<size_t>(b) * k * n;
  const int total = k * n;
  const bool async = (total & 3) == 0 && (reinterpret_cast<uintptr_t>(Rg) & 15) == 0;
  if (async) {
    for (int q = j; q < total / 4; q += kThreads) cp_async16(Rs + 4 * q, Rg + 4 * q);
    asm volatile("cp.async.commit_group;\n" ::);
  } else {
#pragma unroll 4
    for (int q = j; q < total; q += kThreads) Rs[q] = Rg[q];
  }
  const float* Ag = p.A + static_cast<size_t>(b) * p.strideA;
  for (int q = j; q < M * n; q += kThreads) As[q] = Ag[q];
  for (int q = j; q < M * M; q += kThreads) Ls[q] = p.L[static_cast<size_t>(b) * M * M + q];

  // Column j's operands and the free-variable box of minor_iterate.
  const bool col = j < n;
  float g = 0.f, wl = 0.f, wu = 0.f;
  bool fixd = false;
  if (col) {
    const size_t o = static_cast<size_t>(b) * n + j;
    const float x = p.x[o], s = p.s[o], dl = p.delta[b];
    g = p.g[o];
    fixd = p.fixed[o] != 0;
    fx[j] = fixd;
    const float hi = nan_min(p.xu[static_cast<size_t>(b) * p.strideXu + j] - x, dl) - s;
    const float lo = nan_max(p.xl[static_cast<size_t>(b) * p.strideXl + j] - x, -dl) - s;
    wu = fixd ? 0.f : hi;
    wu = wu < 0.f ? 0.f : wu;   // clamp_min(0); NaN stays NaN
    wl = fixd ? 0.f : lo;
    wl = wl > 0.f ? 0.f : wl;   // clamp_max(0)
    rn[j] = g;
  }
  const int nfix = __syncthreads_count(fixd);

  // projected_cg's set-up: v0 = P(g), the tolerances, the entry status.
  if (warp == 0) benlsip::tangent::project_warp<float, M, false>(As, Ls, fx, rn, vn, n, lane);
  __syncthreads();
  const float v0 = col ? vn[j] : 0.f;
  float sums[2] = {g * g, v0 * v0};
  block_reduce<2>(sums, red);
  const float noise = (10.0f * FLT_EPSILON) * sqrtf(sums[0]);
  const float tcg = p.kappa2 * sqrtf(sums[1]);
  const float tol_cg = nan_max(tcg * tcg, noise * noise);
  const int max_iter = 2 * (n - M - nfix);
  const int cap = 2 * (n - M) > 0 ? 2 * (n - M) + 1 : 0;
  float rtv = sums[1];
  int status = rtv <= tol_cg ? kSolved : (max_iter >= 1 ? kRunning : kMaxIter);
  const bool active = p.active == nullptr || p.active[b] != 0;
  bool run = active && status == kRunning;

  float w = 0.f, r = g, pj = -v0;
  if (col) ps[j] = pj;
  int it = 1;
  if (async) asm volatile("cp.async.wait_all;\n" ::);
  __syncthreads();   // R and p in shared memory

  for (int trips = 0; run && trips < cap; ++trips) {
    r_times(Rs, ps, us, k, n);
    __syncthreads();
    const float hp = col ? rt_times(Rs, us, j, k, n) : 0.f;
    float lo = inf(), hi = inf();
    if (col) {   // factor_to_boundary
      lo = pj <= -p.bound_atol ? (wl - w) / pj : inf();
      hi = pj >= p.bound_atol ? (wu - w) / pj : inf();
    }
    float t3[3] = {pj * hp, pj * pj, nan_min(lo, hi)};
    block_reduce<2>(t3, red + kWarps * 3);
    const float pHp = t3[0], pp = t3[1];
    const float gamma = t3[2] < 0.f ? 0.f : t3[2];
    const float gamma_safe = isfinite(gamma) ? gamma : 0.f;
    const float tol = p.atol * pp;
    const bool neg = pHp <= tol;
    const bool nonzero_curv = fabsf(pHp) > tol;
    const float alpha = rtv / (neg ? 1.f : pHp);
    const bool outside = !neg && alpha > gamma;
    const float step = neg ? (nonzero_curv ? gamma_safe : 0.f) : (outside ? gamma : alpha);
    w = w + step * pj;
    if (neg || outside) {   // the same in every thread
      status = neg ? kNegCurv : kBoundHit;
      break;
    }
    // An interior step: the new residual, its projection, the next direction.
    const float r_new = r + alpha * hp;
    if (col) rn[j] = r_new;
    __syncthreads();
    if (warp == 0) benlsip::tangent::project_warp<float, M, false>(As, Ls, fx, rn, vn, n, lane);
    __syncthreads();
    const float v = col ? vn[j] : 0.f;
    float t1[1] = {v * v};
    block_reduce<1>(t1, red + 2 * kWarps * 3);
    const float rtv_next = t1[0];
    const float beta = rtv_next / (rtv != 0.f ? rtv : 1.f);
    r = r_new;
    pj = -v + beta * pj;
    if (col) ps[j] = pj;
    rtv = rtv_next;
    ++it;
    status = fabsf(rtv_next) < tol_cg ? kSolved : (it > max_iter ? kMaxIter : kRunning);
    run = status == kRunning;
    __syncthreads();   // p written before the next trip reads it
  }

  // linesearch along w, capped by the free-variable box.
  if (col) ps[j] = w;
  __syncthreads();
  r_times(Rs, ps, us, k, n);
  __syncthreads();
  float uu = 0.f;
  for (int i = j; i < k; i += kThreads) uu += us[i] * us[i];
  float lo = inf(), hi = inf();
  if (col && !fixd) {
    lo = w < 0.f ? wl / w : inf();
    hi = w > 0.f ? wu / w : inf();
  }
  float t3[3] = {uu, g * w, nan_min(lo, hi)};
  block_reduce<2>(t3, red + 3 * kWarps * 3);
  const float wHw = t3[0], gw = t3[1];
  const float alpha_opt = wHw > 0.f ? -gw / wHw : inf();
  float alpha = nan_min(alpha_opt, t3[2]);
  alpha = isfinite(alpha) ? alpha : 1.f;
  if (col) p.w[static_cast<size_t>(b) * n + j] = status != kNegCurv ? alpha * w : w;
  if (j == 0) {
    p.status[b] = status;
    p.iters[b] = it - 1;
  }
}

// Dynamic shared memory of one block: R, A, L, p, rn, vn, R p, the
// reduction sites and the mask (batched_linalg.minor_direction_smem computes
// the same for the gate, and the entry point refuses a call whose count
// differs).
size_t smem_bytes(int k, int M, int n) {
  return sizeof(float) * (static_cast<size_t>(k) * n + static_cast<size_t>(M) * n + M * M + 3 * n + k + kRedFloats) +
         static_cast<size_t>(n);
}

constexpr size_t kMaxSmem = 232448;   // a block's opt-in limit on sm_90

template <int M>
cudaError_t launch_m(const Params& p, int B, size_t smem, cudaStream_t s) {
  cudaError_t rc = cudaSuccess;
  if (smem > 48 * 1024) {
    rc = cudaFuncSetAttribute(minor_direction_r_kernel<M>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
  }
  if (rc == cudaSuccess) minor_direction_r_kernel<M><<<B, kThreads, smem, s>>>(p);
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
  const size_t smem = smem_bytes(k, M, n);
  if (B <= 0 || k < 1 || M < 1 || M > benlsip::kMaxDim || n < 1 || n > kThreads || strideA < 0 ||
      strideXl < 0 || strideXu < 0 || smem > kMaxSmem || static_cast<long long>(smem) != smem_expected) {
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
