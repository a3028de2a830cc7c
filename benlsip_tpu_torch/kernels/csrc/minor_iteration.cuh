// Device code of one minor iteration of solver/inner on the materialized
// operator R (R^T R = H), shared by two kernels: minor_direction_r.cu (one
// minor iteration a launch, where the design is described) and
// minor_loop_r.cu (the whole minor loop of an inner step a launch).  One
// copy of the arithmetic, so both give the same bits on the same operands.
//
// The block is one instance: kThreads threads, thread j owning column j
// (n <= kThreads), R, the rows of A, L, the mask and the vectors the warps
// share in dynamic shared memory (the layout of `carve`, whose size is
// `smem_bytes`).
#pragma once

#include <cfloat>
#include <cstdint>

#include "project_tangent.cuh"

namespace benlsip {
namespace minor {

constexpr int kThreads = 256;   // one column a thread: n <= kThreads
constexpr int kWarps = kThreads / 32;
constexpr int kRedFloats = 4 * kWarps * 3;   // four reduction sites of up to three values
// The CG statuses of solver/status.py.
constexpr int kRunning = 0, kSolved = 1, kBoundHit = 2, kNegCurv = 3, kMaxIter = 4;
constexpr size_t kMaxSmem = 232448;   // a block's opt-in limit on sm_90

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

// The block's operands in dynamic shared memory.
struct Block {
  float* Rs;           // k * n: R, row-major
  float* As;           // M * n: the rows of A
  float* Ls;           // M * M: L
  float* ps;           // n: p (the line search: w)
  float* rn;           // n: the vector to project
  float* vn;           // n: its projection
  float* us;           // k: R p (R w)
  float* red;          // kRedFloats: four reduction sites
  unsigned char* fx;   // n: the mask
};

__device__ __forceinline__ Block carve(float* smem, int k, int M, int n) {
  Block sh;
  sh.Rs = smem;
  sh.As = sh.Rs + k * n;
  sh.Ls = sh.As + M * n;
  sh.ps = sh.Ls + M * M;
  sh.rn = sh.ps + n;
  sh.vn = sh.rn + n;
  sh.us = sh.vn + n;
  sh.red = sh.us + k;
  sh.fx = reinterpret_cast<unsigned char*>(sh.red + kRedFloats);
  return sh;
}

// Bytes of `carve`'s layout (batched_linalg.minor_direction_smem computes
// the same for the gate, and the entry points refuse a call whose count
// differs).
inline size_t smem_bytes(int k, int M, int n) {
  return sizeof(float) * (static_cast<size_t>(k) * n + static_cast<size_t>(M) * n + M * M + 3 * n + k + kRedFloats) +
         static_cast<size_t>(n);
}

// R (k, n) of instance b into shared memory: asynchronously (cp.async, one
// commit group) where it is 16-byte aligned, returning true, else by plain
// loads, returning false.  Every thread of the block calls it.
__device__ __forceinline__ bool load_r(const Block& sh, const float* Rg, int k, int n) {
  const int j = threadIdx.x;
  const int total = k * n;
  const bool async = (total & 3) == 0 && (reinterpret_cast<uintptr_t>(Rg) & 15) == 0;
  if (async) {
    for (int q = j; q < total / 4; q += kThreads) cp_async16(sh.Rs + 4 * q, Rg + 4 * q);
    asm volatile("cp.async.commit_group;\n" ::);
  } else {
#pragma unroll 4
    for (int q = j; q < total; q += kThreads) sh.Rs[q] = Rg[q];
  }
  return async;
}

// Column j's operands of one minor iteration: x, s and the model gradient
// g of the column, its bounds and the lane's trust radius, and whether it
// is fixed.
struct Column {
  float x, s, g, xl, xu, dl;
  bool fixd;
};

// One minor iteration's tolerances: kappa2 the CG's relative one, atol the
// negative-curvature test's (sqrt(eps)), bound_atol factor_to_boundary's.
struct Tolerances {
  float kappa2, atol, bound_atol;
};

// Column j's share of its result: w_j, and the lane's CG status and trips.
struct Step {
  float w;
  int status, iters;
};

// One minor iteration of solver/inner.minor_iterate for the block's
// instance:
//
//   1. the free-variable box w_l, w_u from x, s, delta and the bounds;
//   2. solver/cg.projected_cg: v0 = P(g), the tolerances, and every CG trip
//      until the instance's status leaves CG_RUNNING (it caps itself at
//      2 (n - m - #fixed) trips);
//   3. solver/cg.linesearch along the CG direction w;
//   4. w <- alpha w unless the CG ended on negative curvature.
//
// sh holds R (or its copy in flight: `async` waits for it before the first
// CG trip), A's rows and L; fx is written here from c.fixd.  Every thread
// of the block calls it (threads j >= n with col false).  An instance not
// `active`, or whose status is not CG_RUNNING at entry, runs no trip and
// returns what the plain version returns: w = 0, its entry status, 0
// iterations.  Ends with a barrier behind its last shared reads but for
// red's fourth site, which the caller may not write before its next barrier.
template <int M>
__device__ __forceinline__ Step iteration(const Block& sh, const Column& c, int k, int n, bool active,
                                          const Tolerances& tol, bool async) {
  const int j = threadIdx.x, lane = j & 31, warp = j >> 5;
  const bool col = j < n;
  float g = 0.f, wl = 0.f, wu = 0.f;
  bool fixd = false;
  if (col) {
    g = c.g;
    fixd = c.fixd;
    sh.fx[j] = fixd;
    const float hi = nan_min(c.xu - c.x, c.dl) - c.s;
    const float lo = nan_max(c.xl - c.x, -c.dl) - c.s;
    wu = fixd ? 0.f : hi;
    wu = wu < 0.f ? 0.f : wu;   // clamp_min(0); NaN stays NaN
    wl = fixd ? 0.f : lo;
    wl = wl > 0.f ? 0.f : wl;   // clamp_max(0)
    sh.rn[j] = g;
  }
  const int nfix = __syncthreads_count(fixd);

  // projected_cg's set-up: v0 = P(g), the tolerances, the entry status.
  if (warp == 0) tangent::project_warp<float, M, false>(sh.As, sh.Ls, sh.fx, sh.rn, sh.vn, n, lane);
  __syncthreads();
  const float v0 = col ? sh.vn[j] : 0.f;
  float sums[2] = {g * g, v0 * v0};
  block_reduce<2>(sums, sh.red);
  const float noise = (10.0f * FLT_EPSILON) * sqrtf(sums[0]);
  const float tcg = tol.kappa2 * sqrtf(sums[1]);
  const float tol_cg = nan_max(tcg * tcg, noise * noise);
  const int max_iter = 2 * (n - M - nfix);
  const int cap = 2 * (n - M) > 0 ? 2 * (n - M) + 1 : 0;
  float rtv = sums[1];
  int status = rtv <= tol_cg ? kSolved : (max_iter >= 1 ? kRunning : kMaxIter);
  bool run = active && status == kRunning;

  float w = 0.f, r = g, pj = -v0;
  if (col) sh.ps[j] = pj;
  int it = 1;
  if (async) asm volatile("cp.async.wait_all;\n" ::);
  __syncthreads();   // R and p in shared memory

  for (int trips = 0; run && trips < cap; ++trips) {
    r_times(sh.Rs, sh.ps, sh.us, k, n);
    __syncthreads();
    const float hp = col ? rt_times(sh.Rs, sh.us, j, k, n) : 0.f;
    float lo = inf(), hi = inf();
    if (col) {   // factor_to_boundary
      lo = pj <= -tol.bound_atol ? (wl - w) / pj : inf();
      hi = pj >= tol.bound_atol ? (wu - w) / pj : inf();
    }
    float t3[3] = {pj * hp, pj * pj, nan_min(lo, hi)};
    block_reduce<2>(t3, sh.red + kWarps * 3);
    const float pHp = t3[0], pp = t3[1];
    const float gamma = t3[2] < 0.f ? 0.f : t3[2];
    const float gamma_safe = isfinite(gamma) ? gamma : 0.f;
    const float tl = tol.atol * pp;
    const bool neg = pHp <= tl;
    const bool nonzero_curv = fabsf(pHp) > tl;
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
    if (col) sh.rn[j] = r_new;
    __syncthreads();
    if (warp == 0) tangent::project_warp<float, M, false>(sh.As, sh.Ls, sh.fx, sh.rn, sh.vn, n, lane);
    __syncthreads();
    const float v = col ? sh.vn[j] : 0.f;
    float t1[1] = {v * v};
    block_reduce<1>(t1, sh.red + 2 * kWarps * 3);
    const float rtv_next = t1[0];
    const float beta = rtv_next / (rtv != 0.f ? rtv : 1.f);
    r = r_new;
    pj = -v + beta * pj;
    if (col) sh.ps[j] = pj;
    rtv = rtv_next;
    ++it;
    status = fabsf(rtv_next) < tol_cg ? kSolved : (it > max_iter ? kMaxIter : kRunning);
    run = status == kRunning;
    __syncthreads();   // p written before the next trip reads it
  }

  // linesearch along w, capped by the free-variable box.
  if (col) sh.ps[j] = w;
  __syncthreads();
  r_times(sh.Rs, sh.ps, sh.us, k, n);
  __syncthreads();
  float uu = 0.f;
  for (int i = j; i < k; i += kThreads) uu += sh.us[i] * sh.us[i];
  float lo = inf(), hi = inf();
  if (col && !fixd) {
    lo = w < 0.f ? wl / w : inf();
    hi = w > 0.f ? wu / w : inf();
  }
  float t3[3] = {uu, g * w, nan_min(lo, hi)};
  block_reduce<2>(t3, sh.red + 3 * kWarps * 3);
  const float wHw = t3[0], gw = t3[1];
  const float alpha_opt = wHw > 0.f ? -gw / wHw : inf();
  float alpha = nan_min(alpha_opt, t3[2]);
  alpha = isfinite(alpha) ? alpha : 1.f;
  return Step{status != kNegCurv ? alpha * w : w, status, it - 1};
}

}  // namespace minor
}  // namespace benlsip
