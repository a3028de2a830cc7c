// Device code of the dual-Newton kernel shared by its two sources:
// polyhedron_newton.cu (the warp forms and the C entry points, where the
// design is described) and polyhedron_newton_split.cu (the split form), two
// sources so that nvcc builds the two families of instantiations in parallel.
#pragma once

#include "common.cuh"

namespace benlsip {
namespace newton {

namespace cg = cooperative_groups;

constexpr int kSec = 17;       // grid points of a section round (ops/polyproject._K_SEC)
constexpr int kMaxGrid = 61;   // bracket points at most: grow_pows <= 60
constexpr int kStall = 4;      // non-improving trips that end a lane, or restart a warm one
constexpr int kLanesMaxN = 32; // the grid-on-lanes layout holds one column a lane

// torch.clamp(v, lo, hi) = min(max(v, lo), hi); a NaN v stays NaN.
template <typename C>
__device__ __forceinline__ C clip(C v, C lo, C hi) {
  const C t = v < lo ? lo : v;
  return t > hi ? hi : t;
}

// torch.minimum: NaN if either operand is NaN.
template <typename C>
__device__ __forceinline__ C nan_min(C a, C b) {
  if (a != a || b != b) return a + b;
  return a < b ? a : b;
}

// 2^k, exact, for 0 <= k <= 60 (the bracket's points, torch's 2.0 ** k).
template <typename C>
__device__ __forceinline__ C pow2(int k) {
  return static_cast<C>(1ull << k);
}

// The section grid's fractions k/16, exact (torch.linspace(0, 1, 17)).
template <typename C>
__device__ __forceinline__ C frac(int k) {
  return static_cast<C>(k) * static_cast<C>(0.0625);
}

template <typename T>
struct Args {
  const T* A;
  long long strideA;
  const T* b;
  const T* l;
  const T* u;
  const T* x;
  const T* lam0;                  // null: cold start
  const unsigned char* active;    // null: every instance
  T* v;
  T* lam;
  int* iters;
  benlsip::compute_t<T>* ws;      // (B, 2, n): z and w of each column
  int B, n, max_iter, grow_pows, n_section;
  benlsip::compute_t<T> tol, reg;
};

// One warp per instance: lane `tid` strides over the columns [j0, j1); a sum
// leaves the same bits in every lane.
template <typename C>
struct WarpTeam {
  static constexpr bool kWarp = true;
  static constexpr int kStride = 32;
  int tid, j0, j1;

  template <int K>
  __device__ __forceinline__ void sum(C (&v)[K], int k) {
#pragma unroll
    for (int e = 0; e < K; ++e) {
      if (e < k) v[e] = warp_sum(v[e]);
    }
  }
  __device__ __forceinline__ void done() {}
};

// A cluster of S blocks per instance, thread `tid` of each block striding
// over the block's slice [j0, j1) of the columns.  A sum adds each value over
// the block (warp_sum, then the warps in warp order) and then the S block
// sums in rank order, read by every block through distributed shared memory.
template <typename C, int KMAX>
struct ClusterTeam {
  static constexpr bool kWarp = false;
  static constexpr int kStride = kSplitThreads;
  cg::cluster_group cluster;
  C* scratch;   // kSplitWarps * KMAX: the warps' sums
  C* part;      // 2 * KMAX: this block's sums, double-buffered
  C* total;     // KMAX: the cluster's sums
  int tid, j0, j1, buf;

  template <int K>
  __device__ __forceinline__ void sum(C (&v)[K], int k) {
    const int lane = tid & 31, warp = tid >> 5;
#pragma unroll
    for (int e = 0; e < K; ++e) {
      if (e < k) {
        const C s = warp_sum(v[e]);
        if (lane == (e & 31)) scratch[warp * KMAX + e] = s;
      }
    }
    __syncthreads();
    C* mine = part + buf * KMAX;
    for (int e = tid; e < k; e += kSplitThreads) {
      C acc = scratch[e];
      for (int w = 1; w < kSplitWarps; ++w) acc += scratch[w * KMAX + e];
      mine[e] = acc;
    }
    // Every block's sums are written.  The other buffer's last readers have
    // passed the previous barrier, so the next sum may overwrite it.
    cluster.sync();
    const unsigned S = cluster.num_blocks();
    for (int e = tid; e < k; e += kSplitThreads) {
      C acc = *cluster.map_shared_rank(mine + e, 0u);
      for (unsigned r = 1; r < S; ++r) acc += *cluster.map_shared_rank(mine + e, r);
      total[e] = acc;
    }
    __syncthreads();
#pragma unroll
    for (int e = 0; e < K; ++e) {
      if (e < k) v[e] = total[e];
    }
    buf ^= 1;
  }
  // No block leaves while another may still read its last sums.
  __device__ __forceinline__ void done() { cluster.sync(); }
};

// Solve (L L^T) y = r with L packed in c, in the order of cho_solve.cu.
template <typename C, int M>
__device__ __forceinline__ void cho_solve_packed(const C* c, const C (&r)[M], C (&out)[M]) {
  C y[M];
#pragma unroll
  for (int i = 0; i < M; ++i) {
    C acc = r[i];
#pragma unroll
    for (int k = 0; k < i; ++k) acc = acc - c[tri(i, k)] * y[k];
    y[i] = acc / c[tri(i, i)];
  }
#pragma unroll
  for (int i = M - 1; i >= 0; --i) {
    C acc = y[i];
#pragma unroll
    for (int k = i + 1; k < M; ++k) acc = acc - c[tri(k, i)] * out[k];
    out[i] = acc / c[tri(i, i)];
  }
}

// phi(t) - db over the n columns in column order, for this lane's t; lane j
// (j < n) holds column j's z, w, l and u (the grid-on-lanes layout).
template <typename C>
__device__ __forceinline__ C phi_on_lane(C t, int n, C zj, C wj, C lj, C uj, C db) {
  C s = C(0);
  for (int j = 0; j < n; ++j) {
    const C z = __shfl_sync(0xffffffffu, zj, j), w = __shfl_sync(0xffffffffu, wj, j);
    const C lo = __shfl_sync(0xffffffffu, lj, j), hi = __shfl_sync(0xffffffffu, uj, j);
    s = s + w * clip(z - t * w, lo, hi);
  }
  return s - db;
}

template <typename T, int M, class Team>
__device__ __forceinline__ void newton(Team& team, const Args<T>& p, int b, bool lanes) {
  using C = benlsip::compute_t<T>;
  constexpr int KT = M * (M + 1) / 2;
  const int n = p.n;
  const T* a = p.A + static_cast<size_t>(b) * p.strideA;
  const T* xb = p.x + static_cast<size_t>(b) * n;
  const T* lb = p.l + static_cast<size_t>(b) * n;
  const T* ub = p.u + static_cast<size_t>(b) * n;
  C* zs = p.ws + static_cast<size_t>(b) * 2 * n;
  C* wsv = zs + n;
  const int G = p.grow_pows;

  C bv[M], lam[M], lam_best[M];
  const bool cold = p.lam0 == nullptr;
#pragma unroll
  for (int i = 0; i < M; ++i) {
    bv[i] = load(p.b + static_cast<size_t>(b) * M + i);
    lam[i] = cold ? C(0) : load(p.lam0 + static_cast<size_t>(b) * M + i);
    lam_best[i] = lam[i];
  }
  int it = 0;
  C Fnorm = C(0), fbest = C(0);   // an inactive instance keeps lam (Fnorm <= fbest)
  if (p.active == nullptr || p.active[b] != 0) {
    C nb = C(0);
#pragma unroll
    for (int i = 0; i < M; ++i) nb = nb + bv[i] * bv[i];
    const C tol_val = p.tol * (C(1) + sqrt(nb));
    // F(0) (for the cold restart) and F(lam0), in one pass.
    C f2[2 * M];
#pragma unroll
    for (int e = 0; e < 2 * M; ++e) f2[e] = C(0);
    for (int j = team.j0 + team.tid; j < team.j1; j += Team::kStride) {
      const C xj = load(xb + j), lj = load(lb + j), uj = load(ub + j);
      C col[M];
      C s = C(0);
#pragma unroll
      for (int i = 0; i < M; ++i) {
        col[i] = load(a + static_cast<size_t>(i) * n + j);
        s = s + col[i] * lam[i];
      }
      const C v0 = clip(xj, lj, uj), v1 = clip(xj - s, lj, uj);
#pragma unroll
      for (int i = 0; i < M; ++i) {
        f2[i] += col[i] * v0;
        f2[M + i] += col[i] * v1;
      }
    }
    team.sum(f2, 2 * M);
    C fz = C(0), f0 = C(0);
#pragma unroll
    for (int i = 0; i < M; ++i) {
      const C e0 = f2[i] - bv[i], e1 = f2[M + i] - bv[i];
      fz = fz + e0 * e0;
      f0 = f0 + e1 * e1;
    }
    const C fn_zero = sqrt(fz);
    Fnorm = sqrt(f0);
    C best = Fnorm;
    fbest = Fnorm;
    int stall = 0;
    bool restarted = cold;   // a cold start has no restart to spend
    while (Fnorm > tol_val && it < p.max_iter && (stall < kStall || !restarted)) {
      if (stall >= kStall && !restarted) {   // the cold restart: lam <- 0
#pragma unroll
        for (int i = 0; i < M; ++i) lam[i] = C(0);
        Fnorm = fn_zero;
        best = fn_zero;
        stall = 0;
        restarted = true;
      }
      // Pass 1: z = x - A^T lam (kept), K = A D A^T, F = A clip(z) - b and
      // |clip(z) - x|^2 for the dual value q(lam), in one reduction.
      C acc[KT + M + 1];
#pragma unroll
      for (int e = 0; e < KT + M + 1; ++e) acc[e] = C(0);
      for (int j = team.j0 + team.tid; j < team.j1; j += Team::kStride) {
        const C xj = load(xb + j), lj = load(lb + j), uj = load(ub + j);
        C col[M];
        C s = C(0);
#pragma unroll
        for (int i = 0; i < M; ++i) {
          col[i] = load(a + static_cast<size_t>(i) * n + j);
          s = s + col[i] * lam[i];
        }
        const C z = xj - s;
        zs[j] = z;
        const C vj = clip(z, lj, uj);
        if (z > lj && z < uj) {
#pragma unroll
          for (int i = 0; i < M; ++i) {
#pragma unroll
            for (int k = 0; k <= i; ++k) acc[tri(i, k)] += col[i] * col[k];
          }
        }
#pragma unroll
        for (int i = 0; i < M; ++i) acc[KT + i] += col[i] * vj;
        const C d = vj - xj;
        acc[KT + M] += d * d;
      }
      team.sum(acc, KT + M + 1);
      C F[M], dl[M];
      C ql = C(0);
#pragma unroll
      for (int i = 0; i < M; ++i) {
        F[i] = acc[KT + i] - bv[i];
        ql = ql + lam[i] * F[i];
      }
      ql = C(0.5) * acc[KT + M] + ql;
      benlsip::cholesky_in_place<C, M>(acc, p.reg);
      cho_solve_packed<C, M>(acc, F, dl);

      // Pass 2: w = A^T dlam (kept); the slope phi(t) = w^T clip(z - t w) - dlam^T b.
      C db = C(0);
#pragma unroll
      for (int i = 0; i < M; ++i) db = db + dl[i] * bv[i];
      for (int j = team.j0 + team.tid; j < team.j1; j += Team::kStride) {
        C s = C(0);
#pragma unroll
        for (int i = 0; i < M; ++i) s = s + load(a + static_cast<size_t>(i) * n + j) * dl[i];
        wsv[j] = s;
      }

      // The exact line search: the first power of two with phi <= 0, then
      // n_section rounds of 17 points inside the bracket.
      int first = -1;
      C zj = C(0), wj = C(0), lj = C(0), uj = C(0);
      if constexpr (Team::kWarp) {
        if (lanes) {
          if (team.tid < n) {
            zj = zs[team.tid];
            wj = wsv[team.tid];
            lj = load(lb + team.tid);
            uj = load(ub + team.tid);
          }
          unsigned long long neg = 0;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int k = team.tid + 32 * r;
            const C ph = phi_on_lane(pow2<C>(k <= G ? k : 0), n, zj, wj, lj, uj, db);
            neg |= static_cast<unsigned long long>(__ballot_sync(0xffffffffu, k <= G && ph <= C(0))) << (32 * r);
          }
          first = neg ? __ffsll(static_cast<long long>(neg)) - 1 : -1;
        }
      }
      if (!lanes) {
        C ph[kMaxGrid];
#pragma unroll
        for (int e = 0; e < kMaxGrid; ++e) ph[e] = C(0);
        for (int j = team.j0 + team.tid; j < team.j1; j += Team::kStride) {
          const C z = zs[j], w = wsv[j], lo = load(lb + j), hi = load(ub + j);
#pragma unroll
          for (int e = 0; e < kMaxGrid; ++e) {
            if (e <= G) ph[e] += w * clip(z - pow2<C>(e) * w, lo, hi);
          }
        }
        team.sum(ph, G + 1);
#pragma unroll
        for (int e = kMaxGrid - 1; e >= 0; --e) {
          if (e <= G && ph[e] - db <= C(0)) first = e;
        }
      }
      C t_hi = pow2<C>(first >= 0 ? first : G);
      C t_lo = first > 0 ? pow2<C>(first - 1) : C(0);
      for (int r = 0; r < p.n_section; ++r) {
        const C d = t_hi - t_lo;
        int cnt = 0;
        if constexpr (Team::kWarp) {
          if (lanes) {
            const int k = team.tid < kSec ? team.tid : 0;
            const C ph = phi_on_lane(t_lo + d * frac<C>(k), n, zj, wj, lj, uj, db);
            cnt = __popc(__ballot_sync(0xffffffffu, team.tid < kSec && ph > C(0)));
          }
        }
        if (!lanes) {
          C ph[kSec];
#pragma unroll
          for (int e = 0; e < kSec; ++e) ph[e] = C(0);
          for (int j = team.j0 + team.tid; j < team.j1; j += Team::kStride) {
            const C z = zs[j], w = wsv[j], lo = load(lb + j), hi = load(ub + j);
#pragma unroll
            for (int e = 0; e < kSec; ++e) ph[e] += w * clip(z - (t_lo + d * frac<C>(e)) * w, lo, hi);
          }
          team.sum(ph, kSec);
#pragma unroll
          for (int e = 0; e < kSec; ++e) cnt += ph[e] - db > C(0);
        }
        // The last grid point with phi > 0 (phi(t_lo) > 0 by the bracket).
        const int idx = cnt > 0 ? cnt - 1 : 0;
        const C new_lo = t_lo + d * frac<C>(idx);
        const C new_hi = t_lo + d * frac<C>(idx + 1 < kSec ? idx + 1 : kSec - 1);
        t_lo = new_lo;
        t_hi = new_hi > new_lo ? new_hi : t_hi;
      }
      const C t_star = C(0.5) * (t_lo + t_hi);

      // Pass 3: F and q at lam + t* dlam; the monotone safeguard accepts on
      // dual ascent or a smaller residual.
      C lt[M];
#pragma unroll
      for (int i = 0; i < M; ++i) lt[i] = lam[i] + t_star * dl[i];
      C ft[M + 1];
#pragma unroll
      for (int e = 0; e < M + 1; ++e) ft[e] = C(0);
      for (int j = team.j0 + team.tid; j < team.j1; j += Team::kStride) {
        const C xj = load(xb + j), lj2 = load(lb + j), uj2 = load(ub + j);
        C col[M];
        C s = C(0);
#pragma unroll
        for (int i = 0; i < M; ++i) {
          col[i] = load(a + static_cast<size_t>(i) * n + j);
          s = s + col[i] * lt[i];
        }
        const C vj = clip(xj - s, lj2, uj2);
#pragma unroll
        for (int i = 0; i < M; ++i) ft[i] += col[i] * vj;
        const C d = vj - xj;
        ft[M] += d * d;
      }
      team.sum(ft, M + 1);
      C f2t = C(0), qt = C(0);
#pragma unroll
      for (int i = 0; i < M; ++i) {
        const C e = ft[i] - bv[i];
        f2t = f2t + e * e;
        qt = qt + lt[i] * e;
      }
      const C fn_try = sqrt(f2t);
      qt = C(0.5) * ft[M] + qt;
      const bool accept = (qt >= ql) || (fn_try < Fnorm);
      if (accept) {
#pragma unroll
        for (int i = 0; i < M; ++i) lam[i] = lt[i];
      }
      const C fn_new = accept ? fn_try : Fnorm;
      const bool improved = fn_new < C(0.7) * best;
      const bool record = fn_new < fbest;
      best = nan_min(fn_new, best);
      fbest = nan_min(fn_new, fbest);
      if (record) {
#pragma unroll
        for (int i = 0; i < M; ++i) lam_best[i] = lam[i];
      }
      stall = improved ? 0 : stall + 1;
      Fnorm = fn_new;
      ++it;
    }
  }

  // A cap or stall exit may end worse than the best dual seen: hand that back.
  const bool keep = Fnorm <= fbest;
#pragma unroll
  for (int i = 0; i < M; ++i) lam[i] = keep ? lam[i] : lam_best[i];
  for (int j = team.j0 + team.tid; j < team.j1; j += Team::kStride) {
    C s = C(0);
#pragma unroll
    for (int i = 0; i < M; ++i) s = s + load(a + static_cast<size_t>(i) * n + j) * lam[i];
    store(p.v + static_cast<size_t>(b) * n + j, clip(load(xb + j) - s, load(lb + j), load(ub + j)));
  }
  if (team.tid == 0 && team.j0 == 0) {
#pragma unroll
    for (int i = 0; i < M; ++i) store(p.lam + static_cast<size_t>(b) * M + i, lam[i]);
    p.iters[b] = it;
  }
}

// Launch the split form (plan S >= 2 blocks per instance) of M-row instances.
template <typename T>
cudaError_t launch_split(const Args<T>& p, int M, int plan, cudaStream_t stream);

}  // namespace newton
}  // namespace benlsip
