// Native polyhedral-projection QP solver (host-side oracle), the port's own
// copy of the JAX package's native/polyqp.cpp (same algorithm, same code).
//
// Role: BEnlsip.jl outsources exact projection onto {v | Av=b, l<=v<=u} to
// Ipopt through JuMP (src/polyhedral_constraints.jl:179-198) and uses it as
// the ground-truth oracle in its tests.  This file is a dependency-free
// dense dual solver for the same QP,
//
//     min_v 1/2 ||v - x||^2   s.t.  A v = b,  l <= v <= u,
//
// solved by damped semismooth Newton on the concave dual
//     q(lam) = min_v 1/2||v-x||^2 + lam' (A v - b),
//     v*(lam) = clip(x - A' lam, l, u),     grad q = A v*(lam) - b,
// with an exact bisection linesearch along each Newton direction (the
// directional derivative of q is a monotone scalar function).  The same
// algorithm as the on-device projection (benlsip_tpu_torch/ops/polyproject.py),
// so the host and device answers cross-validate each other.
//
// m (number of equality constraints) is assumed small; the m x m Newton
// systems use an in-place Cholesky.  No BLAS/LAPACK dependency.
//
// Built with g++ at first use by benlsip_tpu_torch/ops/native_qp.py.

#include <cmath>
#include <cstring>
#include <vector>

namespace {

// One Cholesky attempt on (K + reg I); K is clobbered.  Returns false when
// a pivot goes non-positive (K + reg I numerically indefinite).
bool chol_solve_once(int m, std::vector<double>& K, const double* f,
                     double reg, double* d) {
  for (int i = 0; i < m; ++i) K[i * m + i] += reg;
  // Cholesky factorization K = L L^T (lower, in place).
  for (int j = 0; j < m; ++j) {
    double diag = K[j * m + j];
    for (int k = 0; k < j; ++k) diag -= K[j * m + k] * K[j * m + k];
    if (diag <= 0) return false;
    diag = std::sqrt(diag);
    K[j * m + j] = diag;
    for (int i = j + 1; i < m; ++i) {
      double s = K[i * m + j];
      for (int k = 0; k < j; ++k) s -= K[i * m + k] * K[j * m + k];
      K[i * m + j] = s / diag;
    }
  }
  // Forward then backward substitution.
  for (int i = 0; i < m; ++i) {
    double s = f[i];
    for (int k = 0; k < i; ++k) s -= K[i * m + k] * d[k];
    d[i] = s / K[i * m + i];
  }
  for (int i = m - 1; i >= 0; --i) {
    double s = d[i];
    for (int k = i + 1; k < m; ++k) s -= K[k * m + i] * d[k];
    d[i] = s / K[i * m + i];
  }
  return true;
}

// Solve (K + reg I) d = f robustly: the shift starts scale-relative
// (reg · (1 + max diag)) and escalates 1e4x per failed factorization, so a
// rank-deficient generalized Jacobian (redundant/degenerate rows of A —
// Ipopt's interior point handles these natively, ref
// polyhedral_constraints.jl:185-197) yields the damped min-norm-style
// direction instead of a failure.  The shift only slows the Newton
// contraction; the linesearch keeps every step a dual ascent.
bool chol_solve(int m, std::vector<double>& K, const double* f, double reg,
                double* d) {
  double scale = 0.0;
  for (int i = 0; i < m; ++i) scale = std::fmax(scale, K[i * m + i]);
  double shift = reg * (1.0 + scale);
  std::vector<double> Kcopy(K);
  for (int attempt = 0; attempt < 8; ++attempt) {
    K = Kcopy;
    if (chol_solve_once(m, K, f, shift, d)) return true;
    shift = (shift > 0 ? shift : 1e-300) * 1e4;
  }
  return false;
}

}  // namespace

extern "C" {

// Project x onto {v | Av=b, l<=v<=u}.  A is row-major (m x n).
// Returns the number of Newton iterations used, or -1 on failure to reach
// tol (the best iterate is still written to v).
int polyqp_project(int n, int m, const double* x, const double* A,
                   const double* b, const double* l, const double* u,
                   double* v, double tol, int max_iter) {
  if (m == 0) {
    for (int i = 0; i < n; ++i) v[i] = std::fmin(std::fmax(x[i], l[i]), u[i]);
    return 0;
  }
  std::vector<double> lam(m, 0.0), z(n), F(m), d(m), w(n), K(m * m);
  const double reg = 1e-10;

  auto eval_vF = [&](const std::vector<double>& la) {
    // z = x - A' la;  v = clip(z);  F = A v - b
    for (int i = 0; i < n; ++i) {
      double s = x[i];
      for (int r = 0; r < m; ++r) s -= A[r * n + i] * la[r];
      z[i] = s;
      v[i] = std::fmin(std::fmax(s, l[i]), u[i]);
    }
    for (int r = 0; r < m; ++r) {
      double s = -b[r];
      for (int i = 0; i < n; ++i) s += A[r * n + i] * v[i];
      F[r] = s;
    }
  };

  double bnorm = 0.0;
  for (int r = 0; r < m; ++r) bnorm += b[r] * b[r];
  const double tol_val = tol * (1.0 + std::sqrt(bnorm));

  eval_vF(lam);
  for (int it = 0; it < max_iter; ++it) {
    double fn = 0.0;
    for (int r = 0; r < m; ++r) fn += F[r] * F[r];
    if (std::sqrt(fn) <= tol_val) return it;

    // Generalized Jacobian K = A D A^T, D = diag(1{l < z < u}).
    std::fill(K.begin(), K.end(), 0.0);
    for (int i = 0; i < n; ++i) {
      if (z[i] > l[i] && z[i] < u[i]) {
        for (int r = 0; r < m; ++r) {
          const double ari = A[r * n + i];
          if (ari == 0.0) continue;
          for (int c = r; c < m; ++c) K[r * m + c] += ari * A[c * n + i];
        }
      }
    }
    for (int r = 0; r < m; ++r)
      for (int c = 0; c < r; ++c) K[r * m + c] = K[c * m + r];

    if (!chol_solve(m, K, F.data(), reg, d.data())) return -1;

    // Exact linesearch: phi(t) = d' (A clip(z - t w) - b) is non-increasing
    // in t (concave dual); bracket by doubling, then bisect.
    for (int i = 0; i < n; ++i) {
      double s = 0.0;
      for (int r = 0; r < m; ++r) s += A[r * n + i] * d[r];
      w[i] = s;
    }
    double db = 0.0;
    for (int r = 0; r < m; ++r) db += d[r] * b[r];
    auto phi = [&](double t) {
      double s = -db;
      for (int i = 0; i < n; ++i) {
        double zi = z[i] - t * w[i];
        double vi = std::fmin(std::fmax(zi, l[i]), u[i]);
        s += w[i] * vi;
      }
      return s;
    };
    double t_hi = 1.0;
    int grow = 0;
    while (phi(t_hi) > 0 && t_hi < 1e18 && grow++ < 80) t_hi *= 2.0;
    double t_lo = 0.0;
    for (int k = 0; k < 64; ++k) {
      double t_mid = 0.5 * (t_lo + t_hi);
      if (phi(t_mid) > 0) t_lo = t_mid; else t_hi = t_mid;
    }
    const double t = 0.5 * (t_lo + t_hi);
    for (int r = 0; r < m; ++r) lam[r] += t * d[r];
    eval_vF(lam);
  }
  double fn = 0.0;
  for (int r = 0; r < m; ++r) fn += F[r] * F[r];
  return std::sqrt(fn) <= tol_val ? max_iter : -1;
}

// Batched variant: X, V are (batch x n) row-major; shared A, b, l, u.
int polyqp_project_batch(int batch, int n, int m, const double* X,
                         const double* A, const double* b, const double* l,
                         const double* u, double* V, double tol,
                         int max_iter) {
  int worst = 0;
  for (int s = 0; s < batch; ++s) {
    int r = polyqp_project(n, m, X + (size_t)s * n, A, b, l, u,
                           V + (size_t)s * n, tol, max_iter);
    if (r < 0) return -(s + 1);  // 1-based index of failing instance
    if (r > worst) worst = r;
  }
  return worst;
}

}  // extern "C"
