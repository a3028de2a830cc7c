// R factor of a batch of tall matrices by left-looking block Gram-Schmidt
// (two projection passes against the finished panels, modified
// Gram-Schmidt inside each panel, each finished panel reorthogonalized by
// one CholeskyQR step): S (B, D, N) -> upper-triangular R (B, N, N),
// R^T R = S^T S, positive diagonal.
//
// The Hopper redesign of the Pallas TPU kernel `batched_thin_qr` /
// `_mgs_qr_kernel` (benlsip_tpu/kernels/batched_linalg.py:147,170) for the
// wide R-only factorizations (16 < N) that the TPU kernel's gate left to
// the library: the polish factors [JZ; D] at (64, 1216, 192).  The narrow
// kernel (thin_qr.cu) stays for N <= 16.
//
// What bounds it on the H100: operations (2 D N^2 - 2/3 N^3 a matrix, in
// true float32 on the CUDA cores; each byte of S is read once; the second
// projection pass below brings the kernel's own count to nearly twice
// that, the reorthogonalization adds 4 D BW^2 a finished panel), and
// before those the serial chain of N column steps.  One instance (1216 x 192 x 4 B
// = 934 KB) does not fit in an SM's shared memory; a panel of BW columns
// does.  So one thread block of 256 threads factors one instance, the whole
// batch in one launch, panel by panel:
//
//   1. the panel's columns are read from S into shared memory, column-major
//      with a leading dimension LD = 4 (mod 32) so that four lanes reading
//      four columns at the same rows hit sixteen different banks, and rows
//      padded with zeros to a multiple of 4 so that every access is a
//      16-byte vector of four rows;
//   2. for each finished panel Q_j in turn (streamed from a workspace in
//      global memory that the block wrote itself and that stays in L2):
//      W = Q_j^T P as register tiles (a lane holds BW/8 x BW/4 entries, the
//      warps split the rows, their partial sums are added in a fixed order
//      in shared memory), W goes to R, and P -= Q_j W with lanes over rows;
//      then the same loop once more, each W' added into R (R_jk = W + W')
//      and P -= Q_j W'.  One pass of block classical Gram-Schmidt against
//      panels that are orthonormal to working precision leaves
//      kappa^2 * eps in R (up to 1e2 kappa * eps in float32 where the last
//      panel is ragged); the second pass takes out what the first left
//      ("twice is enough": block CGS2).  "Twice is enough" needs each
//      finished Q_j orthonormal to working precision, which step 4 sees to;
//   3. modified Gram-Schmidt inside the panel in shared memory: at step c
//      one warp per later column takes the column's dot product s with
//      column c (lanes over rows, __shfl_xor_sync) and updates it at once
//      with s / max(s_cc, tiny), one barrier a step; the columns stay
//      unnormalised and R gets s / sqrt(max(s_cc, tiny)), so a zero column
//      never divides by zero and a NaN stays in its own instance (its own
//      block);
//   4. unless the panel is the last (only R is wanted, Q is never returned,
//      and the last panel's Q is never reused): the panel is divided by its
//      norms, which leaves Q_1 orthonormal only to kappa(panel) * eps
//      (modified Gram-Schmidt), and reorthogonalized by one CholeskyQR
//      step: G = Q_1^T Q_1 with the register tiles of step 2, R_2 =
//      chol(G) in one warp, Q_k = Q_1 R_2^-1 (R_2^-1 in the same warp,
//      the product with lanes over rows) written to the workspace, and the
//      panel's diagonal block of R set to R_2 R_1.  Without the step the
//      chord contraction of R reached 8 kappa * eps at (4, 300, 36),
//      kappa = 1e6.  A panel whose G is not positive definite (a zero or
//      NaN column) keeps R_2 = I: Q_k = Q_1 and R_1, never a NaN from the
//      step.  The step adds one Gram and one product of D x BW x BW a
//      finished panel and no column step to the serial chain.
//
// S is read once and never written.  The caller passes the panel width BW
// (32, 16 or 8: the widest whose panel fits beside the partial sums in the
// 227 KB a block may use) and LD, and a workspace of
// ceil(N / BW - 1) * BW * LD elements an instance.
#include <limits>

#include "common.cuh"

namespace {

using benlsip::warp_sum;

constexpr int kQrThreads = 256;
constexpr int kQrWarps = kQrThreads / 32;
constexpr size_t kMaxDynamicSmem = 232448;  // 227 KB, the most a block may opt in to

// Four consecutive rows of one column.
template <typename T>
struct alignas(4 * sizeof(T)) Vec4 {
  T v[4];
};

template <typename T>
__device__ __forceinline__ Vec4<T> load4(const T* p) {
  return *reinterpret_cast<const Vec4<T>*>(p);
}

template <typename T>
__device__ __forceinline__ void store4(T* p, const Vec4<T>& x) {
  *reinterpret_cast<Vec4<T>*>(p) = x;
}

// Dot product of two columns of the panel over the lanes of one warp;
// every lane gets the sum.
template <typename T>
__device__ __forceinline__ T column_dot(const T* p, const T* q, int lane, int groups) {
  T acc[4] = {T(0), T(0), T(0), T(0)};
#pragma unroll 4
  for (int g = lane; g < groups; g += 32) {
    const Vec4<T> u = load4(p + 4 * g), v = load4(q + 4 * g);
#pragma unroll
    for (int x = 0; x < 4; ++x) acc[x] += u.v[x] * v.v[x];
  }
  return warp_sum((acc[0] + acc[1]) + (acc[2] + acc[3]));
}

// W = Qj^T P, the block's sum, into wpart[0 .. BW*BW) (row-major: W[a][b]
// is column a of Qj dotted with column b of P).  Called by every thread of
// the block; ends with a barrier.
template <typename T, int BW>
__device__ __forceinline__ void block_inner(const T* qj, const T* panel, T* wpart, int LD, int groups) {
  constexpr int TA = BW / 8, TB = BW / 4;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int a = lane >> 2, b = lane & 3;

  // Lane (a, b) holds W[a + 8 ta][b + 4 tb]; warp w sums over the row
  // groups w, w + 8, ...
  T acc[TA][TB];
#pragma unroll
  for (int ta = 0; ta < TA; ++ta) {
#pragma unroll
    for (int tb = 0; tb < TB; ++tb) acc[ta][tb] = T(0);
  }
#pragma unroll 2
  for (int g = warp; g < groups; g += kQrWarps) {
    Vec4<T> qv[TA], pv[TB];
#pragma unroll
    for (int ta = 0; ta < TA; ++ta) qv[ta] = load4(qj + (a + 8 * ta) * LD + 4 * g);
#pragma unroll
    for (int tb = 0; tb < TB; ++tb) pv[tb] = load4(panel + (b + 4 * tb) * LD + 4 * g);
#pragma unroll
    for (int x = 0; x < 4; ++x) {
#pragma unroll
      for (int ta = 0; ta < TA; ++ta) {
#pragma unroll
        for (int tb = 0; tb < TB; ++tb) acc[ta][tb] += qv[ta].v[x] * pv[tb].v[x];
      }
    }
  }
#pragma unroll
  for (int ta = 0; ta < TA; ++ta) {
#pragma unroll
    for (int tb = 0; tb < TB; ++tb) {
      wpart[(warp * BW + a + 8 * ta) * BW + b + 4 * tb] = acc[ta][tb];
    }
  }
  __syncthreads();

  // The warps' partial sums, added in warp order.
  for (int e = tid; e < BW * BW; e += kQrThreads) {
    T w = wpart[e];
#pragma unroll
    for (int ww = 1; ww < kQrWarps; ++ww) w += wpart[ww * BW * BW + e];
    wpart[e] = w;
  }
  __syncthreads();
}

// W = Qj^T P (block_inner) into the block of R at r_block (columns < nc
// only; written, or with kAccumulate added to what is there), then
// P -= Qj W.  Called by every thread of the block.
template <typename T, int BW, bool kAccumulate>
__device__ __forceinline__ void project_out(const T* qj, T* panel, T* wpart, T* r_block, int N,
                                            int nc, int LD, int groups) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  block_inner<T, BW>(qj, panel, wpart, LD, groups);
  for (int e = tid; e < BW * BW; e += kQrThreads) {
    const int row = e / BW, col = e % BW;
    if (col < nc) {
      T* rr = r_block + static_cast<size_t>(row) * N + col;
      *rr = kAccumulate ? *rr + wpart[e] : wpart[e];
    }
  }

  // P -= Qj W: a lane owns four rows of eight columns; a warp takes 128
  // rows of one group of eight columns at a time.
  constexpr int NCG = BW / 8;
  const int chunks = (groups + 31) / 32;
  for (int u = warp; u < NCG * chunks; u += kQrWarps) {
    const int cg = u % NCG;
    const int g = (u / NCG) * 32 + lane;
    if (g >= groups) continue;
    T* p = panel + (cg * 8) * LD + 4 * g;
    Vec4<T> out[8];
#pragma unroll
    for (int t = 0; t < 8; ++t) out[t] = load4(p + t * LD);
#pragma unroll 8
    for (int c = 0; c < BW; ++c) {
      const Vec4<T> qv = load4(qj + c * LD + 4 * g);
      const Vec4<T> w0 = load4(wpart + c * BW + cg * 8), w1 = load4(wpart + c * BW + cg * 8 + 4);
#pragma unroll
      for (int t = 0; t < 4; ++t) {
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          out[t].v[x] -= qv.v[x] * w0.v[t];
          out[t + 4].v[x] -= qv.v[x] * w1.v[t];
        }
      }
    }
#pragma unroll
    for (int t = 0; t < 8; ++t) store4(p + t * LD, out[t]);
  }
  __syncthreads();
}

// One CholeskyQR step on a finished panel Q_1 (the BW columns of `panel`,
// divided by their norms): G = Q_1^T Q_1, R_2 = chol(G) (upper, in
// wpart[0 .. BW*BW)), X = R_2^-1 (in the second BW x BW slot of wpart), the
// panel's diagonal block of R (r_block, upper, R_1) staged in the third
// slot; then Q_k = Q_1 X into qk and r_block = R_2 R_1.  A G that is not
// positive definite (a pivot not > 0, NaN included) leaves R_2 = I:
// qk = Q_1 and r_block as it is.  `flag` is one scalar of shared memory.
// Called by every thread of the block; ends with a barrier.
template <typename T, int BW>
__device__ __forceinline__ void reorthogonalize(const T* panel, T* wpart, T* flag, T* qk, T* r_block, int N,
                                                int LD, int groups) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  T* g = wpart;                    // G, then R_2 in its upper triangle
  T* xinv = wpart + BW * BW;       // R_2^-1, zeros below the diagonal
  T* r1 = wpart + 2 * BW * BW;     // R_1
  block_inner<T, BW>(panel, panel, g, LD, groups);

  if (warp == 0) {
    // Right-looking Cholesky, lane j owns column j: row c of R_2 is
    // G[c][j] / sqrt(G[c][c]), then G[i][j] -= R_2[c][i] R_2[c][j], j >= i > c.
    bool ok = true;
    for (int c = 0; c < BW; ++c) {
      const T d = g[c * BW + c];
      if (!(d > T(0))) {           // the same value in every lane: a uniform exit
        ok = false;
        break;
      }
      const T rc = sqrt(d);
      const T rcj = (lane > c && lane < BW) ? g[c * BW + lane] / rc : T(0);
      __syncwarp();
      if (lane > c && lane < BW) g[c * BW + lane] = rcj;
      if (lane == c) g[c * BW + c] = rc;
      for (int i = c + 1; i < BW; ++i) {
        const T rci = __shfl_sync(0xffffffffu, rcj, i);
        if (lane >= i && lane < BW) g[i * BW + lane] -= rci * rcj;
      }
      __syncwarp();
    }
    if (ok && lane < BW) {
      // Column j of R_2^-1 by back substitution, in lane j.
      const int j = lane;
      for (int i = BW - 1; i >= 0; --i) {
        T v = T(0);
        if (i == j) {
          v = T(1) / g[j * BW + j];
        } else if (i < j) {
          T acc = T(0);
          for (int l = i + 1; l <= j; ++l) acc += g[i * BW + l] * xinv[l * BW + j];
          v = -acc / g[i * BW + i];
        }
        xinv[i * BW + j] = v;
      }
    }
    if (lane == 0) *flag = ok ? T(1) : T(0);
  } else {
    for (int e = tid - 32; e < BW * BW; e += kQrThreads - 32) {
      r1[e] = r_block[static_cast<size_t>(e / BW) * N + e % BW];
    }
  }
  __syncthreads();
  const bool ok = *flag != T(0);

  // Q_k = Q_1 X: a lane owns four rows of eight columns, as in project_out.
  constexpr int NCG = BW / 8;
  const int chunks = (groups + 31) / 32;
  for (int u = warp; u < NCG * chunks; u += kQrWarps) {
    const int cg = u % NCG;
    const int gr = (u / NCG) * 32 + lane;
    if (gr >= groups) continue;
    Vec4<T> out[8];
    if (ok) {
#pragma unroll
      for (int t = 0; t < 8; ++t) out[t] = Vec4<T>{{T(0), T(0), T(0), T(0)}};
#pragma unroll 8
      for (int c = 0; c < BW; ++c) {
        const Vec4<T> qv = load4(panel + c * LD + 4 * gr);
        const Vec4<T> x0 = load4(xinv + c * BW + cg * 8), x1 = load4(xinv + c * BW + cg * 8 + 4);
#pragma unroll
        for (int t = 0; t < 4; ++t) {
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            out[t].v[x] += qv.v[x] * x0.v[t];
            out[t + 4].v[x] += qv.v[x] * x1.v[t];
          }
        }
      }
    } else {
#pragma unroll
      for (int t = 0; t < 8; ++t) out[t] = load4(panel + (cg * 8 + t) * LD + 4 * gr);
    }
#pragma unroll
    for (int t = 0; t < 8; ++t) store4(qk + (cg * 8 + t) * LD + 4 * gr, out[t]);
  }

  // R_2 R_1 into the panel's diagonal block (both upper triangular).
  if (ok) {
    for (int e = tid; e < BW * BW; e += kQrThreads) {
      const int i = e / BW, j = e % BW;
      if (j < i) continue;
      T acc = T(0);
      for (int l = i; l <= j; ++l) acc += g[i * BW + l] * r1[l * BW + j];
      r_block[static_cast<size_t>(i) * N + j] = acc;
    }
  }
  __syncthreads();   // the workspace is read back by this block only
}

template <typename T, int BW>
__global__ void __launch_bounds__(kQrThreads)
blocked_qr_r_kernel(const T* __restrict__ S, T* R, T* ws, int D, int N, int LD, T tiny) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* panel = reinterpret_cast<T*>(smem_raw);   // BW columns of LD rows
  T* wpart = panel + BW * LD;                  // kQrWarps partial W, BW x BW each
  T* ssq = wpart + kQrWarps * BW * BW;         // squared norm of each column when it becomes the pivot
  T* nrm = ssq + BW;                           // the panel's column norms

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int npanels = (N + BW - 1) / BW;
  const int groups = (D + 3) / 4;              // row groups of four; rows >= D hold zeros
  const T* s = S + static_cast<size_t>(blockIdx.x) * D * N;
  T* r = R + static_cast<size_t>(blockIdx.x) * N * N;
  T* q_ws = ws + static_cast<size_t>(blockIdx.x) * (npanels - 1) * BW * LD;

  for (int e = tid; e < N * N; e += kQrThreads) r[e] = T(0);

  for (int k = 0; k < npanels; ++k) {
    const int c0 = k * BW;
    const int nc = min(BW, N - c0);

    // 1. The panel, transposed into shared memory; zeros past N and D.
#pragma unroll 8
    for (int e = tid; e < BW * 4 * groups; e += kQrThreads) {
      const int c = e % BW, i = e / BW;
      panel[c * LD + i] = (c < nc && i < D) ? s[static_cast<size_t>(i) * N + c0 + c] : T(0);
    }
    __syncthreads();

    // 2. Project out the finished panels, one after another, twice.
    for (int j = 0; j < k; ++j) {
      project_out<T, BW, false>(q_ws + static_cast<size_t>(j) * BW * LD, panel, wpart,
                                r + static_cast<size_t>(j) * BW * N + c0, N, nc, LD, groups);
    }
    for (int j = 0; j < k; ++j) {
      project_out<T, BW, true>(q_ws + static_cast<size_t>(j) * BW * LD, panel, wpart,
                               r + static_cast<size_t>(j) * BW * N + c0, N, nc, LD, groups);
    }

    // 3. Modified Gram-Schmidt inside the panel.  At step c a warp owns
    // the later columns c + 1 + warp, + 8, ...: it takes the column's dot
    // product with column c, writes the entry of R, updates the column
    // and, for column c + 1, sums the squares of what it wrote: the next
    // step's pivot.  One barrier a step.
    if (warp == 0) {
      const T s00 = column_dot(panel, panel, lane, groups);
      if (lane == 0) ssq[0] = s00;
    }
    __syncthreads();
    for (int c = 0; c < nc; ++c) {
      const T* pc = panel + c * LD;
      // max(s_cc, tiny) with NaN propagating, as the narrow kernel has it.
      const T scc = ssq[c];
      const T ss = (scc > tiny || scc != scc) ? scc : tiny;
      const T nr = sqrt(ss);
      T* r_row = r + static_cast<size_t>(c0 + c) * N + c0;
      if (tid == 0) {
        nrm[c] = nr;
        r_row[c] = nr;
      }
      for (int cc = c + 1 + warp; cc < nc; cc += kQrWarps) {
        T* pcc = panel + cc * LD;
        const T scol = column_dot(pc, pcc, lane, groups);
        if (lane == 0) r_row[cc] = scol / nr;
        const T f = scol / ss;
        T sq[4] = {T(0), T(0), T(0), T(0)};
#pragma unroll 4
        for (int g = lane; g < groups; g += 32) {
          const Vec4<T> u = load4(pc + 4 * g);
          Vec4<T> v = load4(pcc + 4 * g);
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            v.v[x] -= u.v[x] * f;
            sq[x] += v.v[x] * v.v[x];
          }
          store4(pcc + 4 * g, v);
        }
        if (cc == c + 1) {
          const T snext = warp_sum((sq[0] + sq[1]) + (sq[2] + sq[3]));
          if (lane == 0) ssq[cc] = snext;
        }
      }
      __syncthreads();
    }

    // 4. Q_k, kept for the later panels: P / norms, reorthogonalized.
    if (k + 1 < npanels) {   // nc == BW: only the last panel is ragged
      for (int e = tid; e < BW * groups; e += kQrThreads) {
        const int c = e / groups, g = e % groups;
        Vec4<T> v = load4(panel + c * LD + 4 * g);
        const T nr = nrm[c];
#pragma unroll
        for (int x = 0; x < 4; ++x) v.v[x] = v.v[x] / nr;
        store4(panel + c * LD + 4 * g, v);
      }
      __syncthreads();
      reorthogonalize<T, BW>(panel, wpart, ssq, q_ws + static_cast<size_t>(k) * BW * LD,
                             r + static_cast<size_t>(c0) * N + c0, N, LD, groups);
    }
  }
}

template <typename T, int BW>
int launch_width(const T* S, T* R, T* ws, int B, int D, int N, int LD, void* stream) {
  const size_t smem = (static_cast<size_t>(BW) * LD + kQrWarps * BW * BW + 2 * BW) * sizeof(T);
  if (smem > kMaxDynamicSmem) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = blocked_qr_r_kernel<T, BW>;
  const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<B, kQrThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      S, R, ws, D, N, LD, std::numeric_limits<T>::min());
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const T* S, T* R, T* ws, int B, int D, int N, int BW, int LD, void* stream) {
  if (B <= 0 || N < 1 || D < N || LD % 4 != 0 || LD < D) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (BW) {
    case 32: return launch_width<T, 32>(S, R, ws, B, D, N, LD, stream);
    case 16: return launch_width<T, 16>(S, R, ws, B, D, N, LD, stream);
    case 8: return launch_width<T, 8>(S, R, ws, B, D, N, LD, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

BENLSIP_API int benlsip_blocked_qr_r_f32(const float* S, float* R, float* ws, int B, int D, int N,
                                         int BW, int LD, void* stream) {
  return launch<float>(S, R, ws, B, D, N, BW, LD, stream);
}

BENLSIP_API int benlsip_blocked_qr_r_f64(const double* S, double* R, double* ws, int B, int D, int N,
                                         int BW, int LD, void* stream) {
  return launch<double>(S, R, ws, B, D, N, BW, LD, stream);
}
