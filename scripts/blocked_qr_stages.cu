// A copy of the panel QR kernel of commit 74f2a8a
// (benlsip_tpu_torch/kernels/csrc/blocked_qr.cu there) with clock64()
// stamps around its four stages, for scripts/blocked_qr_stages.py: thread 0
// of each block adds the SM cycles between the block's barriers to five
// counters (the panel load with R's zeroing, the two projection passes, the
// in-panel modified Gram-Schmidt, the CholeskyQR step with the division by
// the norms, the whole kernel) and writes them to stamps[5 * instance ...].
// Built on its own by that script; not part of the package.
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
blocked_qr_r_kernel(const T* __restrict__ S, T* R, T* ws, int D, int N, int LD, T tiny, long long* stamps) {
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

  const long long t_start = clock64();
  long long t0 = t_start, t_load = 0, t_proj = 0, t_mgs = 0, t_reorth = 0;
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
    const long long t1 = clock64();
    t_load += t1 - t0;

    // 2. Project out the finished panels, one after another, twice.
    for (int j = 0; j < k; ++j) {
      project_out<T, BW, false>(q_ws + static_cast<size_t>(j) * BW * LD, panel, wpart,
                                r + static_cast<size_t>(j) * BW * N + c0, N, nc, LD, groups);
    }
    for (int j = 0; j < k; ++j) {
      project_out<T, BW, true>(q_ws + static_cast<size_t>(j) * BW * LD, panel, wpart,
                               r + static_cast<size_t>(j) * BW * N + c0, N, nc, LD, groups);
    }

    const long long t2 = clock64();
    t_proj += t2 - t1;
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

    const long long t3 = clock64();
    t_mgs += t3 - t2;
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
    t0 = clock64();
    t_reorth += t0 - t3;
  }
  if (tid == 0) {
    long long* st = stamps + 5 * static_cast<size_t>(blockIdx.x);
    st[0] = t_load;
    st[1] = t_proj;
    st[2] = t_mgs;
    st[3] = t_reorth;
    st[4] = clock64() - t_start;
  }
}

template <typename T, int BW>
int launch_width(const T* S, T* R, T* ws, int B, int D, int N, int LD, long long* stamps, void* stream) {
  const size_t smem = (static_cast<size_t>(BW) * LD + kQrWarps * BW * BW + 2 * BW) * sizeof(T);
  if (smem > kMaxDynamicSmem) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = blocked_qr_r_kernel<T, BW>;
  const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<B, kQrThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      S, R, ws, D, N, LD, std::numeric_limits<T>::min(), stamps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const T* S, T* R, T* ws, int B, int D, int N, int BW, int LD, long long* stamps, void* stream) {
  if (B <= 0 || N < 1 || D < N || LD % 4 != 0 || LD < D) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (BW) {
    case 32: return launch_width<T, 32>(S, R, ws, B, D, N, LD, stamps, stream);
    case 16: return launch_width<T, 16>(S, R, ws, B, D, N, LD, stamps, stream);
    case 8: return launch_width<T, 8>(S, R, ws, B, D, N, LD, stamps, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

BENLSIP_API int blocked_qr_stages_f32(const float* S, float* R, float* ws, int B, int D, int N, int BW, int LD,
                                      long long* stamps, void* stream) {
  return launch<float>(S, R, ws, B, D, N, BW, LD, stamps, stream);
}
