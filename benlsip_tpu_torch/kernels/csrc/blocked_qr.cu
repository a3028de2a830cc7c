// R factor of a batch of tall matrices by left-looking block Gram-Schmidt
// (two projection passes against the finished panels, modified
// Gram-Schmidt inside each panel, each finished panel reorthogonalized by
// one CholeskyQR step): S (B, D, N) -> upper-triangular R (B, N, N),
// R^T R = S^T S, positive diagonal.  With dbot (B, N) the matrix is the
// stacked [S; diag(dbot)] (D + N rows), whose last N rows the kernel makes
// up as it loads them: the polish's factor without the stacked copy.
//
// The Hopper redesign of the Pallas TPU kernel `batched_thin_qr` /
// `_mgs_qr_kernel` (benlsip_tpu/kernels/batched_linalg.py:147,170) for the
// wide R-only factorizations (16 < N) that the TPU kernel's gate left to
// the library: the polish factors [JZ; D] at (64, 1216, 192).  The narrow
// kernel (thin_qr.cuh) stays for N <= 16.
//
// What bounds it on the H100: 2 D N^2 - 2/3 N^3 operations a matrix (the
// second projection pass brings the kernel's own count to nearly twice
// that, the reorthogonalization adds 4 D BW^2 a finished panel), each byte
// of S read once; before those, the serial chain of N column steps, each a
// reduction over D rows.  The design, per instance:
//
//   * a thread-block cluster of C blocks (the plan: C from D alone, so that
//     an instance's bits do not depend on its batch) splits the rows; each
//     block keeps its slice of rows of the current panel of BW columns in
//     shared memory, column-major with a leading dimension LD = 4 (mod 32);
//     sums over rows are taken per block and added across the cluster in
//     rank order through distributed shared memory, so every block holds the
//     same bits of every reduced value and no atomics are used;
//   * the panel products (W = Qj^T P, P -= Qj W, G = Q^T Q, Q R2^-1) run on
//     the tensor cores in 3xTF32 (float32; `mma.sync` m16n8k8): each operand
//     split into a TF32 high part and a TF32 remainder, the three products
//     hi*hi, hi*lo, lo*hi summed in float32 accumulators (the small-by-small
//     term dropped), which keeps float32's accuracy; float64 runs the same
//     steps on the CUDA cores;
//   * each block writes its rows of the finished Q panels to a workspace in
//     global memory (L2-resident) and reads back only its own rows, the
//     loads of a tile issued ahead of the products that consume them;
//   * modified Gram-Schmidt inside the panel takes one cluster barrier a
//     column step: at step c every warp holds column c (the pivot) in
//     registers, reads the reduced dots s_cj, computes column c+1's update
//     itself (the next pivot), and updates its share of the later columns,
//     each followed at once by its partial dot with the next pivot; all
//     warps work on every step;
//   * the CholeskyQR step of a finished panel (G = Q1^T Q1, R2 = chol(G),
//     Q = Q1 R2^-1, the panel's diagonal block of R set to R2 R1) runs its
//     factorization and triangular inverse over all of the block's threads,
//     one step a barrier; a G that is not positive definite (a zero or NaN
//     column) keeps R2 = I.
//
// The columns stay unnormalised in the column steps and R gets
// s / sqrt(max(s_cc, tiny)), so a zero column gets sqrt(tiny) on the
// diagonal and a NaN stays in its own instance.  S is read once and never
// written.  The caller passes the plan (C, the padded rows of a block, LD)
// and a workspace of (ceil(N / BW) - 1) * BW * C * rows elements an instance.
#include <cooperative_groups.h>

#include <cstdint>
#include <limits>

#include "common.cuh"

namespace {

namespace cg = cooperative_groups;
using benlsip::warp_sum;

constexpr int kQrThreads = 256;
constexpr int kQrWarps = kQrThreads / 32;
constexpr int kLaneGroups = 5;        // row groups of four a lane holds in a column step: at most 640 rows a block
constexpr int kMaxCluster = 8;
constexpr size_t kMaxDynamicSmem = 232448;  // 227 KB, the most a block may opt in to

// The panel width of each instantiation: the tensor-core form (float32)
// takes 64 columns, the float64 form 32 (its panel of 640 rows fits).
template <typename T>
struct Panel {
  static constexpr int kWidth = 64;
  static constexpr bool kMma = true;
};
template <>
struct Panel<double> {
  static constexpr int kWidth = 32;
  static constexpr bool kMma = false;
};

// Row stride of the width x width blocks (W, G, R2, its inverse) in shared
// memory: width + 4, so that the tensor-core fragments' accesses hit 32
// different banks.
template <typename T>
__host__ __device__ constexpr int block_stride() {
  return Panel<T>::kWidth + 4;
}

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

// ---------------------------------------------------------------------------
// The cluster: its barrier and the same address in its other blocks
// ---------------------------------------------------------------------------

struct Cluster {
  int size, rank;

  __device__ __forceinline__ void sync() const {
    if (size > 1) {
      cg::this_cluster().sync();
    } else {
      __syncthreads();
    }
  }
  // The same shared-memory address in block `r` of the cluster.
  template <typename T>
  __device__ __forceinline__ const T* at(const T* p, int r) const {
    return size > 1 ? cg::this_cluster().map_shared_rank(const_cast<T*>(p), static_cast<unsigned>(r)) : p;
  }
  template <typename T>
  __device__ __forceinline__ T* at_mut(T* p, int r) const {
    return size > 1 ? cg::this_cluster().map_shared_rank(p, static_cast<unsigned>(r)) : p;
  }
};

// Every block's partial width x width block, summed over the cluster in rank
// order into out (local): the partials were written before the call; ends
// with out complete in this block.
template <typename T>
__device__ __forceinline__ void cluster_reduce(const Cluster& cl, const T* part, T* out) {
  constexpr int BW = Panel<T>::kWidth, WS = block_stride<T>();
  cl.sync();
  for (int e = threadIdx.x; e < BW * BW / 4; e += kQrThreads) {
    const int i = (4 * e) / BW * WS + (4 * e) % BW;
    Vec4<T> v = load4(cl.at(part, 0) + i);
    for (int r = 1; r < cl.size; ++r) {
      const Vec4<T> u = load4(cl.at(part, r) + i);
#pragma unroll
      for (int x = 0; x < 4; ++x) v.v[x] += u.v[x];
    }
    store4(out + i, v);
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// 3xTF32 on the tensor cores
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo to float32's precision: hi the nearest TF32 value, lo the
// (exact) remainder, of which the tensor core reads the leading TF32 bits:
// |lo| <= 2^-11 |x|, so what is lost of lo and of lo * lo is below 2^-22 |x|.
struct Split {
  uint32_t hi, lo;
};

__device__ __forceinline__ Split split(float x) {
  const uint32_t hi = to_tf32(x);
  return {hi, __float_as_uint(x - __uint_as_float(hi))};
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3,
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// d += a b for one m16n8k8 tile, a and b split: the two cross terms first,
// then the high parts.
__device__ __forceinline__ void mma3(float (&d)[4], const Split (&a)[4], const Split (&b)[2]) {
  mma_tf32(d, a[0].lo, a[1].lo, a[2].lo, a[3].lo, b[0].hi, b[1].hi);
  mma_tf32(d, a[0].hi, a[1].hi, a[2].hi, a[3].hi, b[0].lo, b[1].lo);
  mma_tf32(d, a[0].hi, a[1].hi, a[2].hi, a[3].hi, b[0].hi, b[1].hi);
}

// Fragments of m16n8k8 (g = lane / 4, t = lane % 4): A (16 x 8) a0 (g, t),
// a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4); B (8 x 8) b0 (t, g), b1
// (t + 4, g); C (16 x 8) c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3
// (g + 8, 2t + 1).  With LD = 4 (mod 32) and WS = 4 (mod 32) the
// fragments' shared-memory accesses below hit 32 different banks; in the
// products whose k runs over columns (P -= A B), k slots t and t + 4 stand
// for the neighbouring columns 2t and 2t + 1 of both operands (the sum over
// k does not care), which keeps those accesses apart too.

// Partial W = A^T P over this block's rows into part (row-major, stride WS):
// A and P column-major (leading dimensions lda, LD), `rows` rows (a multiple
// of 16), 64 columns each.  A may lie in global or shared memory.  Warp w
// owns the 32 x 32 quarter (w % 2, (w / 2) % 2) of W over half of the rows
// (w / 4); the second half's sums go through `scratch` (64 x WS, shared) and
// are added in a fixed order.  A's loads are issued four k-steps ahead.
__device__ __forceinline__ void gram_partial(const float* A, int lda, const float* P, int LD, int rows, float* part,
                                             float* scratch) {
  constexpr int WS = block_stride<float>(), PF = 4;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = 32 * (warp & 1), n0 = 32 * ((warp >> 1) & 1), half = warp >> 2;
  const int k_begin = half * (rows / 2), k_end = k_begin + rows / 2;
  const float* a = A + static_cast<size_t>(m0 + g) * lda + t;
  const float* p = P + static_cast<size_t>(n0 + g) * LD + t;
  float acc[2][4][4] = {};
  float av[PF][2][4];
  auto load_a = [&](float (&v)[2][4], int k) {
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const float* q = a + static_cast<size_t>(16 * mt) * lda + k;
      v[mt][0] = q[0];
      v[mt][1] = q[static_cast<size_t>(8) * lda];
      v[mt][2] = q[4];
      v[mt][3] = q[static_cast<size_t>(8) * lda + 4];
    }
  };
#pragma unroll
  for (int s = 0; s < PF; ++s) {
    if (k_begin + 8 * s < k_end) load_a(av[s], k_begin + 8 * s);
  }
  for (int k0 = k_begin; k0 < k_end; k0 += 8 * PF) {
#pragma unroll
    for (int s = 0; s < PF; ++s) {
      const int k = k0 + 8 * s;
      if (k < k_end) {
        Split as[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
          for (int x = 0; x < 4; ++x) as[mt][x] = split(av[s][mt][x]);
        }
        if (k + 8 * PF < k_end) load_a(av[s], k + 8 * PF);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float* q = p + static_cast<size_t>(8 * j) * LD + k;
          const Split bs[2] = {split(q[0]), split(q[4])};
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) mma3(acc[mt][j], as[mt], bs);
        }
      }
    }
  }
  // The second half's sums to scratch, then the first half adds them (part
  // is complete after the caller's next barrier).
  if (half) {
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float* o = scratch + (m0 + 16 * mt + g) * WS + n0 + 8 * j + 2 * t;
        *reinterpret_cast<float2*>(o) = make_float2(acc[mt][j][0], acc[mt][j][1]);
        *reinterpret_cast<float2*>(o + 8 * WS) = make_float2(acc[mt][j][2], acc[mt][j][3]);
      }
    }
  }
  __syncthreads();
  if (!half) {
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int e = (m0 + 16 * mt + g) * WS + n0 + 8 * j + 2 * t;
        const float2 u = *reinterpret_cast<const float2*>(scratch + e);
        const float2 w = *reinterpret_cast<const float2*>(scratch + e + 8 * WS);
        *reinterpret_cast<float2*>(part + e) = make_float2(acc[mt][j][0] + u.x, acc[mt][j][1] + u.y);
        *reinterpret_cast<float2*>(part + e + 8 * WS) = make_float2(acc[mt][j][2] + w.x, acc[mt][j][3] + w.y);
      }
    }
  }
}

// out = A Bm (kSubtract: out -= A Bm) over this block's rows: A (rows x BW)
// column-major with leading dimension lda, Bm (BW x BW) row-major with
// stride WS in shared memory, out column-major with leading dimension ldo
// (shared memory for kSubtract, else global).  Warps take the 16-row tiles
// in turn, each tile's A loads issued before its products.
template <bool kSubtract>
__device__ __forceinline__ void panel_product(const float* A, int lda, const float* Bm, float* out, int ldo, int rows) {
  constexpr int BW = 64, WS = block_stride<float>();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  for (int m0 = 16 * warp; m0 < rows; m0 += 16 * kQrWarps) {
    float av[BW / 8][4];
#pragma unroll
    for (int ks = 0; ks < BW / 8; ++ks) {
      const float* a = A + static_cast<size_t>(8 * ks + 2 * t) * lda + m0 + g;
      av[ks][0] = a[0];
      av[ks][1] = a[8];
      av[ks][2] = a[lda];
      av[ks][3] = a[lda + 8];
    }
    float acc[BW / 8][4];
    float* o = out + static_cast<size_t>(2 * t) * ldo + m0 + g;
#pragma unroll
    for (int nt = 0; nt < BW / 8; ++nt) {
      if (kSubtract) {
        const float* on = o + static_cast<size_t>(8 * nt) * ldo;
        acc[nt][0] = on[0];
        acc[nt][1] = on[ldo];
        acc[nt][2] = on[8];
        acc[nt][3] = on[ldo + 8];
      } else {
#pragma unroll
        for (int x = 0; x < 4; ++x) acc[nt][x] = 0.0f;
      }
    }
#pragma unroll
    for (int ks = 0; ks < BW / 8; ++ks) {
      const float sign = kSubtract ? -1.0f : 1.0f;
      const Split a[4] = {split(sign * av[ks][0]), split(sign * av[ks][1]), split(sign * av[ks][2]),
                          split(sign * av[ks][3])};
      const float* b = Bm + (8 * ks + 2 * t) * WS + g;
#pragma unroll
      for (int nt = 0; nt < BW / 8; ++nt) {
        const Split bs[2] = {split(b[8 * nt]), split(b[WS + 8 * nt])};
        mma3(acc[nt], a, bs);
      }
    }
#pragma unroll
    for (int nt = 0; nt < BW / 8; ++nt) {
      float* on = o + static_cast<size_t>(8 * nt) * ldo;
      on[0] = acc[nt][0];
      on[ldo] = acc[nt][1];
      on[8] = acc[nt][2];
      on[ldo + 8] = acc[nt][3];
    }
  }
}

// The same two products on the CUDA cores, for float64.
template <typename T>
__device__ __forceinline__ void gram_partial_fma(const T* A, int lda, const T* P, int LD, int rows, T* part, T*) {
  constexpr int BW = Panel<T>::kWidth, WS = block_stride<T>();
  for (int e = threadIdx.x; e < BW * BW; e += kQrThreads) {
    const int a = e / BW, b = e % BW;
    const T* x = A + static_cast<size_t>(a) * lda;
    const T* y = P + static_cast<size_t>(b) * LD;
    T acc[4] = {T(0), T(0), T(0), T(0)};
    for (int i = 0; i < rows; i += 4) {
#pragma unroll
      for (int u = 0; u < 4; ++u) acc[u] += x[i + u] * y[i + u];
    }
    part[a * WS + b] = (acc[0] + acc[1]) + (acc[2] + acc[3]);
  }
}

template <bool kSubtract, typename T>
__device__ __forceinline__ void panel_product_fma(const T* A, int lda, const T* Bm, T* out, int ldo, int rows) {
  constexpr int BW = Panel<T>::kWidth, WS = block_stride<T>();
  for (int e = threadIdx.x; e < rows * BW; e += kQrThreads) {
    const int i = e % rows, b = e / rows;
    T acc = T(0);
    for (int a = 0; a < BW; ++a) acc += A[static_cast<size_t>(a) * lda + i] * Bm[a * WS + b];
    T* o = out + static_cast<size_t>(b) * ldo + i;
    *o = kSubtract ? *o - acc : acc;
  }
}

// The products of the kernel's dtype: tensor cores for float32, FMA for float64.
template <typename T>
__device__ __forceinline__ void gram(const T* A, int lda, const T* P, int LD, int rows, T* part, T* scratch) {
  if constexpr (Panel<T>::kMma) {
    gram_partial(A, lda, P, LD, rows, part, scratch);
  } else {
    gram_partial_fma(A, lda, P, LD, rows, part, scratch);
  }
}

template <bool kSubtract, typename T>
__device__ __forceinline__ void product(const T* A, int lda, const T* Bm, T* out, int ldo, int rows) {
  if constexpr (Panel<T>::kMma) {
    panel_product<kSubtract>(A, lda, Bm, out, ldo, rows);
  } else {
    panel_product_fma<kSubtract>(A, lda, Bm, out, ldo, rows);
  }
}

// ---------------------------------------------------------------------------
// The column steps of one panel
// ---------------------------------------------------------------------------

// K values a lane (K a power of two, at most 32) summed over the warp with
// 2K - 1 + log2(32 / K) shuffles instead of 5 K: each step sends half of the
// values to the partner lane and keeps the other half.  Lane L gets the sum
// of value transpose_index<K>(L); every lane of the value's group of 32 / K
// the same bits.
template <int K>
__device__ __forceinline__ int transpose_index(int lane) {
  int idx = 0;
#pragma unroll
  for (int w = K / 2, off = 16; w >= 1; w /= 2, off /= 2) idx += (lane & off) ? w : 0;
  return idx;
}

template <typename T, int K>
__device__ __forceinline__ T transpose_sum(T (&v)[K], int lane) {
#pragma unroll
  for (int w = K / 2, off = 16; w >= 1; w /= 2, off /= 2) {
    const bool upper = (lane & off) != 0;
#pragma unroll
    for (int k = 0; k < w; ++k) {
      const T send = upper ? v[k] : v[k + w];
      const T keep = upper ? v[k + w] : v[k];
      v[k] = keep + __shfl_xor_sync(0xffffffffu, send, off);
    }
  }
  T x = v[0];
#pragma unroll
  for (int off = 16 / K; off > 0; off /= 2) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Modified Gram-Schmidt on the nc columns of the panel P (this block's
// `rows` rows): R's row c of the panel's diagonal block gets s_cj / sqrt(ss)
// (rank 0 writes it; r_blk is that block in R), nrm[c] = sqrt(ss) with ss =
// max(s_cc, tiny), NaN kept; the columns are left unnormalised.  One cluster
// barrier a step.  Each block pushes its partial dots into every block's
// dpart (by step parity *dpar, then by rank: [2][kMaxCluster][BW]) before
// the barrier, so that after it every block adds the same partials in rank
// order from its own shared memory.
template <typename T>
__device__ void column_steps(const Cluster& cl, T* P, int LD, int rows, int nc, T* r_blk, int N, T* nrm, T* dpart,
                             int* dpar, T tiny) {
  constexpr int BW = Panel<T>::kWidth, kJobs = BW / kQrWarps;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int groups = rows / 4;
  Vec4<T> piv[kLaneGroups], nxt[kLaneGroups], cur[kLaneGroups], ahead[kLaneGroups];
  auto load_col = [&](Vec4<T>(&v)[kLaneGroups], const T* p) {
#pragma unroll
    for (int u = 0; u < kLaneGroups; ++u) {
      const int g = lane + 32 * u;
      v[u] = g < groups ? load4(p + 4 * g) : Vec4<T>{{T(0), T(0), T(0), T(0)}};
    }
  };
  auto dot = [&](const Vec4<T>(&x)[kLaneGroups], const Vec4<T>(&y)[kLaneGroups]) {
    T acc[4] = {T(0), T(0), T(0), T(0)};
#pragma unroll
    for (int u = 0; u < kLaneGroups; ++u) {
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[q] += x[u].v[q] * y[u].v[q];
    }
    return warp_sum((acc[0] + acc[1]) + (acc[2] + acc[3]));
  };
  // This block's partial dot of column j, into slot `rank` of every block.
  auto push = [&](int par, int j, T v) {
    T* slot = dpart + (par * kMaxCluster + cl.rank) * BW + j;
    for (int r = 0; r < cl.size; ++r) *cl.at_mut(slot, r) = v;
  };

  // Step 0's dots: column 0 with every column of the panel.
  load_col(piv, P);
  for (int j = warp; j < nc; j += kQrWarps) {
    load_col(cur, P + static_cast<size_t>(j) * LD);
    const T s = dot(piv, cur);
    if (lane == 0) push(*dpar, j, s);
  }

  for (int c = 0; c < nc; ++c) {
    cl.sync();                       // every block's dots of step c are in every block
    // The loads of this step first: the next pivot's column and this warp's
    // first later column.
    const int j0 = c + 2 + warp;
    if (c + 1 < nc) load_col(nxt, P + static_cast<size_t>(c + 1) * LD);
    if (j0 < nc) load_col(cur, P + static_cast<size_t>(j0) * LD);
    // Lane 0 takes s_cc, lane 1 s_c,c+1, lane 2 + u the dot of this warp's
    // u-th later column j = c + 2 + warp + 8u; each summed in rank order.
    const T* part = dpart + *dpar * kMaxCluster * BW;
    const int jl = lane < 2 ? c + lane : c + 2 + warp + kQrWarps * (lane - 2);
    T sl = T(0);
    if (lane < 2 + kJobs && jl < nc) {
      sl = part[jl];
      for (int r = 1; r < cl.size; ++r) sl += part[r * BW + jl];
    }
    const T scc = __shfl_sync(0xffffffffu, sl, 0);
    const T ss = (scc > tiny || scc != scc) ? scc : tiny;   // max(s_cc, tiny), NaN kept
    const T nr = sqrt(ss);
    const bool writer = cl.rank == 0 && lane == 0;
    T* r_row = r_blk + static_cast<size_t>(c) * N;
    if (warp == 0 && lane == 0) {
      nrm[c] = nr;
      if (cl.rank == 0) r_row[c] = nr;
    }
    // The pivot, computed at step c - 1, to the panel, by the last warp
    // (never one with more later columns than the others).
    if (c > 0 && warp == kQrWarps - 1) {
#pragma unroll
      for (int u = 0; u < kLaneGroups; ++u) {
        const int g = lane + 32 * u;
        if (g < groups) store4(P + static_cast<size_t>(c) * LD + 4 * g, piv[u]);
      }
    }
    if (c + 1 == nc) break;
    *dpar ^= 1;

    // One division a step: the entries of R and the update factors multiply
    // by 1 / ss and sqrt(ss) / ss.
    const T inv_ss = T(1) / ss, inv_nr = nr * inv_ss;
    // The next pivot, column c + 1 updated, in every warp.
    const T s1 = __shfl_sync(0xffffffffu, sl, 1);
    if (warp == 0 && writer) r_row[c + 1] = s1 * inv_nr;
    {
      const T f = s1 * inv_ss;
#pragma unroll
      for (int u = 0; u < kLaneGroups; ++u) {
#pragma unroll
        for (int q = 0; q < 4; ++q) nxt[u].v[q] -= piv[u].v[q] * f;
      }
    }
    // This warp's later columns j = c + 2 + warp + 8 v: update, write back,
    // and the lane's share of the dot with the next pivot, the next column
    // loaded before this one is stored; then the warp's dots all at once.
    T pd[kJobs];
#pragma unroll
    for (int v = 0; v < kJobs; ++v) {
      const int j = j0 + kQrWarps * v;
      pd[v] = T(0);
      if (j < nc) {                  // uniform in the warp
        if (j + kQrWarps < nc) load_col(ahead, P + static_cast<size_t>(j + kQrWarps) * LD);
        const T sj = __shfl_sync(0xffffffffu, sl, 2 + v);
        if (writer) r_row[j] = sj * inv_nr;
        const T f = sj * inv_ss;
        T* pj = P + static_cast<size_t>(j) * LD;
        T acc[4] = {T(0), T(0), T(0), T(0)};
#pragma unroll
        for (int u = 0; u < kLaneGroups; ++u) {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            cur[u].v[q] -= piv[u].v[q] * f;
            acc[q] += nxt[u].v[q] * cur[u].v[q];
          }
          const int g = lane + 32 * u;
          if (g < groups) store4(pj + 4 * g, cur[u]);
        }
        pd[v] = (acc[0] + acc[1]) + (acc[2] + acc[3]);
#pragma unroll
        for (int u = 0; u < kLaneGroups; ++u) cur[u] = ahead[u];
      }
    }
    // The next pivot's own square, by the first warp with the fewest later
    // columns (q of them), in its free slot q.
    const int q = (nc - c - 2) / kQrWarps;
    const bool self = warp == (nc - c - 2) % kQrWarps;
    if (self) {
      T acc[4] = {T(0), T(0), T(0), T(0)};
#pragma unroll
      for (int u = 0; u < kLaneGroups; ++u) {
#pragma unroll
        for (int x = 0; x < 4; ++x) acc[x] += nxt[u].v[x] * nxt[u].v[x];
      }
#pragma unroll
      for (int v = 0; v < kJobs; ++v) {
        if (v == q) pd[v] = (acc[0] + acc[1]) + (acc[2] + acc[3]);
      }
    }
    if (j0 < nc || self) {
      const T s = transpose_sum(pd, lane);
      const int v = transpose_index<kJobs>(lane);
      const int j = self && v == q ? c + 1 : j0 + kQrWarps * v;
      if ((lane & (32 / kJobs - 1)) == 0 && j < nc) push(*dpar, j, s);
    }
#pragma unroll
    for (int u = 0; u < kLaneGroups; ++u) piv[u] = nxt[u];
  }
  *dpar ^= 1;
  __syncthreads();                   // the last pivot is in the panel
}

// ---------------------------------------------------------------------------
// The CholeskyQR step of a finished panel
// ---------------------------------------------------------------------------

// The width x width blocks of the CholeskyQR step are split over the
// block's threads in register tiles: thread (ti, tj) = (tid / 16, tid % 16)
// holds the entries (ti + 16 a, tj + 16 b), a, b < width / 16, so that a
// step reads one published row from shared memory and updates registers
// only.  `row` holds three rows of width scalars: two for the published row
// (by step parity) and the pivots.

// G (BW x BW, stride WS, in shared memory) -> R2 = chol(G) in its upper
// triangle (zeros below), right-looking, one barrier a column: at step c
// every thread reads row c of the Schur complement, published at the end of
// step c - 1, and updates its entries of the trailing upper triangle,
// G_ij -= G_ci G_cj / G_cc; the owners of row c + 1 then publish it.  Row i
// of R2 is row i of the Schur complement at step i over the square root of
// its pivot.  Returns false (in every thread) if a pivot is not positive and
// finite, NaN included.
template <typename T>
__device__ bool block_cholesky(T* G, T* row) {
  constexpr int BW = Panel<T>::kWidth, WS = block_stride<T>(), K = BW / 16;
  const int ti = threadIdx.x >> 4, tj = threadIdx.x & 15;
  T* pivots = row + 2 * BW;
  T g[K][K];
#pragma unroll
  for (int a = 0; a < K; ++a) {
#pragma unroll
    for (int b = 0; b < K; ++b) g[a][b] = G[(ti + 16 * a) * WS + tj + 16 * b];
  }
  if (ti == 0) {
#pragma unroll
    for (int b = 0; b < K; ++b) row[tj + 16 * b] = g[0][b];
  }
  __syncthreads();
  for (int c = 0; c < BW; ++c) {
    const T* cur = row + (c & 1) * BW;
    const T d = cur[c];
    if (!(d > T(0) && isfinite(d))) return false;   // uniform: every thread reads d
    if (threadIdx.x == 0) pivots[c] = d;
    const T inv_d = T(1) / d;
    T ri[K], rj[K];
#pragma unroll
    for (int a = 0; a < K; ++a) ri[a] = cur[ti + 16 * a] * inv_d;
#pragma unroll
    for (int b = 0; b < K; ++b) rj[b] = cur[tj + 16 * b];
#pragma unroll
    for (int a = 0; a < K; ++a) {
      const int i = ti + 16 * a;
#pragma unroll
      for (int b = 0; b < K; ++b) {
        if (i > c && tj + 16 * b >= i) g[a][b] -= ri[a] * rj[b];
      }
    }
#pragma unroll
    for (int a = 0; a < K; ++a) {
      if (ti + 16 * a != c + 1) continue;           // the owners of row c + 1 publish it
#pragma unroll
      for (int b = 0; b < K; ++b) row[((c + 1) & 1) * BW + tj + 16 * b] = g[a][b];
    }
    __syncthreads();
  }
#pragma unroll
  for (int a = 0; a < K; ++a) {
    const int i = ti + 16 * a;
    const T rc = sqrt(pivots[i]);
    const T inv_rc = T(1) / rc;
#pragma unroll
    for (int b = 0; b < K; ++b) {
      const int j = tj + 16 * b;
      G[i * WS + j] = j > i ? g[a][b] * inv_rc : j == i ? rc : T(0);
    }
  }
  __syncthreads();
  return true;
}

// X = R2^-1 (upper, stride WS) from the bottom row up, one barrier a row: at
// step l every thread reads the final row l of X, published at the end of
// step l + 1, and updates its entries of the rows above, X_ij -= R2_il X_lj
// (j >= l); the owners of row l - 1 then divide it by its pivot and publish
// it.  X is held in register tiles as in block_cholesky.
template <typename T>
__device__ void block_upper_inverse(const T* R2, T* X, T* row) {
  constexpr int BW = Panel<T>::kWidth, WS = block_stride<T>(), K = BW / 16;
  const int ti = threadIdx.x >> 4, tj = threadIdx.x & 15;
  T x[K][K];
  auto publish = [&](int l) {                        // row l: divided by its pivot, published
#pragma unroll
    for (int a = 0; a < K; ++a) {
      if (ti + 16 * a != l) continue;
      const T inv = T(1) / R2[l * WS + l];
#pragma unroll
      for (int b = 0; b < K; ++b) {
        x[a][b] = x[a][b] * inv;
        row[(l & 1) * BW + tj + 16 * b] = x[a][b];
      }
    }
  };
#pragma unroll
  for (int a = 0; a < K; ++a) {
#pragma unroll
    for (int b = 0; b < K; ++b) x[a][b] = ti + 16 * a == tj + 16 * b ? T(1) : T(0);
  }
  publish(BW - 1);
  __syncthreads();
  for (int l = BW - 1; l >= 0; --l) {
    const T* cur = row + (l & 1) * BW;
    T xl[K], ri[K];
#pragma unroll
    for (int b = 0; b < K; ++b) xl[b] = cur[tj + 16 * b];
#pragma unroll
    for (int a = 0; a < K; ++a) ri[a] = R2[(ti + 16 * a) * WS + l];
#pragma unroll
    for (int a = 0; a < K; ++a) {
#pragma unroll
      for (int b = 0; b < K; ++b) {
        if (ti + 16 * a < l && tj + 16 * b >= l) x[a][b] -= ri[a] * xl[b];
      }
    }
    if (l > 0) publish(l - 1);
    __syncthreads();
  }
#pragma unroll
  for (int a = 0; a < K; ++a) {
#pragma unroll
    for (int b = 0; b < K; ++b) X[(ti + 16 * a) * WS + tj + 16 * b] = x[a][b];
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// The kernel
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kQrThreads)
blocked_qr_r_kernel(const T* __restrict__ S, const T* __restrict__ dbot, T* R, T* ws, int DS, int N, int C, int rows,
                    int LD, T tiny) {
  constexpr int BW = Panel<T>::kWidth, WS = block_stride<T>();
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* panel = reinterpret_cast<T*>(smem_raw);   // BW columns of LD rows
  T* wpart = panel + BW * LD;                  // two partial BW x BW blocks, by parity
  T* wsum = wpart + 2 * BW * WS;               // the reduced block (W, G, R2)
  T* dpart = wsum + BW * WS;                   // partial column dots, [parity][rank][BW]
  T* nrm = dpart + 2 * kMaxCluster * BW;       // the panel's column norms

  Cluster cl;
  cl.size = C;                                   // blocks of a cluster are consecutive in x
  cl.rank = static_cast<int>(blockIdx.x) % C;
  const int inst = blockIdx.x / C;
  const int r0 = cl.rank * rows;                 // this block's first row
  const int D = DS + (dbot ? N : 0);             // the stacked rows included
  const int ldw = cl.size * rows;                // the workspace's leading dimension
  const int npanels = (N + BW - 1) / BW;
  const T* s = S + static_cast<size_t>(inst) * DS * N;
  const T* db = dbot ? dbot + static_cast<size_t>(inst) * N : nullptr;
  T* r = R + static_cast<size_t>(inst) * N * N;
  T* q_ws = ws + static_cast<size_t>(inst) * (npanels - 1) * BW * ldw + r0;
  int wpar = 0, dpar = 0;

  if (cl.rank == 0) {
    for (int e = threadIdx.x; e < N * N; e += kQrThreads) r[e] = T(0);
  }

  for (int k = 0; k < npanels; ++k) {
    const int c0 = k * BW;
    const int nc = min(BW, N - c0);

    // 1. This block's rows of the panel into shared memory, zeros past N
    // and D; S's rows by asynchronous copies, the stacked rows made up.  A
    // warp takes four rows of eight columns (32-byte reads, 32 banks).
    for (int e = threadIdx.x; e < BW * rows; e += kQrThreads) {
      const int q = e >> 5, l = e & 31;
      const int c = (q % (BW / 8)) * 8 + (l & 7), il = (q / (BW / 8)) * 4 + (l >> 3);
      const int gi = r0 + il;
      T* dst = panel + static_cast<size_t>(c) * LD + il;
      if (c < nc && gi < DS) {
        const unsigned sa = static_cast<unsigned>(__cvta_generic_to_shared(dst));
        const T* src = s + static_cast<size_t>(gi) * N + c0 + c;
        if (sizeof(T) == 4) {
          asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(sa), "l"(src) : "memory");
        } else {
          asm volatile("cp.async.ca.shared.global [%0], [%1], 8;" ::"r"(sa), "l"(src) : "memory");
        }
      } else {
        *dst = (c < nc && gi < D && gi - DS == c0 + c) ? db[c0 + c] : T(0);
      }
    }
    asm volatile("cp.async.wait_all;" ::: "memory");
    __syncthreads();

    // 2. The finished panels projected out one after another, twice; the
    // first pass writes its W into R, the second adds to it.
    for (int pass = 0; pass < 2; ++pass) {
      for (int j = 0; j < k; ++j) {
        const T* qj = q_ws + static_cast<size_t>(j) * BW * ldw;
        gram(qj, ldw, panel, LD, rows, wpart + wpar * BW * WS, wsum);
        cluster_reduce(cl, wpart + wpar * BW * WS, wsum);
        wpar ^= 1;
        if (cl.rank == 0) {
          for (int e = threadIdx.x; e < BW * nc; e += kQrThreads) {
            const int a = e / nc, b = e % nc;
            T* rr = r + static_cast<size_t>(j * BW + a) * N + c0 + b;
            *rr = pass ? *rr + wsum[a * WS + b] : wsum[a * WS + b];
          }
        }
        product<true>(qj, ldw, wsum, panel, LD, rows);
        __syncthreads();
      }
    }

    // 3. Modified Gram-Schmidt inside the panel.
    column_steps(cl, panel, LD, rows, nc, r + static_cast<size_t>(c0) * N + c0, N, nrm, dpart, &dpar, tiny);

    // 4. Q_k, kept for the later panels: P / norms, reorthogonalized by one
    // CholeskyQR step (only the last panel is ragged, and it is not kept).
    if (k + 1 < npanels) {
      for (int c = 0; c < BW; ++c) {
        const T inv = T(1) / nrm[c];
        for (int i = threadIdx.x; i < rows; i += kQrThreads) panel[static_cast<size_t>(c) * LD + i] *= inv;
      }
      __syncthreads();
      gram(static_cast<const T*>(panel), LD, panel, LD, rows, wpart + wpar * BW * WS, wsum);
      cluster_reduce(cl, wpart + wpar * BW * WS, wsum);
      T* xinv = wpart + (wpar ^ 1) * BW * WS;   // free: its last readers passed the reduction's barrier
      wpar ^= 1;
      const bool ok = block_cholesky(wsum, dpart);   // the column steps' buffers are free here
      T* qk = q_ws + static_cast<size_t>(k) * BW * ldw;
      if (ok) {
        block_upper_inverse(static_cast<const T*>(wsum), xinv, dpart);
        product<false>(static_cast<const T*>(panel), LD, xinv, qk, ldw, rows);
        if (cl.rank == 0) {
          // The panel's diagonal block of R <- R2 R1, both upper triangular,
          // R1 staged in the inverse's shared memory (read by now).
          T* rb = r + static_cast<size_t>(c0) * N + c0;
          T* r1 = xinv;
          __syncthreads();
          for (int e = threadIdx.x; e < BW * BW; e += kQrThreads) r1[e / BW * WS + e % BW] = rb[static_cast<size_t>(e / BW) * N + e % BW];
          __syncthreads();
          for (int e = threadIdx.x; e < BW * BW; e += kQrThreads) {
            const int i = e / BW, j = e % BW;
            if (j < i) continue;
            T acc = T(0);
            for (int l = i; l <= j; ++l) acc += wsum[i * WS + l] * r1[l * WS + j];
            rb[static_cast<size_t>(i) * N + j] = acc;
          }
        }
      } else {
        for (int e = threadIdx.x; e < BW * rows; e += kQrThreads) {
          const int c = e / rows, i = e % rows;
          qk[static_cast<size_t>(c) * ldw + i] = panel[static_cast<size_t>(c) * LD + i];
        }
      }
      __syncthreads();   // the workspace is read back by this block only
    }
  }
  cl.sync();             // no block leaves while another reads its shared memory
}

template <typename T>
size_t smem_bytes(int LD) {
  constexpr int BW = Panel<T>::kWidth, WS = block_stride<T>();
  return (static_cast<size_t>(BW) * LD + 3 * BW * WS + (2 * kMaxCluster + 1) * BW) * sizeof(T);
}

template <typename T>
int launch(const T* S, const T* dbot, T* R, T* ws, int B, int DS, int N, int C, int rows, int LD, void* stream) {
  const int D = DS + (dbot ? N : 0);
  if (B <= 0 || N < 1 || D < N || C < 1 || C > kMaxCluster || rows % 16 != 0 || rows > 4 * 32 * kLaneGroups ||
      static_cast<long long>(C) * rows < D || LD < rows || LD % 4 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = smem_bytes<T>(LD);
  if (smem > kMaxDynamicSmem) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = blocked_qr_r_kernel<T>;
  const T tiny = std::numeric_limits<T>::min();
  if (C == 1) {
    const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<B, kQrThreads, smem, static_cast<cudaStream_t>(stream)>>>(S, dbot, R, ws, DS, N, 1, rows, LD, tiny);
    return static_cast<int>(cudaGetLastError());
  }
  return static_cast<int>(benlsip::launch_cluster(kernel, C, B, smem, static_cast<cudaStream_t>(stream), S, dbot, R,
                                                  ws, DS, N, C, rows, LD, tiny));
}

}  // namespace

// S (B, DS, N); dbot (B, N) or null (then D = DS, else the stacked D = DS + N
// rows); R (B, N, N); ws the workspace; C blocks an instance of `rows`
// padded rows each, the panel's leading dimension LD.
BENLSIP_API int benlsip_blocked_qr_r_f32(const float* S, const float* dbot, float* R, float* ws, int B, int D, int N,
                                         int C, int rows, int LD, void* stream) {
  return launch<float>(S, dbot, R, ws, B, D, N, C, rows, LD, stream);
}

BENLSIP_API int benlsip_blocked_qr_r_f64(const double* S, const double* dbot, double* R, double* ws, int B, int D,
                                         int N, int C, int rows, int LD, void* stream) {
  return launch<double>(S, dbot, R, ws, B, D, N, C, rows, LD, stream);
}
