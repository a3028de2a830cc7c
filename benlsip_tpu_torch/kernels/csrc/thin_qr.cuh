// Batched thin QR by modified Gram-Schmidt for N <= 16 columns:
// A (B, D, N) -> R (B, N, N), and Q (B, D, N) when the caller asks for it;
// with a diagonal dbot (B, N), R of the stacked [A; diag(dbot)] without the
// stacked matrix ever being built.
//
// Replaces the Pallas TPU kernel `batched_thin_qr` / `_mgs_qr_kernel`
// (benlsip_tpu/kernels/batched_linalg.py:147,170) and computes what it
// computes: for each column j the earlier (normalised) columns projected
// out one at a time (r_kj = q_k . v_j, v_j -= q_k r_kj), then the norm
// sqrt(max(v_j . v_j, tiny)) with NaN propagating, so R has a positive
// diagonal, a zero column never divides by zero, and R's strict lower
// triangle is exactly 0.
//
// What bounds it on the H100: the bytes of A (each instance is D*N
// contiguous elements, read once) at large batches, the launch at small
// ones.  The TPU kernel kept the batch on the vector lanes and a slab in
// VMEM; the first port put one warp on an instance and went back to device
// memory j + 2 times for each column j.  Here an instance is read once,
// kept on chip, and factored there:
//
//  * the group form (plan G = 1..32, a power of two; D*N small enough): G
//    lanes own one instance, 32/G instances a warp.  Lane g holds rows g,
//    g + G, g + 2G, ... of all N columns in registers (at most
//    group_rows(N) rows), every dot product is a lane's sum over its rows
//    in row order and then an xor-shuffle tree of width G, and nothing
//    touches memory between the loads and the stores;
//  * the wide form (plan 0, the rest of the gate up to D = 2048): one
//    block of kWideThreads an instance, the instance staged column-major in
//    shared memory (<= 128 KiB at 2048 x 16 float32), a thread's rows are
//    tid, tid + kWideThreads, ..., and each sum is a warp's xor tree and
//    then the warps' sums in warp order.
//
// Both run modified Gram-Schmidt right-looking: once q_j is normalised,
// r_jk = q_j . v_k for every later column k and v_k -= q_j r_jk.  Every v_k
// then meets q_0, q_1, ... in the same order, with the same operands, as in
// the column-by-column loop above, so R and Q are the same bits; the chain
// of dependent reductions is N rounds instead of N(N+1)/2 + N, and the
// reductions of one round are independent of each other.
//
// The plan comes from (D, N, dtype) alone (`narrow_qr_plan` in
// ../batched_linalg.py, never the batch), so a lane's sums, and its bits,
// do not depend on its batch or on its neighbours.  The rows of diag(dbot)
// are made up where torch.cat would put them (rows D..D+N-1: dbot[i] at
// column i, 0 elsewhere), so R of (A, dbot) is bitwise R of the stacked
// matrix, with or without Q.  Rows past the end of an instance are added to
// no sum, and a group past the end of the batch leaves at once.
//
// bf16 loads bf16, computes in float and rounds each output once, as the
// other kernels do (common.cuh); double keeps fewer rows a lane (the same
// register budget).  The wrapper passes the plan; a plan that does not fit
// the shape is refused with cudaErrorInvalidValue.
#pragma once

#include <limits>

#include "common.cuh"

namespace benlsip {
namespace narrow_qr {

// Threads of a group-form block (4 warps), and of a wide-form block.
constexpr int kGroupThreads = 128;
constexpr int kWideThreads = 256;
constexpr int kWideWarps = kWideThreads / 32;
constexpr int kWideLoads = 8;  // loads a wide-form thread keeps in flight
constexpr int kWideRows = 8;   // rows of an instance a wide-form thread owns: D + N <= 2048
// A lane of the group form holds at most kMaxLaneRows rows, and at most
// kLaneRegisters 32-bit registers of its instance (../batched_linalg.py
// NARROW_QR_LANE_ROWS and NARROW_QR_LANE_REGISTERS); both powers of two.
constexpr int kMaxLaneRows = 8;
constexpr int kLaneRegisters = 128;

// The rows a lane may hold at n columns of `words` registers each: a power
// of two (the slot counts the kernel is instantiated for).
__host__ __device__ constexpr int group_rows(int n, int words) {
  int rows = kMaxLaneRows;
  while (rows > 1 && rows * n * words > kLaneRegisters) rows /= 2;
  return rows;
}

// Leading dimension of the wide form's column-major copy: odd, so that
// the flat (row-major) loads' stores to it spread over the banks.
__host__ __device__ constexpr int wide_ld(int rows) { return rows | 1; }

namespace {

// max(ss, tiny) with NaN propagating (jnp.maximum / torch.clamp_min), then sqrt.
template <typename C>
__device__ __forceinline__ C floored_norm(C ss, C tiny) {
  return sqrt((ss > tiny || ss != ss) ? ss : tiny);
}

// Blocks an SM must hold for the group form at N columns: at N <= 4 (float)
// a lane's slots fit in 64 registers, so 8 blocks (1024 threads) an SM run config
// 5's 16,384 instances in one wave; wider N keeps every register it needs.
__host__ __device__ constexpr int group_min_blocks(int n, int words) { return n * words <= 4 ? 8 : 1; }

// P: the register slots of a lane, 1, 2, 4 or 8 (the fewest that hold its
// rows, at most group_rows(N)); the launch picks the instantiation.
template <typename T, int N, int P>
__global__ void __launch_bounds__(kGroupThreads, group_min_blocks(N, sizeof(compute_t<T>) / 4))
narrow_qr_group_kernel(const T* __restrict__ A, const T* __restrict__ dbot, T* __restrict__ Q, T* __restrict__ R,
                       int B, int D, int G, compute_t<T> tiny) {
  using C = compute_t<T>;
  const int t = blockIdx.x * kGroupThreads + threadIdx.x, lg = __ffs(G) - 1;
  const int b = t >> lg, g = t & (G - 1);
  // A group past the batch leaves at once: the xor trees stay inside a
  // group, so the shuffles' mask is the live lanes of the warp.
  const unsigned mask = __ballot_sync(0xffffffffu, b < B);
  if (b >= B) return;
  const int Dt = D + (dbot != nullptr ? N : 0);
  // The slots in use, the same in every lane: the unrolled loops skip the
  // rest of the P slots with a uniform branch.
  const int rows = (Dt + G - 1) >> lg;
  const size_t inst = b;
  const T* a = A + inst * D * N;

  // Slot p holds row p * G + g; row D + i of the stacked matrix is dbot[i]
  // at column i.  Every slot in use loads first, from a valid address (a
  // row past A's end reads row 0), and only then does any lane look at what
  // it loaded, so that all of a lane's loads are in flight at once.
  C v[P][N], dv[P];
  bool own[P];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    own[p] = false;
    dv[p] = C(0);
#pragma unroll
    for (int c = 0; c < N; ++c) v[p][c] = C(0);
    if (p < rows) {
      const int r = p * G + g, i = r - D;
      const T* row = a + (r < D ? r : 0) * N;
#pragma unroll
      for (int c = 0; c < N; ++c) v[p][c] = load(row + c);
      if (dbot != nullptr) dv[p] = load(dbot + inst * N + (i < 0 ? 0 : (i < N ? i : N - 1)));
    }
  }
#pragma unroll
  for (int p = 0; p < P; ++p) {
    if (p < rows) {
      const int r = p * G + g, i = r - D;
      own[p] = r < Dt;
#pragma unroll
      for (int c = 0; c < N; ++c) v[p][c] = !own[p] ? C(0) : (i < 0 ? v[p][c] : (i == c ? dv[p] : C(0)));
    }
  }

  // The compute selects rather than branches on a lane's own rows (a
  // divergent branch would cost a reconvergence barrier each), and skips
  // the slots past `rows` with a uniform branch.  A row the lane does not
  // own is added to no sum.  A zero dividend takes the slow path of the IEEE
  // division, in which the other lanes wait: a zero entry (a row the lane
  // does not own, a zero of diag(dbot)) divides the norm by itself in its
  // place and keeps its 0, the bits that 0 / nrm gives.
  T* rr = R + inst * N * N;
  C s[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    C ss = C(0);
#pragma unroll
    for (int p = 0; p < P; ++p) {
      if (p < rows) ss = own[p] ? ss + v[p][j] * v[p][j] : ss;
    }
    for (int off = G >> 1; off > 0; off >>= 1) ss += __shfl_xor_sync(mask, ss, off);
    const C nrm = floored_norm(ss, tiny);
#pragma unroll
    for (int k = j + 1; k < N; ++k) s[k] = C(0);
#pragma unroll
    for (int p = 0; p < P; ++p) {
      if (p < rows) {
        const bool div = own[p] && v[p][j] != C(0);
        const C q = (div ? v[p][j] : nrm) / nrm;
        v[p][j] = div ? q : v[p][j];
#pragma unroll
        for (int k = j + 1; k < N; ++k) s[k] = own[p] ? s[k] + v[p][j] * v[p][k] : s[k];
      }
    }
    // One tree for every later column at once: their shuffles overlap.
    for (int off = G >> 1; off > 0; off >>= 1) {
#pragma unroll
      for (int k = j + 1; k < N; ++k) s[k] += __shfl_xor_sync(mask, s[k], off);
    }
#pragma unroll
    for (int p = 0; p < P; ++p) {
      if (p < rows) {
#pragma unroll
        for (int k = j + 1; k < N; ++k) v[p][k] = v[p][k] - v[p][j] * s[k];
      }
    }
    // Row j of R, its entries spread over the group's lanes.
#pragma unroll
    for (int k = j; k < N; ++k) {
      if (((j * N + k) & (G - 1)) == g) store(rr + j * N + k, k == j ? nrm : s[k]);
    }
  }
  for (int e = g; e < N * N; e += G) {
    if (e / N > e % N) store(rr + e, C(0));
  }
  if (Q != nullptr) {
    T* q = Q + inst * D * N;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int r = p * G + g;
      if (p < rows && r < D) {
#pragma unroll
        for (int c = 0; c < N; ++c) store(q + r * N + c, v[p][c]);
      }
    }
  }
}

// x[k] for k0 <= k < k1 summed over the block: each over its warp by
// warp_sum, then the warps' sums in warp order; every thread gets the same
// bits.  part is shared memory of kWideWarps * kMaxDim values.
template <typename C>
__device__ __forceinline__ void wide_sums(C (&x)[kMaxDim], int k0, int k1, C* part) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < kMaxDim; ++k) {
    if (k >= k0 && k < k1) {
      const C w = warp_sum(x[k]);
      if (lane == 0) part[warp * kMaxDim + k] = w;
    }
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kMaxDim; ++k) {
    if (k >= k0 && k < k1) {
      C acc = part[k];
      for (int w = 1; w < kWideWarps; ++w) acc += part[w * kMaxDim + k];
      x[k] = acc;
    }
  }
  __syncthreads();  // part is written again by the next call
}

template <typename T>
__global__ void __launch_bounds__(kWideThreads)
narrow_qr_wide_kernel(const T* __restrict__ A, const T* __restrict__ dbot, T* __restrict__ Q, T* __restrict__ R,
                      int D, int N, compute_t<T> tiny) {
  using C = compute_t<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  C* col = reinterpret_cast<C*>(smem_raw);  // column c at col + c * ld
  __shared__ C part[kWideWarps * kMaxDim];
  const int tid = threadIdx.x;
  const size_t inst = blockIdx.x;
  const int Dt = D + (dbot != nullptr ? N : 0), ld = wide_ld(Dt);
  const T* a = A + inst * D * N;
  // A's rows in batches of kWideLoads a thread, every load of a batch from a
  // valid address and in flight before the first store; then diag(dbot).
  const int DN = D * N;
  for (int e0 = tid; e0 < DN; e0 += kWideLoads * kWideThreads) {
    C x[kWideLoads];
#pragma unroll
    for (int i = 0; i < kWideLoads; ++i) x[i] = load(a + min(e0 + i * kWideThreads, DN - 1));
#pragma unroll
    for (int i = 0; i < kWideLoads; ++i) {
      const int e = e0 + i * kWideThreads, r = e / N;
      if (e < DN) col[(e - r * N) * ld + r] = x[i];
    }
  }
  if (dbot != nullptr) {
    for (int e = tid; e < N * N; e += kWideThreads) {
      const int i = e / N, c = e - i * N;
      col[c * ld + D + i] = i == c ? load(dbot + inst * N + c) : C(0);
    }
  }
  __syncthreads();

  // A thread's rows are tid + i * kWideThreads, i < kWideRows: each pass
  // over a column reads them into registers at once, so that their
  // shared-memory loads overlap; sums run over them in row order.
  T* rr = R + inst * N * N;
  C x[kMaxDim];
  for (int j = 0; j < N; ++j) {
    C* vj = col + j * ld;
    C qj[kWideRows];
    x[0] = C(0);
#pragma unroll
    for (int i = 0; i < kWideRows; ++i) {
      const int r = tid + i * kWideThreads;
      qj[i] = r < Dt ? vj[r] : C(0);
      if (r < Dt) x[0] += qj[i] * qj[i];
    }
    wide_sums(x, 0, 1, part);
    const C nrm = floored_norm(x[0], tiny);
#pragma unroll
    for (int i = 0; i < kWideRows; ++i) {
      const int r = tid + i * kWideThreads;
      if (r < Dt && qj[i] != C(0)) {   // 0 / nrm is 0: no slow path for the zeros of diag(dbot)
        qj[i] = qj[i] / nrm;
        vj[r] = qj[i];
      }
    }
#pragma unroll
    for (int k = 0; k < kMaxDim; ++k) {
      if (k > j && k < N) {
        const C* vk = col + k * ld;
        C vr[kWideRows];
#pragma unroll
        for (int i = 0; i < kWideRows; ++i) {
          const int r = tid + i * kWideThreads;
          vr[i] = r < Dt ? vk[r] : C(0);
        }
        x[k] = C(0);
#pragma unroll
        for (int i = 0; i < kWideRows; ++i) {
          if (tid + i * kWideThreads < Dt) x[k] += qj[i] * vr[i];
        }
      }
    }
    wide_sums(x, j + 1, N, part);
#pragma unroll
    for (int k = 0; k < kMaxDim; ++k) {
      if (k > j && k < N) {
        C* vk = col + k * ld;
#pragma unroll
        for (int i = 0; i < kWideRows; ++i) {
          const int r = tid + i * kWideThreads;
          if (r < Dt) vk[r] = vk[r] - qj[i] * x[k];
        }
      }
    }
    // Row j of R: thread k writes entry (j, k).
#pragma unroll
    for (int k = 0; k < kMaxDim; ++k) {
      if (tid == k && k < N) store(rr + j * N + k, k < j ? C(0) : (k == j ? nrm : x[k]));
    }
  }
  if (Q != nullptr) {
    __syncthreads();
    T* q = Q + inst * D * N;
    for (int e = tid; e < D * N; e += kWideThreads) {
      const int r = e / N, c = e - r * N;
      store(q + e, col[c * ld + r]);
    }
  }
}

// The instantiation for n columns and `rows` rows a lane: the fewest slots
// P in 1, 2, 4, 8 that hold them, so that a lane runs no more unrolled code
// than its rows need (its instructions are fetched once a launch).
template <typename T, int N = 1, int P = 1>
cudaError_t launch_group(int n, int rows, int B, int D, int G, const T* A, const T* dbot, T* Q, T* R,
                         compute_t<T> tiny, cudaStream_t stream) {
  if constexpr (N > kMaxDim) {
    return cudaErrorInvalidValue;
  } else if constexpr (P > group_rows(N, sizeof(compute_t<T>) / 4)) {
    return cudaErrorInvalidValue;
  } else {
    if (n != N) return launch_group<T, N + 1, 1>(n, rows, B, D, G, A, dbot, Q, R, tiny, stream);
    if (rows > P) return launch_group<T, N, 2 * P>(n, rows, B, D, G, A, dbot, Q, R, tiny, stream);
    const int blocks = blocks_for(B, kGroupThreads / G);
    narrow_qr_group_kernel<T, N, P><<<blocks, kGroupThreads, 0, stream>>>(A, dbot, Q, R, B, D, G, tiny);
    return cudaGetLastError();
  }
}

}  // namespace

// plan: G (1..32, a power of two) for the group form, 0 for the wide form.
// dbot may be null (R of A alone), Q may be null (R only); not both given.
template <typename T>
int launch(const T* A, const T* dbot, T* Q, T* R, int B, int D, int N, int plan, void* stream_ptr) {
  using C = compute_t<T>;
  const int Dt = D + (dbot != nullptr ? N : 0);
  if (B <= 0 || N < 1 || N > kMaxDim || D < 0 || Dt < N || A == nullptr || R == nullptr ||
      (Q != nullptr && dbot != nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const C tiny = std::numeric_limits<C>::min();
  if (plan == 0) {
    if (Dt > kWideRows * kWideThreads) return static_cast<int>(cudaErrorInvalidValue);
    const size_t smem = static_cast<size_t>(wide_ld(Dt)) * N * sizeof(C);
    cudaError_t rc = cudaSuccess;
    if (smem > 48 * 1024) {
      rc = cudaFuncSetAttribute(narrow_qr_wide_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(smem));
    }
    if (rc == cudaSuccess) {
      narrow_qr_wide_kernel<T><<<B, kWideThreads, smem, stream>>>(A, dbot, Q, R, D, N, tiny);
    }
    const cudaError_t last = cudaGetLastError();
    return static_cast<int>(rc != cudaSuccess ? rc : last);
  }
  const int rows = (Dt + plan - 1) / plan;
  if (plan < 1 || plan > 32 || (plan & (plan - 1)) != 0 || rows > group_rows(N, sizeof(C) / 4)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(launch_group<T>(N, rows, B, D, plan, A, dbot, Q, R, tiny, stream));
}

}  // namespace narrow_qr
}  // namespace benlsip

// One C entry point a dtype (thin_qr.cu, thin_qr_bf16.cu, thin_qr_f64.cu):
// A (B, D, N), dbot (B, N) or null, Q (B, D, N) or null, R (B, N, N).
#define BENLSIP_THIN_QR_ENTRY(SUFFIX, T)                                                                  \
  BENLSIP_API int benlsip_thin_qr_##SUFFIX(const T* A, const T* dbot, T* Q, T* R, int B, int D, int N, \
                                           int plan, void* stream) {                                   \
    return benlsip::narrow_qr::launch<T>(A, dbot, Q, R, B, D, N, plan, stream);                        \
  }
