// The split form of the dual-Newton kernel (plan S >= 2: a thread-block
// cluster of S blocks per instance, n >= SPLIT_MIN_N; config 4's
// (1, 8, 10240)); the design is described in polyhedron_newton.cu.
#include "polyhedron_newton.cuh"

namespace benlsip {
namespace newton {
namespace {

template <typename T, int M>
__global__ void __launch_bounds__(kSplitThreads) polyhedron_newton_split_kernel(const Args<T> p) {
  using C = benlsip::compute_t<T>;
  constexpr int KT = M * (M + 1) / 2;
  constexpr int KMAX = KT + M + 1 > kMaxGrid ? KT + M + 1 : kMaxGrid;
  __shared__ C scratch[kSplitWarps * KMAX];
  __shared__ C part[2 * KMAX];
  __shared__ C total[KMAX];
  cg::cluster_group cluster = cg::this_cluster();
  const int S = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int2 slice = benlsip::split_slice(p.n, S, rank);
  ClusterTeam<C, KMAX> team{cluster, scratch, part, total, static_cast<int>(threadIdx.x), slice.x, slice.y, 0};
  newton<T, M>(team, p, blockIdx.x / S, false);
  team.done();
}

}  // namespace

template <typename T>
cudaError_t launch_split(const Args<T>& p, int M, int plan, cudaStream_t s) {
  switch (M) {
#define BENLSIP_CASE(MM) \
  case MM:               \
    return launch_cluster(polyhedron_newton_split_kernel<T, MM>, plan, p.B, 0, s, p);
    BENLSIP_CASE(1) BENLSIP_CASE(2) BENLSIP_CASE(3) BENLSIP_CASE(4)
    BENLSIP_CASE(5) BENLSIP_CASE(6) BENLSIP_CASE(7) BENLSIP_CASE(8)
    BENLSIP_CASE(9) BENLSIP_CASE(10) BENLSIP_CASE(11) BENLSIP_CASE(12)
    BENLSIP_CASE(13) BENLSIP_CASE(14) BENLSIP_CASE(15) BENLSIP_CASE(16)
#undef BENLSIP_CASE
  }
  return cudaErrorInvalidValue;
}

template cudaError_t launch_split<float>(const Args<float>&, int, int, cudaStream_t);
template cudaError_t launch_split<__nv_bfloat16>(const Args<__nv_bfloat16>&, int, int, cudaStream_t);

}  // namespace newton
}  // namespace benlsip
