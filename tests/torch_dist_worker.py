"""One rank of a gloo world for tests/test_torch_dist.py.

    python tests/torch_dist_worker.py RANK WORLD STORE INPUTS OUT

joins a gloo process group over the file store STORE, runs the port's
collectives and distributed solves on the data in INPUTS (an .npz the test
writes) and saves what it computed to OUT.RANK (torch.save).  It imports
nothing of JAX: the test holds these results to numpy and to the JAX
package in its own process.
"""
import datetime
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from benlsip_tpu_torch.batch.vmap_solve import BatchedProblem  # noqa: E402
from benlsip_tpu_torch.dist import collectives as col  # noqa: E402
from benlsip_tpu_torch.dist import sharded  # noqa: E402
from benlsip_tpu_torch.dist.mesh import make_mesh  # noqa: E402
from benlsip_tpu_torch.problems.generators import exp_fit_family  # noqa: E402
from benlsip_tpu_torch.solver.api import Problem  # noqa: E402
from benlsip_tpu_torch.solver.options import SolverOptions  # noqa: E402

# The blocked solves' operator variants (name: SolverOptions overrides).
BLOCKED_VARIANTS = {
    "replicated": {},
    "sharded-xla": {"gram_layout": "sharded", "reduce_schedule": "xla"},
    "sharded-ring": {"gram_layout": "sharded", "reduce_schedule": "ring"},
    "cholqr2-sharded": {"gn_factorization": "cholqr2", "gram_layout": "sharded"},
}
BLOCKED_OPTS = dict(max_outer_iter=8, max_inner_iter=40)
DP_OPTS = dict(max_outer_iter=30, max_inner_iter=80)
DP_FAMILY = dict(B=16, d=16, seed=3)


def collective_input(rank: int) -> np.ndarray:
    return np.random.default_rng(100 + rank).standard_normal((4, 6))


def collectives(rank: int) -> dict:
    x = torch.as_tensor(collective_input(rank))
    with col.bind_mesh(make_mesh(1, dist.get_world_size(), device="cpu")):
        ax = "block"
        return {
            "axis_index": col.axis_index(ax),
            "axis_size": col.axis_size(ax),
            "psum": col.psum(x, ax),
            "pmean": col.pmean(x, ax),
            "all_gather": col.all_gather(x, ax),
            "all_gather_dim1": col.all_gather(x, ax, dim=1),
            "all_gather_untiled": col.all_gather(x, ax, tiled=False),
            "psum_scatter": col.psum_scatter(x, ax),
            "psum_scatter_dim1": col.psum_scatter(x, ax, dim=1),
            "ppermute_ring": col.ppermute_ring(x, ax),
            "ring_psum_scatter": col.ring_psum_scatter(x, ax),
            "ring_psum_scatter_dim1": col.ring_psum_scatter(x, ax, dim=1),
            "ring_psum_scatter_lazy": col.ring_psum_scatter_lazy(
                lambda c, op: op[2 * c: 2 * c + 2], ax, operand=x),
            "size_one_identity": col.psum(x, "batch") is x and col.all_gather(x, "batch") is x,
        }


def _info(info) -> dict:
    return {f: t.clone() for f, t in info._asdict().items()}


def blocked(data) -> dict:
    """The blocked solves on a (1, world) mesh: each rank holds d/world rows."""
    t = {k: torch.as_tensor(data[k]) for k in ("J", "y", "A", "b")}
    n = t["J"].shape[1]
    bp = BatchedProblem(
        residuals=lambda x, th: th["J"] @ x - th["y"],
        jac_res=lambda x, th: th["J"],
        A=t["A"], b=t["b"],
        xl=torch.full((n,), -3.0, dtype=torch.float64), xu=torch.full((n,), 3.0, dtype=torch.float64),
    )
    theta = {"J": t["J"], "y": t["y"]}
    x0 = torch.zeros(n, dtype=torch.float64)
    mesh = make_mesh(1, dist.get_world_size(), device="cpu")
    out = {}
    for name, kw in BLOCKED_VARIANTS.items():
        x, y, info = sharded.solve_large_blocked_shardmap(bp, theta, x0, SolverOptions(**BLOCKED_OPTS, **kw), mesh)
        out[name] = (x, y, _info(info))
    x, y, info = sharded.solve_large_blocked_family(bp, theta, x0, SolverOptions(**BLOCKED_OPTS), mesh)
    out["family"] = (x, y, _info(info))
    problem = Problem(residuals=lambda x: t["J"] @ x - t["y"], jac_res=lambda x: t["J"],
                      A=t["A"], b=t["b"], xl=[-3.0] * n, xu=[3.0] * n)
    x, y, info = sharded.solve_large_blocked(problem, x0, SolverOptions(**BLOCKED_OPTS), mesh)
    out["problem"] = (x, y, _info(info))
    return out


def data_parallel() -> dict:
    """The batched solves on a (world, 1) mesh: each rank solves B/world lanes."""
    f = dict(DP_FAMILY)
    bp, theta, X0 = exp_fit_family(f.pop("B"), **f, device="cpu")
    mesh = make_mesh(dist.get_world_size(), 1, device="cpu")
    out = {}
    for name in ("solve_batched_sharded", "solve_batched_shardmap"):
        X, Y, info = getattr(sharded, name)(bp, theta, X0, SolverOptions(**DP_OPTS), mesh)
        out[name] = (X, Y, _info(info))
    return out


def main() -> None:
    rank, world, store, inputs, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5]
    torch.set_num_threads(1)
    # A collective that a rank never meets fails after this timeout instead of hanging.
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    data = np.load(inputs)
    results = {"collectives": collectives(rank), "blocked": blocked(data), "data_parallel": data_parallel()}
    torch.save(results, f"{out}.{rank}")
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
