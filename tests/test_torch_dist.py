"""dist/ of the port on torch.distributed against numpy and the JAX package.

A gloo world of two CPU ranks (`tests/torch_dist_worker.py`, spawned once
for this module, with a timeout so that a rank that misses a collective
fails the module instead of hanging it) runs the collectives, the blocked
solves on a (1, 2) mesh — each rank holding half of the residual rows — and
the data-parallel solves on a (2, 1) mesh.  The JAX package runs the same
blocked solves under shard_map on a (1, 2) mesh of the 8-virtual-device CPU
platform of tests/conftest.py.

Tolerances: the collectives sum two float64 values, which rounds the same
in any order, so they are held to numpy exactly.  The blocked solves (the
family of tests/test_blocked_shardmap.py: n=96, d=512, m=4, float64) to
the JAX answer at rtol 1e-8 / atol 1e-10 in x (the JAX package's own pin
of its two blocked paths); the ranks return replicated results, equal bit
for bit.  Data parallel: to the port's single-process solve at 1e-12 and
to the JAX package at 1e-7 (tests/test_torch_bulk.py's float64 bar).
"""
import subprocess
import sys
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))

import torch_dist_worker as worker  # noqa: E402

from benlsip_tpu.batch.vmap_solve import BatchedProblem as JBatchedProblem  # noqa: E402
from benlsip_tpu.dist import sharded as j_sharded  # noqa: E402
from benlsip_tpu.dist.mesh import make_mesh as j_make_mesh  # noqa: E402
from benlsip_tpu.problems.generators import exp_fit_family as j_exp_fit  # noqa: E402
from benlsip_tpu.solver.options import SolverOptions as JOptions  # noqa: E402
from benlsip_tpu_torch.batch.vmap_solve import BatchedProblem, solve_batched  # noqa: E402
from benlsip_tpu_torch.dist import collectives as col  # noqa: E402
from benlsip_tpu_torch.dist.mesh import make_mesh  # noqa: E402
from benlsip_tpu_torch.dist.sharded import solve_large_blocked_family  # noqa: E402
from benlsip_tpu_torch.problems.generators import exp_fit_family  # noqa: E402
from benlsip_tpu_torch.solver.options import SolverOptions  # noqa: E402

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs the 8-virtual-device CPU mesh")

WORLD = 2
SPAWN_TIMEOUT_S = 300
X_TOL = dict(rtol=1e-8, atol=1e-10)


def _family_data(n=96, d=512, m=4, seed=2) -> dict:
    """The numpy recipe of tests/test_blocked_shardmap.py:_family."""
    rng = np.random.default_rng(seed)
    J = rng.standard_normal((d, n)) / np.sqrt(d)
    x_true = rng.standard_normal(n)
    y = J @ x_true + 0.01 * rng.standard_normal(d)
    A = rng.standard_normal((m, n)) / np.sqrt(n)
    return {"J": J, "y": y, "A": A, "b": A @ x_true}


@pytest.fixture(scope="module")
def gloo(tmp_path_factory):
    """Both ranks' results, {rank: dict}; spawned once for the module."""
    tmp = tmp_path_factory.mktemp("gloo")
    inputs, out, store = tmp / "inputs.npz", tmp / "out", tmp / "store"
    np.savez(inputs, **_family_data())
    procs = [
        subprocess.Popen(
            [sys.executable, str(ROOT / "tests" / "torch_dist_worker.py"), str(r), str(WORLD), str(store),
             str(inputs), str(out)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for r in range(WORLD)
    ]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=SPAWN_TIMEOUT_S)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail(f"the gloo world did not finish in {SPAWN_TIMEOUT_S} s (a rank missed a collective?)")
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} failed:\n{log[-4000:]}"
    return {r: torch.load(f"{out}.{r}", weights_only=False) for r in range(WORLD)}


@pytest.fixture(scope="module")
def jax_family():
    """The JAX package's inputs for the blocked solves."""
    data = _family_data()
    n = data["J"].shape[1]
    bp = JBatchedProblem(
        residuals=lambda x, th: th["J"] @ x - th["y"],
        jac_res=lambda x, th: th["J"],
        A=jnp.asarray(data["A"]), b=jnp.asarray(data["b"]),
        xl=jnp.full(n, -3.0), xu=jnp.full(n, 3.0),
    )
    return bp, {"J": jnp.asarray(data["J"]), "y": jnp.asarray(data["y"])}, jnp.zeros(n)


@pytest.fixture(scope="module")
def jax_family_1x1(jax_family):
    bp, theta, x0 = jax_family
    mesh = j_make_mesh(1, 1, devices=jax.devices()[:1])
    return j_sharded.solve_large_blocked_family(bp, theta, x0, JOptions(**worker.BLOCKED_OPTS), mesh)


def _expected_collectives(rank: int) -> dict:
    xs = [worker.collective_input(r) for r in range(WORLD)]
    total = xs[0] + xs[1]
    rows, cols = slice(2 * rank, 2 * rank + 2), slice(3 * rank, 3 * rank + 3)
    return {
        "psum": total,
        "pmean": total / 2,
        "all_gather": np.concatenate(xs, 0),
        "all_gather_dim1": np.concatenate(xs, 1),
        "all_gather_untiled": np.stack(xs, 0),
        "psum_scatter": total[rows],
        "psum_scatter_dim1": total[:, cols],
        "ppermute_ring": xs[(rank - 1) % WORLD],
        "ring_psum_scatter": total[rows],
        "ring_psum_scatter_dim1": total[:, cols],
        "ring_psum_scatter_lazy": total[rows],
    }


@pytest.mark.parametrize("name", list(_expected_collectives(0)))
def test_collective_against_numpy(gloo, name):
    for rank in range(WORLD):
        np.testing.assert_array_equal(gloo[rank]["collectives"][name].numpy(), _expected_collectives(rank)[name])


def test_axis_coordinates_and_size_one_identity(gloo):
    for rank in range(WORLD):
        got = gloo[rank]["collectives"]
        assert (got["axis_index"], got["axis_size"]) == (rank, WORLD)
        assert got["size_one_identity"] is True


def _assert_ranks_equal(gloo, group: str, name: str):
    (x0, y0, i0), (x1, y1, i1) = (gloo[r][group][name] for r in range(WORLD))
    assert torch.equal(x0, x1) and torch.equal(y0, y1)
    assert all(torch.equal(i0[f], i1[f]) for f in i0)


@pytest.mark.parametrize("variant", list(worker.BLOCKED_VARIANTS))
def test_blocked_shardmap_on_two_ranks_matches_jax(gloo, jax_family, variant):
    """The explicit-collective blocked solve, each rank holding d/2 rows,
    against the JAX package's shard_map on a (1, 2) mesh."""
    bp, theta, x0 = jax_family
    mesh = j_make_mesh(1, 2, devices=jax.devices()[:2])
    opts = JOptions(**worker.BLOCKED_OPTS, **worker.BLOCKED_VARIANTS[variant])
    xj, yj, ij = j_sharded.solve_large_blocked_shardmap(bp, theta, x0, opts, mesh)
    _assert_ranks_equal(gloo, "blocked", variant)
    x, y, info = gloo[0]["blocked"][variant]
    assert bool(info["converged"]) and bool(ij.converged)
    assert int(info["inner_iters"]) == int(ij.inner_iters)
    np.testing.assert_allclose(x.numpy(), np.asarray(xj), **X_TOL)
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), rtol=1e-6, atol=1e-8)


@pytest.mark.parametrize("entry", ["family", "problem"])
def test_blocked_family_and_problem_on_two_ranks(gloo, jax_family_1x1, entry):
    """solve_large_blocked_family and solve_large_blocked (a Problem) on a
    (1, 2) mesh run the explicit path; both agree with the JAX package's
    blocked family solve."""
    xj, yj, ij = jax_family_1x1
    _assert_ranks_equal(gloo, "blocked", entry)
    x, y, info = gloo[0]["blocked"][entry]
    assert bool(info["converged"]) and bool(ij.converged)
    np.testing.assert_allclose(x.numpy(), np.asarray(xj), **X_TOL)


def test_blocked_family_one_rank_in_process(jax_family_1x1):
    """make_mesh(1, 1) needs no launcher: it starts a one-rank gloo group."""
    xj, yj, ij = jax_family_1x1
    data = {k: torch.as_tensor(v) for k, v in _family_data().items()}
    n = data["J"].shape[1]
    bp = BatchedProblem(
        residuals=lambda x, th: th["J"] @ x - th["y"], jac_res=lambda x, th: th["J"],
        A=data["A"], b=data["b"],
        xl=torch.full((n,), -3.0, dtype=torch.float64), xu=torch.full((n,), 3.0, dtype=torch.float64),
    )
    mesh = make_mesh(1, 1, device="cpu")
    assert mesh.mesh_dim_names == ("batch", "block") and tuple(mesh.shape) == (1, 1)
    x, y, info = solve_large_blocked_family(bp, {"J": data["J"], "y": data["y"]}, torch.zeros(n, dtype=torch.float64),
                                            SolverOptions(**worker.BLOCKED_OPTS), mesh)
    assert x.shape == (n,) and y.shape == (0,) and info.converged.shape == ()
    assert bool(info.converged) and int(info.inner_iters) == int(ij.inner_iters)
    np.testing.assert_allclose(x.numpy(), np.asarray(xj), **X_TOL)


@pytest.mark.parametrize("entry", ["solve_batched_sharded", "solve_batched_shardmap"])
def test_data_parallel_on_two_ranks(gloo, entry):
    """Each rank solves 8 of the 16 lanes with its own loop exit; the
    gathered batch equals the single-process solve and the JAX package's
    data-parallel solve on two devices."""
    f = dict(worker.DP_FAMILY)
    B = f.pop("B")
    bp, theta, X0 = exp_fit_family(B, **f, device="cpu")
    Xs, Ys, info_s = solve_batched(bp, theta, X0, SolverOptions(**worker.DP_OPTS))
    bp_j, th_j, X0_j = j_exp_fit(B, **f)
    Xj, _, ij = j_sharded.solve_batched_shardmap(bp_j, th_j, X0_j, JOptions(**worker.DP_OPTS),
                                                 j_make_mesh(batch=2, devices=jax.devices()[:2]))
    _assert_ranks_equal(gloo, "data_parallel", entry)
    X, Y, info = gloo[0]["data_parallel"][entry]
    assert X.shape == (B, 3) and Y.shape == (B, 0)
    assert torch.equal(info["converged"], info_s.converged) and bool(info["converged"].all())
    np.testing.assert_array_equal(info["converged"].numpy(), np.asarray(ij.converged))
    np.testing.assert_allclose(X.numpy(), Xs.numpy(), rtol=0, atol=1e-12)
    np.testing.assert_allclose(X.numpy(), np.asarray(Xj), rtol=0, atol=1e-7)


def test_mesh_and_collectives_refuse_what_they_cannot_do():
    """No silent fallback: several ranks need a group, the card needs a
    card, an axis needs a bound mesh that names it."""
    if torch.distributed.is_initialized():   # the one-rank group of the test above
        with pytest.raises(ValueError, match="2x1 != 1 ranks"):
            make_mesh(2, 1, device="cpu")
    else:
        with pytest.raises(RuntimeError, match="process group"):
            make_mesh(2, 1, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            make_mesh(1, 1)
    with pytest.raises(RuntimeError, match="bind_mesh"):
        col.psum(torch.ones(2), "block")
    with col.bind_mesh(make_mesh(1, 1, device="cpu")):
        with pytest.raises(ValueError, match="not a dim"):
            col.psum(torch.ones(2), "rows")
        x = torch.ones(3)
        assert col.psum(x, "block") is x and torch.equal(col.ring_psum_scatter(x, "block"), x)
