"""The port's small twins of JAX-package functions, `ops/native_qp`, against
the JAX package on the same seeded numpy inputs.

The JAX functions take one instance and are lifted with jax.vmap; the
port's are batch-first.  Tolerance 1e-12 in float64: both sides compute the
same formulas, so only summation order differs.  The native projection is
the port's own build of its own copy of `polyqp.cpp`; it is held against
the JAX module's build (the same algorithm: 1e-12) and against the port's
device projection `ops/polyproject` (the JAX test's 1e-8, 1e-7 on the
rank-deficient rows: two solvers that stop at their own tolerances).
"""
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benlsip_tpu.ops import al as jal
from benlsip_tpu.ops import cholesky as jchol
from benlsip_tpu.ops import constraints as jc
from benlsip_tpu.ops import native_qp as jqp
from benlsip_tpu.ops import project as jpr
from benlsip_tpu.solver import multipliers as jmult
from benlsip_tpu.solver import subproblem as jsub
import benlsip_tpu_torch as bt
from benlsip_tpu_torch.kernels import batched_linalg as tk
from benlsip_tpu_torch.ops import al as tal
from benlsip_tpu_torch.ops import cholesky as tchol
from benlsip_tpu_torch.ops import constraints as tc
from benlsip_tpu_torch.ops import native_qp as tqp
from benlsip_tpu_torch.ops import polyproject as tpp
from benlsip_tpu_torch.ops import project as tpr
from benlsip_tpu_torch.solver import multipliers as tmult
from benlsip_tpu_torch.solver import subproblem as tsub

torch.set_num_threads(2)
TOL = dict(rtol=1e-12, atol=1e-12)


@pytest.fixture
def rng(request):
    return np.random.default_rng(zlib.crc32(request.node.nodeid.encode()))


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_masked_factor_matches_greedy_and_augmented(rng):
    # tests/test_ops.py::test_masked_factor_matches_greedy_and_augmented.
    m, n = 3, 6
    A = rng.random((m, n))
    fixed = np.zeros(n, dtype=bool)
    fixed[[1, 3, 5]] = True
    L_aat = np.linalg.cholesky(A @ A.T)
    L_aug = tchol.cholesky_aug_aat_dense(A, fixed, L_aat)
    np.testing.assert_allclose(L_aug, jchol.cholesky_aug_aat_dense(A, fixed, L_aat), **TOL)
    B = np.vstack([A, np.eye(n)[fixed]])
    np.testing.assert_allclose(L_aug, np.linalg.cholesky(B @ B.T), rtol=1e-10, atol=1e-12)
    assert tchol.cholesky_aug_aat_dense(A, np.zeros(n, bool), L_aat).shape == (m, m)

    # masked_aat under its ops/cholesky name is the kernel module's, batched.
    assert tchol.masked_aat is tk.masked_aat
    Ab = rng.random((4, m, n))
    free = rng.random((4, n)) < 0.6
    K = tchol.masked_aat(t(Ab), t(free)).numpy()
    np.testing.assert_allclose(K, np.asarray(jax.vmap(jchol.masked_aat)(jnp.asarray(Ab), jnp.asarray(free))), **TOL)
    E = np.eye(n)[fixed]
    schur = A @ A.T - (A @ E.T) @ (E @ A.T)
    np.testing.assert_allclose(tchol.masked_aat(t(A[None]), t(~fixed[None])).numpy()[0], schur, rtol=1e-12)


def _poly(rng, B, m, n):
    A = rng.standard_normal((B, m, n))
    x = rng.standard_normal((B, n))
    return A, np.einsum("bmn,bn->bm", A, x), x - 1.0, x + 1.0


def test_left_mul_and_transpose(rng):
    # tests/test_ops.py:114-124 on the HS48 rows, then on a random batch:
    # [A x ; x on the fixed slots] and Aᵀ y_lin + y_bnd on the fixed slots.
    A = np.array([[1.0, 1, 1, 1, 1], [0, 0, 1, -2, -2]])
    m, n = A.shape
    fixed = np.array([True, True, False, False, False])
    x_hs = np.array([3.0, 5, -3, 2, -2])
    poly = tc.Polyhedron(t(A[None]), t(np.array([[5.0, -3]])), t(np.full((1, n), -np.inf)), t(np.full((1, n), np.inf)))
    Bd = np.vstack([A, np.eye(n)[fixed]])
    y = rng.random(m + 2)
    y_full = np.zeros(m + n)
    y_full[:m] = y[:m]
    y_full[m + np.flatnonzero(fixed)] = y[m:]
    np.testing.assert_allclose(tpr.left_mul_tr(poly, t(fixed[None]), t(y_full[None])).numpy()[0], Bd.T @ y, rtol=1e-12)
    lm = tpr.left_mul(poly, t(fixed[None]), t(x_hs[None])).numpy()[0]
    np.testing.assert_allclose(lm[:m], A @ x_hs, rtol=1e-12)
    np.testing.assert_allclose(lm[m + np.flatnonzero(fixed)], x_hs[fixed], rtol=1e-12)
    assert np.all(lm[m + np.flatnonzero(~fixed)] == 0)

    Ab, b, xl, xu = _poly(rng, 5, 2, 7)
    fx = rng.random((5, 7)) < 0.4
    xv, yv = rng.standard_normal((5, 7)), rng.standard_normal((5, 9))
    tp = tc.Polyhedron(t(Ab), t(b), t(xl), t(xu))
    jp = jc.Polyhedron(jnp.asarray(Ab), jnp.asarray(b), jnp.asarray(xl), jnp.asarray(xu))
    axes = jc.Polyhedron(0, 0, 0, 0)
    for port, jax_fn, v in ((tpr.left_mul, jpr.left_mul, xv), (tpr.left_mul_tr, jpr.left_mul_tr, yv)):
        want = np.asarray(jax.vmap(jax_fn, in_axes=(axes, 0, 0))(jp, jnp.asarray(fx), jnp.asarray(v)))
        np.testing.assert_allclose(port(tp, t(fx), t(v)).numpy(), want, **TOL)


def test_first_and_second_derivatives(rng):
    B, n, d, p = 4, 5, 8, 2
    J, C = rng.standard_normal((B, d, n)), rng.standard_normal((B, p, n))
    x, y, mu = rng.standard_normal((B, n)), rng.standard_normal((B, p)), rng.random(B) + 1.0
    rx, cx = rng.standard_normal((B, d)), rng.standard_normal((B, p))
    y_bar, Jx, Cx, g = bt.first_derivatives(t(x), t(y), t(mu), t(rx), t(cx), lambda X: t(J), lambda X: t(C))

    def one(x_, y_, mu_, rx_, cx_, J_, C_):
        return jal.first_derivatives(x_, y_, mu_, rx_, cx_, lambda _: J_, lambda _: C_)

    want = jax.vmap(one)(*(jnp.asarray(a) for a in (x, y, mu, rx, cx, J, C)))
    for got, w in zip((y_bar, Jx, Cx, g), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), **TOL)
    H = bt.second_derivatives(Jx, Cx, t(mu))
    assert isinstance(H, tal.AlHessian) and H.J is Jx and H.C is Cx
    v = rng.standard_normal((B, n))
    Hj = jax.vmap(lambda J_, C_, mu_: jal.second_derivatives(J_, C_, mu_))(jnp.asarray(J), jnp.asarray(C), jnp.asarray(mu))
    hv_j = jax.vmap(jal.hv, in_axes=(jal.AlHessian(0, 0, 0, None, None), 0))(Hj, jnp.asarray(v))
    np.testing.assert_allclose(tal.hv(H, t(v)).numpy(), np.asarray(hv_j), **TOL)
    # new_point is built from the same two functions.
    assert "first_derivatives" in bt.__all__ and "second_derivatives" in bt.__all__


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_sqrt_eps(dtype):
    got = tc.sqrt_eps(getattr(torch, dtype))
    assert got == jc.sqrt_eps(jnp.dtype(dtype))
    np.testing.assert_allclose(got, np.sqrt(np.finfo(dtype).eps), rtol=1e-7)


def test_reduced_gradient_measure_and_first_order_multipliers(rng):
    B, m, n = 5, 2, 7
    Ab, b, xl, xu = _poly(rng, B, m, n)
    fx = rng.random((B, n)) < 0.3
    g = rng.standard_normal((B, n))
    tp = tc.Polyhedron(t(Ab), t(b), t(xl), t(xu))
    jp = jc.Polyhedron(*(jnp.asarray(a) for a in (Ab, b, xl, xu)))
    got = tsub.reduced_gradient_measure(tp, tc.make_active_set(tp, t(fx)), t(g)).numpy()
    want = jax.vmap(lambda p_, f_, g_: jsub.reduced_gradient_measure(p_, jc.make_active_set(p_, f_), g_))(
        jp, jnp.asarray(fx), jnp.asarray(g))
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-11, atol=1e-12)

    y, cx, mu = rng.standard_normal((B, 3)), rng.standard_normal((B, 3)), rng.random(B) * 10
    np.testing.assert_allclose(
        tmult.first_order_multipliers(t(y), t(cx), t(mu)).numpy(),
        np.asarray(jax.vmap(jmult.first_order_multipliers)(jnp.asarray(y), jnp.asarray(cx), jnp.asarray(mu))), **TOL)


# ---------------------------------------------------------------------------
# ops/native_qp (the four cases of tests/test_native_qp.py)
# ---------------------------------------------------------------------------


def device_projection(A, b, l, u, X):
    """The port's device projection (ops/polyproject) of the rows of X onto
    one polyhedron, float64 on the CPU."""
    Bn = X.shape[0]
    rep = lambda a: t(np.broadcast_to(a, (Bn,) + a.shape).copy())
    return tpp.projection_polyhedron(tc.Polyhedron(rep(A), rep(b), rep(l), rep(u)), t(X)).numpy()


def test_native_builds_from_the_ports_own_copy():
    assert tqp.available()
    lib = tqp.library_path()
    assert lib.exists() and lib.parent == tqp.BUILD_DIR != tk.BUILD_DIR
    assert tqp._SRC.parent.parent.name == "benlsip_tpu_torch" and tqp._SRC.name == "polyqp.cpp"
    assert lib.parent.parent == tqp._SRC.parent        # benlsip_tpu_torch/native/_build


def test_native_matches_jax_module_and_device(rng):
    for _ in range(6):
        m, n = int(rng.integers(0, 4)), 10
        A = rng.standard_normal((m, n))
        v_feas = rng.standard_normal(n)
        l = v_feas - rng.random(n) * 2
        u = v_feas + rng.random(n) * 2
        b = A @ v_feas
        x = rng.standard_normal(n) * 3
        v = tqp.projection_polyhedron_host(x, A, b, l, u)
        assert isinstance(v, np.ndarray)
        np.testing.assert_allclose(v, jqp.projection_polyhedron_host(x, A, b, l, u), **TOL)
        assert np.all(v >= l - 1e-10) and np.all(v <= u + 1e-10)
        if m:
            np.testing.assert_allclose(A @ v, b, atol=1e-9)
        np.testing.assert_allclose(v, device_projection(A, b, l, u, x[None])[0], atol=1e-8)


def test_native_batch(rng):
    m, n, B = 2, 6, 64
    A = rng.standard_normal((m, n))
    vf = rng.standard_normal(n)
    l, u = vf - 1, vf + 1
    b = A @ vf
    X = rng.standard_normal((B, n)) * 2
    # Tensors in, a tensor out on x's device.
    V = tqp.projection_polyhedron_host(t(X), t(A), t(b), t(l), t(u))
    assert isinstance(V, torch.Tensor) and V.shape == (B, n) and V.dtype == torch.float64 and V.device == torch.device("cpu")
    V = V.numpy()
    np.testing.assert_allclose(V, jqp.projection_polyhedron_host(X, A, b, l, u), **TOL)
    np.testing.assert_allclose(V @ A.T, np.broadcast_to(b, (B, m)), atol=1e-9)
    np.testing.assert_allclose(V[7], tqp.projection_polyhedron_host(X[7], A, b, l, u), atol=1e-12)
    np.testing.assert_allclose(V, device_projection(A, b, l, u, X), atol=1e-8)


def test_native_hs48_fixture():
    A = np.array([[1.0, 1, 1, 1, 1], [0, 0, 1, -2, -2]])
    b = np.array([5.0, -3])
    x = np.array([3.0, 5, -3, 2, -2])
    l, u = np.full(5, -1e6), np.full(5, 1e6)
    v = tqp.projection_polyhedron_host(x, A, b, l, u)
    np.testing.assert_allclose(v, x, atol=1e-9)          # x already feasible
    np.testing.assert_allclose(v, jqp.projection_polyhedron_host(x, A, b, l, u), **TOL)
    np.testing.assert_allclose(v, device_projection(A, b, l, u, x[None])[0], atol=1e-8)


def test_native_degenerate_rows_match_device():
    # Rank-deficient consistent rows (a repeated row, a zero row).
    n = 8
    r = np.random.default_rng(11)
    A1 = r.standard_normal((2, n))
    A = np.vstack([A1, 2.0 * A1[0:1], np.zeros((1, n))])
    xt = r.standard_normal(n)
    b1 = A1 @ xt
    b = np.concatenate([b1, [2.0 * b1[0]], [0.0]])
    l, u = np.full(n, -2.0), np.full(n, 2.0)
    for seed in range(4):
        z = np.random.default_rng(seed).standard_normal(n) * 3
        v = tqp.projection_polyhedron_host(z, A, b, l, u)
        assert np.all(np.isfinite(v))
        np.testing.assert_allclose(v, jqp.projection_polyhedron_host(z, A, b, l, u), **TOL)
        np.testing.assert_allclose(A @ v, b, atol=1e-8)
        np.testing.assert_allclose(v, device_projection(A, b, l, u, z[None])[0], atol=1e-7)
