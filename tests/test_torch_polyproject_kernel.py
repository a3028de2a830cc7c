"""The dual Newton of `ops/polyproject` and its kernel's wrapper on the CPU.

On a CUDA tensor in float32 or bf16 with 0 < m ≤ 16 the projection is one
launch of `kernels.batched_linalg.polyhedron_newton`; on the CPU it runs
the kernel's plain version, the masked loop `dual_newton`, unchanged.  So
these tests hold the port's `projection_polyhedron` to the JAX package's on
the same numpy-seeded inputs at the paths' shapes (config 2's (B, 1, 3),
config 3's (B, 6, 192) with one A shared by the batch, a (1, 8, 2048)
instance, a degenerate lane), cold and warm, with an `active` mask, and
check the wrapper's refusals, its plain version in bf16 and the gate.  The
kernel itself runs on the card only (`chip_smoke.py`, phase 3).

Tolerances: float64, the projection's own (v 1e-10, the dual 1e-8 / 1e-9)
with equal trip counts; float32, v within 1e-5·(1 + |x|∞) a lane and no
trip-count comparison (a lane at the float32 floor may stall in one
package and not the other).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from benlsip_tpu.ops import constraints as jc
from benlsip_tpu.ops import polyproject as jpp
from benlsip_tpu_torch.kernels import batched_linalg as tk
from benlsip_tpu_torch.ops import constraints as tc
from benlsip_tpu_torch.ops import polyproject as tpp

torch.set_num_threads(2)


def _polys(gen, B, m, n, shared, dtype, degenerate=False):
    """Boxes around 0, b = A·p for a point p in the box, x spread over a few
    units; with `degenerate` the last lane's x lies above every upper bound,
    so no column is inside its box at λ = 0 and the first Newton matrix is
    reg·I."""
    A = gen.standard_normal((1 if shared else B, m, n))
    A = np.broadcast_to(A, (B, m, n))
    xl = -np.abs(gen.standard_normal((B, n))) - 0.1
    xu = np.abs(gen.standard_normal((B, n))) + 0.1
    b = np.einsum("bmn,bn->bm", A, gen.uniform(xl, xu))
    x = 2.0 * gen.standard_normal((B, n))
    if degenerate:
        x[-1] = xu[-1] + 1.0 + gen.random(n)
    return [np.ascontiguousarray(a).astype(dtype) for a in (A, b, xl, xu, x)]


def _jax_projection(A, b, xl, xu, x, shared, lam0=None):
    """The JAX package's projection, vmapped: (v, λ, trips)."""
    axes = jc.Polyhedron(None if shared else 0, 0, 0, 0)
    poly = jc.Polyhedron(jnp.asarray(A[0] if shared else A), jnp.asarray(b), jnp.asarray(xl), jnp.asarray(xu))
    if lam0 is None:
        fn = jax.vmap(lambda p, z: jpp.projection_polyhedron(p, z, return_lam=True, return_iters=True), in_axes=(axes, 0))
        out = fn(poly, jnp.asarray(x))
    else:
        fn = jax.vmap(lambda p, z, l0: jpp.projection_polyhedron(p, z, lam0=l0, return_lam=True, return_iters=True),
                      in_axes=(axes, 0, 0))
        out = fn(poly, jnp.asarray(x), jnp.asarray(lam0))
    return [np.asarray(o) for o in out]


def _torch_poly(A, b, xl, xu, shared):
    At = torch.as_tensor(A[:1]).expand(A.shape) if shared else torch.as_tensor(A)
    return tc.Polyhedron(At, torch.as_tensor(b), torch.as_tensor(xl), torch.as_tensor(xu))


def _hold(got, want, x, f64, lanes=None):
    """got = the port's (v, λ, trips), want = JAX's, on the lanes given."""
    v, lam, it = (t.numpy() for t in got)
    jv, jlam, jit = want
    sel = slice(None) if lanes is None else lanes
    if f64:
        np.testing.assert_allclose(v[sel], jv[sel], rtol=1e-10, atol=1e-10)
        np.testing.assert_allclose(lam[sel], jlam[sel], rtol=1e-8, atol=1e-9)
        np.testing.assert_array_equal(it[sel], jit[sel])
    else:
        bound = 1e-5 * (1 + np.abs(x[sel]).max(-1, keepdims=True))
        assert (np.abs(v[sel] - jv[sel]) <= bound).all(), np.abs(v[sel] - jv[sel]).max()


CASES = {
    "c2": (32, 1, 3, False, True),        # config 2's bulk chunk, narrowed; a degenerate last lane
    "c3": (8, 6, 192, True, False),       # config 3: one A shared by the batch
    "wide": (1, 8, 2048, False, False),   # one instance of large n (config 4's layout)
}


@pytest.mark.parametrize(
    "case,dtype,seed",
    [("c2", np.float64, 1), ("c2", np.float32, 2), ("c3", np.float64, 3), ("c3", np.float32, 4), ("wide", np.float64, 5)],
    ids=["c2-float64", "c2-float32", "c3-float64", "c3-float32", "wide-float64"],
)
def test_projection_against_jax_cold_warm_and_active(case, dtype, seed):
    B, m, n, shared, degenerate = CASES[case]
    gen = np.random.default_rng(seed)
    A, b, xl, xu, x = _polys(gen, B, m, n, shared, dtype, degenerate)
    f64 = dtype == np.float64
    poly = _torch_poly(A, b, xl, xu, shared)

    cold = tpp.projection_polyhedron(poly, torch.as_tensor(x), return_lam=True, return_iters=True)
    jcold = _jax_projection(A, b, xl, xu, x, shared)
    _hold(cold, jcold, x, f64)
    assert cold[2].dtype == torch.int32 and (cold[2].numpy() >= 1).all()

    lam0 = (jcold[1] + gen.standard_normal((B, m))).astype(dtype)
    warm = tpp.projection_polyhedron(poly, torch.as_tensor(x), lam0=torch.as_tensor(lam0), return_lam=True,
                                     return_iters=True)
    _hold(warm, _jax_projection(A, b, xl, xu, x, shared, lam0), x, f64)

    # An active mask: the active lanes are the JAX answer, the others run no
    # trip and keep λ₀ with v = clip(x − Aᵀλ₀, l, u).
    active = np.arange(B) % 3 != 1
    part = tpp.projection_polyhedron(poly, torch.as_tensor(x), lam0=torch.as_tensor(lam0), return_lam=True,
                                     return_iters=True, active=torch.as_tensor(active))
    _hold(part, _jax_projection(A, b, xl, xu, x, shared, lam0), x, f64, lanes=active)
    idle = ~active
    if idle.any():
        v, lam, it = (t.numpy() for t in part)
        np.testing.assert_array_equal(it[idle], 0)
        np.testing.assert_array_equal(lam[idle], lam0[idle])
        want = np.clip(x - np.einsum("bmn,bm->bn", A, lam0), xl, xu)[idle]
        np.testing.assert_allclose(v[idle], want, rtol=0, atol=1e-12 if f64 else 1e-5)


def test_degenerate_lane_newton_matrix_is_reg():
    # Every coordinate of the lane above its upper bound: the first trip's
    # Newton matrix is reg·I; both packages still reach the same point.
    gen = np.random.default_rng(4)
    A, b, xl, xu, x = _polys(gen, 4, 2, 6, False, np.float64)
    x[:] = xu + 1.0 + gen.random(xu.shape)
    z = x - np.einsum("bmn,bm->bn", A, np.zeros((4, 2)))
    assert not ((z > xl) & (z < xu)).any()
    got = tpp.projection_polyhedron(_torch_poly(A, b, xl, xu, False), torch.as_tensor(x), return_lam=True,
                                    return_iters=True)
    _hold(got, _jax_projection(A, b, xl, xu, x, False), x, True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
def test_wrapper_plain_version_on_cpu(dtype):
    # On a CPU tensor the wrapper runs its plain version: the float32 loop
    # of `dual_newton` (so projection_polyhedron's bits), in bf16 that loop
    # in float32 on the upcast inputs with bf16's tolerances and geometry,
    # v and λ rounded once.  No launch is counted.
    gen = np.random.default_rng(8)
    A, b, xl, xu, x = (torch.as_tensor(a).to(dtype) for a in _polys(gen, 16, 2, 5, False, np.float64))
    eps = torch.finfo(dtype).eps
    geometry = tpp.line_search_geometry(dtype)
    tk.reset_launches()
    v, lam, it = tk.polyhedron_newton(A, b, xl, xu, x, eps ** 0.75, eps ** 0.5, 100, *geometry)
    assert sum(tk.LAUNCHES.values()) == 0 and v.dtype == lam.dtype == dtype and it.dtype == torch.int32
    for g, w in zip((v, lam, it), tpp.newton_plain(A, b, xl, xu, x, eps ** 0.75, eps ** 0.5, 100, *geometry)):
        assert torch.equal(g, w)
    if dtype == torch.float32:
        want = tpp.projection_polyhedron(tc.Polyhedron(A, b, xl, xu), x, return_lam=True, return_iters=True)
        for g, w in zip((v, lam, it), want):
            assert torch.equal(g, w)
    else:
        up = [t.float() for t in (A, b, xl, xu, x)]
        wv, wlam, wit = tpp.dual_newton(*up, eps ** 0.75, eps ** 0.5, 100, None, None, *geometry)
        assert geometry == (60, 14)
        assert torch.equal(v, wv.to(dtype)) and torch.equal(lam, wlam.to(dtype)) and torch.equal(it, wit)


def test_kernel_layer_imports_nothing_from_ops():
    # The plain version lives a layer up, in ops/polyproject, and is
    # registered into the kernel module; the kernel layer imports no module
    # of ops/ (nor of any other layer of the package).
    import ast
    from pathlib import Path

    src = Path(tk.__file__).parent
    for path in sorted(src.glob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.ImportFrom):
                assert node.level <= 1, f"{path.name} imports from a package above kernels/: {node.module}"
                assert not (node.module or "").startswith("benlsip_tpu_torch"), f"{path.name}: {node.module}"
            elif isinstance(node, ast.Import):
                assert not any(a.name.startswith("benlsip_tpu_torch") for a in node.names), path.name
    assert tk._NEWTON_PLAIN is tpp.newton_plain


def test_wrapper_refuses_operands_before_any_launch():
    gen = np.random.default_rng(9)
    A, b, xl, xu, x = (torch.as_tensor(a).float() for a in _polys(gen, 4, 2, 5, False, np.float64))
    call = lambda *t, **kw: tk.polyhedron_newton(*t, 1e-5, 1e-4, 100, 40, 6, **kw)
    tk.reset_launches()
    with pytest.raises(TypeError):      # float64: the certification's projection runs the plain loop
        call(A.double(), b.double(), xl.double(), xu.double(), x.double())
    with pytest.raises(TypeError):      # mixed dtypes
        call(A, b.double(), xl, xu, x)
    with pytest.raises(ValueError):     # m > 16
        call(torch.zeros(4, 17, 5), torch.zeros(4, 17), xl, xu, x)
    with pytest.raises(ValueError):     # mixed devices
        call(A, b, xl.to("meta"), xu, x)
    with pytest.raises(ValueError):     # a non-contiguous vector
        call(A, b, xl, xu, x.T.contiguous().T)
    with pytest.raises(ValueError):     # A without row-major blocks
        call(A.transpose(1, 2).contiguous().transpose(1, 2), b, xl, xu, x)
    with pytest.raises(ValueError):     # a geometry past the kernel's bracket
        tk.polyhedron_newton(A, b, xl, xu, x, 1e-5, 1e-4, 100, 61, 6)
    with pytest.raises(ValueError):     # a device that is neither CPU nor CUDA
        call(*(t.to("meta") for t in (A, b, xl, xu, x)))
    assert sum(tk.LAUNCHES.values()) == 0
    # A batch-shared A (stride 0) is taken as it is; an empty batch launches nothing.
    shared = A[:1].expand(4, 2, 5)
    assert tk.has_row_major_blocks(shared)
    assert call(shared, b, xl, xu, x)[0].shape == (4, 5)
    v, lam, it = call(A[:0], b[:0], xl[:0], xu[:0], x[:0])
    assert v.shape == (0, 5) and lam.shape == (0, 2) and it.shape == (0,)
    assert sum(tk.LAUNCHES.values()) == 0


@pytest.mark.parametrize(
    "device_type,dtype,m,n,want",
    [
        ("cuda", torch.float32, 1, 3, True),        # configs 1, 2, 5
        ("cuda", torch.float32, 6, 192, True),      # config 3
        ("cuda", torch.float32, 8, 10240, True),    # config 4 (the split form)
        ("cuda", torch.bfloat16, 6, 192, True),     # the bf16 bulk
        ("cuda", torch.float32, 16, 40, True),
        ("cuda", torch.float64, 1, 3, False),       # the certification's pix check
        ("cuda", torch.float32, 17, 40, False),     # past the kernel's m
        ("cuda", torch.float32, 0, 3, False),       # no equality: a clip
        ("cuda", torch.float32, 2, 0, False),
        ("cpu", torch.float32, 1, 3, False),        # every CPU tensor runs the plain loop
        ("cpu", torch.bfloat16, 6, 192, False),
    ],
)
def test_gate(device_type, dtype, m, n, want):
    assert tpp.newton_on_kernel(device_type, dtype, m, n) is want


def test_layout_plan_is_a_function_of_the_shape():
    # The grid on the lanes up to 32 columns, the columns on the lanes below
    # the split form, the fused kernels' cluster sizes from 512 on.
    assert [tk.newton_plan(1, n, torch.float32) for n in (1, 3, 32, 33, 192, 511)] == [0, 0, 0, 1, 1, 1]
    assert tk.newton_plan(8, 10240, torch.float32) == tk.fused_plan(8, 10240, torch.float32) == 16
    assert tk.newton_plan(8, 512, torch.bfloat16) == tk.fused_plan(8, 512, torch.bfloat16) == 2
