"""The narrow QR's R-only and stacked forms on the CPU.

`kernels/batched_linalg.narrow_qr_r(S, dbot)` is R of S, or of the stacked
[S; diag(dbot)] without the stacked matrix; `ops/qr.qr_r_stacked` routes the
polish's factor through it (`batch/polish._factor_qr`).  Their plain
versions (what a CPU tensor runs) are held against the JAX package's Pallas
MGS kernel `batched_thin_qr` in interpret mode on the stacked matrix
(float32: rtol 1e-5, atol 1e-5·√D, `test_thin_qr_plain_matches_pallas`'s R
tolerance; bf16 at bf16 grade and within one bf16 ulp of the JAX float32
round trip, as `test_thin_qr_bf16_matches_pallas` holds the full QR), and
bitwise against `batched_thin_qr_plain` of the stacked matrix, so that every
pipeline result on the CPU is the bits it was when the polish built the
stacked matrix itself.  The kernel compiles and runs only on the GPU;
chip_smoke.py holds it to these plain versions there, and its stacked and
R-only forms bitwise to its full R.

D below counts the stacked rows: JZ has D − N rows.  dbot is what the
polish builds: 1 on a fixed coordinate, √reg on a free one.  Inputs come from
a numpy generator seeded from each test's node id.
"""
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benlsip_tpu.kernels import batched_linalg as jk
from benlsip_tpu.ops import qr as jqr
from benlsip_tpu_torch.batch import polish as tpol
from benlsip_tpu_torch.kernels import batched_linalg as tk
from benlsip_tpu_torch.ops import qr as tqr

torch.set_num_threads(2)
BF = torch.bfloat16
EPS32 = float(np.finfo(np.float32).eps)
STACKED = [(8, 3), (35, 3), (7, 3), (16, 8), (3, 1)]


@pytest.fixture
def rng(request):
    return np.random.default_rng(zlib.crc32(request.node.nodeid.encode()))


def polish_operands(rng, B, D, N, reg):
    """JZ (B, D − N, N) and dbot (B, N) as float32 arrays; the first lane
    has no fixed coordinate, the second every one, the rest about a third."""
    JZ = rng.standard_normal((B, D - N, N)).astype(np.float32)
    fixed = rng.random((B, N)) < 1 / 3
    fixed[0], fixed[1] = False, True
    dbot = np.where(fixed, 1.0, np.sqrt(reg)).astype(np.float32)
    return JZ, dbot


def stacked(JZ, dbot):
    return np.concatenate([JZ, np.einsum("bi,ij->bij", dbot, np.eye(dbot.shape[1], dtype=dbot.dtype))], axis=1)


def bits(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().view({2: torch.int16, 4: torch.int32, 8: torch.int64}[t.element_size()]).numpy()


@pytest.mark.parametrize("reg", [0.0, 1e-3])
@pytest.mark.parametrize("D,N", STACKED)
def test_narrow_qr_r_plain_matches_pallas(D, N, reg, rng):
    JZ, dbot = polish_operands(rng, 140, D, N, reg)
    S = stacked(JZ, dbot)
    R_pl = np.asarray(jk.batched_thin_qr(jnp.asarray(S), interpret=True)[1])
    R_st = tk.narrow_qr_r_plain(torch.from_numpy(JZ), torch.from_numpy(dbot))
    R_s = tk.narrow_qr_r_plain(torch.from_numpy(S))
    for R in (R_st, R_s):
        np.testing.assert_allclose(R.numpy(), R_pl, rtol=1e-5, atol=1e-5 * np.sqrt(D))
        assert np.all(np.tril(R.numpy(), -1) == 0) and np.all(np.diagonal(R.numpy(), axis1=1, axis2=2) > 0)
    # The stacked form, the R-only form and the full R: the same bits, through
    # the wrappers (a CPU tensor runs the plain version) and through qr_r_stacked.
    want = bits(tk.batched_thin_qr_plain(torch.from_numpy(S))[1])
    for got in (R_st, R_s, tk.narrow_qr_r(torch.from_numpy(JZ), torch.from_numpy(dbot)),
                tk.narrow_qr_r(torch.from_numpy(S)), tqr.qr_r_stacked(torch.from_numpy(JZ), torch.from_numpy(dbot))):
        np.testing.assert_array_equal(bits(got), want)


def bf16(a) -> np.ndarray:
    """a rounded once to bf16, held as float32 (what both packages get)."""
    return torch.from_numpy(np.asarray(a, np.float32)).to(BF).float().numpy()


def f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.array(jnp.asarray(a, jnp.float32))


@pytest.mark.parametrize("D,N", STACKED)
def test_narrow_qr_r_bf16_matches_pallas(D, N, rng):
    JZ, dbot = (bf16(a) for a in polish_operands(rng, 8, D, N, 1e-3))
    S = stacked(JZ, dbot)
    R_t = tk.narrow_qr_r(torch.from_numpy(JZ).to(BF), torch.from_numpy(dbot).to(BF))
    assert R_t.dtype == BF
    # bf16 grade against the Pallas kernel, which rounds every operation to bf16.
    R_pl = f32(jk.batched_thin_qr(jnp.asarray(S).astype(jnp.bfloat16), interpret=True)[1])
    err = np.abs(f32(R_t) - R_pl).reshape(8, -1).max(1)
    assert np.all(err <= 2 * N * 2.0 ** -8 * np.abs(R_pl).reshape(8, -1).max(1))
    # Within one bf16 ulp of the JAX float32 round trip (Householder), signs
    # normalised to R's positive diagonal, plus float32 rounding.
    R_x = f32(jax.vmap(lambda a: jqr._xla_qr(a, "reduced"))(jnp.asarray(S).astype(jnp.bfloat16))[1])
    R_x = R_x * np.sign(np.diagonal(R_x, axis1=1, axis2=2))[:, :, None]
    slack = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(R_x), np.finfo(np.float32).tiny))) - 7) + 8 * EPS32 * np.abs(R_x).max()
    assert np.all(np.abs(f32(R_t) - R_x) <= slack)
    # bf16 in, bf16 out: the float32 plain version on the upcast, rounded once,
    # and the same bits as the stacked matrix's full R.
    np.testing.assert_array_equal(bits(R_t), bits(tk.narrow_qr_r_plain(torch.from_numpy(JZ), torch.from_numpy(dbot)).to(BF)))
    np.testing.assert_array_equal(bits(R_t), bits(tk.batched_thin_qr(torch.from_numpy(S).to(BF))[1]))


STACKED_ROUTES = [
    # JZ shape, dtype, route of qr_r_stacked (the stacked matrix has D + N rows)
    ((4, 32, 3), torch.float32, "narrow_qr_r"),
    ((4, 32, 3), torch.bfloat16, "narrow_qr_r"),
    ((4, 1, 3), torch.float32, "narrow_qr_r"),
    ((2, 2032, 16), torch.float32, "narrow_qr_r"),
    ((2, 2033, 16), torch.float32, "linalg"),
    ((4, 23, 17), torch.float32, "blocked_qr_r"),
    # One stacked panel launch, a full panel and a ragged one; config 3's
    # (64, 1024 + 192, 192) takes the same route, checked on the card.
    ((4, 200, 70), torch.float32, "blocked_qr_r"),
    ((3, 23, 17), torch.float32, "linalg"),
    ((4, 32, 3), torch.float64, "linalg"),
]


@pytest.mark.parametrize("shape,dtype,route", STACKED_ROUTES, ids=lambda v: str(v).replace("torch.", ""))
def test_qr_r_stacked_routes(shape, dtype, route, monkeypatch, rng):
    # Inside the narrow gate (float32 or bf16, N ≤ 16, N ≤ D + N ≤ 2048) one
    # call of the R-only narrow kernel; elsewhere qr_r of the stacked matrix:
    # the panel QR (float32, 16 < N, a batch of 4 or more) or torch.linalg.
    # Either way the bits of qr_r on the stacked matrix.
    calls = []
    for name in ("narrow_qr_r", "batched_thin_qr", "blocked_qr_r"):
        orig = getattr(tk, name)
        monkeypatch.setattr(tk, name, lambda *a, _o=orig, _n=name: calls.append(_n) or _o(*a))
    B, d, N = shape
    JZ = torch.from_numpy(rng.standard_normal(shape)).to(dtype)
    dbot = torch.from_numpy(np.where(rng.random((B, N)) < 0.3, 1.0, np.sqrt(1e-3))).to(dtype)
    R = tqr.qr_r_stacked(JZ, dbot)
    assert calls == ([] if route == "linalg" else [route])
    assert R.shape == (B, N, N) and R.dtype == dtype
    calls.clear()
    np.testing.assert_array_equal(bits(R), bits(tqr.qr_r(torch.cat([JZ, torch.diag_embed(dbot)], dim=-2))))


@pytest.mark.parametrize("B,d,n,q,dtype", [(6, 32, 3, 1, torch.float32), (4, 4, 3, 2, torch.float32),
                                           (4, 30, 20, 3, torch.float32), (3, 32, 3, 1, torch.float64)])
def test_factor_qr_matches_the_stacked_composition(B, d, n, q, dtype, rng):
    # The polish's range-space factor: RJ from qr_r_stacked, bit for bit the
    # R of qr_r on the stacked [JZ; D] that the polish built before, and the
    # same Qw, Tw after it.
    JZ = torch.from_numpy(rng.standard_normal((B, d, n))).to(dtype)
    EZ = torch.from_numpy(rng.standard_normal((B, q, n))).to(dtype)
    fixed = torch.from_numpy(rng.random((B, n)) < 0.3)
    reg = 1e-6
    F = tpol._factor_qr(JZ, EZ, fixed, reg, 1e-14)
    sreg = torch.sqrt(torch.full((), reg, dtype=dtype))
    dbot = torch.where(fixed, torch.ones((), dtype=dtype), sreg)
    RJ = tqr.qr_r(torch.cat([JZ, torch.diag_embed(dbot)], dim=-2))
    Wt = torch.linalg.solve_triangular(RJ.mT, EZ.mT, upper=False)
    for got, want in zip(F, (RJ, *tqr.thin_qr(Wt))):
        np.testing.assert_array_equal(bits(got), bits(want))


def test_narrow_qr_plan_and_wrapper_contract():
    # The plan: the fewest lanes (a power of two up to 32) that leave each at
    # most 8 rows and 128 registers of its instance (double: 2 registers a
    # value; the rows a power of two), else the wide form (0); a function of
    # (D, N, dtype) alone.
    f32_, f64_ = torch.float32, torch.float64
    assert [tk.narrow_qr_plan(D, N, f32_) for D, N in ((35, 3), (3, 1), (7, 3), (192, 6), (1216, 6))] == [8, 1, 1, 32, 0]
    assert tk.narrow_qr_plan(256, 16, f32_) == 32 and tk.narrow_qr_plan(257, 16, f32_) == 0
    assert tk.narrow_qr_plan(35, 3, torch.bfloat16) == 8
    assert tk.narrow_qr_plan(128, 16, f64_) == 32 and tk.narrow_qr_plan(129, 16, f64_) == 0
    assert tk.narrow_qr_plan(256, 8, f64_) == 32 and tk.narrow_qr_plan(9, 16, f64_) == 4
    assert tk.narrow_qr_plan(32, 9, f64_) == 8 and tk.narrow_qr_plan(129, 9, f64_) == 0   # 4 rows a lane, not 7
    # Empty batches and N = 0; refused shapes on either device; nothing on the
    # CPU counts as a launch, and the launch path refuses a CPU tensor.
    tk.reset_launches()
    z = torch.zeros
    assert tk.narrow_qr_r(z((0, 35, 3))).shape == (0, 3, 3)
    assert tk.narrow_qr_r(z((0, 32, 3)), z((0, 3))).shape == (0, 3, 3)
    assert tk.narrow_qr_r(z((3, 5, 0))).shape == (3, 0, 0)
    for S, dbot in ((z((35, 3)), None), (z((2, 32, 3)), z((2, 2))), (z((2, 32, 3)), z((3, 3)))):
        with pytest.raises(ValueError):
            tk.narrow_qr_r(S, dbot)
    with pytest.raises(ValueError):
        tk.narrow_qr_r(z((2, 32, 3), device="meta"))
    with pytest.raises(ValueError):
        tk._narrow_qr_args("narrow_qr_r", z((2, 32, 3)), z((2, 3)))
    # bf16 in, bf16 out, on the CPU the float32 plain version rounded once.
    S = torch.from_numpy(np.random.default_rng(3).standard_normal((4, 35, 3)).astype(np.float32))
    Rb = tk.narrow_qr_r(S.to(BF))
    assert Rb.dtype == BF
    np.testing.assert_array_equal(bits(Rb), bits(tk.narrow_qr_r_plain(S.to(BF).float()).to(BF)))
    assert sum(tk.LAUNCHES.values()) == 0 and not tk.LAUNCHES_BY_DTYPE
