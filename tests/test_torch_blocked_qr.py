"""The panel QR's plan and stacked form on the CPU.

`kernels/batched_linalg.blocked_qr_plan(D, N, dtype)` is the layout of the
panel QR kernel (`csrc/blocked_qr.cu`): the blocks of the cluster that
factors one instance, the panel width, a block's padded rows and the panel's
leading dimension.  It must depend on the instance's shape and dtype alone
(an instance's bits may not depend on its batch), fit in the 227 KB of shared
memory a block may use, and refuse what the kernel cannot take.
`blocked_qr_r(S, dbot)` is R of the stacked [S; diag(dbot)] without the
stacked matrix; its plain version (what a CPU tensor runs) must give the bits
of the plain version on the stacked matrix, zero and NaN lanes included, so
that `ops/qr.qr_r_stacked` gives every pipeline the bits it had when the
polish stacked the matrix itself.  The stacked form's plain version is also
held against the JAX package's `ops/qr.qr_r` (XLA's Householder) on the
stacked matrix at the kernel tests' tolerance.  The kernel compiles and runs
only on the GPU; chip_smoke.py holds it to these plain versions there.
"""
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benlsip_tpu.ops import qr as jqr
from benlsip_tpu_torch.kernels import batched_linalg as tk
from benlsip_tpu_torch.ops import qr as tqr

torch.set_num_threads(2)
EPS32 = float(np.finfo(np.float32).eps)


@pytest.fixture
def rng(request):
    return np.random.default_rng(zlib.crc32(request.node.nodeid.encode()))


def bits(t):
    return t.contiguous().view(torch.int32 if t.dtype == torch.float32 else torch.int64).numpy()


PLAN_SHAPES = [(17, 17), (40, 17), (300, 36), (534, 150), (640, 64), (641, 64), (1216, 192), (1540, 70),
               (2048, 256), (2560, 40), (5120, 100)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=str)
@pytest.mark.parametrize("D,N", PLAN_SHAPES)
def test_blocked_qr_plan_depends_on_shape_only_and_fits(D, N, dtype):
    plan = tk.blocked_qr_plan(D, N, dtype)
    assert plan is not None
    C, bw, rows, ld = plan
    # The fewest blocks whose slices hold at most QR_BLOCK_ROWS rows each.
    assert C in tk.QR_CLUSTER_SIZES and C * rows >= D and -(-D // C) <= tk.QR_BLOCK_ROWS
    assert C == 1 or -(-D // (C // 2)) > tk.QR_BLOCK_ROWS
    assert rows % tk.QR_ROW_TILE == 0 and rows - -(-D // C) < tk.QR_ROW_TILE and rows <= tk.QR_BLOCK_ROWS
    assert ld >= rows and ld % 32 == 4
    assert bw == tk.QR_PANEL_WIDTH[dtype] == (64 if dtype == torch.float32 else 32)
    assert tk.blocked_qr_smem(ld, dtype) <= tk.MAX_DYNAMIC_SMEM
    # Nothing but (D, N, dtype) moves it: the same plan however it is asked.
    assert tk.blocked_qr_plan(D, N, dtype) == plan


@pytest.mark.parametrize("D,N,dtype", [(5121, 20, torch.float32), (10 ** 6, 20, torch.float64),
                                       (300, 20, torch.bfloat16), (300, 20, torch.float16), (0, 20, torch.float32),
                                       (300, 0, torch.float32)], ids=str)
def test_blocked_qr_plan_refuses_what_the_kernel_cannot_take(D, N, dtype):
    assert tk.blocked_qr_plan(D, N, dtype) is None


def test_blocked_qr_plan_config3_polish():
    # The polish's [JZ; D] at (64, 1024 + 192, 192): two blocks of 608 rows.
    assert tk.blocked_qr_plan(1216, 192, torch.float32) == (2, 64, 608, 612)
    assert tk.blocked_qr_smem(612, torch.float32) == (64 * 612 + 3 * 64 * 68 + 17 * 64) * 4 <= 232448


def polish_dbot(rng, B, N):
    fixed = rng.random((B, N)) < 1 / 3
    return np.where(fixed, 1.0, np.sqrt(1e-3))


@pytest.mark.parametrize("B,d,N", [(4, 23, 17), (3, 60, 40), (4, 100, 70), (3, 150, 136)])
def test_blocked_qr_r_plain_stacked_is_the_stacked_bits(B, d, N, rng):
    JZ = torch.from_numpy(rng.standard_normal((B, d, N)).astype(np.float32))
    dbot = torch.from_numpy(polish_dbot(rng, B, N).astype(np.float32))
    # A zero column in lane 1 (in JZ, with dbot 0 there: the stacked column is
    # zero), a NaN in lane 2; lane 0 and the last are healthy.
    JZ[1, :, N // 2] = 0.0
    dbot[1, N // 2] = 0.0
    JZ[2, d // 3, 1] = float("nan")
    S = torch.cat([JZ, torch.diag_embed(dbot)], dim=-2)
    R = tk.blocked_qr_r_plain(JZ, dbot)
    np.testing.assert_array_equal(bits(R), bits(tk.blocked_qr_r_plain(S)))
    # The wrapper on a CPU tensor, and qr_r on the stacked matrix, give the same bits.
    np.testing.assert_array_equal(bits(tk.blocked_qr_r(JZ, dbot)), bits(R))
    np.testing.assert_array_equal(bits(tk.blocked_qr_r(S)), bits(R))
    floor = np.sqrt(np.finfo(np.float32).tiny)
    np.testing.assert_allclose(float(R[1, N // 2, N // 2]), floor, rtol=1e-6)
    assert torch.isfinite(R[[0, 1, B - 1] if B > 3 else [0, 1]]).all() and torch.isnan(R[2]).any()


@pytest.mark.parametrize("B,d,N", [(4, 23, 17), (4, 100, 70), (4, 150, 136)])
def test_blocked_qr_r_plain_stacked_matches_jax(B, d, N, rng):
    # R of the stacked matrix against the JAX package's qr_r on the same
    # matrix (sign-normalised): RᵀR = SᵀS to 2·N·eps and R within
    # 4·eps·(√D + κ)·max|R|, the kernel tests' tolerance.
    JZ = rng.standard_normal((B, d, N)).astype(np.float32)
    dbot = polish_dbot(rng, B, N).astype(np.float32)
    S = np.concatenate([JZ, dbot[:, :, None] * np.eye(N, dtype=np.float32)], axis=1)
    R = tk.blocked_qr_r(torch.from_numpy(JZ), torch.from_numpy(dbot)).numpy().astype(np.float64)
    Rj = np.asarray(jax.vmap(jqr.qr_r)(jnp.asarray(S))).astype(np.float64)
    Rj *= np.where(np.diagonal(Rj, axis1=1, axis2=2) < 0, -1.0, 1.0)[:, :, None]
    G = np.einsum("bdi,bdj->bij", S.astype(np.float64), S.astype(np.float64))
    gram = np.linalg.norm(np.einsum("bki,bkj->bij", R, R) - G, axis=(1, 2)) / np.linalg.norm(G, axis=(1, 2))
    assert gram.max() <= 2 * N * EPS32
    kappa = np.linalg.cond(Rj).max()
    assert np.abs(R - Rj).max() <= 4 * EPS32 * (np.sqrt(d + N) + kappa) * np.abs(Rj).max()


def test_qr_r_stacked_sends_the_panel_gate_to_one_stacked_call(monkeypatch, rng):
    # Inside qr_r's panel gate the polish's factor is one call of the panel
    # kernel's wrapper with dbot, never torch.cat + diag_embed: on the card's
    # route (the wrapper made to take the CPU tensor as a CUDA one) the launch
    # gets dbot itself.
    calls = []
    orig = tk.blocked_qr_r
    monkeypatch.setattr(tk, "blocked_qr_r", lambda *a: calls.append(len(a)) or orig(*a))
    cat = torch.cat
    cats = []
    monkeypatch.setattr(torch, "cat", lambda *a, **k: cats.append(1) or cat(*a, **k))
    JZ = torch.from_numpy(rng.standard_normal((4, 40, 20)).astype(np.float32))
    dbot = torch.from_numpy(polish_dbot(rng, 4, 20).astype(np.float32))
    monkeypatch.setattr(tk, "_on_cpu", lambda t: False)      # the card's route: no plain stacking
    monkeypatch.setattr(tk, "_require_cuda", lambda *a, **k: None)
    launched = []
    monkeypatch.setattr(tk, "_launch", lambda *a, **k: launched.append(a[4:]))
    tqr.qr_r_stacked(JZ, dbot)
    assert calls == [2] and cats == []
    # The launch gets dbot's pointer and JZ's own rows: D = 40, N = 20, the
    # plan of the 60 stacked rows.
    assert len(launched) == 1 and launched[0][0] == dbot.data_ptr()
    assert launched[0][3:] == (4, 40, 20, *(tk.blocked_qr_plan(60, 20, torch.float32)[i] for i in (0, 2, 3)))
