"""Classic constrained-NLS test problems with known optima (PyTorch port
of `benlsip_tpu/problems/classic.py`).

The subset of Hock–Schittkowski (HS) and Moré–Garbow–Hillstrom (MGH)
problems that map *exactly* onto the solver's problem class

    min ½‖r(x)‖²  s.t.  c(x) = 0,  A x = b,  xl ≤ x ≤ xu

— NLS-expressible objectives, equality constraints only.  Quartic/sextic
objective terms are expressed as squared/cubed residuals so the Gauss-
Newton model stays exact where the classical statement is a plain sum of
squares.

Each entry is a `ClassicProblem` record; `REGISTRY` maps name → record so
tests and benchmarks can sweep the battery.  `x_star`/`f_star` are the
published optima (f = ½‖r‖², i.e. HALF the HS book's Σ-of-squares value,
matching the solver's objective convention); `None` where the optimum is
known only through the KKT conditions (tests then verify via an
independent host-side KKT oracle).

Unconstrained/bound-only entries (the MGH battery) double as regression
coverage for empty constraint blocks, which the reference crashes on.

The residuals and constraints are per-instance functions of x (n,) written
with torch ops; the constraint data are plain lists, cast by
`Problem.build` to the solve's dtype and device, so `make_problem` takes
no dtype.  `x0(dtype, device)` creates the start on `device` (None: the
CUDA card).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional, Sequence

import torch

from .._device import as_tensor
from ..solver.api import Problem

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class ClassicProblem:
    """One battery entry. x0 takes (dtype, device); x_star/f_star are plain
    tuples/floats (None when not known in closed form)."""

    name: str
    make_problem: Callable[[], Problem]
    x0: Callable[..., Tensor]
    x_star: Optional[Sequence[float]] = None
    f_star: Optional[float] = None
    # Loose per-problem tolerance on ‖x - x*‖∞ (f64 solves); problems with
    # singular Jacobians at the solution converge slower in x than in f.
    x_tol: float = 1e-5
    unconstrained: bool = False
    # SolverOptions overrides (e.g. wider stall windows for badly scaled
    # problems whose legitimate convergence is slower than the sweep-tuned
    # stall defaults).
    options: Optional[Dict[str, object]] = None


def _p(residuals, nlconstraints=None, A=None, b=None, xl=None, xu=None):
    def make():
        return Problem(residuals=residuals, nlconstraints=nlconstraints, A=A, b=b, xl=xl, xu=xu)

    return make


def _x0(vals):
    return lambda dtype=torch.float64, device=None: as_tensor(vals, dtype, device)


# --------------------------------------------------------------------------
# Hock–Schittkowski: equality-constrained, NLS-expressible objectives.
# --------------------------------------------------------------------------

HS6 = ClassicProblem(
    name="hs6",
    make_problem=_p(
        residuals=lambda x: torch.stack([1.0 - x[0]]),
        nlconstraints=lambda x: torch.stack([10.0 * (x[1] - x[0] ** 2)]),
    ),
    x0=_x0([-1.2, 1.0]),
    x_star=(1.0, 1.0),
    f_star=0.0,
)

HS26 = ClassicProblem(
    # (x1-x2)² + (x2-x3)⁴ as r = (x1-x2, (x2-x3)²).
    name="hs26",
    make_problem=_p(
        residuals=lambda x: torch.stack([x[0] - x[1], (x[1] - x[2]) ** 2]),
        nlconstraints=lambda x: torch.stack(
            [(1.0 + x[1] ** 2) * x[0] + x[2] ** 4 - 3.0]
        ),
    ),
    x0=_x0([-2.6, 2.0, 2.0]),
    x_star=(1.0, 1.0, 1.0),
    f_star=0.0,
    # GN Jacobian of (x2-x3)² is singular at x*: x converges ~√tol.
    x_tol=3e-3,
)

HS27 = ClassicProblem(
    # 0.01(x1-1)² + (x2-x1²)²; c: x1 + x3² + 1 = 0.
    name="hs27",
    make_problem=_p(
        residuals=lambda x: torch.stack([0.1 * (x[0] - 1.0), x[1] - x[0] ** 2]),
        nlconstraints=lambda x: torch.stack([x[0] + x[2] ** 2 + 1.0]),
    ),
    x0=_x0([2.0, 2.0, 2.0]),
    x_star=(-1.0, 1.0, 0.0),
    f_star=0.02,
    # The constraint Jacobian row (1, 0, 2x3) degenerates in x3 at x3*=0:
    # x3 is determined only to ~∜eps.
    x_tol=2e-3,
)

HS28 = ClassicProblem(
    name="hs28",
    make_problem=_p(
        residuals=lambda x: torch.stack([x[0] + x[1], x[1] + x[2]]),
        A=[[1.0, 2.0, 3.0]],
        b=[1.0],
    ),
    x0=_x0([-4.0, 1.0, 1.0]),
    x_star=(0.5, -0.5, 0.5),
    f_star=0.0,
)

HS42 = ClassicProblem(
    # Σ(xi - i)²; x1 = 2 (linear), x3² + x4² = 2 (nonlinear).
    name="hs42",
    make_problem=_p(
        residuals=lambda x: x - torch.arange(1.0, 5.0, dtype=x.dtype, device=x.device),
        nlconstraints=lambda x: torch.stack([x[2] ** 2 + x[3] ** 2 - 2.0]),
        A=[[1.0, 0.0, 0.0, 0.0]],
        b=[2.0],
    ),
    x0=_x0([1.0, 1.0, 1.0, 1.0]),
    x_star=(2.0, 2.0, 0.6 * 2.0 ** 0.5, 0.8 * 2.0 ** 0.5),
    f_star=(28.0 - 10.0 * 2.0 ** 0.5) / 2.0,
)

HS46 = ClassicProblem(
    # (x1-x2)² + (x3-1)² + (x4-1)⁴ + (x5-1)⁶ via squared/cubed residuals.
    name="hs46",
    make_problem=_p(
        residuals=lambda x: torch.stack(
            [x[0] - x[1], x[2] - 1.0, (x[3] - 1.0) ** 2, (x[4] - 1.0) ** 3]
        ),
        nlconstraints=lambda x: torch.stack(
            [
                x[0] ** 2 * x[3] + torch.sin(x[3] - x[4]) - 1.0,
                x[1] + x[2] ** 4 * x[3] ** 2 - 2.0,
            ]
        ),
    ),
    x0=_x0([0.5 * 2.0 ** 0.5, 1.75, 0.5, 2.0, 2.0]),
    x_star=(1.0, 1.0, 1.0, 1.0, 1.0),
    f_star=0.0,
    # Quartic/sextic terms: x4, x5 identified only to ~f_tol^(1/4), ^(1/6).
    x_tol=6e-2,
)

HS49 = ClassicProblem(
    # Same objective as HS46, linear equalities.
    name="hs49",
    make_problem=_p(
        residuals=lambda x: torch.stack(
            [x[0] - x[1], x[2] - 1.0, (x[3] - 1.0) ** 2, (x[4] - 1.0) ** 3]
        ),
        A=[[1.0, 1.0, 1.0, 4.0, 0.0], [0.0, 0.0, 1.0, 0.0, 5.0]],
        b=[7.0, 6.0],
    ),
    x0=_x0([10.0, 7.0, 2.0, -3.0, 0.8]),
    x_star=(1.0, 1.0, 1.0, 1.0, 1.0),
    f_star=0.0,
    x_tol=6e-2,
)

HS50 = ClassicProblem(
    # (x1-x2)² + (x2-x3)² + (x3-x4)⁴ + (x4-x5)².
    name="hs50",
    make_problem=_p(
        residuals=lambda x: torch.stack(
            [x[0] - x[1], x[1] - x[2], (x[2] - x[3]) ** 2, x[3] - x[4]]
        ),
        A=[
            [1.0, 2.0, 3.0, 0.0, 0.0],
            [0.0, 1.0, 2.0, 3.0, 0.0],
            [0.0, 0.0, 1.0, 2.0, 3.0],
        ],
        b=[6.0, 6.0, 6.0],
    ),
    x0=_x0([35.0, -31.0, 11.0, 5.0, -5.0]),
    x_star=(1.0, 1.0, 1.0, 1.0, 1.0),
    f_star=0.0,
    x_tol=3e-3,
)

HS51 = ClassicProblem(
    name="hs51",
    make_problem=_p(
        residuals=lambda x: torch.stack(
            [x[0] - x[1], x[1] + x[2] - 2.0, x[3] - 1.0, x[4] - 1.0]
        ),
        A=[[1.0, 3.0, 0.0, 0.0, 0.0], [0.0, 0.0, 1.0, 1.0, -2.0], [0.0, 1.0, 0.0, 0.0, -1.0]],
        b=[4.0, 0.0, 0.0],
    ),
    x0=_x0([2.5, 0.5, 2.0, -1.0, 0.5]),
    x_star=(1.0, 1.0, 1.0, 1.0, 1.0),
    f_star=0.0,
)

HS52 = ClassicProblem(
    # (4x1-x2)² + (x2+x3-2)² + (x4-1)² + (x5-1)²; homogeneous equalities.
    # Optimum not at a round point: tests certify it against a host KKT
    # oracle (linear LS + linear equalities → exact saddle-point solve).
    name="hs52",
    make_problem=_p(
        residuals=lambda x: torch.stack(
            [4.0 * x[0] - x[1], x[1] + x[2] - 2.0, x[3] - 1.0, x[4] - 1.0]
        ),
        A=[[1.0, 3.0, 0.0, 0.0, 0.0], [0.0, 0.0, 1.0, 1.0, -2.0], [0.0, 1.0, 0.0, 0.0, -1.0]],
        b=[0.0, 0.0, 0.0],
    ),
    x0=_x0([2.0, 2.0, 2.0, 2.0, 2.0]),
)

HS53 = ClassicProblem(
    # HS52's structure with b=(0,0,0) kept and the box |x| ≤ 10 added; the
    # box is inactive at the optimum, exercising bound bookkeeping on a
    # constrained interior solution.
    name="hs53",
    make_problem=_p(
        residuals=lambda x: torch.stack(
            [x[0] - x[1], x[1] + x[2] - 2.0, x[3] - 1.0, x[4] - 1.0]
        ),
        A=[[1.0, 3.0, 0.0, 0.0, 0.0], [0.0, 0.0, 1.0, 1.0, -2.0], [0.0, 1.0, 0.0, 0.0, -1.0]],
        b=[0.0, 0.0, 0.0],
        xl=[-10.0] * 5,
        xu=[10.0] * 5,
    ),
    x0=_x0([2.0, 2.0, 2.0, 2.0, 2.0]),
)

HS79 = ClassicProblem(
    # Σ of 5 squared terms incl. (x2-x3)⁴ as a squared residual; three
    # nonlinear equalities.  Published optimum ≈ 0.0787768 (Σ-of-squares).
    name="hs79",
    make_problem=_p(
        residuals=lambda x: torch.stack(
            [
                x[0] - 1.0,
                x[0] - x[1],
                x[1] - x[2],
                (x[2] - x[3]) ** 2,
                (x[3] - x[4]) ** 2,
            ]
        ),
        nlconstraints=lambda x: torch.stack(
            [
                x[0] + x[1] ** 2 + x[2] ** 3 - 2.0 - 3.0 * 2.0 ** 0.5,
                x[1] - x[2] ** 2 + x[3] + 2.0 - 2.0 * 2.0 ** 0.5,
                x[0] * x[4] - 2.0,
            ]
        ),
    ),
    x0=_x0([2.0, 2.0, 2.0, 2.0, 2.0]),
    f_star=0.0787768209 / 2.0,
)


# --------------------------------------------------------------------------
# Moré–Garbow–Hillstrom: unconstrained NLS (empty-constraint coverage).
# --------------------------------------------------------------------------

def _powell_badly_scaled(x):
    return torch.stack(
        [1e4 * x[0] * x[1] - 1.0, torch.exp(-x[0]) + torch.exp(-x[1]) - 1.0001]
    )


MGH03_POWELL_BS = ClassicProblem(
    name="mgh03_powell_badly_scaled",
    make_problem=_p(residuals=_powell_badly_scaled),
    x0=_x0([0.0, 1.0]),
    f_star=0.0,
    x_star=None,  # ≈ (1.098e-5, 9.106): asserted via f only (badly scaled)
    unconstrained=True,
    # κ(J) ~ 1e9 at the start: pi contracts slowly but genuinely; the
    # sweep-tuned stall windows (12/6) would misdiagnose it as stuck.
    options={"max_inner_iter": 2000, "stall_window": 100, "outer_stall_window": 50},
)


def _beale(x):
    y = torch.tensor([1.5, 2.25, 2.625], dtype=x.dtype, device=x.device)
    powers = torch.arange(1.0, 4.0, dtype=x.dtype, device=x.device)
    return y - x[0] * (1.0 - x[1] ** powers)


MGH05_BEALE = ClassicProblem(
    name="mgh05_beale",
    make_problem=_p(residuals=_beale),
    x0=_x0([1.0, 1.0]),
    x_star=(3.0, 0.5),
    f_star=0.0,
    unconstrained=True,
)


def _helical_valley(x):
    # MINPACK's two-branch angle: θ = atan(x2/x1)/2π (+ 0.5 if x1 < 0),
    # branchless via atan2 with a +1 correction in the third quadrant.
    theta = torch.atan2(x[1], x[0]) / (2.0 * math.pi)
    theta = torch.where((x[0] < 0.0) & (x[1] < 0.0), theta + 1.0, theta)
    return torch.stack(
        [
            10.0 * (x[2] - 10.0 * theta),
            10.0 * (torch.sqrt(x[0] ** 2 + x[1] ** 2) - 1.0),
            x[2],
        ]
    )


MGH07_HELICAL = ClassicProblem(
    name="mgh07_helical_valley",
    make_problem=_p(residuals=_helical_valley),
    x0=_x0([-1.0, 0.0, 0.0]),
    x_star=(1.0, 0.0, 0.0),
    f_star=0.0,
    unconstrained=True,
)


def _wood(x):
    s10 = 10.0 ** 0.5
    return torch.stack(
        [
            10.0 * (x[1] - x[0] ** 2),
            1.0 - x[0],
            90.0 ** 0.5 * (x[3] - x[2] ** 2),
            1.0 - x[2],
            s10 * (x[1] + x[3] - 2.0),
            (x[1] - x[3]) / s10,
        ]
    )


MGH14_WOOD = ClassicProblem(
    name="mgh14_wood",
    make_problem=_p(residuals=_wood),
    x0=_x0([-3.0, -1.0, -3.0, -1.0]),
    x_star=(1.0, 1.0, 1.0, 1.0),
    f_star=0.0,
    unconstrained=True,
)


def _brown_almost_linear(n):
    def residuals(x):
        s = torch.sum(x)
        head = x + s - (n + 1.0)
        tail = torch.prod(x) - 1.0
        return torch.cat([head, tail[None]])

    return residuals


MGH27_BROWN_AL = ClassicProblem(
    name="mgh27_brown_almost_linear",
    make_problem=_p(residuals=_brown_almost_linear(5)),
    x0=_x0([0.5] * 5),
    x_star=(1.0,) * 5,
    f_star=0.0,
    unconstrained=True,
)


def _box3d(x):
    t = torch.arange(1.0, 11.0, dtype=x.dtype, device=x.device) * 0.1
    model = torch.exp(-t * x[0]) - torch.exp(-t * x[1])
    target = x[2] * (torch.exp(-t) - torch.exp(-10.0 * t))
    return model - target


MGH12_BOX3D = ClassicProblem(
    name="mgh12_box3d",
    make_problem=_p(residuals=_box3d),
    x0=_x0([0.0, 10.0, 20.0]),
    # f = 0 also along the continuum {x1 = x2, x3 = 0} besides (1, 10, 1):
    # only the objective is pinned.
    f_star=0.0,
    unconstrained=True,
)


REGISTRY = {
    p.name: p
    for p in [
        HS6, HS26, HS27, HS28, HS42, HS46, HS49, HS50, HS51, HS52, HS53, HS79,
        MGH03_POWELL_BS, MGH05_BEALE, MGH07_HELICAL, MGH14_WOOD,
        MGH27_BROWN_AL, MGH12_BOX3D,
    ]
}
