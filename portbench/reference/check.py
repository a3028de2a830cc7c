"""The comparison that decides `correct`: the answers the timed calls
returned, read again by the plain reference once the window has closed.

Four readings, each against a limit the configuration's file states:

* `pix_max` — the exact-projection criticality ‖P_Ω(x − Jᵀr) − x‖₂ that
  `projection.criticality` works out in float64 at every lane the port
  flagged certified, the largest over the run;
* `pix_claim_gap` — the largest gap between that reading and the `pix`
  the port reported for the lane;
* `kkt_ratio_max` — the first-principles KKT check (`kkt.kkt_check_point`)
  of a sample of certified lanes drawn from the seed, the lanes that went
  through the port's fallback refine first: its worst measure over its
  tolerance (≤ 1 passes);
* `dx_median` — the median, over a smaller sample drawn from the seed
  among all certified lanes alike, of ‖x − x_ref‖∞ / (1 + ‖x_ref‖∞), where
  x_ref is the frozen NumPy solver's answer from the same start.  (The
  fallback's lanes are not drawn first here: they stop at the certificate's
  threshold, so their distance to x_ref is of the order of the control's,
  and a median over a sample half made of them swings with their count.)

The reference reads the benchmark's own inputs (`lanes`, `shared`: the
data the traffic generator made) and the port's outputs, and nothing the
port derived.  `failed` counts the lanes the port left uncertified and the
certified lanes a reading rejects.
"""
from __future__ import annotations

import importlib

import numpy as np
import torch

from . import projection
from .kkt import kkt_check_point
from .numpy_solver import _SQEPS

# Lanes read together by the batched projection (memory, not accuracy).
LANE_BLOCK = 1 << 16


def family_model(family: str):
    """The reference model of a problem family: `reference/<family>.py`."""
    return importlib.import_module(f".{family}", __package__)


def _kkt_ratio(v: dict, feas_scale: float, bound_scale: float, tol: float = 1.5e-8) -> float:
    """The worst of the oracle's measures over the tolerance it applies to
    it (`kkt_check_point`'s defaults): ≤ 1 where the oracle says ok."""
    return max(v["stat"] / (tol * v["scale"]), v["sign_viol"] / (tol * v["scale"]),
               v["feas"] / (tol * feas_scale), v["bound_viol"] / (tol * bound_scale))


def _sample(rng: np.random.Generator, lanes: np.ndarray, size: int, first=()) -> np.ndarray:
    """Up to `size` of `lanes`: the ones in `first` (at most half), then a
    draw from the rest."""
    first = rng.permutation(np.asarray(first, dtype=lanes.dtype))[: size // 2]
    rest = np.setdiff1d(lanes, first)
    return np.concatenate([first, rng.choice(rest, size=min(size - first.size, rest.size), replace=False)])


def judge(model, calls: list, inputs, starts, check: dict, limits: dict, seed: int) -> dict:
    """Read the answers of `calls` again and compare them.

    calls: per timed call, (pool index k, X (B, n), certified (B,) bool,
    the port's pix (B,), outer iterations (B,)).  inputs(k) gives that
    batch's (lanes, shared) dicts of float64 tensors, starts(k) its X0.
    check: the sample sizes; limits: name -> limit.  Returns {"numbers":
    name -> (value, limit), "failed", "checked", "uncertified", "lanes",
    "proj_resid_max"}.
    """
    B = calls[0][1].shape[0]
    pix_ref, pix_port, cert, outer = [], [], [], []
    resid_max = 0.0
    # Every lane: the batched f64 criticality, a block of calls at a time.
    per_block = max(1, LANE_BLOCK // B)
    for c0 in range(0, len(calls), per_block):
        block = calls[c0: c0 + per_block]
        parts = [inputs(k) for k, *_ in block]
        lanes = {key: torch.cat([p[0][key] for p in parts]) for key in parts[0][0]}
        X = torch.cat([c[1] for c in block]).to(torch.float64)
        A, b, xl, xu = model.polyhedron(lanes, parts[0][1])
        p, resid = projection.criticality(X, model.gradient(X, lanes, parts[0][1]), A, b, xl, xu)
        pix_ref.append(p)
        pix_port.append(torch.cat([c[3] for c in block]).to(torch.float64))
        cert.append(torch.cat([c[2] for c in block]).to(torch.bool))
        outer.append(torch.cat([c[4] for c in block]))
        resid_max = max(resid_max, float(resid.max()))
    pix_ref, pix_port, on = torch.cat(pix_ref), torch.cat(pix_port), torch.cat(cert)
    outer = torch.cat(outer).cpu().numpy()
    certified = torch.nonzero(on).flatten().cpu().numpy()
    numbers = {
        "pix_max": (float(pix_ref[on].max()) if certified.size else 0.0, limits["pix_max"]),
        "pix_claim_gap": (float((pix_ref - pix_port).abs()[on].max()) if certified.size else 0.0,
                          limits["pix_claim_gap"]),
    }
    rejected = set(torch.nonzero(on & (pix_ref > limits["pix_max"])).flatten().tolist())

    # Samples drawn from the seed; the KKT sample takes the lanes the port
    # refined with its full fallback solve (the longest work) first.
    rng = np.random.default_rng([seed % (1 << 63), 7])
    fallback = certified[outer[certified] > 0]

    def lane(i: int):
        k, X = calls[i // B][:2]
        lanes, shared = inputs(k)
        np_lane = {key: v[i % B].cpu().numpy() for key, v in lanes.items()}
        np_shared = {key: v.cpu().numpy() for key, v in shared.items()}
        return np_lane, np_shared, X[i % B].to(torch.float64).cpu().numpy(), starts(k)[i % B].cpu().numpy()

    ratios, dxs = [], []
    if certified.size:
        for i in _sample(rng, certified, check["kkt_sample"], fallback):
            ln, sh, x, _ = lane(int(i))
            r, J, A, b, xl, xu = model.kkt_arrays(x, ln, sh)
            v = kkt_check_point(x, r, J, None, None, A, b, xl, xu)
            ratios.append(_kkt_ratio(v, 1.0 + float(np.linalg.norm(b)), 1.0 + float(np.max(np.abs(x)))))
            if not v["ok"]:
                rejected.add(int(i))
        for i in _sample(rng, certified, check["solve_sample"]):
            ln, sh, x, x0 = lane(int(i))
            x_ref = model.numpy_solve(ln, sh, x0, _SQEPS)
            dxs.append(float(np.max(np.abs(x - x_ref)) / (1.0 + np.max(np.abs(x_ref)))))
    numbers["kkt_ratio_max"] = (max(ratios, default=0.0), limits["kkt_ratio_max"])
    numbers["dx_median"] = (float(np.median(dxs)) if dxs else 0.0, limits["dx_median"])
    return {"numbers": numbers, "failed": int(on.numel() - certified.size) + len(rejected),
            "checked": int(certified.size), "uncertified": int(on.numel() - certified.size),
            "lanes": int(on.numel()), "proj_resid_max": resid_max}


def verdict(result: dict) -> bool:
    """Correct: some certified lane was read, and every number is within
    its limit."""
    return result["checked"] > 0 and all(v <= lim for v, lim in result["numbers"].values())


def report_lines(result: dict) -> list:
    """One line per number compared, with its limit, for standard error."""
    lines = [f"checked {result['checked']} certified of {result['lanes']} lanes, {result['uncertified']} uncertified, "
             f"reference projection residual max {result['proj_resid_max']!r}"]
    for name, (v, lim) in result["numbers"].items():
        lines.append(f"check {name} {v!r} limit {lim!r} {'ok' if v <= lim else 'FAILED'}")
    return lines


def as_json(result: dict) -> dict:
    return {name: {"value": v, "limit": lim} for name, (v, lim) in result["numbers"].items()}

