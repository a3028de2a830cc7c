"""The control and the faults that the comparison must fail, as wrappers
of the timed entry (`solve(bp, theta, X0, options, **route)`).  The tests
and `calibrate.py` use them; the benchmark's own runs never do.

* `f32_returns` — the control: the answers returned in float32, the
  nearest precision below the float64 the configuration states (the
  port's own answer, rounded: the best float32 answer there is);
* `state_unchanged` — the start handed back as the answer;
* `half_batch` — the second half of the batch left at its start;
* `altered_answer` — one lane's answer moved by 1e-6 where it is produced.

Each keeps the port's certified flags and pix, so each claims what the
port claims.
"""
from __future__ import annotations


def f32_round(X):
    return X.float().double()


def f32_returns(solve):
    def wrapped(bp, theta, X0, options, **route):
        X, Y, info = solve(bp, theta, X0, options, **route)
        return f32_round(X), f32_round(Y), info
    return wrapped


def state_unchanged(solve):
    def wrapped(bp, theta, X0, options, **route):
        X, Y, info = solve(bp, theta, X0, options, **route)
        return X0.to(X.dtype).clone(), Y, info
    return wrapped


def half_batch(solve):
    def wrapped(bp, theta, X0, options, **route):
        X, Y, info = solve(bp, theta, X0, options, **route)
        X = X.clone()
        half = X.shape[0] // 2
        X[half:] = X0[half:].to(X.dtype)
        return X, Y, info
    return wrapped


def altered_answer(solve):
    def wrapped(bp, theta, X0, options, **route):
        X, Y, info = solve(bp, theta, X0, options, **route)
        X = X.clone()
        X[0, 0] += 1e-6
        return X, Y, info
    return wrapped


FAULTS = {"state_unchanged": state_unchanged, "half_batch": half_batch, "altered_answer": altered_answer}
