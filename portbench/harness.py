"""One run of one cell: set-up, the measured window, the readers of the
cell's metrics, and the reference's comparison.

Everything that belongs to a configuration, a traffic mix or a metric is
a file of its own, found by the name `BENCHMARK.json` gives it:

* `configs/<config>.json` — the sizes, the solver options, the limits of
  the comparison and the family (`families/<family>.py`, the user's code,
  and `reference/<family>.py`, its plain reference);
* `traffic/<mix>.json` — the batch a call, the pool of batches, the start
  and the route options of `solve_mixed_precision`;
* `metrics/<metric>.py` — a reader with `read(run)` and, where it needs
  one, a `before_window(run)` hook; `read` returns None where it finds
  nothing to read, and the metric is left out.

The loop is closed: one caller sends the pool's batches back to back, each
call waiting for its certified answers (`torch.cuda.synchronize()`), until
`seconds` have passed; the call in flight finishes inside the window.
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import sys
import time
from pathlib import Path
from typing import Callable, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# Top-level module names that no run may hold once its window has closed:
# JAX and the JAX package.  Compared whole: the port's own name,
# benlsip_tpu_torch, begins with the JAX package's.
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "benlsip_tpu"})
# The NVML sampling interval of a traced run, seconds.
UTIL_INTERVAL = 0.05


def forbidden_modules(modules=None) -> list:
    """Forbidden top-level names among `modules` (default: sys.modules)."""
    names = sys.modules if modules is None else modules
    return sorted({name.split(".")[0] for name in names} & FORBIDDEN)


def load_file(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(f"portbench: no file {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Spec:
    """BENCHMARK.json and the files it names."""

    def __init__(self, path: Path = ROOT / "BENCHMARK.json"):
        self.data = json.loads(path.read_text())

    def workload(self, name: str) -> dict:
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"portbench: no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        return json.loads((HERE / "configs" / f"{name}.json").read_text())

    def traffic(self, name: str) -> dict:
        return json.loads((HERE / "traffic" / f"{name}.json").read_text())

    def metrics(self, cell: str, kind: str) -> list:
        """The `kind` ("end_to_end" or "per_layer") metrics that `cell` reports."""
        e2e = [m["name"] for m in self.data["end_to_end"] if cell in m.get("workloads", [cell])]
        if kind == "end_to_end":
            return [m for m in self.data["end_to_end"] if m["name"] in e2e]
        return [m for m in self.data["per_layer"]
                if (cell in m["workloads"] if "workloads" in m else m["moves"] in e2e)]


@dataclasses.dataclass
class Run:
    """What a run holds for its readers."""

    cell: dict
    cfg: dict
    mix: dict
    seed: int
    device: object
    setup_s: float = 0.0
    window_s: float = 0.0
    times: list = dataclasses.field(default_factory=list)      # seconds of each call
    calls: list = dataclasses.field(default_factory=list)      # (k, X, certified, pix, outer iterations)
    util: Optional[float] = None       # mean NVML utilization % over the window (traced runs)
    util_samples: int = 0
    state: dict = dataclasses.field(default_factory=dict)      # readers' own

    @property
    def n_calls(self) -> int:
        return len(self.calls)


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def measure(spec: Spec, workload: str, seed: int, seconds: float, trace: bool, t0: float, *,
            device=None, solve: Optional[Callable] = None, sizes: Optional[dict] = None, log=sys.stderr):
    """Set-up, the window and the cell's readers; returns (run, pool,
    result without the comparison).

    device None is the CUDA card (`cuda:0`).  `solve` (default the port's
    `solve_mixed_precision`) and `sizes` (traffic keys to override) are
    hooks for the tests and the calibration, which the command never
    passes."""
    import torch

    from benlsip_tpu_torch.batch.refine import solve_mixed_precision
    from benlsip_tpu_torch.kernels import batched_linalg as kern
    from benlsip_tpu_torch.solver.options import SolverOptions

    cell = spec.workload(workload)
    cfg, mix = spec.config(cell["config"]), spec.traffic(cell["traffic"])
    mix = {**mix, **(sizes or {})}
    device = torch.device("cuda:0" if device is None else device)
    family = importlib.import_module(f".families.{cfg['family']}", __package__)
    kind = "per_layer" if trace else "end_to_end"
    readers = {m["name"]: load_file(HERE / "metrics" / f"{m['name']}.py", f"portbench_metric_{m['name']}")
               for m in spec.metrics(workload, kind)}
    run = Run(cell, cfg, mix, seed, device)

    # Set-up: the kernel library (built at the first run in a checkout),
    # the pool from the seed, one call at the cell's shapes (the captures).
    if device.type == "cuda":
        kern.load_library()
    pool = family.Pool(cfg, mix, seed, device)
    options = SolverOptions(**cfg["options"])
    solve = solve or solve_mixed_precision

    def call(k: int):
        bp, theta, X0 = pool.batch(k)
        return solve(bp, theta, X0, options, **mix["route"])

    call(0)
    _sync(device)
    run.setup_s = time.perf_counter() - t0

    sampler = None
    if trace:
        for r in readers.values():
            if hasattr(r, "before_window"):
                r.before_window(run)
        if device.type == "cuda":
            from .nvml import Nvml, UtilizationSampler

            sampler = UtilizationSampler(Nvml(device.index or 0), UTIL_INTERVAL).start()
    start = time.perf_counter()
    k = 0
    while True:
        t_call = time.perf_counter()
        X, _, info = call(k % pool.size)
        _sync(device)
        t_end = time.perf_counter()
        run.times.append(t_end - t_call)
        run.calls.append((k % pool.size, X, info.converged, info.pix, info.outer_iters))
        k += 1
        if t_end - start >= seconds:
            break
    run.window_s = t_end - start
    dev_info = {"platform": "gpu" if device.type == "cuda" else device.type,
                "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
                "count": 1,
                "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0}
    if sampler is not None:
        samples = sampler.stop()
        run.util, run.util_samples = sampler.mean_between(samples, start, t_end)
        print(f"nvml: {run.util_samples} samples of utilization.gpu every {UTIL_INTERVAL} s over the "
              f"{run.window_s!r} s window, mean {run.util!r} %; power limit {sampler.nvml.power_limit_w()} W",
              file=log)
        sampler.nvml.close()
        if run.util is not None:
            dev_info["busy_s"] = run.util / 100.0 * run.window_s
        dev_info["window_s"] = run.window_s

    metrics = {}
    for m in spec.metrics(workload, kind):
        value = readers[m["name"]].read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": None, "attempted": run.n_calls * mix["batch"], "failed": None,
              "metrics": metrics, "device": dev_info}
    print(f"{workload} seed {seed}: {run.n_calls} calls of {mix['batch']} in {run.window_s!r} s, "
          f"set-up {run.setup_s!r} s", file=log)
    return run, pool, result


def compare(run: Run, pool) -> dict:
    """The reference's comparison of the window's answers (once the window
    has closed and the peak is read)."""
    from .reference import check

    return check.judge(check.family_model(run.cfg["family"]), run.calls, pool.inputs, pool.start,
                       run.cfg["check"], run.cfg["limits"], run.seed)


def run_cell(spec: Spec, workload: str, seed: int, seconds: float, trace: bool, t0: float, *,
             device=None, solve: Optional[Callable] = None, sizes: Optional[dict] = None, log=sys.stderr) -> dict:
    """One run: `measure`, then `compare`; returns the result line's
    object, with the numbers compared last, and writes them, each beside
    its limit, as the last lines of `log`."""
    from .reference import check

    run, pool, result = measure(spec, workload, seed, seconds, trace, t0, device=device, solve=solve,
                                sizes=sizes, log=log)
    verdict = compare(run, pool)
    result.update(correct=check.verdict(verdict), failed=verdict["failed"], checks=check.as_json(verdict))
    for line in check.report_lines(verdict):
        print(line, file=log)
    return result


def main(argv: list, t0: float) -> int:
    import argparse

    p = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json once and print its result line.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    spec = Spec()
    chips = spec.workload(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 3
    result = run_cell(spec, args.workload, args.seed, args.seconds, bool(args.trace), t0)
    found = forbidden_modules()
    if found:
        print(f"portbench: the run loaded {', '.join(found)}, which the port must not use", file=sys.stderr)
        return 4
    print(json.dumps(result))
    return 0
