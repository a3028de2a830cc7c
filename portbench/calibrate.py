"""The readings that the comparison's limits are set from: the program's
numbers and the control's on many seeds of one cell, in one process (the
set-up's imports and library load paid once).

    python3 portbench/calibrate.py --workload <cell> --seconds <s> --seeds <n> [<n> ...]

For each seed: the set-up with that seed's pool and one window, as a run
makes them; then the comparison of the answers as the port returned them,
and of the same answers as the control returns them (`controls.f32_round`).
Prints one JSON line a seed, then the largest program reading and the
smallest control reading of each number.  Needs the card; the benchmark's
runs never call it.
"""
import dataclasses
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench import controls  # noqa: E402
from portbench.harness import Spec, compare, measure  # noqa: E402


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    spec = Spec()
    lower, upper = {}, {}
    for seed in args.seeds:
        t0 = time.perf_counter()
        run, pool, result = measure(spec, args.workload, seed, args.seconds, False, t0)
        program = compare(run, pool)
        control_run = dataclasses.replace(run, calls=[(k, controls.f32_round(X), *rest) for k, X, *rest in run.calls])
        control = compare(control_run, pool)
        line = {"seed": seed, "calls": run.n_calls, "window_s": run.window_s, "setup_s": run.setup_s,
                "metrics": {k: v["value"] for k, v in result["metrics"].items()},
                "uncertified": program["uncertified"], "failed": program["failed"],
                "fallback_lanes": sum(int((c[4] > 0).sum()) for c in run.calls),
                "program": {k: v for k, (v, _) in program["numbers"].items()},
                "control": {k: v for k, (v, _) in control["numbers"].items()},
                "control_failed": control["failed"], "proj_resid_max": program["proj_resid_max"]}
        print(json.dumps(line), flush=True)
        for k, v in line["program"].items():
            lower[k] = max(lower.get(k, v), v)
        for k, v in line["control"].items():
            upper[k] = min(upper.get(k, v), v)
    print(json.dumps({"workload": args.workload, "seeds": len(args.seeds), "lower": lower, "upper": upper}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
