"""Every cell through the harness on the CPU at a few lanes (the test-only
`device` and `sizes` hooks), and the comparison against the control and
the faults: each must come out not correct."""
import json
import time

import pytest

from portbench import controls
from portbench.harness import ROOT, Spec, run_cell

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
# Cells kept as data for later (their configuration and mix files), which
# the harness must run as it runs BENCHMARK.json's.
LATER = [("expfit-n3-d32", "cold-b1024-fused"), ("expfit-n3-d32", "refit-b1024-fused")]
CELLS = [w["name"] for w in SPEC["workloads"]] + [f"{cfg}.{mix}" for cfg, mix in LATER]
SECONDS = 0.3


def spec() -> Spec:
    """BENCHMARK.json, with the cells kept for later."""
    s = Spec()
    s.data["workloads"] += [{"name": f"{cfg}.{mix}", "config": cfg, "traffic": mix, "chips": 1, "why": "test"}
                            for cfg, mix in LATER]
    return s


def test_every_configuration_and_mix_has_a_cell():
    cells = spec().data["workloads"]
    assert {w["traffic"] for w in cells} == {p.stem for p in (ROOT / "portbench" / "traffic").glob("*.json")}
    assert {w["config"] for w in cells} == {p.stem for p in (ROOT / "portbench" / "configs").glob("*.json")}


def small(cell: str) -> dict:
    """A CPU size for the cell: at most 8 lanes a call, two batches."""
    s = spec()
    mix = s.traffic(s.workload(cell)["traffic"])
    batch = min(mix["batch"], 8 if s.workload(cell)["config"].startswith("expfit") else 4)
    return {"batch": batch, "pool": 2, "route": {**mix["route"], "chunk": batch}}


def run(cell, trace=False, solve=None, seed=3_000_000_019):
    return run_cell(spec(), cell, seed, SECONDS, trace, time.perf_counter(), device="cpu", solve=solve,
                    sizes=small(cell))


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_and_is_correct(cell, trace):
    out = run(cell, bool(trace))
    assert list(out) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert set(out) - {"checks"} == {"correct", "attempted", "failed", "metrics", "device"}
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] >= small(cell)["batch"]
    wanted = {m["name"]: m["unit"] for m in spec().metrics(cell, "per_layer" if trace else "end_to_end")}
    # The CPU has no graphs and no NVML: those readers find nothing to read.
    cpu_silent = {"device_ops_per_call", "while_trips_per_call", "capture_s", "device_idle_pct", "panel_qr_roofline"}
    assert set(out["metrics"]) == set(wanted) - cpu_silent
    for name, m in out["metrics"].items():
        assert m["unit"] == wanted[name] and isinstance(m["value"], float)
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(out["device"])
    json.dumps(out)


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(cell):
    out = run(cell, solve=controls.f32_returns(_port()))
    assert out["correct"] is False
    assert out["checks"]["pix_max"]["value"] > out["checks"]["pix_max"]["limit"]


@pytest.mark.parametrize("fault", sorted(controls.FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_each_fault_is_not_correct(cell, fault):
    out = run(cell, solve=controls.FAULTS[fault](_port()))
    assert out["correct"] is False and out["failed"] > 0


def _port():
    from benlsip_tpu_torch.batch.refine import solve_mixed_precision

    return solve_mixed_precision


@pytest.mark.card
@pytest.mark.parametrize("seed", [3_000_000_101, 3_000_000_102, 3_000_000_103])
@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_card_control_at_the_cell_size(card, cell, seed):
    """On the card at the cell's own size, with a short window: the port is
    correct, its answers returned in float32 are not."""
    out = run_cell(Spec(), cell, seed, 2.0, False, time.perf_counter(), device=card)
    assert out["correct"] is True
    out = run_cell(Spec(), cell, seed, 2.0, False, time.perf_counter(), device=card,
                   solve=controls.f32_returns(_port()))
    assert out["correct"] is False
