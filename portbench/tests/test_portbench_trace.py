"""The readers of the port's span recorder (`portbench/spans.py`): on the
card, a short traced run of the cell, whose device spans resolve onto the
host's clock and whose split closes on the window; on the CPU, a port
without the recorder gives them nothing to read."""
import time

import pytest

from portbench import spans
from portbench.harness import HERE, Run, Spec, load_file, measure

CELL = "densequad-b64-fused"
READERS = ("bulk_graph_ms_per_call", "cert_graph_ms_per_call", "host_gap_ms_per_call", "warmup_s")


def test_without_the_recorder_the_readers_read_nothing(monkeypatch):
    monkeypatch.setattr(spans, "_trace", None)
    run = Run(cell={}, cfg={}, mix={}, seed=1, device=None)
    for name in READERS:
        reader = load_file(HERE / "metrics" / f"{name}.py", f"portbench_test_metric_{name}")
        reader.before_window(run)
        assert reader.read(run) is None


@pytest.mark.card
def test_card_device_spans_resolve_and_the_split_closes_on_the_window(card):
    from benlsip_tpu_torch import _trace

    run, _, result = measure(Spec(), CELL, 2_147_483_907, 3.0, True, time.perf_counter(), device=card)
    got = _trace.spans()
    stages = [s for s in got if s.name in ("load", "bulk", "cert")]
    half = _trace.clock().half
    assert stages and len([s for s in got if s.name == "call"]) == run.n_calls
    for s in stages:
        d0, d1 = s.device
        # The device starts a stage no sooner than the host asks for it.
        assert s._events is None and d0 <= d1 and d0 >= s.t0 - half - 1_000
    split = run.state["spans"]
    window_ms = 1e3 * run.window_s
    assert split["calls"] == run.n_calls
    assert abs(split["busy_ms"] + split["idle_ms"] - window_ms) <= 0.01 * window_ms
    assert set(READERS) <= set(result["metrics"])
    assert result["metrics"]["host_syncs_per_call"]["value"] == 1.0
    assert result["metrics"]["warmup_s"]["value"] > 0
    assert 0 < result["metrics"]["bulk_graph_ms_per_call"]["value"] and 0 < result["metrics"]["cert_graph_ms_per_call"]["value"]
