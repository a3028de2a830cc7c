"""BENCHMARK.json checked against the format the benchmark keeps: keys, names, units,
the files each entry names, and which cells report which metrics."""
import json
import re

import pytest

from portbench.harness import HERE, ROOT, Spec

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["portbench"] and SPEC["command"] == ["python3", "portbench/run.py"]
    assert isinstance(SPEC["run_seconds"], int) and 1 <= SPEC["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_lines():
    for section, keys in (("configs", {"name", "source", "file", "reduced", "why"}),
                          ("workloads", {"name", "config", "traffic", "chips", "why"})):
        for entry in SPEC[section]:
            assert set(entry) == keys, entry
            assert NAME.fullmatch(entry["name"]) and _line(entry["why"])
    for entry in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert NAME.fullmatch(entry["name"]) and UNIT.fullmatch(entry["unit"]), entry
        assert entry["better"] in ("lower", "higher")
    names = [e["name"] for s in ("configs", "workloads", "end_to_end", "per_layer") for e in SPEC[s]]
    assert len(names) == len(set(names))


def test_configs_and_cells():
    used = {w["config"] for w in SPEC["workloads"]}
    files = [c["file"] for c in SPEC["configs"]]
    assert len(files) == len(set(files))
    for c in SPEC["configs"]:
        assert c["name"] in used and c["file"] == f"portbench/configs/{c['name']}.json" and _line(c["source"])
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"] == []
        assert (HERE / "families" / f"{cfg['family']}.py").is_file()
        assert (HERE / "reference" / f"{cfg['family']}.py").is_file()
        assert set(cfg["limits"]) == {"pix_max", "pix_claim_gap", "kkt_ratio_max", "dx_median"}
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))
    for w in SPEC["workloads"]:
        assert w["chips"] == 1 and NAME.fullmatch(w["traffic"]) and NAME.fullmatch(w["config"])
        assert (HERE / "traffic" / f"{w['traffic']}.json").is_file()


def test_end_to_end_metrics():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert set(e2e) == {"certified_per_s", "call_p95_ms", "setup_s"}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_each_cell_reports_what_its_metrics_move(cell):
    spec = Spec()
    e2e = {m["name"] for m in spec.metrics(cell, "end_to_end")}
    per_layer = spec.metrics(cell, "per_layer")
    assert "setup_s" in e2e and len(e2e) >= 2 and per_layer
    for m in per_layer:
        assert m["moves"] in e2e
    for m in spec.metrics(cell, "end_to_end") + per_layer:
        assert (HERE / "metrics" / f"{m['name']}.py").is_file()


def test_per_layer_metrics():
    for m in SPEC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert _line(m["layer"]) and m["moves"] in {e["name"] for e in SPEC["end_to_end"]}
        for w in m.get("workloads", []):
            assert w in {c["name"] for c in SPEC["workloads"]}
    rooflines = [m for m in SPEC["per_layer"] if m["name"].endswith("_roofline")]
    assert rooflines and all(m["unit"] == "%" for m in rooflines)
