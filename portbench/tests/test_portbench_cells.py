"""Each cell of BENCHMARK.json, cut to a tiny size, runs on the CPU through the
harness as ``run.py`` drives it and prints a well-formed last line."""

import json
import math

import pytest

import tiny


def _bench():
    with open(tiny.ROOT / "BENCHMARK.json") as f:
        return json.load(f)


@pytest.mark.parametrize("name", tiny.cells())
def test_a_tiny_run_prints_a_wellformed_line(name):
    result, last, err = tiny.run(tiny.cell(name))
    assert last.startswith("{") and list(result) == ["correct", "attempted", "failed", "metrics",
                                                     "device", "checks"]
    assert isinstance(result["correct"], bool)
    assert result["attempted"] > 0 and result["failed"] == 0
    want = {m["name"]: m["unit"] for m in _bench()["end_to_end"]
            if name in m.get("workloads", [name])}
    assert {k: v["unit"] for k, v in result["metrics"].items()} == want
    assert all(math.isfinite(v["value"]) and v["value"] > 0 for v in result["metrics"].values())
    assert set(result["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert result["checks"] and all(set(c) == {"value", "limit"} and c["limit"] is not None
                                    for c in result["checks"].values())
    tail = err.strip().splitlines()[-len(result["checks"]):]
    assert [line.split(":")[0] for line in tail] == [f"check {k}" for k in result["checks"]]


@pytest.mark.parametrize("name", tiny.cells())
def test_every_metric_of_a_cell_has_a_reader(name):
    cell = tiny.cell(name)
    for kind, metric, unit in cell.metrics:
        assert callable(tiny.M.reader(metric)), metric
    assert {k for k, _, _ in cell.metrics} == {"end_to_end", "per_layer"}


def test_the_benchmark_file_keeps_to_its_contract():
    bench = _bench()
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(names) == len(set(names)) and "setup_s" in names
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e
    for c in bench["configs"]:
        with open(tiny.ROOT / c["file"]) as f:
            assert json.load(f)["reduced"] == c["reduced"] == []
