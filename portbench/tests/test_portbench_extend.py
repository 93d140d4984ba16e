"""A cell, its traffic, its limits and a per-layer metric are added as new files
and entries alone: a temporary copy of the benchmark's data gains a dummy
cell and a dummy metric, and the harness runs them unchanged."""

import json
import shutil

import tiny


def test_a_new_cell_and_metric_need_only_new_files(tmp_path):
    home = tmp_path / "portbench"
    for d in ("configs", "traffic", "libraries", "limits", "metrics"):
        shutil.copytree(tiny.M.HERE / d, home / d)
    with open(tiny.ROOT / "BENCHMARK.json") as f:
        bench = json.load(f)
    (home / "traffic" / "eval.b16.json").write_text(json.dumps(
        {"driver": "eval", "library": "biosnap", "split": "test", "batch": 16,
         "checked_batches": 2}))
    shutil.copy(home / "limits" / "lamp.eval.b512.json", home / "limits" / "dummy.eval.b16.json")
    (home / "metrics" / "dummy_share.py").write_text(
        '"""A dummy per-layer metric."""\n\n\ndef read(r):\n    return 42.0\n')
    bench["workloads"].append({"name": "dummy.eval.b16", "config": "DrugLAMP",
                               "traffic": "eval.b16", "chips": 1, "why": "a test"})
    bench["end_to_end"].append({"name": "dummy_pairs_per_s", "unit": "pairs/s",
                                "better": "higher", "bound": 0.25, "source": "host_clock",
                                "workloads": ["dummy.eval.b16"]})
    (home / "metrics" / "dummy_pairs_per_s.py").write_text(
        (tiny.M.HERE / "metrics" / "eval_pairs_per_s.py").read_text())
    bench["per_layer"].append({"name": "dummy_share", "unit": "%", "better": "higher",
                               "source": "device_trace", "layer": "device",
                               "moves": "dummy_pairs_per_s"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = tiny.cell("dummy.eval.b16", root=tmp_path, home=home)
    assert ("per_layer", "dummy_share", "%") in cell.metrics
    result, _, _ = tiny.run(cell)
    assert set(result["metrics"]) == {"dummy_pairs_per_s", "setup_s"}
    assert tiny.M.reader("dummy_share", home)(None) == 42.0
    assert tiny.M.reader("dummy_share.another_family", home)(None) == 42.0   # its family's file
