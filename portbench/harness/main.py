"""One run of one cell: ``run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>``.

The cell is looked up in ``BENCHMARK.json`` (its configuration and traffic),
its files by name: ``configs/<config>.json``, ``traffic/<traffic>.json``,
``libraries/<library>.json``, ``limits/<cell>.json``, a driver
``harness/drivers/<driver>.py``, and a reader for each metric the cell
reports: ``metrics/<metric>.py``, or, where that file is not there, the
reader of its family, the name without its last ``.`` part
(``mfu.full`` → ``metrics/mfu.py``).  A cell, a configuration, a traffic
mix or a metric is added by adding files and entries.

The last line of standard output is the result; the numbers compared, each
beside its limit, end standard error and the result's line.  The run exits
2 without a result when the card or cards the cell asks for are missing,
and 3 when the process holds JAX, Flax or the JAX package once the window
has closed.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import math
import os
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional

HERE = Path(__file__).resolve().parent.parent          # portbench/
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "druglamp_tpu")


@dataclass
class Cell:
    name: str
    chips: int
    cfg: dict
    traffic: dict
    library: dict
    limits: dict
    metrics: list            # [(kind, name, unit)]
    home: Path = HERE        # the folder of its files


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(root: Path, name: str, home: Path = HERE) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json``, its files under ``home``."""
    bench = _json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has {sorted(cells)}")
    w = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    cfg = _json(root / conf["file"])
    traffic = _json(home / "traffic" / f"{w['traffic']}.json")
    library = _json(home / "libraries" / f"{traffic['library']}.json")
    limits = _json(home / "limits" / f"{name}.json")

    def mine(m):
        return name in m["workloads"] if "workloads" in m else True

    e2e = [m for m in bench["end_to_end"] if mine(m)]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m else m["moves"] in reported)]
    return Cell(name, w["chips"], cfg, traffic, library, limits,
                [("end_to_end", m["name"], m["unit"]) for m in e2e]
                + [("per_layer", m["name"], m["unit"]) for m in per_layer], home)


def reader(name: str, home: Path = HERE):
    """The ``read`` function of ``metrics/<name>.py``, or of its family's
    ``metrics/<name without its last . part>.py``."""
    path = home / "metrics" / f"{name}.py"
    if not path.exists() and "." in name:
        path = home / "metrics" / f"{name.rsplit('.', 1)[0]}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


@dataclass
class Context:
    cfg: dict
    traffic: dict
    library: dict
    seed: int
    seconds: float
    trace: bool
    device: object
    t0: float
    control: Optional[str] = None
    detail: dict = field(default_factory=dict)       # printed to standard error
    marks: list = field(default_factory=list)        # (what, host seconds) of set-up

    def mark(self, what: str) -> None:
        """The end of a part of set-up."""
        self.marks.append((what, time.perf_counter()))

    def sync(self) -> None:
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def memory_peak(self) -> int:
        """The device's peak of allocated bytes so far; the caching allocator's
        counters beside it go to standard error (a retry frees the cache and
        waits for the device)."""
        import torch

        if self.device.type != "cuda":
            return 0
        stats = torch.cuda.memory_stats(self.device)
        self.detail["allocator"] = {k: stats.get(k) for k in (
            "num_alloc_retries", "num_device_alloc", "num_device_free", "num_sync_all_streams",
            "reserved_bytes.all.peak")}
        return int(torch.cuda.max_memory_allocated(self.device))


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def prepare(cell: Cell) -> None:
    """The cell's environment: the configuration's switches for the program.
    (The program builds its kernels into ``druglamp_tpu_torch/_build/``
    inside the checkout, and uses no other build or kernel cache.)"""
    os.environ["USE_FLAX"] = "0"
    for k, v in cell.cfg.get("env", {}).items():
        os.environ[k] = str(v)


def execute(cell: Cell, args, t0: float, device=None, control: Optional[str] = None,
            out=sys.stdout, err=sys.stderr) -> dict:
    """Run the cell once and print its result; returns the result."""
    import torch

    if device is None:
        device = torch.device("cuda", 0)
    ctx = Context(cell.cfg, cell.traffic, cell.library, args.seed, args.seconds,
                  bool(args.trace), torch.device(device), t0, control)
    driver = importlib.import_module(f"harness.drivers.{cell.traffic['driver']}")
    done = driver.run(ctx)
    found = forbidden_modules()
    if found:
        print(f"the process holds {', '.join(found)} after the window", file=err)
        raise SystemExit(3)
    reading = done["reading"]
    wanted = [(n, u) for kind, n, u in cell.metrics if (kind == "per_layer") == bool(args.trace)]
    metrics = {}
    for name, unit in wanted:
        value = reader(name, cell.home)(reading)
        if value is not None:
            metrics[name] = {"value": value, "unit": unit}
    checks = {k: {"value": v, "limit": cell.limits[k]} for k, v in done["checks"].items()
              if k in cell.limits}
    readings = {k: v for k, v in done["checks"].items() if k not in cell.limits}
    correct = (done["failed"] == 0 and set(checks) == set(cell.limits)
               and all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                       for c in checks.values()))
    dev = ctx.device
    result = {"correct": correct, "attempted": done["attempted"], "failed": done["failed"],
              "metrics": metrics,
              "device": {"platform": "gpu" if dev.type == "cuda" else dev.type,
                         "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                         "count": cell.chips, "memory_peak_bytes": done["memory_peak"]}}
    if reading.trace is not None:
        ctx.detail["host_issue"] = reading.trace.host
        result["device"]["busy_s"] = reading.trace.busy_s
        result["device"]["window_s"] = reading.trace.window_s
        result["breakdown"] = reading.trace.breakdown()
    if done.get("control") is not None:
        result["control"] = done["control"]
        result["readings"] = readings
    result["checks"] = checks
    last = t0
    parts = []
    for what, t in ctx.marks:
        parts.append(f"{what} {t - last:.3f}")
        last = t
    print("setup_s by part: " + ", ".join(parts), file=err)
    for k, v in ctx.detail.items():
        print(f"detail {k}: {json.dumps(v)}", file=err)
    for k, v in readings.items():
        print(f"reading {k}: {v!r} (not compared)", file=err)
    for k, c in checks.items():
        print(f"check {k}: {c['value']!r} limit {c['limit']!r}", file=err)
    err.flush()
    print(json.dumps(result), file=out, flush=True)
    return result


def main(argv=None, t0: Optional[float] = None) -> int:
    t0 = time.perf_counter() if t0 is None else t0
    args = parse(argv)
    root = HERE.parent
    cell = load_cell(root, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found",
              file=sys.stderr)
        return 2
    prepare(cell)
    execute(cell, args, t0)
    return 0
