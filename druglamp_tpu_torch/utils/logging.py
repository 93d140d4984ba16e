"""Console and JSONL metric logging (the port's copy of
``druglamp_tpu/utils/logging.py``).

Console and JSONL sinks are always on; a Comet adapter attaches only if
``comet_ml`` is importable and enabled in the config.
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Any, Dict, Optional


class ExperimentLogger:
    def __init__(self, output_dir: str, exp_name: str, hyperparams: Optional[Dict] = None,
                 use_comet: bool = False, comet_cfg: Optional[Dict] = None,
                 quiet: bool = False):
        self.exp_name = exp_name
        self.quiet = quiet
        self.dir = os.path.join(output_dir, exp_name)
        os.makedirs(self.dir, exist_ok=True)
        self.jsonl_path = os.path.join(self.dir, "metrics.jsonl")
        self._jsonl = open(self.jsonl_path, "a")
        self._t0 = time.time()
        self.comet = None
        if use_comet:
            try:
                from comet_ml import Experiment  # type: ignore

                self.comet = Experiment(project_name=(comet_cfg or {}).get("project_name"),
                                        workspace=(comet_cfg or {}).get("workspace"))
                self.comet.set_name(exp_name)
                if hyperparams:
                    self.comet.log_parameters(hyperparams)
            except ImportError:
                self._print("comet_ml not installed; continuing with console/JSONL only")
        if hyperparams:
            self.log_dict({"event": "hyperparams", **_jsonable(hyperparams)})

    def _print(self, msg: str):
        if not self.quiet:
            print(f"[{self.exp_name}] {msg}", file=sys.stderr, flush=True)

    def log_metrics(self, metrics: Dict[str, Any], step: Optional[int] = None,
                    epoch: Optional[int] = None, prefix: str = ""):
        payload = {f"{prefix}{k}": _num(v) for k, v in metrics.items()}
        rec = {"t": round(time.time() - self._t0, 3)}
        if epoch is not None:
            rec["epoch"] = epoch
        if step is not None:
            rec["step"] = step
        rec.update(payload)
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()
        if self.comet is not None:
            self.comet.log_metrics(payload, step=step, epoch=epoch)
        summary = " ".join(f"{k}={v:.5f}" if isinstance(v, float) else f"{k}={v}"
                           for k, v in payload.items())
        ep = f"epoch {epoch} " if epoch is not None else ""
        self._print(f"{ep}{summary}")

    def log_dict(self, rec: Dict[str, Any]):
        self._jsonl.write(json.dumps(_jsonable(rec)) + "\n")
        self._jsonl.flush()

    def close(self):
        self._jsonl.close()
        if self.comet is not None:
            self.comet.end()


def _num(v):
    try:
        return float(v)
    except (TypeError, ValueError):
        return v


def _jsonable(d):
    out = {}
    for k, v in d.items():
        try:
            json.dumps(v)
            out[k] = v
        except TypeError:
            out[k] = str(v)
    return out
