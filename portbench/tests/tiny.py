"""A cell of the benchmark cut to a size the CPU runs in seconds: every width
of the model and the library's counts made small, the harness driven as
``run.py`` drives it, without its look for a card."""

from __future__ import annotations

import argparse
import io
import json
import time
from pathlib import Path

from harness import main as M

ROOT = M.HERE.parent
TINY = {"n_hidden": 16, "max_nodes": 64, "seq_len": 144, "max_resis": 60, "drug_llm_dim": 12,
        "prot_llm_dim": 20, "decoder": {"in_dim": 32, "hidden_dim": 64, "out_dim": 32,
                                        "binary": 1}}
LIBRARY = {"drugs": 50, "proteins": 20, "pairs": 300, "protein_residues": [10, 60]}
TRAFFIC = {"train": {"batch": 8, "chunk_steps": 2}, "eval": {"batch": 32, "checked_batches": 3}}


def cell(name: str, root: Path = ROOT, home: Path = M.HERE) -> M.Cell:
    c = M.load_cell(root, name, home)
    c.cfg = {**c.cfg, **TINY}
    c.library = {**c.library, **LIBRARY}
    c.traffic = {**c.traffic, **TRAFFIC[c.traffic["driver"]]}
    return c


def run(c: M.Cell, seed: int = 2**31 + 17, control=None, trace: int = 0):
    """One run on the CPU → (the result, the last line printed, standard error)."""
    out, err = io.StringIO(), io.StringIO()
    args = argparse.Namespace(workload=c.name, seed=seed, seconds=0.3, trace=trace)
    M.prepare(c)
    M.execute(c, args, time.perf_counter(), device="cpu", control=control, out=out, err=err)
    last = out.getvalue().strip().splitlines()[-1]
    return json.loads(last), last, err.getvalue()


def cells():
    with open(ROOT / "BENCHMARK.json") as f:
        return [w["name"] for w in json.load(f)["workloads"]]
