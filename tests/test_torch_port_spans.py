"""The phase ranges of the port's train and eval steps
(``druglamp_tpu_torch/utils/profiling.py::span``, ``train/steps.py``) on the
CPU, at a tiny configuration over the toy device-resident dataset.

- ``span`` is one shared context that records nothing while no profiler
  records, and a user annotation while one does.
- A profiled 2-step chunk of ``make_epoch_step_gather`` (calibration off)
  shows, step by step and in order, the gather (``druglamp.gather`` twice:
  the batch from the store, then its decoding), one ``druglamp.forward``, a
  ``druglamp.backward.<loss>`` and then a ``druglamp.optimizer.<loss>`` for
  each active loss; the ranges do not overlap and sit inside
  ``epoch_step.loop``, after the chunk's own gather.  The cls-only gate shows
  no ``ssl`` or ``cm`` range.
- Every ATen operation of the full gate's chunk lies in a ``druglamp.*``
  range but the chunk's closing ``stack``s and the CM weight's ``full``;
  under ``DRUGLAMP_REMAT=full`` the recomputed forward lies in
  ``druglamp.backward.cls``.
- ``make_eval_scan_gather`` shows the gather and a forward a batch, the host
  pipeline's ``make_train_step`` and ``make_eval_step`` their copy to the
  device as a gather, and ``utils.profiling.trace``'s Chrome trace holds the
  ranges.
"""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from druglamp_tpu_torch.data.device_data import train_index_plan
from druglamp_tpu_torch.data.encoding import compact_batch
from druglamp_tpu_torch.models.registry import build_model
from druglamp_tpu_torch.train import steps
from druglamp_tpu_torch.train.state import TrainState
from druglamp_tpu_torch.utils import profiling
from druglamp_tpu_torch.utils.synthetic import make_batch, tiny_config
from tests.test_torch_port_trainer import PORT_BUILD, _cfg, _toy_dataset, _world
from tests.torch_port_util import ND, NP

torch.set_num_threads(1)

LRS = (1e-3, 1e-3, 1e-3, 0.5, 1.0)      # lr_cls, lr_ssl, lr_cm, margin, the CM weight
STEPS = 2


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    (pl, _, _), emb, data = _world(_toy_dataset(str(tmp_path_factory.mktemp("data"))), _cfg(),
                                   PORT_BUILD)
    idx = train_index_plan(np.random.RandomState(0).permutation(len(pl.ds)), 4)[:STEPS]
    return data.tree_for(pl.ds), emb, idx


def _model(name="DrugLAMP2C2P"):
    return build_model(name, tiny_config(n_hidden=16, max_nodes=32, site_seq=16), ND, NP,
                       generator=torch.Generator().manual_seed(0))


def _profiled(fn):
    """The host records of ``fn()`` under the profiler: [(name, start, end,
    user annotation)], in order of their start, an outer record before the
    records it holds."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return sorted(((e.name(), e.start_ns(), e.end_ns(), e.is_user_annotation())
                   for e in prof.profiler.kineto_results.events()
                   if e.device_type() == torch.autograd.DeviceType.CPU),
                  key=lambda r: (r[1], -r[2]))


def _ranges(records, prefix="druglamp."):
    return [r for r in records if r[3] and r[0].startswith(prefix)]


def _within(r, outer):
    return outer[1] <= r[1] and r[2] <= outer[2]


def _epoch(world, use_ssl, use_cm, calibrate=False):
    tree, emb, idx = world
    model = _model()
    state = TrainState.create(model, use_ssl, use_cm, flat_opt=False)
    epoch = steps.make_epoch_step_gather(model, use_ssl, use_cm, True, True,
                                         calibrate=calibrate, device="cpu")
    ones = np.ones(idx.shape, np.float32)
    return lambda: epoch(state, idx, ones, tree, emb, torch.Generator().manual_seed(3), *LRS)


def test_a_span_records_only_under_a_profiler():
    assert profiling.span("druglamp.a") is profiling.span("druglamp.b")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("druglamp.a"):
            torch.ones(2).sum()
    with profiling.span("druglamp.b"):
        torch.ones(2).sum()
    names = [e.name() for e in prof.profiler.kineto_results.events() if e.is_user_annotation()]
    assert names == ["druglamp.a"]


@pytest.mark.parametrize("gates", [(True, True), (False, False)], ids=["full", "cls"])
def test_a_chunk_shows_each_phase_of_each_step_in_order(world, gates):
    use_ssl, use_cm = gates
    records = _profiled(_epoch(world, use_ssl, use_cm))
    (loop,) = [r for r in records if r[0] == "epoch_step.loop"]
    ranges = _ranges(records)
    losses = ["cls"] + ["ssl"] * use_ssl + ["cm"] * use_cm
    step = (["druglamp.gather", "druglamp.gather", "druglamp.forward"]
            + [f"druglamp.backward.{k}" for k in losses]
            + [f"druglamp.optimizer.{k}" for k in losses])
    assert [r[0] for r in ranges] == ["druglamp.gather"] + step * STEPS
    assert not _within(ranges[0], loop)                 # the chunk's plan and pre-gather
    assert all(_within(r, loop) for r in ranges[1:])
    assert all(a[2] <= b[1] for a, b in zip(ranges, ranges[1:]))


@pytest.mark.parametrize("mode", ["none", "full"])
def test_every_op_of_the_chunk_lies_in_a_phase(world, monkeypatch, mode):
    monkeypatch.setenv("DRUGLAMP_REMAT", mode)
    records = _profiled(_epoch(world, True, True))
    ranges = _ranges(records)
    ops = [r for r in records if not r[3] and r[0].startswith("aten::")]
    outside = [r for r in ops if not any(_within(r, s) for s in ranges)]
    top = [r for r in outside if not any(o is not r and _within(r, o) for o in outside)]
    assert [r[0] for r in top] == ["aten::full"] + ["aten::stack"] * 3
    assert top[0][2] <= ranges[1][1] and ranges[-1][2] <= top[1][1]   # before and after the loop
    backward = [s for s in ranges if s[0] == "druglamp.backward.cls"]
    recomputed = [r for r in ops if r[0] == "aten::convolution"
                  and any(_within(r, s) for s in backward)]
    assert bool(recomputed) == (mode == "full")


def test_an_eval_pass_shows_the_gather_and_a_forward_a_batch(world):
    tree, emb, idx = world
    scan = steps.make_eval_scan_gather(_model("DrugLAMP"), True, True, device="cpu")
    records = _profiled(lambda: scan(idx, np.ones(idx.shape, np.float32), tree, emb))
    assert [r[0] for r in _ranges(records)] == (
        ["druglamp.gather"] + ["druglamp.gather", "druglamp.gather", "druglamp.forward"] * STEPS)


def test_the_host_pipeline_copies_its_batch_in_a_gather():
    model = _model("DrugLAMP")
    cfg = tiny_config(n_hidden=16, max_nodes=32, site_seq=16)
    host = make_batch(cfg, 4, seed=3, n_drug_feature=ND, n_prot_feature=NP)
    batch = compact_batch(host, (host["d_fill"] == 0).sum(1))
    step = steps.make_train_step(model, False, False, device="cpu")
    state = TrainState.create(model, False, False, flat_opt=False)
    evaluate = steps.make_eval_step(model, device="cpu")
    records = _profiled(lambda: (step(state, batch, torch.Generator().manual_seed(1), 1e-3),
                                 evaluate(batch)))
    assert [r[0] for r in _ranges(records)] == [
        "druglamp.gather", "druglamp.gather", "druglamp.forward", "druglamp.backward.cls",
        "druglamp.optimizer.cls", "druglamp.gather", "druglamp.gather", "druglamp.forward"]


def test_the_operators_trace_holds_the_ranges(world, tmp_path):
    with profiling.trace(str(tmp_path), device="cpu"):
        _epoch(world, False, False)()
    (path,) = list(tmp_path.iterdir())
    names = {e.get("name") for e in json.loads(path.read_text())["traceEvents"]}
    assert {"epoch_step.loop", "druglamp.gather", "druglamp.forward", "druglamp.backward.cls",
            "druglamp.optimizer.cls"} <= names
