"""The Trainer's asynchronous checkpoint writes (``train/trainer.py``) on the CPU: DrugLAMP2C2P at a tiny f32 configuration,
dropout on, the toy dataset of ``tests/test_torch_port_trainer.py`` over the
device-resident transport, 3 epochs (cls; ssl + cm + calibrate; cm),
``ckpt_every`` 1.

- Asynchronous writes (the default) and ``DRUGLAMP_SYNC_CKPT=1`` give the
  same fit and files with equal tensors and host state; the asynchronous
  ones are written on a thread that is not the caller's.
- A Trainer from other weights resumes from the asynchronous epoch-2
  ``ckpt_last.pt`` and ends with the unbroken run's ``ckpt_last.pt``, bit
  for bit.
- ``restore`` joins a write still in flight (one slowed on purpose), and so
  does a fit that raises.
- Two gloo ranks: with rank 0's write slowed, no rank passes
  ``_join_ckpt`` (the barrier) before the file is there
  (``tests/torch_port_ranks.py::job_ckpt``).
"""

import os
import pickle
import shutil
import sys
import threading
import time

import pytest
import torch

from druglamp_tpu_torch.models.registry import build_model
from druglamp_tpu_torch.nn.inits import init_model
from druglamp_tpu_torch.train import trainer as trainer_mod
from druglamp_tpu_torch.train.state import TrainState
from druglamp_tpu_torch.train.trainer import Trainer
from druglamp_tpu_torch.utils.logging import ExperimentLogger
from tests.test_torch_port_trainer import (PATIENCE, PORT_BUILD, _cfg, _full_port_config,
                                           _toy_dataset, _world)
from tests.torch_port_ranks import run_ranks
from tests.torch_port_util import ND, NP, port_config

RANKS = [sys.executable, "-m", "tests.torch_port_ranks"]
FIT_SEED = 7


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    cfg = _cfg(dropout=0.1, lr=1e-3)
    root = _toy_dataset(str(tmp_path_factory.mktemp("data")))
    return cfg, _world(root, cfg, PORT_BUILD)


def _trainer(world, work, seed=0):
    cfg, ((pl, pvl, ptl), emb, data) = world
    model = build_model("DrugLAMP2C2P", port_config(cfg), ND, NP)
    init_model(model, torch.Generator().manual_seed(seed))
    t = Trainer(model, _full_port_config(cfg), pl, pvl, ptl, work_dir=str(work),
                embed_store=emb, device_data=data, device="cpu",
                logger=ExperimentLogger(str(work), "log", quiet=True))
    t.patience = PATIENCE
    return t, TrainState.create(model, True, True)


def _load(path):
    return torch.load(path, weights_only=True)


def _same_checkpoint(a, b):
    return (a["host"] == b["host"] and a["model"].keys() == b["model"].keys()
            and all(torch.equal(a["model"][k], b["model"][k]) for k in a["model"])
            and _same_tree(a["optim"], b["optim"]))


def _same_tree(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same_tree(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same_tree(x, y) for x, y in zip(a, b))
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    return a == b


@pytest.fixture(scope="module")
def fits(world, tmp_path_factory):
    """The same fit with asynchronous writes (its writer threads noted, its
    epoch-2 ``ckpt_last.pt`` kept) and with synchronous ones."""
    d = tmp_path_factory.mktemp("fits")
    out = {"writers": []}
    write = trainer_mod._write_checkpoint

    def noting(payload, path):
        out["writers"].append(threading.current_thread() is threading.main_thread())
        write(payload, path)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(trainer_mod, "_write_checkpoint", noting)
        for label, sync in (("async", "0"), ("sync", "1")):
            mp.setenv("DRUGLAMP_SYNC_CKPT", sync)
            t, state = _trainer(world, d / label)
            assert t.async_ckpt == (sync == "0")
            save = t._save

            def keep_epoch2(path, snapshot, t=t, label=label):
                save(path, snapshot)
                if path.endswith("ckpt_last.pt") and t.epoch == 2:
                    t._join_ckpt()
                    shutil.copy(path, d / f"{label}_epoch2.pt")

            t._save = keep_epoch2
            out[label] = {"test": t.run_experiment(FIT_SEED, state=state), "logger": t.logger,
                          "state": {k: v.clone() for k, v in t.model.state_dict().items()}}
    return d, out


def test_async_and_sync_writes_give_the_same_files(fits):
    d, out = fits
    assert out["async"]["test"] == out["sync"]["test"]
    assert all(torch.equal(v, out["sync"]["state"][k]) for k, v in out["async"]["state"].items())
    for name in ("ckpt_best.pt", "ckpt_last.pt", "epoch2.pt"):
        a, b = ((_load(d / w / name) if name.startswith("ckpt") else _load(d / f"{w}_{name}"))
                for w in ("async", "sync"))
        assert _same_checkpoint(a, b), name
    assert _load(d / "async" / "ckpt_last.pt")["host"]["epoch"] == 3
    n = len(out["writers"]) // 2
    assert n >= 3 and out["writers"] == [False] * n + [True] * n


def test_resume_from_an_async_checkpoint_continues_bit_for_bit(world, fits, tmp_path):
    d, _ = fits
    (tmp_path / "resumed").mkdir()
    shutil.copy(d / "async_epoch2.pt", tmp_path / "resumed" / "ckpt_last.pt")
    resumed, state = _trainer(world, tmp_path / "resumed", seed=1)
    resumed.restore(str(tmp_path / "resumed" / "ckpt_last.pt"), state)
    assert resumed.epoch == 2
    resumed.fit(state, FIT_SEED, start_epoch=resumed.epoch + 1)
    assert _same_checkpoint(_load(tmp_path / "resumed" / "ckpt_last.pt"),
                            _load(d / "async" / "ckpt_last.pt"))


def _slow_writes(monkeypatch, delay):
    write = trainer_mod._write_checkpoint

    def slow(payload, path):
        time.sleep(delay)
        write(payload, path)

    monkeypatch.setattr(trainer_mod, "_write_checkpoint", slow)


def test_restore_joins_a_pending_write(world, tmp_path, monkeypatch):
    _slow_writes(monkeypatch, 0.5)
    t, state = _trainer(world, tmp_path)
    saved = {k: v.clone() for k, v in t.model.state_dict().items()}
    path = str(tmp_path / "ckpt_last.pt")
    t.epoch = 5
    t._save(path, t._snapshot(state))
    assert t._ckpt_write is not None and not os.path.exists(path)
    t.epoch = 0
    with torch.no_grad():
        for p in t.model.parameters():
            p.zero_()
    t.restore(path, state)
    assert t._ckpt_write is None and t.epoch == 5
    assert all(torch.equal(v, saved[k]) for k, v in t.model.state_dict().items())


class _Stop(Exception):
    pass


def test_a_fit_that_raises_leaves_its_last_write_done(world, tmp_path, monkeypatch):
    _slow_writes(monkeypatch, 0.3)
    t, state = _trainer(world, tmp_path)
    run_epoch = t._fit_epoch_gather

    def stop_in_epoch_2(state, epoch, *args):
        if epoch == 2:
            raise _Stop
        return run_epoch(state, epoch, *args)

    t._fit_epoch_gather = stop_in_epoch_2
    with pytest.raises(_Stop):
        t.fit(state, FIT_SEED)
    assert t._ckpt_write is None
    assert _load(tmp_path / "ckpt_last.pt")["host"]["epoch"] == 1


def test_two_ranks_pass_the_barrier_only_once_the_file_is_there(tmp_path):
    cfg = _cfg()
    with open(tmp_path / "ckpt.pkl", "wb") as f:
        pickle.dump({"cfg": _full_port_config(cfg), "nd": ND, "np": NP, "delay": 1.5}, f)
    run_ranks(RANKS + ["ckpt", str(tmp_path)], timeout=300)
    runs = []
    for rank in range(2):
        with open(tmp_path / f"rank{rank}_ckpt.pkl", "rb") as f:
            runs.append(pickle.load(f))
    for rank, run in enumerate(runs):
        assert run["async"]["after_join"] and run["sync"]["after_save"], rank
        assert not run["async"]["pending"] and not run["sync"]["pending"], rank
    assert not runs[0]["async"]["after_save"]          # rank 0's own write was still running
