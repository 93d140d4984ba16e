"""Experiment driver: fit → select the best state by validation AUSum → test
(port of ``druglamp_tpu/train/trainer.py`` over the device-resident
transport).

    trainer = Trainer(model, cfg, train_loader, val_loader, test_loader,
                      work_dir="results/run", embed_store=emb.tree, device_data=data)
    test_metrics = trainer.run_experiment(seed, resume=False)

Per epoch (1-based, as the reference's ``cur_epoch``):

- the gates: SSL on every ``rs.epoch_step``-th epoch, CM from
  ``rs.init_epoch`` on, the CM weight's power-of-10 calibration in the
  ``rs.init_epoch`` epoch; one ``make_epoch_step_gather`` per gate
  combination, built at first use;
- the LRs from the cosine-warmup schedule: the cls LR at the epoch, the SSL
  and CM LRs at their own counts, which advance only on the epochs where
  their loss fires, as the margin schedule does (``MarginSchedule.step``
  after each CM epoch);
- the whole epoch in one call of the epoch driver, with a generator derived
  from (seed, epoch) (dropout, then the MLM masks), so a resumed run goes on
  exactly as the unbroken one; the CM weight enters as the value the last
  CM epoch left and leaves as the calibrated one;
- the validation pass (``make_eval_scan_gather``), AUROC/AUPRC; the best
  validation AUSum keeps a copy of the state on the device; early stopping
  after ``max(1, max_epoch // 4)`` epochs without improvement;
- checkpoints by ``torch.save``: ``ckpt_last.pt`` every
  ``solver.ckpt_every`` epochs and when training stops, ``ckpt_best.pt`` at
  those points when the best state changed.  Each holds the model
  (parameters and BatchNorm buffers), the three AdamW states and the step
  count, and the host state: the CM weight, the margin schedule, the SSL/CM
  schedule counts, the epoch, the best AUSum and epoch, the epochs without
  improvement.

``run_experiment`` restores ``ckpt_last.pt`` with ``resume=True``, fits,
then tests on the best state, which the model holds afterwards.  Only the
device-resident transport is ported (``device_data``, a ``DeviceDataStore``);
the host pipeline (``BatchLoader``'s batches, ``make_epoch_step``) belongs
to the host-pipeline slice.
"""

from __future__ import annotations

import copy
import os
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from druglamp_tpu_torch.config import Config
from druglamp_tpu_torch.data.device_data import eval_index_plan, train_index_plan
from druglamp_tpu_torch.eval.metrics import MetricCollector
from druglamp_tpu_torch.losses.schedules import MarginSchedule
from druglamp_tpu_torch.nn.inits import init_model
from druglamp_tpu_torch.serve import resolve_device
from druglamp_tpu_torch.train.schedule import cosine_warmup_restarts_lr
from druglamp_tpu_torch.train.state import TrainState
from druglamp_tpu_torch.train.steps import make_epoch_step_gather, make_eval_scan_gather
from druglamp_tpu_torch.utils.logging import ExperimentLogger


class Trainer:
    def __init__(self, model: torch.nn.Module, cfg: Config, train_loader, val_loader,
                 test_loader, logger: Optional[ExperimentLogger] = None,
                 work_dir: str = "results/run", embed_store: Optional[Dict[str, Any]] = None,
                 device_data=None, device="cuda"):
        if device_data is None:
            raise NotImplementedError("training without the device-resident dataset (the host "
                                      "pipeline: BatchLoader's batches, make_epoch_step) "
                                      "belongs to the host-pipeline slice")
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.cfg = cfg
        self.train_loader = train_loader
        self.val_loader = val_loader
        self.test_loader = test_loader
        self.logger = logger
        self.work_dir = os.path.abspath(work_dir)
        os.makedirs(self.work_dir, exist_ok=True)
        self.embed_store = embed_store
        self.device_data = device_data

        s = cfg.solver
        self.epochs = s.max_epoch
        self.use_ssl = cfg.rs.ssl
        self.use_cm = cfg.rs.cm
        self.patience = max(1, self.epochs // 4)
        self.n_class = cfg.decoder.binary
        self.margin_sched = MarginSchedule(m_ori=cfg.rs.max_margin, n_epoch=self.epochs,
                                           n_re=cfg.rs.reset_epoch)
        self._epoch_fns: Dict[Any, Any] = {}
        self._eval_fn = None

        # host state; the SSL/CM schedules advance only on epochs where their loss fires
        self.ssl_sched_steps = 0
        self.cm_sched_steps = 0
        self.cm_weight = 1.0
        self.epoch = 0
        self.epochs_no_improve = 0
        self.best_ausum = -np.inf
        self.best_epoch = -1
        self._best_state: Optional[Dict[str, Any]] = None   # a device copy
        self._best_dirty = False

    # --- plumbing -----------------------------------------------------------

    def _lr(self, base_lr: float, sched_step: int) -> float:
        return cosine_warmup_restarts_lr(sched_step, first_cycle_steps=self.epochs,
                                         max_lr=base_lr, min_lr=1e-8,
                                         warmup_steps=int(self.epochs * 0.2))

    def _generator(self, seed: int, epoch: int) -> torch.Generator:
        """The epoch's generator, a function of (seed, epoch) alone."""
        return torch.Generator(device=self.device).manual_seed((seed + 777) * 100003 + epoch)

    def init_state(self, seed: int) -> TrainState:
        """Fresh weights drawn from ``seed`` (the reference's initializers)
        and the optimizers of the recipe's gates."""
        self.model.cpu()
        init_model(self.model, torch.Generator().manual_seed(seed))
        self.model.to(self.device)
        return TrainState.create(self.model, self.use_ssl, self.use_cm)

    def _epoch_fn(self, compute_ssl: bool, compute_cm: bool, calibrate: bool):
        key = (compute_ssl, compute_cm, calibrate)
        if key not in self._epoch_fns:
            self._epoch_fns[key] = make_epoch_step_gather(
                self.model, use_ssl=compute_ssl, use_cm=compute_cm,
                include_llm=self.device_data.include_llm,
                emb_ordinals=self.device_data.emb_ordinals, calibrate=calibrate,
                grad_mode=self.cfg.solver.grad_mode, n_class=self.n_class, device=self.device)
        return self._epoch_fns[key]

    # --- fit / evaluate -----------------------------------------------------

    def fit(self, state: TrainState, seed: int, start_epoch: int = 1) -> TrainState:
        best_path = os.path.join(self.work_dir, "ckpt_best.pt")
        last_path = os.path.join(self.work_dir, "ckpt_last.pt")
        if self.epochs_no_improve >= self.patience:
            return state                     # resumed past an early stop
        rs = self.cfg.rs
        for epoch in range(start_epoch, self.epochs + 1):
            compute_ssl = self.use_ssl and epoch % rs.epoch_step == 0
            compute_cm = self.use_cm and epoch >= rs.init_epoch
            calibrate = compute_cm and epoch == rs.init_epoch
            lr_cls = self._lr(self.cfg.solver.lr, epoch - 1)
            lr_ssl = self._lr(self.cfg.solver.ssl_lr, self.ssl_sched_steps)
            lr_cm = self._lr(self.cfg.solver.cm_lr, self.cm_sched_steps)
            margin = self.margin_sched.margin

            t0 = time.time()
            sums, n_batches = self._fit_epoch_gather(state, epoch, seed, compute_ssl,
                                                     compute_cm, calibrate, lr_cls, lr_ssl,
                                                     lr_cm, margin)
            if compute_ssl:
                self.ssl_sched_steps += 1
            if compute_cm:
                self.cm_sched_steps += 1
                self.margin_sched.step()
            wall = time.time() - t0
            train_metrics = {"train_loss": sums[0] / max(n_batches, 1), "lr": lr_cls,
                             "epoch_time_s": wall,
                             "pairs_per_s": n_batches * self.train_loader.batch_size
                             / max(wall, 1e-9)}
            if compute_ssl:
                train_metrics["ssl_loss"] = sums[1] / max(n_batches, 1)
            if compute_cm:
                train_metrics["cm_loss"] = sums[2] / max(n_batches, 1)
                train_metrics["cm_weight"] = self.cm_weight
                train_metrics["margin"] = margin

            val_metrics = self.evaluate(state, self.val_loader, full=False)
            if self.logger:
                self.logger.log_metrics({**train_metrics,
                                         **{f"val_{k}": v for k, v in val_metrics.items()}},
                                        epoch=epoch)
            ausum = val_metrics["ausum"]
            self.epoch = epoch
            if np.isfinite(ausum) and ausum > self.best_ausum:
                self.best_ausum = ausum
                self.best_epoch = epoch
                self.epochs_no_improve = 0
                self._best_state = self._snapshot(state)
                self._best_dirty = True
            else:
                self.epochs_no_improve += 1
            stopping = self.epochs_no_improve >= self.patience or epoch == self.epochs
            if stopping or epoch % max(1, self.cfg.solver.ckpt_every) == 0:
                if self._best_dirty:
                    self._save(best_path, self._best_state)
                    self._best_dirty = False
                self._save(last_path, self._snapshot(state))
            if self.epochs_no_improve >= self.patience:
                if self.logger:
                    self.logger.log_dict({"event": "early_stop", "epoch": epoch,
                                          "best_epoch": self.best_epoch})
                break
        if self._best_dirty:
            self._save(best_path, self._best_state)
            self._best_dirty = False
        return state

    def _fit_epoch_gather(self, state, epoch, seed, compute_ssl, compute_cm, calibrate,
                          lr_cls, lr_ssl, lr_cm, margin):
        """The epoch in one call of the epoch driver over the training plan;
        → ((cls, ssl, cm) loss sums, number of steps).  The sums are read
        back after the call."""
        epoch_fn = self._epoch_fn(compute_ssl, compute_cm, calibrate)
        tree = self.device_data.tree_for(self.train_loader.ds)
        idx = train_index_plan(self.train_loader._order(epoch), self.train_loader.batch_size)
        ones = np.ones(idx.shape, np.float32)
        out = epoch_fn(state, idx, ones, tree, self.embed_store, self._generator(seed, epoch),
                       lr_cls, lr_ssl, lr_cm, margin, self.cm_weight)
        if compute_cm:
            self.cm_weight = float(out.cm_weight)
        sums = tuple(float(np.sum(x.float().cpu().numpy()))
                     for x in (out.cls_losses, out.ssl_losses, out.cm_losses))
        return sums, idx.shape[0]

    def evaluate(self, state: Optional[TrainState], loader, full: bool) -> Dict[str, float]:
        """AUROC, AUPRC, AUSum (and with ``full`` the threshold metrics) and
        the mean loss of the model as it stands, over ``loader``'s split in
        one call of the eval driver (the plan's ragged tail is masked)."""
        if self._eval_fn is None:
            self._eval_fn = make_eval_scan_gather(
                self.model, include_llm=self.device_data.include_llm,
                emb_ordinals=self.device_data.emb_ordinals, n_class=self.n_class,
                device=self.device)
        tree = self.device_data.tree_for(loader.ds)
        idx, valid = eval_index_plan(len(loader.ds), loader.batch_size)
        probs, losses = self._eval_fn(idx, valid, tree, self.embed_store)
        mask = valid.astype(bool)
        collector = MetricCollector()
        collector.update(probs.float().cpu().numpy()[mask], loader.ds.labels[idx[mask]])
        m = collector.compute(full=full)
        m["loss"] = float(np.mean(losses.float().cpu().numpy()))
        return m

    def run_experiment(self, seed: int, resume: bool = False,
                       state: Optional[TrainState] = None) -> Dict[str, float]:
        """fit → restore the best state → test.  ``state`` (weights already in
        the model) in place of fresh weights from ``seed``; with ``resume``
        and a ``ckpt_last.pt``, training goes on from the epoch after it."""
        state = self.init_state(seed) if state is None else state
        start_epoch = 1
        last_path = os.path.join(self.work_dir, "ckpt_last.pt")
        if resume and os.path.exists(last_path):
            self.restore(last_path, state)
            start_epoch = self.epoch + 1
            if self.logger:
                self.logger.log_dict({"event": "resume", "from_epoch": self.epoch})
        state = self.fit(state, seed, start_epoch=start_epoch)
        if self._best_state is not None:
            self._load(self._best_state, state)
        else:
            self.restore(os.path.join(self.work_dir, "ckpt_best.pt"), state, load_host=False)
        test_metrics = self.evaluate(state, self.test_loader, full=True)
        if self.logger:
            self.logger.log_metrics({f"test_{k}": v for k, v in test_metrics.items()})
            self.logger.log_dict({"event": "done", "best_epoch": self.best_epoch,
                                  "best_val_ausum": float(self.best_ausum)})
        return test_metrics

    # --- checkpointing --------------------------------------------------------

    def _snapshot(self, state: TrainState) -> Dict[str, Any]:
        """A copy of the model and optimizer states, on their device."""
        return {"model": {k: v.detach().clone() for k, v in self.model.state_dict().items()},
                "optim": copy.deepcopy(state.state_dict())}

    def _host_state(self) -> Dict[str, Any]:
        return {"cm_weight": self.cm_weight, "ssl_sched_steps": self.ssl_sched_steps,
                "cm_sched_steps": self.cm_sched_steps, "epoch": self.epoch,
                "epochs_no_improve": self.epochs_no_improve,
                "best_ausum": float(self.best_ausum), "best_epoch": self.best_epoch,
                "margin": self.margin_sched.state_dict()}

    def _save(self, path: str, snapshot: Dict[str, Any]) -> None:
        tmp = path + ".tmp"
        torch.save({**snapshot, "host": self._host_state()}, tmp)
        os.replace(tmp, path)

    def _load(self, snapshot: Dict[str, Any], state: TrainState) -> None:
        self.model.load_state_dict(snapshot["model"])
        state.load_state_dict(snapshot["optim"])

    def restore(self, path: str, state: TrainState, load_host: bool = True) -> TrainState:
        """Load a checkpoint into the model and ``state`` (and with
        ``load_host`` the host state); a missing file changes nothing."""
        if not os.path.exists(path):
            return state
        ckpt = torch.load(path, map_location=self.device, weights_only=True)
        self._load(ckpt, state)
        if load_host:
            host = ckpt["host"]
            self.cm_weight = float(host["cm_weight"])
            self.ssl_sched_steps = int(host["ssl_sched_steps"])
            self.cm_sched_steps = int(host["cm_sched_steps"])
            self.epoch = int(host["epoch"])
            self.epochs_no_improve = int(host["epochs_no_improve"])
            self.best_ausum = float(host["best_ausum"])
            self.best_epoch = int(host["best_epoch"])
            self.margin_sched.load_state_dict(host["margin"])
        return state
