"""The rank processes of tests/test_torch_port_parallel.py: each job runs in
every rank of a gloo process group on the CPU, started as torchrun starts
them (``run_ranks``), and reads its inputs from and writes its results to a
directory the test gives it:

    RANK=r WORLD_SIZE=2 LOCAL_RANK=r MASTER_ADDR=127.0.0.1 MASTER_PORT=p \\
        python -m tests.torch_port_ranks step,fit <dir>

Nothing here imports JAX: the test computes the JAX package's references in
its own process.  The MLM mask is ``fixed_mask`` (every 5th non-pad
position, the one the parity tests inject into the port), so a rank's draws
do not matter."""

from __future__ import annotations

import os
import pickle
import shutil
import socket
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_env(rank: int, world: int, port: int) -> dict:
    """torchrun's variables for one rank of a group on this host."""
    return {"RANK": str(rank), "WORLD_SIZE": str(world), "LOCAL_RANK": str(rank),
            "LOCAL_WORLD_SIZE": str(world), "MASTER_ADDR": "127.0.0.1",
            "MASTER_PORT": str(port)}


def run_ranks(argv, world: int = 2, timeout: float = 300.0, env=None):
    """Start ``argv`` once a rank and wait for all; a rank that fails (or a
    run past ``timeout``) stops every rank and raises with their output.
    → [(stdout, stderr)] by rank."""
    port = free_port()
    base = {**os.environ, **(env or {}), "PYTHONPATH": ROOT, "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen(argv, cwd=ROOT, env={**base, **rank_env(r, world, port)},
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(world)]
    end = time.time() + timeout
    try:
        while any(p.poll() is None for p in procs):
            if any(p.returncode not in (None, 0) for p in procs) or time.time() > end:
                break
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        outs = [p.communicate() for p in procs]
    if any(p.returncode != 0 for p in procs):
        raise RuntimeError("\n".join(f"rank {r}: rc {p.returncode}\n{o}\n{e[-6000:]}"
                                     for r, (p, (o, e)) in enumerate(zip(procs, outs))))
    return outs


def fixed_mask(seq, generator, **kw):
    """The MLM mask of every 5th non-pad position: the same tokens whichever
    rank or package holds a row."""
    import torch

    idx = torch.arange(seq.shape[1])[None, :]
    mask = (seq != 0) & (idx % 5 == 0)
    return torch.where(mask, torch.full_like(seq, 26), seq), torch.where(mask, seq, 0), mask


def _setup():
    """Join the group; → (MeshContext, rank)."""
    import torch

    from druglamp_tpu_torch.losses import masking
    from druglamp_tpu_torch.parallel.distributed import maybe_initialize_distributed
    from druglamp_tpu_torch.parallel.mesh import MeshContext, make_mesh

    torch.set_num_threads(1)
    masking.mlm_mask = fixed_mask
    assert maybe_initialize_distributed("gloo", "cpu")
    mesh = MeshContext(make_mesh(1))
    return mesh, mesh.rank


def _tensors(tree):
    import numpy as np
    import torch

    return {k: _tensors(v) if isinstance(v, dict) else torch.from_numpy(np.asarray(v))
            for k, v in tree.items()}


def job_step(d: str) -> None:
    """``step.pkl``: {"cfg", "lrs" (cls, ssl, cm, margin, w0), "cases": {mode:
    {"bn_groups", "state" (the port state_dict), "batch" (the global compact
    batch; its ``cm`` the whole batch's, or one block a rank)}}}.  For each
    mode: ``loss_gradients`` over the ranks (the global losses and the
    averaged gradients), and the full-gate step (ssl, cm, calibrate) in both
    grad modes; for global mode also ``loss_gradients`` with the statistics
    accumulated in f64 as on a card (``global_f64``) → rank{r}.pkl."""
    import torch

    from druglamp_tpu_torch.data.encoding import decode_batch
    from druglamp_tpu_torch.models.registry import build_model
    from druglamp_tpu_torch.nn import layers
    from druglamp_tpu_torch.train import steps
    from druglamp_tpu_torch.train.state import TrainState

    mesh, rank = _setup()
    with open(os.path.join(d, "step.pkl"), "rb") as f:
        spec = pickle.load(f)
    lr, lr_ssl, lr_cm, margin, w0 = spec["lrs"]
    out = {}
    for mode, case in spec["cases"].items():
        batch = _tensors(case["batch"])
        shard = mesh.shard_batch(batch, whole=("cm",) if case["bn_groups"] == 1 else ())

        def fresh():
            model = build_model("DrugLAMP2C2P", spec["cfg"], spec["nd"], spec["np"],
                                bn_groups=case["bn_groups"])
            model.load_state_dict(case["state"])
            return model

        def loss_gradients():
            model = fresh().train()
            with steps.train_numerics():
                *losses, probs, w, grads = steps.loss_gradients(
                    model, decode_batch(dict(shard)), None, True, True, False, margin,
                    torch.ones(()), mesh=mesh)
            names = [n for n, _ in model.named_parameters()]
            return {"losses": [float(x) for x in losses], "probs": probs.numpy(),
                    "grads": {k: {n: g.numpy() for n, g in zip(names, v)}
                              for k, v in grads.items()}}

        out[mode] = {**loss_gradients(), "steps": {}}
        if mode == "global":
            acc, layers._acc_dtype = layers._acc_dtype, lambda x: torch.float64
            out["global_f64"] = loss_gradients()
            layers._acc_dtype = acc
        for grad_mode in steps.GRAD_MODES:
            model = fresh()
            state = TrainState.create(model, True, True)
            step = steps.make_train_step(model, True, True, calibrate=True, grad_mode=grad_mode,
                                         device="cpu", mesh=mesh)
            o = step(state, shard, None, lr, lr_ssl, lr_cm, margin, w0)
            out[mode]["steps"][grad_mode] = {
                "state": {k: v.numpy().copy() for k, v in model.state_dict().items()},
                "losses": [float(o.cls_loss), float(o.ssl_loss), float(o.cm_loss)],
                "w": float(o.cm_weight), "probs": o.probs.numpy()}
    with open(os.path.join(d, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def job_fit(d: str) -> None:
    """``fit.pkl``: {"cfg", "nd", "np", "seed", "root" (toy CSVs), "cache"
    (an embedding cache), "state" (initial weights), "transports" (of
    gather and host ordinals), "resume"}.  For each transport:
    ``Trainer.run_experiment`` over the ranks in ``<d>/<transport>``, its
    checkpoints' writers counted; then with ``resume`` on the gather
    transport a Trainer from other weights resumes from the epoch-1
    ``ckpt_last.pt`` in ``<d>/resume`` → rank{r}_fit.pkl."""
    import torch

    from druglamp_tpu_torch.data.cache import EmbeddingCache
    from druglamp_tpu_torch.data.dataset import DTIDataset
    from druglamp_tpu_torch.data.device_data import DeviceDataStore
    from druglamp_tpu_torch.data.device_store import DeviceEmbeddingStore
    from druglamp_tpu_torch.data.loader import BatchLoader
    from druglamp_tpu_torch.models.registry import build_model
    from druglamp_tpu_torch.train import trainer as trainer_mod
    from druglamp_tpu_torch.utils.logging import ExperimentLogger

    mesh, rank = _setup()
    with open(os.path.join(d, "fit.pkl"), "rb") as f:
        spec = pickle.load(f)
    cfg = spec["cfg"]
    saves = []
    save = torch.save
    torch.save = lambda obj, path, *a, **k: (saves.append(str(path)), save(obj, path, *a, **k))
    raw_save = trainer_mod.Trainer._save

    def keep_epoch1(self, path, snapshot):
        raw_save(self, path, snapshot)
        if (self.epoch == 1 and os.path.basename(path) == "ckpt_last.pt"
                and os.path.basename(os.path.dirname(path)) == "gather"):
            if self.primary:
                os.makedirs(os.path.join(d, "resume"), exist_ok=True)
                for name in ("ckpt_best.pt", "ckpt_last.pt"):
                    shutil.copy(os.path.join(os.path.dirname(path), name),
                                os.path.join(d, "resume", name))
            mesh.barrier()

    trainer_mod.Trainer._save = keep_epoch1

    kw = dict(max_nodes=cfg.drug.max_nodes, seq_len=cfg.protein.seq_len,
              max_prot_resis=cfg.protein.max_resis)
    train = DTIDataset(spec["root"], "toy", "random", "train.csv", **kw)
    val = DTIDataset(spec["root"], "toy", "random", "val.csv", table=train.table, **kw)
    test = DTIDataset(spec["root"], "toy", "random", "test.csv", table=train.table, **kw)
    cache = EmbeddingCache(spec["cache"], "toy", spec["nd"], spec["np"])
    emb = DeviceEmbeddingStore.build(train.table, cache, max_drug_tokens=cfg.drug.max_nodes,
                                     max_prot_len=cfg.protein.max_resis + 2, device="cpu").tree
    data = DeviceDataStore.build(train.table, cfg.drug.max_nodes, cfg.protein.seq_len, True,
                                 True, device="cpu")
    B = cfg.solver.batch_size

    def trainer(work, device_data):
        loaders = [BatchLoader(ds, B, shuffle=sh, drop_last=sh, seed=cfg.solver.seed,
                               emb_ordinals=True, prefetch=0)
                   for ds, sh in ((train, True), (val, False), (test, False))]
        model = build_model("DrugLAMP2C2P", cfg, spec["nd"], spec["np"])
        log = ExperimentLogger(os.path.dirname(work), os.path.basename(work), quiet=True) \
            if rank == 0 else None
        t = trainer_mod.Trainer(model, cfg, *loaders, logger=log, work_dir=work,
                                embed_store=emb, device_data=device_data, device="cpu",
                                mesh=mesh)
        t.patience = spec["patience"]
        return t, log

    out = {}
    for transport in spec["transports"]:
        device_data = data if transport == "gather" else None
        work = os.path.join(d, transport)
        t, log = trainer(work, device_data)
        before = len(saves)
        test_metrics = t.run_experiment(cfg.solver.seed, state=_load(t, spec["state"]))
        if log is not None:
            log.close()
        out[transport] = {"test": test_metrics, "saves": saves[before:],
                          "state": {k: v.numpy().copy() for k, v in t.model.state_dict().items()}}
    if spec["resume"]:
        # the gather run again from its epoch-1 checkpoint, in a Trainer whose
        # model starts from other weights: epoch 2's parameters in memory
        t, log = trainer(os.path.join(d, "resume"), data)
        state = t.init_state(cfg.solver.seed + 1)
        t.restore(os.path.join(d, "resume", "ckpt_last.pt"), state)
        t.fit(state, cfg.solver.seed, start_epoch=t.epoch + 1)
        if log is not None:
            log.close()
        out["resume"] = {"state": {k: v.numpy().copy() for k, v in t.model.state_dict().items()},
                         "epoch": t.epoch}
    with open(os.path.join(d, f"rank{rank}_fit.pkl"), "wb") as f:
        pickle.dump(out, f)


def _load(t, state):
    """The Trainer's model at ``state`` and the optimizers of its gates."""
    from druglamp_tpu_torch.train.state import TrainState

    t.model.load_state_dict(state)
    return TrainState.create(t.model, t.use_ssl, t.use_cm)


if __name__ == "__main__":
    for job in sys.argv[1].split(","):
        {"step": job_step, "fit": job_fit}[job](sys.argv[2])
