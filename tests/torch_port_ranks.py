"""The rank processes of tests/test_torch_port_parallel.py,
tests/test_torch_port_tensor_parallel.py, tests/test_torch_port_flat_opt.py,
tests/test_torch_port_checkpoint_chunks.py and tests/test_torch_port_remat.py:
each job runs in every rank of a gloo process group on the CPU, started as
torchrun starts them
(``run_ranks``), and reads its inputs from and writes its results to a
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
            self._join_ckpt()              # the write done, and its barrier passed
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


# --- the model axis (tests/test_torch_port_tensor_parallel.py) ----------------------------

def _grid(mesh):
    """The grid as this rank sees it: its place and its groups' ranks."""
    import torch.distributed as dist

    m = mesh.mesh
    ranks = (lambda g: list(range(dist.get_world_size())) if g is None
             else dist.get_process_group_ranks(g))
    return {"n_data": m.n_data, "rank": m.rank, "n_model": m.n_model,
            "model_rank": m.model_rank, "primary": mesh.primary,
            "data_group": ranks(m.group),
            "model_group": ranks(m.model_group) if m.n_model > 1 else None}


def _np(tree):
    return {k: v.detach().numpy().copy() for k, v in tree.items()}


def _loss_grads(model, batch, gen_seed, use_ssl, use_cm, mesh=None, gather=None):
    """``steps.loss_gradients`` (calibration off) → (losses, {loss: {name:
    whole gradient}}); a sharded model's gradients gathered by ``gather``."""
    import torch

    from druglamp_tpu_torch.data.encoding import decode_batch
    from druglamp_tpu_torch.train import steps

    gen = None if gen_seed is None else torch.Generator().manual_seed(gen_seed)
    model.train()
    with steps.train_numerics():
        *losses, _, _, grads = steps.loss_gradients(model, decode_batch(dict(batch)), gen,
                                                    use_ssl, use_cm, False, 0.5, torch.ones(()),
                                                    mesh=mesh)
    names = [n for n, _ in model.named_parameters()]
    out = {}
    for loss, gs in grads.items():
        named = dict(zip(names, gs))
        out[loss] = _np(gather(model, values=named) if gather is not None else named)
    return [float(x) for x in losses], out


def _moments(model, state, gather=None):
    """{optimizer: {"exp_avg" | "exp_avg_sq": {name: the whole moment}}} of
    the AdamWs of ``state`` (a TrainState over ``model``); a sharded model's
    moments gathered by ``gather``."""
    out = {}
    for opt_name in ("opt_cls", "opt_ssl", "opt_cm"):
        opt = getattr(state, opt_name)
        if opt is None:
            continue
        out[opt_name] = {}
        for key in ("exp_avg", "exp_avg_sq"):
            named = {n: opt.state[p][key] for n, p in model.named_parameters()}
            out[opt_name][key] = _np(gather(model, values=named) if gather is not None
                                     else named)
    return out


def job_tp(d: str) -> None:
    """``tp.pkl``: {"n_model", "cfg" (dropout on), "cfg0" (dropout 0), "nd",
    "np", "batch" (a compact batch with its CM ground truth), "lrs",
    "jax_params", "jax_stats" (the JAX reference's flax trees, for cfg0),
    "esm" (tiny ESM-2 configs by name), "esm_tokens"} on a 1 × 2 grid: the
    grid; ``build_model(mesh=)`` then ``gather_params`` against the whole
    model; the cls and full-gate ``loss_gradients`` with dropout on, sharded
    and in one process (gradients gathered); one full-gate step both ways in
    each grad mode, its parameters and AdamW moments gathered; in each grad
    mode two full-gate steps, the second after ``shard_state`` (one process:
    both whole); the cls step from the JAX weights at dropout 0; each
    ESM-2 whole and column-parallel, and ``generate_embeddings`` over the
    grid into ``<d>/cache`` → rank{r}_tp.pkl."""
    import types

    import numpy as np
    import torch

    from druglamp_tpu_torch.convert import from_jax_params, load_jax_params_sharded
    from druglamp_tpu_torch.encoders import embed_pipeline, esm2
    from druglamp_tpu_torch.encoders.chemberta import ChemBERTaConfig
    from druglamp_tpu_torch.encoders.layers import seeded_state
    from druglamp_tpu_torch.encoders.sharding import shard_encoder
    from druglamp_tpu_torch.data.cache import EmbeddingCache
    from druglamp_tpu_torch.losses import masking
    from druglamp_tpu_torch.models.registry import build_model
    from druglamp_tpu_torch.parallel.distributed import maybe_initialize_distributed
    from druglamp_tpu_torch.parallel.mesh import MeshContext, make_mesh
    from druglamp_tpu_torch.train import steps
    from druglamp_tpu_torch.train.state import TrainState

    torch.set_num_threads(1)
    masking.mlm_mask = fixed_mask
    assert maybe_initialize_distributed("gloo", "cpu")
    with open(os.path.join(d, "tp.pkl"), "rb") as f:
        spec = pickle.load(f)
    mesh = MeshContext(make_mesh(spec["n_model"]))
    out = {"grid": _grid(mesh)}
    cfg, nd, npf = spec["cfg"], spec["nd"], spec["np"]
    batch = _tensors(spec["batch"])
    lr, lr_ssl, lr_cm, margin, w0 = spec["lrs"]

    def model(c=cfg, sharded=True):
        m = build_model("DrugLAMP2C2P", c, nd, npf, generator=torch.Generator().manual_seed(0))
        if sharded:
            out.setdefault("split", mesh.shard_params(m))
        return m

    whole = _np(model(sharded=False).state_dict())
    tp = model()
    out["local_shapes"] = {k: tuple(v.shape) for k, v in tp.state_dict().items()}
    out["roundtrip"] = [k for k, v in mesh.gather_params(tp).items()
                        if not np.array_equal(v.numpy(), whole[k])]
    for gate, (use_ssl, use_cm) in (("cls", (False, False)), ("full", (True, True))):
        out[gate] = {"tp": _loss_grads(model(), batch, 5, use_ssl, use_cm,
                                       gather=mesh.gather_params),
                     "one": _loss_grads(model(sharded=False), batch, 5, use_ssl, use_cm)}
    out["step"] = {}
    for grad_mode in steps.GRAD_MODES:
        runs = out["step"][grad_mode] = {}
        for name, sharded in (("tp", True), ("one", False)):
            m = model(sharded=sharded)
            step = steps.make_train_step(m, True, True, calibrate=True, grad_mode=grad_mode,
                                         device="cpu")
            state = TrainState.create(m, True, True)
            o = step(state, batch, torch.Generator().manual_seed(5), lr, lr_ssl, lr_cm, margin, w0)
            gather = mesh.gather_params if sharded else None
            runs[name] = {"local": _np(m.state_dict()), "losses": [float(o.cls_loss),
                          float(o.ssl_loss), float(o.cm_loss)], "w": float(o.cm_weight),
                          "whole": _np(mesh.gather_params(m)) if sharded else None,
                          "moments": _moments(m, state, gather)}
    # a state that already holds moments, sharded between two steps
    out["shard_state"] = {}
    for grad_mode in steps.GRAD_MODES:
        runs = out["shard_state"][grad_mode] = {}
        for name in ("tp", "one"):
            m = model(sharded=False)
            state = TrainState.create(m, True, True)
            step = steps.make_train_step(m, True, True, calibrate=True, grad_mode=grad_mode,
                                         device="cpu")
            o = step(state, batch, torch.Generator().manual_seed(5), lr, lr_ssl, lr_cm, margin, w0)
            first = _np(m.state_dict())
            if name == "tp":
                runs["split"] = mesh.shard_state(m, state)
            o = step(state, batch, torch.Generator().manual_seed(6), lr, lr_ssl, lr_cm, margin,
                     float(o.cm_weight))
            gather = mesh.gather_params if name == "tp" else None
            runs[name] = {"first": first, "local": _np(m.state_dict()),
                          "whole": _np(gather(m)) if gather is not None else None,
                          "losses": [float(o.cls_loss), float(o.ssl_loss), float(o.cm_loss)],
                          "moments": _moments(m, state, gather)}
    jax_cls = {}
    for name, sharded in (("tp", True), ("one", False)):
        m = model(spec["cfg0"], sharded=False)
        if sharded:
            load_jax_params_sharded(spec["jax_params"], spec["jax_stats"], m, mesh)
        else:
            m.load_state_dict(from_jax_params(spec["jax_params"], spec["jax_stats"], m))
        step = steps.make_train_step(m, False, False, device="cpu")
        o = step(TrainState.create(m), _tensors(spec["jax_batch"]), None, lr)
        jax_cls[name] = float(o.cls_loss)
    out["jax_cls"] = jax_cls

    tokens = torch.from_numpy(spec["esm_tokens"])
    out["esm"] = {}
    for name, kw in spec["esm"].items():
        enc = esm2.ESM2(esm2.ESM2Config(**kw))
        enc.load_state_dict(seeded_state(enc, 0))
        with torch.inference_mode():
            ref = enc(tokens).numpy()
            split = shard_encoder(enc, mesh)
            got = enc(tokens).numpy()
        out["esm"][name] = {"one": ref, "tp": got, "split": split}
    esm2._ESM2_SIZES[12] = esm2.ESM2Config(**spec["esm"]["heads"])
    embed_pipeline._BUCKETS, embed_pipeline._DRUG_BUCKETS = (48,), (32,)
    table = types.SimpleNamespace(prot2ord=spec["proteins"], drug2ord=spec["drugs"])
    cache = EmbeddingCache(os.path.join(d, "cache"), "toy", nd, 32)
    embed_pipeline.generate_embeddings(table, cache, n_layer=12, device="cpu", verbose=False,
                                       chemberta_cfg=ChemBERTaConfig(**spec["chemberta"]),
                                       mesh=mesh)
    mesh.barrier()
    with open(os.path.join(d, f"rank{torch.distributed.get_rank()}_tp.pkl"), "wb") as f:
        pickle.dump(out, f)


def job_tp4(d: str) -> None:
    """``tp4.pkl``: {"cfg0" (dropout 0), "nd", "np", "cases": {mode:
    {"bn_groups", "batch" (the global compact batch; its ``cm`` the whole
    batch's, or one block a data rank)}}, "esm", "proteins", "drugs",
    "chemberta" (as ``tp.pkl``'s)} on a 2 × 2 grid: the grid; for each mode
    ``loss_gradients`` over the grid (gradients gathered over the model
    ranks) and in one process on the whole batch, and the local state after
    one full-gate step over the grid; ``generate_embeddings`` over the grid
    into ``<d>/cache``, the ESM-2 models each rank built counted →
    rank{r}_tp4.pkl."""
    import types

    import torch

    from druglamp_tpu_torch.data.cache import EmbeddingCache
    from druglamp_tpu_torch.encoders import embed_pipeline, esm2
    from druglamp_tpu_torch.encoders.chemberta import ChemBERTaConfig
    from druglamp_tpu_torch.losses import masking
    from druglamp_tpu_torch.models.registry import build_model
    from druglamp_tpu_torch.parallel.distributed import maybe_initialize_distributed
    from druglamp_tpu_torch.parallel.mesh import MeshContext, make_mesh
    from druglamp_tpu_torch.train import steps
    from druglamp_tpu_torch.train.state import TrainState

    torch.set_num_threads(1)
    masking.mlm_mask = fixed_mask
    assert maybe_initialize_distributed("gloo", "cpu")
    with open(os.path.join(d, "tp4.pkl"), "rb") as f:
        spec = pickle.load(f)
    mesh = MeshContext(make_mesh(2))
    out = {"grid": _grid(mesh)}
    for mode, case in spec["cases"].items():
        groups = case["bn_groups"]
        batch = _tensors(case["batch"])
        shard = mesh.shard_batch(batch, whole=("cm",) if groups == 1 else ())

        def model(sharded=True):
            return build_model("DrugLAMP2C2P", spec["cfg0"], spec["nd"], spec["np"],
                               generator=torch.Generator().manual_seed(0), bn_groups=groups,
                               mesh=mesh if sharded else None)

        res = {"tp": _loss_grads(model(), shard, None, True, True, mesh=mesh,
                                 gather=mesh.gather_params)}
        if torch.distributed.get_rank() == 0:
            res["one"] = _loss_grads(model(False), batch, None, True, True)
        m = model()
        step = steps.make_train_step(m, True, True, calibrate=True, device="cpu", mesh=mesh)
        step(TrainState.create(m, True, True), shard, None, 1e-3, 1e-3, 1e-3, 0.5, 1.0)
        res["local"] = _np(m.state_dict())
        out[mode] = res
    built = []

    class CountedESM2(esm2.ESM2):
        def __init__(self, *a, **k):
            built.append(1)
            super().__init__(*a, **k)

    embed_pipeline.ESM2 = CountedESM2
    esm2._ESM2_SIZES[12] = esm2.ESM2Config(**spec["esm"]["heads"])
    embed_pipeline._BUCKETS, embed_pipeline._DRUG_BUCKETS = (48,), (32,)
    table = types.SimpleNamespace(prot2ord=spec["proteins"], drug2ord=spec["drugs"])
    cache = EmbeddingCache(os.path.join(d, "cache"), "toy", spec["nd"], 32)
    embed_pipeline.generate_embeddings(table, cache, n_layer=12, device="cpu", verbose=False,
                                       chemberta_cfg=ChemBERTaConfig(**spec["chemberta"]),
                                       mesh=mesh)
    mesh.barrier()
    out["esm_built"] = len(built)
    with open(os.path.join(d, f"rank{torch.distributed.get_rank()}_tp4.pkl"), "wb") as f:
        pickle.dump(out, f)


# --- the flat AdamW and the checkpoint writes over ranks --------------------------

def _flat_moments(model, state, gather=None):
    """``_moments`` of a TrainState of ``FlatAdamW``s: {optimizer: {"exp_avg"
    | "exp_avg_sq": {name: moment}}}, each buffer unraveled by the
    parameters' (local) shapes; a sharded model's gathered by ``gather``."""
    out = {}
    named = list(model.named_parameters())
    for opt_name in ("opt_cls", "opt_ssl", "opt_cm"):
        opt = getattr(state, opt_name)
        if opt is None:
            continue
        out[opt_name] = {}
        for key, buf in (("exp_avg", opt.m), ("exp_avg_sq", opt.v)):
            parts = buf.split([p.numel() for _, p in named])
            leaves = {n: t.view(p.shape) for (n, p), t in zip(named, parts)}
            out[opt_name][key] = _np(gather(model, values=leaves) if gather is not None
                                     else leaves)
    return out


def job_flat_tp(d: str) -> None:
    """``flat_tp.pkl``: {"cfg", "nd", "np", "batch", "lrs"} on a 1 × 2 grid:
    in each grad mode two full-gate steps with ``FlatAdamW``s from seeded
    weights, in one process and with ``MeshContext.shard_state`` between
    them → rank{r}_flat_tp.pkl: the split, the first step's parameters, and
    after the second the parameters (local and gathered), the losses and
    the moments (gathered)."""
    import torch

    from druglamp_tpu_torch.models.registry import build_model
    from druglamp_tpu_torch.parallel.distributed import maybe_initialize_distributed
    from druglamp_tpu_torch.parallel.mesh import MeshContext, make_mesh
    from druglamp_tpu_torch.losses import masking
    from druglamp_tpu_torch.train import steps
    from druglamp_tpu_torch.train.state import FlatAdamW, TrainState

    torch.set_num_threads(1)
    masking.mlm_mask = fixed_mask
    assert maybe_initialize_distributed("gloo", "cpu")
    with open(os.path.join(d, "flat_tp.pkl"), "rb") as f:
        spec = pickle.load(f)
    mesh = MeshContext(make_mesh(2))
    batch = _tensors(spec["batch"])
    lr, lr_ssl, lr_cm, margin, w0 = spec["lrs"]
    out = {}
    for grad_mode in steps.GRAD_MODES:
        runs = out[grad_mode] = {}
        for name in ("tp", "one"):
            m = build_model("DrugLAMP2C2P", spec["cfg"], spec["nd"], spec["np"],
                            generator=torch.Generator().manual_seed(0))
            state = TrainState.create(m, True, True, flat_opt=True)
            assert isinstance(state.opt_cls, FlatAdamW)
            step = steps.make_train_step(m, True, True, calibrate=True, grad_mode=grad_mode,
                                         device="cpu")
            o = step(state, batch, torch.Generator().manual_seed(5), lr, lr_ssl, lr_cm, margin, w0)
            first = _np(m.state_dict())
            if name == "tp":
                runs["split"] = mesh.shard_state(m, state)
            o = step(state, batch, torch.Generator().manual_seed(6), lr, lr_ssl, lr_cm, margin,
                     float(o.cm_weight))
            gather = mesh.gather_params if name == "tp" else None
            runs[name] = {"first": first, "local": _np(m.state_dict()),
                          "whole": _np(gather(m)) if gather is not None else None,
                          "losses": [float(o.cls_loss), float(o.ssl_loss), float(o.cm_loss)],
                          "moments": _flat_moments(m, state, gather),
                          "count": int(state.opt_cls.count)}
    with open(os.path.join(d, f"rank{torch.distributed.get_rank()}_flat_tp.pkl"), "wb") as f:
        pickle.dump(out, f)


def job_ckpt(d: str) -> None:
    """``ckpt.pkl``: {"cfg", "nd", "np", "delay"}: a Trainer over the ranks
    saves a checkpoint whose write on rank 0 starts ``delay`` seconds late,
    asynchronously then with ``DRUGLAMP_SYNC_CKPT=1``; each rank notes
    whether the file is there when ``_save`` returns and after
    ``_join_ckpt``, then restores it → rank{r}_ckpt.pkl."""
    import types

    import torch

    from druglamp_tpu_torch.models.registry import build_model
    from druglamp_tpu_torch.train import trainer as trainer_mod
    from druglamp_tpu_torch.train.state import TrainState

    mesh, rank = _setup()
    with open(os.path.join(d, "ckpt.pkl"), "rb") as f:
        spec = pickle.load(f)
    write = trainer_mod._write_checkpoint

    def late_write(payload, path):
        time.sleep(spec["delay"])
        write(payload, path)

    trainer_mod._write_checkpoint = late_write
    loader = types.SimpleNamespace(batch_size=4)
    out = {}
    for label, sync in (("async", "0"), ("sync", "1")):
        os.environ["DRUGLAMP_SYNC_CKPT"] = sync
        model = build_model("DrugLAMP2C2P", spec["cfg"], spec["nd"], spec["np"],
                            generator=torch.Generator().manual_seed(0))
        t = trainer_mod.Trainer(model, spec["cfg"], loader, loader, loader,
                                work_dir=os.path.join(d, label), device="cpu", mesh=mesh)
        state = TrainState.create(model, True, True)
        path = os.path.join(d, label, "ckpt_last.pt")
        t._save(path, t._snapshot(state))
        after_save = os.path.exists(path)
        t._join_ckpt()
        after_join = os.path.exists(path)
        t.restore(path, state)
        out[label] = {"after_save": after_save, "after_join": after_join,
                      "pending": t._ckpt_write is not None or t._ckpt_owed}
    with open(os.path.join(d, f"rank{rank}_ckpt.pkl"), "wb") as f:
        pickle.dump(out, f)


def job_remat(d: str) -> None:
    """One full-gate step (ssl, cm, calibrate) of a seeded tiny DrugLAMP2C2P,
    dropout 0.1 and the MLM mask drawn from the step's generator, under
    ``DRUGLAMP_REMAT=none`` and ``=full``: over the two ranks as data ranks
    (this rank's rows of a batch of 8, global BatchNorm; key "data") and as
    one model axis (the whole batch, the model sharded by
    ``MeshContext.shard_params``; key "model") → rank{r}_remat.pkl: {key:
    {"differ": the parts of the full step (outputs, this rank's parameters
    and buffers, AdamW moments, the generator's state) that are not none's,
    "losses": none's, "recomputed": the checkpoint frames the full step
    made}}."""
    import numpy as np
    import torch
    import torch.utils.checkpoint as torch_checkpoint

    from druglamp_tpu_torch.data.encoding import compact_batch
    from druglamp_tpu_torch.data.loader import build_cm_arrays
    from druglamp_tpu_torch.losses import masking
    from druglamp_tpu_torch.models.registry import build_model
    from druglamp_tpu_torch.parallel.mesh import MeshContext, make_mesh
    from druglamp_tpu_torch.train import steps
    from druglamp_tpu_torch.train.state import TrainState
    from druglamp_tpu_torch.utils.synthetic import make_batch, tiny_config

    drawn = masking.mlm_mask
    mesh, rank = _setup()
    masking.mlm_mask = drawn
    frames = []
    init = torch_checkpoint._CheckpointFrame.__init__

    def record(frame, *a, **k):
        init(frame, *a, **k)
        frames.append(1)

    torch_checkpoint._CheckpointFrame.__init__ = record
    cfg = tiny_config(n_hidden=16, max_nodes=32, site_seq=16, pmma_dropout=0.1)
    host = make_batch(cfg, 8, seed=3, n_drug_feature=24, n_prot_feature=40)
    batch = compact_batch(host, (host["d_fill"] == 0).sum(1))
    t = np.arange(8)
    pid, did = t % 3, t % 4
    batch["labels"] = ((t % 2 == 0) & (pid != 2)).astype(np.float32)
    batch["cm"] = build_cm_arrays(pid, did, batch["labels"])
    axis = MeshContext(make_mesh(2))          # the same two ranks as a model axis
    out = {}
    for key, rows, step_mesh, shard_mesh in (
            ("data", mesh.shard_batch(_tensors(batch), whole=("cm",)), mesh, None),
            ("model", _tensors(batch), None, axis)):
        runs = {}
        for mode in ("none", "full"):
            os.environ["DRUGLAMP_REMAT"] = mode
            model = build_model("DrugLAMP2C2P", cfg, 24, 40,
                                generator=torch.Generator().manual_seed(0))
            if shard_mesh is not None:
                shard_mesh.shard_params(model)
            state = TrainState.create(model, True, True, flat_opt=False)
            step = steps.make_train_step(model, True, True, calibrate=True, device="cpu",
                                         mesh=step_mesh)
            gen = torch.Generator().manual_seed(5)
            o = step(state, rows, gen, 1e-3, 1e-3, 1e-3, 0.5, 1e-3)
            parts = {f"output {k}": getattr(o, k) for k in ("cls_loss", "ssl_loss", "cm_loss",
                                                             "probs", "cm_weight")}
            parts.update(model.state_dict())
            parts.update({f"{n} {opt_name} {k}": v
                          for opt_name in ("opt_cls", "opt_ssl", "opt_cm")
                          for n, p in model.named_parameters()
                          for k, v in getattr(state, opt_name).state[p].items()})
            parts["generator"] = gen.get_state()
            runs[mode] = (parts, len(frames))
            frames.clear()
        (a, _), (b, n_frames) = runs["none"], runs["full"]
        out[key] = {"differ": [k for k in a if not torch.equal(a[k], b[k])],
                    "losses": [float(a[f"output {k}"]) for k in ("cls_loss", "ssl_loss",
                                                                 "cm_loss")],
                    "recomputed": n_frames}
    with open(os.path.join(d, f"rank{rank}_remat.pkl"), "wb") as f:
        pickle.dump(out, f)


if __name__ == "__main__":
    for job in sys.argv[1].split(","):
        {"step": job_step, "fit": job_fit, "tp": job_tp, "tp4": job_tp4, "flat_tp": job_flat_tp,
         "ckpt": job_ckpt, "remat": job_remat}[job](sys.argv[2])
