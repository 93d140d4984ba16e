"""Training CLI of the port (flag-compatible with ``druglamp_tpu.cli.main``,
plus ``--device``).

    python -m druglamp_tpu_torch.cli.main --model DrugLAMP --data human \
        --split random --seed 42 [--max_epoch N] [--data-root DIR] [--device cuda|cpu]

It trains, validates, checkpoints (``ckpt_{best,last}.pt`` in the work dir)
and tests on ``--device`` (``cuda`` unless ``cpu`` is asked for; it raises
without a card), through the transport the JAX CLI picks: the device-resident
dataset (``--device-data auto|on``, whenever ``DeviceDataStore.supports`` the
loader: DrugLAMPwoLLM, or every entity's embedding cached), else the host
pipeline (``BatchLoader`` batches with the LLM embeddings, or entity ordinals
into the device embedding store).  ``--eval-only --ckpt <ckpt_best.pt>``
scores a checkpoint of the port on the test split.  ``--gen-embed`` first
writes the frozen encoders' embedding caches (ESM-2 and ChemBERTa,
``encoders/embed_pipeline.py``) for the entity table, from ``--esm-ckpt`` /
``--chemberta-ckpt`` (with ``--chemberta-tokenizer``) or seeded random
weights; ``--gen-embed-only`` stops after them.

Split semantics follow the reference: 'cluster'/'Tcpi' switch to RS-task
mode (source_train.csv for training, target_test.csv for both val and test);
otherwise train/val/test CSVs.

Under torchrun it trains data-parallel over the ranks, one process and one
card a rank (``cuda:LOCAL_RANK``), as the JAX CLI trains over its mesh's
``data`` axis:

    torchrun --nproc-per-node N -m druglamp_tpu_torch.cli.main --model DrugLAMP2C2P ...

The backend is NCCL on cards and gloo on the CPU; ``DRUGLAMP_DIST_BACKEND=
gloo`` with ``--device cuda:0`` puts every rank on one card (for tests: two
ranks sharing a card measure correctness, not speed).  Each global batch of
``solver.batch_size`` splits into contiguous rows, one share a rank.
``--bn-mode global`` (the default) is the single program on the global
batch; ``per_replica`` gives every BatchNorm per-rank statistics and mines
the CM triplets per rank (torch DDP's semantics; the JAX CLI's
``bn_groups``), over the host pipeline.  ``--devices`` is accepted and
changes nothing: the process group sets the data-parallel size.  Rank 0
writes the logs and checkpoints.

``--mesh-model M`` lays the N ranks out as a (data, model) grid of N/M × M
(``parallel/mesh.py::make_mesh``; it raises when N does not divide by M, in
one process too), as the JAX CLI does: the training never shards the model,
so the model axis only narrows the data axis to N/M, the BatchNorm and CM
groups follow N/M, and the M ranks of a data group compute the same rows
and end bit-identical.  ``--gen-embed`` with ``--mesh-model M`` runs ESM-2
column-parallel over each model group when its weights are a seeded random
init (``encoders/sharding.py``); checkpoint weights run replicated, as in
the JAX package.

    torchrun --nproc-per-node 4 -m druglamp_tpu_torch.cli.main --mesh-model 2 ...
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

# ESM-2 layer-count → (ChemBERTa hidden, ESM embed dim), per public ESM-2 size
N_LAYER2DIMS = {
    48: (384, 5120),   # esm2_t48_15B
    36: (384, 2560),   # esm2_t36_3B
    33: (384, 1280),   # esm2_t33_650M
    30: (384, 640),    # esm2_t30_150M (default)
    12: (384, 480),    # esm2_t12_35M
}

DIST_BACKEND_ENV = "DRUGLAMP_DIST_BACKEND"     # nccl | gloo; unset: nccl on cards


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="DrugLAMP (PyTorch) for DTI prediction")
    p.add_argument("--seed", default=42, type=int, help="which seed to use")
    p.add_argument("--no-comet", action="store_true", help="do not use comet.ml")
    p.add_argument("--data", required=True, type=str, metavar="TASK", help="dataset")
    p.add_argument("--model", required=True, type=str,
                   help="which model to do DTI prediction")
    p.add_argument("--n-layer", default=30, type=int, choices=sorted(N_LAYER2DIMS),
                   help="which ESM-2 LLM to use")
    p.add_argument("--split", default="random", type=str, metavar="S",
                   choices=["random", "cold", "cluster", "Tcpi"], help="split task")
    p.add_argument("--devices", type=str, default=None,
                   help="accepted for reference-script compatibility; changes nothing "
                        "(the process group sets the data-parallel size)")
    p.add_argument("--max_epoch", type=int, default=None)
    p.add_argument("--data-root", type=str, default="datasets",
                   help="directory holding <data>/<split>/*.csv")
    p.add_argument("--work-dir", type=str, default=None)
    p.add_argument("--cutoff", type=int, default=None, help="row limit (smoke runs)")
    p.add_argument("--eval-batch-size", type=int, default=None)
    p.add_argument("--mesh-model", type=int, default=1, help="tensor-parallel size")
    p.add_argument("--grad-mode", type=str, default=None,
                   choices=["per_loss", "legacy_aliased"])
    p.add_argument("--scan-chunk", type=int, default=None,
                   help="accepted for the JAX CLI's sake (its lax.scan length); "
                        "the port runs one step call per host batch whatever it is")
    p.add_argument("--bn-mode", type=str, default=None,
                   choices=["global", "per_replica"],
                   help="BN batch-stat scope under DP (per_replica = "
                        "torch-DDP emulation)")
    p.add_argument("--compute-dtype", type=str, default=None,
                   choices=["float32", "bfloat16"],
                   help="model compute dtype (default bfloat16; use float32 "
                        "for reference-parity studies)")
    p.add_argument("--gen-embed", action="store_true",
                   help="generate frozen-encoder embedding caches before training")
    p.add_argument("--gen-embed-only", action="store_true",
                   help="generate the embedding caches for this "
                        "(data, split)'s training entity table, then exit "
                        "without training (cache warm-up for sweeps/bench)")
    p.add_argument("--resume", action="store_true",
                   help="resume from work-dir's last checkpoint if present")
    p.add_argument("--eval-only", action="store_true",
                   help="skip training: restore --ckpt and evaluate the test "
                        "split only (e.g. cross-dataset zero-shot passes on "
                        "splits that ship without train data)")
    p.add_argument("--ckpt", type=str, default=None,
                   help="checkpoint for --eval-only (a trainer ckpt_best.pt or "
                        "ckpt_last.pt)")
    p.add_argument("--allow-zero-embeddings", action="store_true",
                   help="let --eval-only proceed with zero LLM embeddings "
                        "when caches are missing (otherwise it refuses: "
                        "scoring an LLM-stream model on zeros records "
                        "meaningless metrics)")
    p.add_argument("--config", type=str, default=None,
                   help="path to a config YAML (default: the built-in "
                        "configs/<model>.yaml) — same schema as the "
                        "reference's configs")
    p.add_argument("--device-data", type=str,
                   default=os.environ.get("DRUGLAMP_DEVICE_DATA", "auto"),
                   choices=["auto", "on", "off"],
                   help="upload the dataset's compact arrays to the device once "
                        "and gather batches there (data/device_data.py); epochs "
                        "then ship only int32 index arrays.  auto (default) "
                        "enables it whenever the loader config supports it "
                        "(woLLM, or every embedding cached); also settable via "
                        "DRUGLAMP_DEVICE_DATA=on|off")
    p.add_argument("--esm-ckpt", type=str, default=None,
                   help="local ESM-2 checkpoint used by --gen-embed")
    p.add_argument("--chemberta-ckpt", type=str, default=None,
                   help="local ChemBERTa checkpoint used by --gen-embed")
    p.add_argument("--chemberta-tokenizer", type=str, default=None,
                   help="directory with the ChemBERTa checkpoint's HF tokenizer "
                        "files; required with --chemberta-ckpt")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu")
    return p


def resolve_split_files(data_root: str, data: str, split: str, rs_task: bool):
    """(train, val, test) CSV names for a split.

    RS-task splits (cluster/Tcpi) train on source_train.csv and use
    target_test.csv for BOTH val and test.  Some checkouts ship only
    target_train.csv for a cluster split; fall back to it so the shipped
    data runs."""
    if not rs_task:
        return "train.csv", "val.csv", "test.csv"
    train_file = "source_train.csv"
    if not os.path.exists(os.path.join(data_root, data, split, train_file)):
        alt = os.path.join(data_root, data, split, "target_train.csv")
        if os.path.exists(alt):
            print(f"[warn] source_train.csv missing for {data}/{split}; "
                  f"training on target_train.csv", file=sys.stderr)
            train_file = "target_train.csv"
    return train_file, "target_test.csv", "target_test.csv"


def _cache_dir(args, work_dir: str, table) -> str:
    """Embedding-cache directory for a dataset's entity table.

    Cache files are keyed by entity ORDINAL.  full.csv ordinals are stable
    across splits, so the cache is shared per dataset; split-union fallback
    ordinals are split-local, so the cache is namespaced per split (a
    human/cold run must never read human/random's cache)."""
    if args.work_dir:
        return os.path.join(work_dir, "embed_cache")
    name = args.data if table.ordinal_scope == "full" else \
        f"{args.data}-{table.ordinal_scope}"
    return os.path.join(os.path.dirname(work_dir), "embed_cache", name)


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)

    import torch

    from druglamp_tpu_torch.config import builtin_config_path, load_config
    from druglamp_tpu_torch.data.cache import EmbeddingCache, ZeroEmbeddings
    from druglamp_tpu_torch.data.dataset import DTIDataset
    from druglamp_tpu_torch.data.device_data import DeviceDataStore
    from druglamp_tpu_torch.data.device_store import DeviceEmbeddingStore
    from druglamp_tpu_torch.data.loader import BatchLoader
    from druglamp_tpu_torch.models.registry import MODEL_REGISTRY, build_model
    from druglamp_tpu_torch.parallel.distributed import join_group
    from druglamp_tpu_torch.parallel.mesh import MeshContext, make_mesh
    from druglamp_tpu_torch.serve import resolve_device
    from druglamp_tpu_torch.train.trainer import Trainer
    from druglamp_tpu_torch.utils.logging import ExperimentLogger

    if args.model not in MODEL_REGISTRY:
        print(f"error: unknown model {args.model!r}; available: "
              f"{', '.join(sorted(MODEL_REGISTRY))}", file=sys.stderr)
        return 2
    device = resolve_device(join_group(args.device, os.environ.get(DIST_BACKEND_ENV)))
    mesh = MeshContext(make_mesh(args.mesh_model))
    primary = mesh.primary

    overrides = {"solver.seed": args.seed}
    if args.max_epoch:
        overrides["solver.max_epoch"] = args.max_epoch
    if args.eval_batch_size:
        overrides["solver.eval_batch_size"] = args.eval_batch_size
    if args.grad_mode:
        overrides["solver.grad_mode"] = args.grad_mode
    if args.bn_mode:
        overrides["solver.bn_mode"] = args.bn_mode
    if args.scan_chunk is not None:
        overrides["solver.scan_chunk"] = args.scan_chunk
        print("[info] --scan-chunk changes nothing in the port: its host pipeline runs one "
              "step call per batch", file=sys.stderr)
    if args.compute_dtype:
        overrides["solver.compute_dtype"] = args.compute_dtype
    if args.split in ("cluster", "Tcpi"):
        overrides["rs.task"] = True
    cfg = load_config(args.config or builtin_config_path(args.model), overrides)

    np.random.seed(cfg.solver.seed)

    from druglamp_tpu_torch.chem import native

    if not native.available():
        print(native.INFO_NOT_BUILT, file=sys.stderr)

    timestamp = _rank0_value(mesh, time.strftime("%m%d_%H%M%S"))
    exp_name = f"{args.data}-{args.split}-{args.model}-seed{args.seed}-{timestamp}"
    work_dir = args.work_dir or os.path.join(cfg.result.output_dir, exp_name)
    os.makedirs(work_dir, exist_ok=True)

    n_drug_feature, n_prot_feature = N_LAYER2DIMS[args.n_layer]

    kw = dict(max_nodes=cfg.drug.max_nodes, seq_len=cfg.protein.seq_len,
              max_prot_resis=cfg.protein.max_resis, cutoff=args.cutoff)
    if args.eval_only:
        if not args.ckpt:
            print("error: --eval-only requires --ckpt", file=sys.stderr)
            return 2
        test_file = "target_test.csv" if cfg.rs.task else "test.csv"
        test_ds = DTIDataset(args.data_root, args.data, args.split, test_file, **kw)
        return _eval_only(args, cfg, test_ds, work_dir, n_drug_feature, n_prot_feature,
                          device, mesh)
    train_file, val_file, test_file = resolve_split_files(
        args.data_root, args.data, args.split, cfg.rs.task)
    train_ds = DTIDataset(args.data_root, args.data, args.split, train_file, **kw)
    val_ds = DTIDataset(args.data_root, args.data, args.split, val_file,
                        table=train_ds.table, **kw)
    test_ds = val_ds if test_file == val_file else DTIDataset(
        args.data_root, args.data, args.split, test_file, table=train_ds.table, **kw)

    needs_llm = args.model != "DrugLAMPwoLLM" or args.gen_embed_only
    cache_dir = _cache_dir(args, work_dir, train_ds.table)
    if needs_llm:
        cache = EmbeddingCache(cache_dir, args.data, n_drug_feature, n_prot_feature,
                               dtype=torch.bfloat16)
        if args.gen_embed or args.gen_embed_only:
            _gen_embed(args, train_ds.table, cache, device, mesh)
            if primary:
                # the LLM widths' sidecar of the reference's workflow
                # (handler/dataset.py:107-117 writes configs/{n}_layers_params.txt)
                sidecar = os.path.join(work_dir, f"{args.n_layer}_layers_params.txt")
                if not os.path.exists(sidecar):
                    with open(sidecar, "w") as f:
                        f.write(f"{n_drug_feature}\t{n_prot_feature}\n")
            mesh.barrier()
        if args.gen_embed_only:
            print(f"[gen-embed-only] caches written to {cache_dir}; exiting")
            return 0
        missing = [o for o in range(train_ds.table.n_drug) if not cache.has_drug(o)]
        if missing:
            print(f"[warn] {len(missing)} drug embeddings missing from {cache_dir}; "
                  f"using zeros (run with --gen-embed to populate)", file=sys.stderr)
            embeddings = ZeroEmbeddings(n_drug_feature, n_prot_feature)
        else:
            embeddings = cache
    else:
        embeddings = ZeroEmbeddings(n_drug_feature, n_prot_feature)

    # the frozen embeddings on the device once, batches carrying ordinals;
    # host-shipped embeddings when over its budget or with no cache
    store = None
    if needs_llm and not isinstance(embeddings, ZeroEmbeddings):
        store = DeviceEmbeddingStore.build(train_ds.table, embeddings,
                                           max_drug_tokens=cfg.drug.max_nodes,
                                           max_prot_len=cfg.protein.max_resis + 2,
                                           device=device)
        if store is None:
            print("[info] embedding store over its device budget; shipping "
                  "embeddings from the host per batch", file=sys.stderr)

    bs = cfg.solver.batch_size
    eval_bs = cfg.solver.eval_batch_size
    use_ords = store is not None
    train_loader = BatchLoader(train_ds, bs, shuffle=True, drop_last=True,
                               embeddings=embeddings, seed=cfg.solver.seed,
                               include_llm=needs_llm, emb_ordinals=use_ords)
    val_loader = BatchLoader(val_ds, eval_bs, shuffle=False, drop_last=False,
                             embeddings=embeddings, include_llm=needs_llm,
                             emb_ordinals=use_ords)
    test_loader = BatchLoader(test_ds, eval_bs, shuffle=False, drop_last=False,
                              embeddings=embeddings, include_llm=needs_llm,
                              emb_ordinals=use_ords)

    # per_replica: torch DDP's per-rank BatchNorm statistics and CM mining
    bn_groups = mesh.n_data if cfg.solver.bn_mode == "per_replica" else 1
    model = build_model(args.model, cfg, n_drug_feature, n_prot_feature, bn_groups=bn_groups)
    for loader in (train_loader, val_loader, test_loader):
        loader.cm_groups = bn_groups

    device_data = None
    if args.device_data in ("auto", "on"):
        if DeviceDataStore.supports(train_loader):
            device_data = DeviceDataStore.build(train_ds.table, cfg.drug.max_nodes,
                                                cfg.protein.seq_len, include_llm=needs_llm,
                                                emb_ordinals=use_ords, device=device)
            print(f"[info] device-resident dataset: "
                  f"{device_data.nbytes() / 1e6:.0f} MB uploaded", file=sys.stderr)
        elif args.device_data == "on":
            print("[info] --device-data on: unsupported loader config "
                  "(dense LLM batches or grouped CM); using the host pipeline", file=sys.stderr)

    # explicit --work-dir: keep every artifact (metrics.jsonl included) under it
    log_root, log_name = ((os.path.dirname(work_dir) or ".", os.path.basename(work_dir))
                          if args.work_dir else (cfg.result.output_dir, exp_name))
    logger = None if not primary else ExperimentLogger(
        log_root, log_name,
        hyperparams={"model": args.model, "data": args.data, "split": args.split,
                     "seed": args.seed, "batch_size": bs,
                     "max_epoch": cfg.solver.max_epoch, "lr": cfg.solver.lr,
                     "ssl": cfg.rs.ssl, "cm": cfg.rs.cm,
                     "device_data": device_data is not None,
                     "train_csv": train_file, "ranks": mesh.n_data,
                     "bn_mode": cfg.solver.bn_mode},
        use_comet=cfg.comet.use and not args.no_comet,
        comet_cfg={"project_name": cfg.comet.project_name,
                   "workspace": cfg.comet.workspace})

    trainer = Trainer(model, cfg, train_loader, val_loader, test_loader,
                      logger=logger, work_dir=work_dir,
                      embed_store=store.tree if store is not None else None,
                      device_data=device_data, device=device, mesh=mesh)
    metrics = trainer.run_experiment(seed=cfg.solver.seed, resume=args.resume)
    if primary:
        print({f"test_{k}": round(v, 5) for k, v in metrics.items()})
        logger.close()
    return 0


def _rank0_value(mesh, value):
    """Rank 0's ``value`` on every rank of the grid (one work dir for the
    whole run)."""
    if mesh.n_data * mesh.n_model == 1:
        return value
    import torch.distributed as dist

    box = [value]
    dist.broadcast_object_list(box, src=0, group=mesh.mesh.world)
    return box[0]


def _gen_embed(args, table, cache, device, mesh) -> None:
    """The frozen encoders' caches for ``table``'s entities (the JAX CLI's
    call: seed 0, f32), on every rank of the grid: rank 0 writes them (its
    model group runs ESM-2 tensor-parallel, ``generate_embeddings``), the
    others wait at a barrier."""
    from druglamp_tpu_torch.encoders.embed_pipeline import generate_embeddings

    generate_embeddings(table, cache, n_layer=args.n_layer, esm_ckpt=args.esm_ckpt,
                        chemberta_ckpt=args.chemberta_ckpt,
                        chemberta_tokenizer=args.chemberta_tokenizer, device=device,
                        mesh=mesh)
    mesh.barrier()


def _eval_only(args, cfg, test_ds, work_dir, n_drug_feature, n_prot_feature, device,
               mesh) -> int:
    """Restore a checkpoint of the port and score the test split through the
    host pipeline (no training; over several ranks each scores its rows and
    rank 0 writes the record)."""
    from druglamp_tpu_torch.data.cache import EmbeddingCache, ZeroEmbeddings
    from druglamp_tpu_torch.data.loader import BatchLoader
    from druglamp_tpu_torch.models.registry import build_model
    from druglamp_tpu_torch.train.trainer import Trainer

    needs_llm = args.model != "DrugLAMPwoLLM"
    if needs_llm:
        cache_dir = _cache_dir(args, work_dir, test_ds.table)
        cache = EmbeddingCache(cache_dir, args.data, n_drug_feature, n_prot_feature)
        if args.gen_embed:
            _gen_embed(args, test_ds.table, cache, device, mesh)
        have_all = (all(cache.has_drug(o) for o in range(test_ds.table.n_drug))
                    and all(cache.has_prot(o) for o in range(test_ds.table.n_prot)))
        if not have_all and not args.allow_zero_embeddings:
            # an LLM-stream model scored on zero embeddings records
            # meaningless metrics as results: refuse unless explicitly asked
            print(f"error: embedding caches missing from {cache_dir}; run with --gen-embed "
                  f"to populate them, or pass --allow-zero-embeddings to proceed anyway",
                  file=sys.stderr)
            return 3
        embeddings = cache if have_all else ZeroEmbeddings(n_drug_feature, n_prot_feature)
        if not have_all:
            print(f"[warn] embeddings missing from {cache_dir}; using zeros", file=sys.stderr)
    else:
        embeddings = ZeroEmbeddings(n_drug_feature, n_prot_feature)

    test_loader = BatchLoader(test_ds, cfg.solver.eval_batch_size, shuffle=False,
                              drop_last=False, embeddings=embeddings, include_llm=needs_llm)
    model = build_model(args.model, cfg, n_drug_feature, n_prot_feature)
    trainer = Trainer(model, cfg, test_loader, test_loader, test_loader, work_dir=work_dir,
                      device=device, mesh=mesh)
    state = trainer.init_state(seed=cfg.solver.seed)
    if not os.path.exists(args.ckpt):
        print(f"error: checkpoint {args.ckpt!r} not found", file=sys.stderr)
        return 2
    state = trainer.restore(os.path.abspath(args.ckpt), state, load_host=False)
    metrics = trainer.evaluate(state, test_loader, full=True)
    record = {f"test_{k}": round(v, 5) for k, v in metrics.items()}
    if mesh.primary:
        print(record)
        write_eval_record(args, record, n_rows=len(test_ds))
    return 0


def write_eval_record(args, record: dict, n_rows: int, results_root: str = "results") -> str:
    """Persist an --eval-only result as a results/ metrics.jsonl artifact:
    the eval_only event, the metrics, and a terminal done event."""
    out_dir = os.path.join(
        results_root, f"{args.data}-{args.split}-{args.model}-seed{args.seed}"
        f"-eval-{time.strftime('%m%d_%H%M%S')}")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "metrics.jsonl"), "w") as f:
        f.write(json.dumps({"event": "eval_only", "model": args.model,
                            "data": args.data, "split": args.split,
                            "ckpt": os.path.abspath(args.ckpt),
                            "n_rows": n_rows}) + "\n")
        f.write(json.dumps(record) + "\n")
        f.write(json.dumps({"event": "done", "mode": "eval_only"}) + "\n")
    return out_dir


if __name__ == "__main__":
    s = time.time()
    rc = main()
    print(f"Total running time: {round(time.time() - s, 2)}s")
    import torch.distributed as dist

    if dist.is_initialized():          # a rank under torchrun leaves its group
        dist.destroy_process_group()
    sys.exit(rc)
