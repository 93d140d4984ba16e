"""The port's training CLI (druglamp_tpu_torch/cli/main.py) and sweep
(cli/sweep.py) against the JAX package's, on the CPU.

- The parser takes every option of ``druglamp_tpu.cli.main.build_argparser``
  with the same flags, defaults, choices, types and actions (compared
  programmatically; ``--data-root`` defaults to ``datasets`` under the
  working directory in place of the JAX CLI's one mount point), plus
  ``--device`` (default ``cuda``).
- ``resolve_split_files``, ``_cache_dir`` and ``write_eval_record`` give the
  JAX package's outputs.
- ``--mesh-model`` > 1 (tensor parallelism) raises NotImplementedError
  naming its slice; ``--devices`` and ``--bn-mode per_replica`` run (over
  several ranks: tests/test_torch_port_parallel.py); ``--device cuda``
  raises without a card.
- ``main`` at a tiny ``--config`` on a CSV dataset written here, ``--device
  cpu``, in the three transports the JAX CLI picks: no cache (host batches
  with zero LLM arrays), a seeded cache with ``--device-data off`` (host
  batches of ordinals into the device store) and with ``--device-data auto``
  (the device-resident dataset).  Each run's metrics.jsonl equals a direct
  ``Trainer`` run with the same settings (times aside), and the two cached
  runs equal each other.
- ``--eval-only`` on a run's ``ckpt_best.pt`` reproduces the run's test
  metrics (with the cache, and with zeros under ``--allow-zero-embeddings``),
  and refuses missing embeddings with rc 3.
- The frozen encoders through the CLI (ESM-2 at 2 layers and ChemBERTa at 3,
  the LLM widths of ``--n-layer 12``): ``--gen-embed-only`` from checkpoint
  files writes the caches and sidecar the JAX CLI writes (values within
  2e-5) and trains nothing, for every model; ``--gen-embed`` then trains on
  them and a second call generates nothing; ``--eval-only --gen-embed``
  fills the test table's caches; a real ChemBERTa checkpoint without its
  tokenizer, or with a tokenizer too large for it, raises as the JAX CLI
  does.
- The sweep's retries, watchdog and summary, as tests/test_cli.py holds the
  JAX sweep to them, against the port's module; both modes start the port's
  CLI.
"""

import json
import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from druglamp_tpu.cli import main as jcli
from druglamp_tpu_torch.cli import main as cli
from druglamp_tpu_torch.cli import sweep
from druglamp_tpu_torch.config import load_config
from druglamp_tpu_torch.data.cache import EmbeddingCache, ZeroEmbeddings
from druglamp_tpu_torch.data.dataset import DTIDataset
from druglamp_tpu_torch.data.device_data import DeviceDataStore
from druglamp_tpu_torch.data.device_store import DeviceEmbeddingStore
from druglamp_tpu_torch.data.loader import BatchLoader
from druglamp_tpu_torch.models.registry import build_model
from druglamp_tpu_torch.train.trainer import Trainer
from druglamp_tpu_torch.utils.logging import ExperimentLogger
from tests.test_torch_port_trainer import _records, _toy_dataset

torch.set_num_threads(1)

TINY_YAML = """MODEL: {N_HIDDEN: 16, PMMA_DROPOUT: 0.1}
DRUG: {MAX_NODES: 32}
PROTEIN: {SEQ_LEN: 144, MAX_RESIS: 40}
DECODER: {IN_DIM: 32, HIDDEN_DIM: 64, OUT_DIM: 32}
SOLVER: {BATCH_SIZE: 4, EVAL_BATCH_SIZE: 4, MAX_EPOCH: 2, LR: 1e-3, SSL_LR: 1e-3, CM_LR: 1e-3,
         COMPUTE_DTYPE: float32}
RS: {SSL: True, CM: True, INIT_EPOCH: 2, EPOCH_STEP: 2}
"""
N_LAYER = 12                           # LLM widths (384, 480), the smallest of the table
TIMES = ("t", "epoch_time_s", "pairs_per_s")


# --- the parser and the helpers -------------------------------------------------------------

def _actions(parser):
    return {a.dest: a for a in parser._actions if a.dest != "help"}


def test_parser_takes_every_jax_option():
    ref, got = _actions(jcli.build_argparser()), _actions(cli.build_argparser())
    assert set(got) == set(ref) | {"device"}
    for dest, r in ref.items():
        g = got[dest]
        assert g.option_strings == r.option_strings, dest
        assert type(g) is type(r), dest
        for attr in ("choices", "type", "nargs", "required", "const", "metavar"):
            assert getattr(g, attr) == getattr(r, attr), (dest, attr)
        if dest == "data_root":
            assert g.default == "datasets"
        else:
            assert g.default == r.default, dest
    assert got["device"].default == "cuda"
    argv = ["--model", "DrugLAMP", "--data", "human", "--split", "Tcpi", "--n-layer", "12"]
    assert vars(cli.build_argparser().parse_args(argv))["split"] == "Tcpi"
    with pytest.raises(SystemExit):
        cli.build_argparser().parse_args(argv[:4] + ["--split", "bogus"])


def test_resolve_split_files_matches_jax(tmp_path, capsys):
    for rs in (False, True):
        assert cli.resolve_split_files("/x", "human", "random", rs) == \
            jcli.resolve_split_files("/x", "human", "random", rs)
    d = tmp_path / "biosnap" / "cluster"
    d.mkdir(parents=True)
    (d / "target_train.csv").write_text("SMILES,Protein,Y\n")
    got = cli.resolve_split_files(str(tmp_path), "biosnap", "cluster", True)
    assert got == jcli.resolve_split_files(str(tmp_path), "biosnap", "cluster", True) == (
        "target_train.csv", "target_test.csv", "target_test.csv")
    assert "source_train.csv missing" in capsys.readouterr().err
    (d / "source_train.csv").write_text("SMILES,Protein,Y\n")
    assert cli.resolve_split_files(str(tmp_path), "biosnap", "cluster", True) == \
        jcli.resolve_split_files(str(tmp_path), "biosnap", "cluster", True)


@pytest.mark.parametrize("work_dir", [None, "/w"])
@pytest.mark.parametrize("scope", ["random", "cold", "full"])
def test_cache_dir_matches_jax(tmp_path, work_dir, scope):
    args = SimpleNamespace(work_dir=work_dir, data="human")
    table = SimpleNamespace(ordinal_scope=scope)
    wd = work_dir or str(tmp_path / "results" / "exp1")
    assert cli._cache_dir(args, wd, table) == jcli._cache_dir(args, wd, table)


def test_write_eval_record_matches_jax(tmp_path):
    args = SimpleNamespace(data="bindingdb", split="cluster", model="DrugLAMP2C2P", seed=42,
                           ckpt=str(tmp_path / "ckpt_best.pt"))
    rec = {"test_auroc": 0.5, "test_auprc": 0.25}
    out = [cli.write_eval_record(args, rec, n_rows=907, results_root=str(tmp_path / "port")),
           jcli.write_eval_record(args, rec, n_rows=907, results_root=str(tmp_path / "jax"))]
    assert os.path.basename(out[0])[:-len("0101_000000")] == \
        os.path.basename(out[1])[:-len("0101_000000")]
    got, ref = (open(os.path.join(o, "metrics.jsonl")).read() for o in out)
    assert got == ref
    assert json.loads(got.splitlines()[1]) == rec


BASE = ["--model", "DrugLAMP2C2P", "--data", "toy", "--data-root", "unused", "--device", "cpu"]


@pytest.mark.parametrize("flags", [
    ["--mesh-model", "2"], ["--devices", "0,1"], ["--bn-mode", "per_replica", "--devices", "0,1"],
], ids=["mesh-model", "devices", "bn-mode"])
def test_unported_flags_raise_naming_their_slice(runs, flags, tmp_path):
    """``--mesh-model 2`` in one process raises: one rank does not divide
    into a model axis of 2 (the JAX ``make_mesh``'s divisibility assert; the
    two-rank run is in tests/test_torch_port_tensor_parallel.py; the test's
    name is from when the flag named its slice).  ``--devices`` and
    ``--bn-mode per_replica`` run: in one process the data-parallel size is
    1, so either gives the run without it (``nocache``) value for value."""
    if flags[0] == "--mesh-model":
        with pytest.raises(ValueError) as e:
            cli.main(BASE + flags)
        assert "do not divide into a model axis of 2" in str(e.value)
        assert "--mesh-model" in str(e.value)
        return
    wd = str(tmp_path / "run")
    assert cli.main(_argv(runs["root"], runs["yaml"], wd) + flags) == 0
    assert _strip(_records(os.path.join(wd, "metrics.jsonl"))) == _strip(runs["nocache"])


def test_per_replica_bn_on_one_device_passes_the_flag_check():
    """The flags parse, and their grid in one process is one rank (the
    check of the model axis is ``make_mesh``'s)."""
    from druglamp_tpu_torch.parallel.mesh import MeshContext, make_mesh

    args = cli.build_argparser().parse_args(BASE + ["--devices", "0", "--bn-mode",
                                                    "per_replica"])
    assert (args.bn_mode, args.devices, args.mesh_model) == ("per_replica", "0", 1)
    mesh = MeshContext(make_mesh(args.mesh_model))
    assert (mesh.n_data, mesh.n_model, mesh.primary) == (1, 1, True)


def test_main_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(BASE[:-2])


def test_main_rejects_unknown_model(capsys):
    assert cli.main(["--model", "Nope", "--data", "toy", "--device", "cpu"]) == 2
    assert "available" in capsys.readouterr().err


def test_eval_only_requires_ckpt(tmp_path, capsys):
    rc = cli.main(BASE + ["--model", "DrugLAMPwoLLM", "--eval-only", "--work-dir",
                          str(tmp_path)])
    assert rc == 2 and "--ckpt" in capsys.readouterr().err


# --- main over the three transports ---------------------------------------------------------

def _seed_cache(cache_dir, table):
    nd, npf = cli.N_LAYER2DIMS[N_LAYER]
    cache = EmbeddingCache(cache_dir, "toy", nd, npf)
    r = np.random.RandomState(2)
    for smi, o in table.drug2ord.items():
        cache.put_drug(o, r.randn(min(len(smi) + 2, 32), nd))
    for seq, o in table.prot2ord.items():
        cache.put_prot(o, r.randn(min(len(seq), 40) + 2, npf))


CASES = {"nocache": [], "off": ["--device-data", "off"], "auto": ["--device-data", "auto"]}


def _argv(root, yaml, work):
    return ["--model", "DrugLAMP2C2P", "--data", "toy", "--data-root", root, "--config", yaml,
            "--work-dir", work, "--device", "cpu", "--n-layer", str(N_LAYER), "--seed", "5"]


def _direct(root, yaml, work, case):
    """The same experiment through the port's Trainer called directly."""
    cfg = load_config(yaml, {"solver.seed": 5})
    kw = dict(max_nodes=cfg.drug.max_nodes, seq_len=cfg.protein.seq_len,
              max_prot_resis=cfg.protein.max_resis)
    train = DTIDataset(root, "toy", "random", "train.csv", **kw)
    val = DTIDataset(root, "toy", "random", "val.csv", table=train.table, **kw)
    test = DTIDataset(root, "toy", "random", "test.csv", table=train.table, **kw)
    nd, npf = cli.N_LAYER2DIMS[N_LAYER]
    if case == "nocache":
        emb, store = ZeroEmbeddings(nd, npf), None
    else:
        _seed_cache(os.path.join(work, "embed_cache"), train.table)
        emb = EmbeddingCache(os.path.join(work, "embed_cache"), "toy", nd, npf,
                             dtype=torch.bfloat16)
        store = DeviceEmbeddingStore.build(train.table, emb, max_drug_tokens=32,
                                           max_prot_len=42, device="cpu").tree
    ords = store is not None
    loaders = [BatchLoader(ds, 4, shuffle=sh, drop_last=sh, embeddings=emb,
                           seed=cfg.solver.seed if sh else 0, emb_ordinals=ords)
               for ds, sh in ((train, True), (val, False), (test, False))]
    data = (DeviceDataStore.build(train.table, 32, 144, True, True, device="cpu")
            if case == "auto" else None)
    log = ExperimentLogger(os.path.dirname(work), os.path.basename(work), quiet=True)
    t = Trainer(build_model("DrugLAMP2C2P", cfg, nd, npf), cfg, *loaders, logger=log,
                work_dir=work, embed_store=store, device_data=data, device="cpu")
    t.run_experiment(cfg.solver.seed)
    log.close()
    return _records(log.jsonl_path)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = _toy_dataset(str(tmp_path_factory.mktemp("data")))
    yaml = os.path.join(root, "tiny.yaml")
    with open(yaml, "w") as f:
        f.write(TINY_YAML)
    work = tmp_path_factory.mktemp("work")
    out = {"root": root, "yaml": yaml, "work": work}
    for case, flags in CASES.items():
        wd = str(work / case)
        if case != "nocache":
            table = DTIDataset(root, "toy", "random", "train.csv", max_nodes=32, seq_len=144,
                               max_prot_resis=40).table
            _seed_cache(os.path.join(wd, "embed_cache"), table)
        assert cli.main(_argv(root, yaml, wd) + flags) == 0
        out[case] = _records(os.path.join(wd, "metrics.jsonl"))
        out[case + "_direct"] = _direct(root, yaml, str(work / (case + "_direct")), case)
    return out


def _strip(records):
    return [{k: v for k, v in r.items() if k not in TIMES}
            for r in records if r.get("event") != "hyperparams"]


@pytest.mark.parametrize("case", list(CASES))
def test_main_matches_a_direct_trainer_run(runs, case):
    got = runs[case]
    hp = got[0]
    assert hp["event"] == "hyperparams" and hp["device_data"] == (case == "auto")
    epochs = [r for r in got if "train_loss" in r]
    assert [r["epoch"] for r in epochs] == [1, 2] and "cm_loss" in epochs[1]
    assert all(np.isfinite(r["train_loss"]) for r in epochs)
    assert got[-1]["event"] == "done"
    assert _strip(got) == _strip(runs[case + "_direct"])


def test_cached_runs_match_across_transports(runs):
    """The host pipeline over the ordinal store and the gather epoch give the
    same run (tests/test_torch_port_host_pipeline.py holds the transports to
    each other bit for bit)."""
    assert _strip(runs["off"]) == _strip(runs["auto"])


def _test_record(records):
    return next(r for r in records if "test_auroc" in r)


@pytest.mark.parametrize("case,flags", [("off", []), ("nocache", ["--allow-zero-embeddings"])])
def test_eval_only_reproduces_the_test_metrics(runs, case, flags, tmp_path, monkeypatch,
                                               capsys):
    monkeypatch.chdir(tmp_path)
    wd = str(runs["work"] / case)
    ckpt = os.path.join(wd, "ckpt_best.pt")
    assert cli.main(_argv(runs["root"], runs["yaml"], wd) + ["--eval-only", "--ckpt", ckpt]
                    + flags) == 0
    (out_dir,) = os.listdir(tmp_path / "results")
    lines = _records(tmp_path / "results" / out_dir / "metrics.jsonl")
    assert lines[0]["event"] == "eval_only" and lines[0]["ckpt"] == ckpt
    want = {k: round(v, 5) for k, v in _test_record(runs[case]).items() if k.startswith("test_")}
    assert lines[1] == want
    assert lines[2] == {"event": "done", "mode": "eval_only"}


def test_eval_only_refuses_missing_embeddings(runs, capsys):
    wd = str(runs["work"] / "nocache")
    rc = cli.main(_argv(runs["root"], runs["yaml"], wd)
                  + ["--eval-only", "--ckpt", os.path.join(wd, "ckpt_best.pt")])
    assert rc == 3
    assert "--allow-zero-embeddings" in capsys.readouterr().err


# --- the frozen encoders through the CLI -----------------------------------------------------

ESM_TINY = dict(num_layers=2, embed_dim=480, num_heads=4, ffn_dim=256)   # --n-layer 12's width


@pytest.fixture(scope="module")
def encoder_files(tmp_path_factory):
    """An HF EsmModel (2 layers, 480 wide) and an HF RobertaModel at
    ChemBERTa-77M-MTR's geometry (hidden 384 of --n-layer 12) saved with
    torch.save, and the RoBERTa tokenizer of tests/test_hf_tokenizer.py."""
    transformers = pytest.importorskip("transformers")
    from tests.test_hf_tokenizer import _MERGES, _VOCAB
    from tests.test_torch_port_encoders import _write_tokenizer

    d = tmp_path_factory.mktemp("encoders")
    esm = transformers.EsmConfig(
        vocab_size=33, mask_token_id=32, pad_token_id=1, hidden_size=480, num_hidden_layers=2,
        num_attention_heads=4, intermediate_size=256, position_embedding_type="rotary",
        emb_layer_norm_before=False, token_dropout=True, layer_norm_eps=1e-5,
        max_position_embeddings=1026)
    rob = transformers.RobertaConfig(
        vocab_size=600, hidden_size=384, num_hidden_layers=3, num_attention_heads=12,
        intermediate_size=464, max_position_embeddings=515, pad_token_id=1, type_vocab_size=1,
        layer_norm_eps=1e-12)
    torch.manual_seed(0)
    torch.save(transformers.EsmModel(esm, add_pooling_layer=False).state_dict(), d / "esm.pt")
    torch.manual_seed(1)
    torch.save(transformers.RobertaModel(rob, add_pooling_layer=False).state_dict(), d / "cb.pt")
    return {"esm": str(d / "esm.pt"), "cb": str(d / "cb.pt"),
            "tok": _write_tokenizer(d / "tok", _VOCAB, _MERGES)}


@pytest.fixture
def tiny_esm(monkeypatch):
    """Both packages: --n-layer 12's ESM-2 cut to 2 layers, buckets small;
    the JAX CLI's persistent compilation cache left off."""
    import druglamp_tpu.encoders.embed_pipeline as jpipe
    import druglamp_tpu.encoders.esm2 as jesm
    import druglamp_tpu.utils.jaxsetup as jaxsetup
    import druglamp_tpu_torch.encoders.embed_pipeline as ppipe
    import druglamp_tpu_torch.encoders.esm2 as pesm

    monkeypatch.setitem(jesm._ESM2_SIZES, N_LAYER, jesm.ESM2Config(**ESM_TINY))
    monkeypatch.setitem(pesm._ESM2_SIZES, N_LAYER, pesm.ESM2Config(**ESM_TINY))
    for mod in (jpipe, ppipe):
        monkeypatch.setattr(mod, "_BUCKETS", (48,))
        monkeypatch.setattr(mod, "_DRUG_BUCKETS", (32,))
    monkeypatch.setattr(jaxsetup, "enable_compilation_cache", lambda *a, **k: None)


def _encoder_flags(files, tokenizer=True):
    return (["--esm-ckpt", files["esm"], "--chemberta-ckpt", files["cb"]]
            + (["--chemberta-tokenizer", files["tok"]] if tokenizer else []))


def _cache_files(d):
    return {n: np.load(os.path.join(d, n)) for n in sorted(os.listdir(d))}


def _table(runs, name):
    return DTIDataset(runs["root"], "toy", "random", name, max_nodes=32, seq_len=144,
                      max_prot_resis=40).table


def _jax_argv(argv):
    """The port CLI's argv for the JAX CLI (which has no --device)."""
    i = argv.index("--device")
    return argv[:i] + argv[i + 2:]


def test_gen_embed_only_matches_the_jax_cli(runs, encoder_files, tiny_esm, tmp_path, capsys):
    outs = {}
    for name, main in (("port", cli.main), ("jax", jcli.main)):
        argv = _argv(runs["root"], runs["yaml"], str(tmp_path / name)) + ["--gen-embed-only"] \
            + _encoder_flags(encoder_files)
        assert main(argv if name == "port" else _jax_argv(argv)) == 0
        assert "[gen-embed-only] caches written" in capsys.readouterr().out
        assert not os.path.exists(tmp_path / name / "metrics.jsonl")
        outs[name] = _cache_files(tmp_path / name / "embed_cache")
        assert open(tmp_path / name / f"{N_LAYER}_layers_params.txt").read() == "384\t480\n"
    table = _table(runs, "train.csv")
    assert outs["port"].keys() == outs["jax"].keys()
    assert len(outs["port"]) == table.n_drug + table.n_prot
    for n, want in outs["jax"].items():
        assert outs["port"][n].shape == want.shape, n
        np.testing.assert_allclose(outs["port"][n], want, rtol=0, atol=2e-5, err_msg=n)


@pytest.mark.parametrize("model", ["DrugLAMPwoLLM", "DrugLAMP"])
def test_gen_embed_only_random_init_writes_caches_for_every_model(runs, tiny_esm, tmp_path,
                                                                  model, capsys):
    """No checkpoint: seeded random weights with the warning; DrugLAMPwoLLM
    too (--gen-embed-only is a cache warm-up whatever the model)."""
    argv = _argv(runs["root"], runs["yaml"], str(tmp_path)) + ["--gen-embed-only"]
    argv[argv.index("DrugLAMP2C2P")] = model
    assert cli.main(argv) == 0
    assert "random-initialized" in capsys.readouterr().err
    table = _table(runs, "train.csv")
    files = _cache_files(tmp_path / "embed_cache")
    assert len(files) == table.n_drug + table.n_prot
    assert all(np.isfinite(a).all() for a in files.values())
    assert not os.path.exists(tmp_path / "metrics.jsonl")


def test_gen_embed_then_trains(runs, encoder_files, tiny_esm, tmp_path, monkeypatch):
    """--gen-embed writes every entity's cache, then trains over the
    device-resident dataset on them; a second call finds them all and runs
    neither encoder."""
    import druglamp_tpu_torch.encoders.chemberta as pcb
    import druglamp_tpu_torch.encoders.esm2 as pesm

    wd = str(tmp_path / "w")
    argv = _argv(runs["root"], runs["yaml"], wd) + ["--gen-embed"] + _encoder_flags(encoder_files)
    assert cli.main(argv) == 0
    table = _table(runs, "train.csv")
    cache = EmbeddingCache(os.path.join(wd, "embed_cache"), "toy", 384, 480)
    assert all(cache.has_drug(o) for o in range(table.n_drug))
    assert all(cache.has_prot(o) for o in range(table.n_prot))
    records = _records(os.path.join(wd, "metrics.jsonl"))
    assert records[0]["device_data"] is True
    epochs = [r for r in records if "train_loss" in r]
    assert [r["epoch"] for r in epochs] == [1, 2]
    assert all(np.isfinite(r[k]) for r in epochs for k in ("train_loss", "val_ausum"))
    assert np.isfinite(_test_record(records)["test_auroc"])
    for cls in (pesm.ESM2, pcb.ChemBERTa):
        monkeypatch.setattr(cls, "forward", lambda self, t: pytest.fail("an encoder ran"))
    assert cli.main(_argv(runs["root"], runs["yaml"], wd) + ["--gen-embed-only"]) == 0


def test_eval_only_gen_embed_fills_the_test_table(runs, encoder_files, tiny_esm, tmp_path,
                                                  monkeypatch):
    monkeypatch.chdir(tmp_path)
    wd = str(tmp_path / "w")
    ckpt = os.path.join(str(runs["work"] / "nocache"), "ckpt_best.pt")
    argv = _argv(runs["root"], runs["yaml"], wd) + ["--eval-only", "--ckpt", ckpt,
                                                    "--gen-embed"] + _encoder_flags(encoder_files)
    assert cli.main(argv) == 0
    table = _table(runs, "test.csv")
    files = _cache_files(os.path.join(wd, "embed_cache"))
    assert len(files) == table.n_drug + table.n_prot
    (out_dir,) = os.listdir(tmp_path / "results")
    record = _records(tmp_path / "results" / out_dir / "metrics.jsonl")[1]
    assert np.isfinite(record["test_auroc"])


@pytest.mark.parametrize("case", ["no_tokenizer", "foreign_tokenizer"])
def test_real_chemberta_ckpt_needs_its_tokenizer(runs, encoder_files, tiny_esm, tmp_path, case):
    """A real ChemBERTa checkpoint with the regex tokenizer, or with a
    tokenizer larger than its embedding table: both CLIs raise the same
    ValueError and write no drug cache."""
    flags = _encoder_flags(encoder_files, tokenizer=False)
    if case == "foreign_tokenizer":
        vocab = {f"t{i}": i for i in range(700)}
        vocab.update({"<s>": 0, "<pad>": 1, "</s>": 2, "<unk>": 3, "<mask>": 4})
        from tests.test_torch_port_encoders import _write_tokenizer
        flags += ["--chemberta-tokenizer", _write_tokenizer(tmp_path / "big", vocab, ["#v"])]
    errors = []
    for name, main in (("port", cli.main), ("jax", jcli.main)):
        argv = _argv(runs["root"], runs["yaml"], str(tmp_path / name)) + ["--gen-embed"] + flags
        with pytest.raises(ValueError) as e:
            main(argv if name == "port" else _jax_argv(argv))
        errors.append(str(e.value))
        assert not any("drug" in f for f in os.listdir(tmp_path / name / "embed_cache"))
    assert errors[0] == errors[1]
    assert ("regex tokenizer" if case == "no_tokenizer" else "exceeds") in errors[0]


# --- the sweep ------------------------------------------------------------------------------

def test_sweep_retries_and_summary(tmp_path, monkeypatch):
    calls = []

    def fake_call(cmd):
        calls.append(cmd)
        seed = cmd[cmd.index("--seed") + 1]
        if seed == "40" and sum(1 for c in calls if c[c.index("--seed") + 1] == "40") == 1:
            return 1
        return 0

    monkeypatch.setattr(sweep.subprocess, "call", fake_call)
    monkeypatch.setattr(sweep.time, "sleep", lambda s: None)
    out = tmp_path / "summary.json"
    rc = sweep.main(["--model", "DrugLAMP", "--data", "human", "--seeds", "40", "41",
                     "--out", str(out), "--", "--device", "cpu"])
    assert rc == 0
    assert json.loads(out.read_text())["exit_codes"] == {"40": 0, "41": 0}
    assert [c[c.index("--seed") + 1] for c in calls] == ["40", "40", "41"]
    assert all(c[1:3] == ["-m", "druglamp_tpu_torch.cli.main"] and c[-2:] == ["--device", "cpu"]
               for c in calls)


def test_sweep_max_retries(monkeypatch, tmp_path):
    monkeypatch.setattr(sweep.subprocess, "call", lambda cmd: 1)
    monkeypatch.setattr(sweep.time, "sleep", lambda s: None)
    rc = sweep.main(["--model", "DrugLAMP", "--data", "human", "--seeds", "40",
                     "--max-retries", "3", "--out", str(tmp_path / "s.json")])
    assert rc == 1


def test_sweep_in_process_runs_the_port_cli(monkeypatch, tmp_path):
    """--in-process calls the port's main; a failing seed falls back to the
    subprocess loop."""
    seen = []

    def fake_main(argv):
        seen.append(argv)
        if argv[argv.index("--seed") + 1] == "41":
            raise RuntimeError("boom")
        return 0

    monkeypatch.setattr(cli, "main", fake_main)
    monkeypatch.setattr(sweep.subprocess, "call", lambda cmd: 0)
    rc = sweep.main(["--model", "M", "--data", "d", "--seeds", "40", "41", "--in-process",
                     "--out", str(tmp_path / "s.json")])
    assert rc == 0 and [a[a.index("--seed") + 1] for a in seen] == ["40", "41"]


def test_sweep_watchdog_kills_stalled_run(tmp_path, monkeypatch):
    calls = {"n": 0}
    real_popen = subprocess.Popen

    def fake_popen(cmd, stdout=None, stderr=None):
        calls["n"] += 1
        script = ("import sys,time;print('x',flush=True);time.sleep(60)" if calls["n"] == 1
                  else "print('ok')")
        return real_popen([sys.executable, "-c", script], stdout=stdout, stderr=stderr)

    monkeypatch.setattr(subprocess, "Popen", fake_popen)
    ld = str(tmp_path / "wdlogs")
    assert sweep._run_seed(["ignored"], watchdog=2, log_dir=ld) == 124
    assert any(f.endswith(".log") for f in os.listdir(ld))
    assert sweep._run_seed(["ignored"], watchdog=2, log_dir=ld) == 0
    assert len(os.listdir(ld)) == 1

    calls["n"] = 0
    monkeypatch.chdir(tmp_path)
    rc = sweep.main(["--model", "M", "--data", "d", "--seeds", "7", "--watchdog", "2",
                     "--max-retries", "3", "--out", str(tmp_path / "s.json")])
    assert rc == 0 and calls["n"] == 2


def test_sweep_watchdog_grace_covers_silent_startup(tmp_path, monkeypatch):
    real_popen = subprocess.Popen

    def fake_popen(cmd, stdout=None, stderr=None):
        script = "import time;time.sleep(4);print('late ok',flush=True)"
        return real_popen([sys.executable, "-c", script], stdout=stdout, stderr=stderr)

    monkeypatch.setattr(subprocess, "Popen", fake_popen)
    assert sweep._run_seed(["ignored"], watchdog=1, grace=120,
                           log_dir=str(tmp_path / "wdlogs")) == 0
