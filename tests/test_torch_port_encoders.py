"""The port's frozen encoders against the JAX package's, on the CPU at tiny
sizes (ESM-2: 2 layers, 64 wide, 4 heads, FFN 256; ChemBERTa: 1–2 layers,
32 wide).

- The regex tokenizer's ids, spans, ``extend_from_corpus`` vocabulary and
  ``smiles_token_edges`` over ``chip_smoke.py``'s real drugs, ``esm_tokenize``,
  ``_batched`` and ``TableZeroEmbeddings``: bit-identical.
- ESM-2 (pads and a ``<mask>`` in the batch) and ChemBERTa on the same flax
  weights (``convert.from_jax_encoder_params``): f32 within 2e-5 of JAX; bf16
  within 4 bf16 ulps of the output's largest magnitude of JAX's bf16 (the
  packages round at other points: on these inputs each bf16 output sits
  about 2 ulps from the f32 one).
- The checkpoint converters on ``transformers``-built models: equal to the JAX
  converters' weights, and the outputs within 2e-5 of transformers' own;
  ``load_torch_state_dict`` over every file layout.
- ``HFTokenizer`` gives JAX's ids on ``tests/test_hf_tokenizer.py``'s
  tokenizer; without ``transformers`` it raises naming the flag.
- ``generate_embeddings`` from checkpoint files writes the caches the JAX
  package writes (names, shapes, values within 2e-5), the pad id taken from
  the checkpoint's tokenizer; each guard raises as JAX's does.
"""

import json
import math
import sys
from types import SimpleNamespace

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import druglamp_tpu.encoders.embed_pipeline as jpipe
import druglamp_tpu.encoders.esm2 as jesm
from chip_smoke import EPOCH_SMILES, make_proteins
from druglamp_tpu.chem.tokenizer import SmilesTokenizer as JTokenizer
from druglamp_tpu.chem.tokenizer import smiles_token_edges as jedges
from druglamp_tpu.data.cache import EmbeddingCache as JCache
from druglamp_tpu.data.cache import TableZeroEmbeddings as JTableZero
from druglamp_tpu.encoders.chemberta import ChemBERTa as JChemBERTa
from druglamp_tpu.encoders.chemberta import ChemBERTaConfig as JCBConfig
from druglamp_tpu.encoders.convert import chemberta_params_from_torch, esm2_params_from_torch
import druglamp_tpu_torch.encoders.embed_pipeline as ppipe
import druglamp_tpu_torch.encoders.esm2 as pesm
from druglamp_tpu_torch.chem import hf_tokenizer as phf
from druglamp_tpu_torch.chem.tokenizer import SmilesTokenizer, smiles_token_edges
from druglamp_tpu_torch.convert import from_jax_encoder_params
from druglamp_tpu_torch.data.cache import EmbeddingCache, TableZeroEmbeddings
from druglamp_tpu_torch.encoders import convert as pconv
from druglamp_tpu_torch.encoders.chemberta import ChemBERTa, ChemBERTaConfig
from druglamp_tpu_torch.encoders.layers import seeded_state

torch.set_num_threads(1)

ATOL = 2e-5
ESM_TINY = dict(num_layers=2, embed_dim=64, num_heads=4, ffn_dim=256)
CB_TINY = dict(vocab=64, hidden=32, num_layers=2, num_heads=4, intermediate=48,
               max_positions=40)
PROTEINS = ["MKTAYIAK", "LAGVSERTIDPKQ", "mktxzbou", "MKT"]


def _perturbed(params, seed):
    """Unboxed flax params with seeded noise on every leaf (zero biases take part)."""
    rng = np.random.RandomState(seed)
    return jax.tree.map(lambda a: np.asarray(a) + 0.05 * rng.randn(*a.shape).astype(np.float32),
                        fnn.meta.unbox(params))


def _bf16_ulp(x: float) -> float:
    return 2.0 ** (math.floor(math.log2(x)) - 7)


def _esm_tokens():
    toks = np.full((len(PROTEINS), 18), pesm.ESM_PAD, np.int32)
    for r, seq in enumerate(PROTEINS):
        t = pesm.esm_tokenize(seq)
        toks[r, :len(t)] = t
    toks[1, 3] = pesm.ESM_MASK
    return toks


# --- tokenizers and host code -----------------------------------------------------------------

def test_smiles_tokenizer_matches_jax():
    port, ref = SmilesTokenizer(), JTokenizer()
    assert port.vocab == ref.vocab
    corpus = EPOCH_SMILES + ["[Na+].[Cl-]", "C[C@@H](N)C(=O)O", "c1ccc2c(c1)[nH]c1ccccc12"]
    port.extend_from_corpus(corpus)
    ref.extend_from_corpus(corpus)
    assert port.vocab == ref.vocab and port.vocab_size > 54
    for smi in corpus:
        assert port.tokenize_with_spans(smi) == ref.tokenize_with_spans(smi), smi
        for n in (None, 8, 3):
            assert port.encode(smi, max_length=n) == ref.encode(smi, max_length=n), (smi, n)
    assert port.encode(EPOCH_SMILES[4], max_length=8)[-1] == port.sep_id


@pytest.mark.parametrize("extended", [False, True])
def test_smiles_token_edges_match_jax(extended):
    port, ref = SmilesTokenizer(), JTokenizer()
    if extended:
        port.extend_from_corpus(EPOCH_SMILES)
        ref.extend_from_corpus(EPOCH_SMILES)
    for smi in EPOCH_SMILES:
        (pe, pm), (je, jm) = smiles_token_edges(smi, port), jedges(smi, ref)
        assert pe.dtype == je.dtype and np.array_equal(pe, je), smi
        assert np.array_equal(pm, jm), smi


def test_esm_tokenize_matches_jax():
    assert pesm.ESM_ALPHABET == jesm.ESM_ALPHABET
    for seq in PROTEINS + make_proteins(np.random.RandomState(0), 3):
        for n in (None, 5, 1022):
            got, want = pesm.esm_tokenize(seq, n), jesm.esm_tokenize(seq, n)
            assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("buckets", [None, (4, 8, 16), (520,)])
def test_batched_matches_jax(buckets):
    rng = np.random.RandomState(1)
    items = [(o, rng.randint(0, 30, size=rng.randint(2, 19)).astype(np.int32))
             for o in rng.permutation(11)]
    for pad in (1, 0):
        got = list(ppipe._batched(items, 4, pad, buckets))
        want = list(jpipe._batched(items, 4, pad, buckets))
        assert len(got) == len(want)
        for (o1, t1, l1), (o2, t2, l2) in zip(got, want):
            assert o1 == o2 and l1 == l2 and t1.dtype == t2.dtype and np.array_equal(t1, t2)
    assert ppipe._BUCKETS == jpipe._BUCKETS and ppipe._DRUG_BUCKETS == jpipe._DRUG_BUCKETS


def test_table_zero_embeddings_match_jax():
    prots = make_proteins(np.random.RandomState(0), 5)
    table = SimpleNamespace(drug2ord={s: i for i, s in enumerate(EPOCH_SMILES)},
                            prot2ord={p: i for i, p in enumerate(prots)})
    for kw in ({}, {"max_prot_resis": 100, "max_drug_tokens": 10, "n_drug_feature": 8}):
        port, ref = TableZeroEmbeddings.from_table(table, **kw), JTableZero.from_table(table, **kw)
        for o in range(len(EPOCH_SMILES) + 1):
            assert port.drug(o).shape == ref.drug(o).shape and not port.drug(o).any()
        for o in range(len(prots) + 1):
            assert port.prot(o).shape == ref.prot(o).shape
    assert TableZeroEmbeddings.from_table(SimpleNamespace()).drug(0).shape == (0, 384)


# --- the encoders on shared weights -----------------------------------------------------------

@pytest.fixture(scope="module")
def esm_pair():
    toks = _esm_tokens()
    params = _perturbed(jesm.ESM2(jesm.ESM2Config(**ESM_TINY)).init(
        jax.random.key(0), jnp.asarray(toks))["params"], 0)
    return toks, params


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_esm2_matches_jax(esm_pair, dtype):
    toks, params = esm_pair
    ref = np.asarray(jesm.ESM2(jesm.ESM2Config(**ESM_TINY), dtype=getattr(jnp, dtype)).apply(
        {"params": params}, jnp.asarray(toks)), np.float32)
    model = pesm.ESM2(pesm.ESM2Config(**ESM_TINY), dtype=getattr(torch, dtype))
    model.load_state_dict(from_jax_encoder_params(params, model))
    with torch.inference_mode():
        got = model(torch.from_numpy(toks))
    assert got.dtype == torch.float32 and got.shape == (*toks.shape, 64)
    valid = toks != pesm.ESM_PAD
    err = np.abs(got.numpy() - ref)[valid].max()
    tol = ATOL if dtype == "float32" else 4 * _bf16_ulp(np.abs(ref[valid]).max())
    assert err <= tol, (err, tol)


def test_rotary_matches_jax():
    rng = np.random.RandomState(3)
    q, k = (rng.randn(2, 3, 11, 16).astype(np.float32) for _ in range(2))
    pos = np.arange(11)
    want = jesm.apply_rotary(jnp.asarray(q), jnp.asarray(k), jnp.asarray(pos))
    got = pesm.apply_rotary(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(pos))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-6)
    qb = torch.from_numpy(q).to(torch.bfloat16)
    assert pesm.apply_rotary(qb, qb, torch.from_numpy(pos))[0].dtype == torch.bfloat16


def test_esm2_row_independent_of_padding_and_batch(esm_pair):
    toks, params = esm_pair
    model = pesm.ESM2(pesm.ESM2Config(**ESM_TINY))
    model.load_state_dict(from_jax_encoder_params(params, model))
    with torch.inference_mode():
        full = model(torch.from_numpy(toks)).numpy()
        n = len(pesm.esm_tokenize(PROTEINS[0]))
        alone = model(torch.from_numpy(toks[:1, :n])).numpy()
    np.testing.assert_allclose(alone[0], full[0, :n], rtol=0, atol=ATOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chemberta_matches_jax(dtype):
    toks = np.array([[0, 10, 11, 12, 2, 1, 1, 1], [0, 20, 21, 22, 23, 24, 25, 2],
                     [0, 63, 5, 2, 1, 1, 1, 1]], np.int32)
    cfg = JCBConfig(**CB_TINY)
    params = _perturbed(JChemBERTa(cfg).init(jax.random.key(1), jnp.asarray(toks))["params"], 1)
    ref = np.asarray(JChemBERTa(cfg, dtype=getattr(jnp, dtype)).apply(
        {"params": params}, jnp.asarray(toks)), np.float32)
    model = ChemBERTa(ChemBERTaConfig(**CB_TINY), dtype=getattr(torch, dtype))
    model.load_state_dict(from_jax_encoder_params(params, model))
    with torch.inference_mode():
        got = model(torch.from_numpy(toks)).numpy()
    err = np.abs(got - ref).max()
    tol = ATOL if dtype == "float32" else 4 * _bf16_ulp(np.abs(ref).max())
    assert err <= tol, (err, tol)


def test_chemberta_wrong_pad_id_goes_non_finite():
    """A pad id other than the model's counts pad positions as tokens; past
    max_positions the lookup gives NaN (the reference's take), the state the
    pipeline's finiteness guard refuses; the model's own pad id stays finite
    at a bucket far beyond max_positions."""
    cfg = ChemBERTaConfig(vocab=64, hidden=32, num_layers=1, num_heads=4, intermediate=32,
                          max_positions=24)
    model = ChemBERTa(cfg)
    model.load_state_dict(seeded_state(model, 0))
    ids = [2, 17, 23, 5, 3]
    ok = torch.full((2, 64), cfg.pad_id, dtype=torch.int32)
    bad = torch.zeros((2, 64), dtype=torch.int32)
    ok[:, :5] = bad[:, :5] = torch.tensor(ids)
    with torch.inference_mode():
        assert torch.isfinite(model(ok)).all()
        assert not torch.isfinite(model(bad)).all()


def test_bridge_raises_on_a_missing_or_foreign_leaf(esm_pair):
    _, params = esm_pair
    model = pesm.ESM2(pesm.ESM2Config(**ESM_TINY))
    partial = {k: v for k, v in params.items() if k != "emb_layer_norm_after"}
    with pytest.raises(KeyError, match="emb_layer_norm_after"):
        from_jax_encoder_params(partial, model)
    with pytest.raises(KeyError, match="does not have"):
        from_jax_encoder_params({**params, "extra": {"kernel": np.zeros((2, 2))}}, model)


# --- checkpoint converters ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def hf_models():
    transformers = pytest.importorskip("transformers")
    esm_cfg = transformers.EsmConfig(
        vocab_size=33, mask_token_id=32, pad_token_id=1, hidden_size=64, num_hidden_layers=2,
        num_attention_heads=4, intermediate_size=256, position_embedding_type="rotary",
        hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0, emb_layer_norm_before=False,
        token_dropout=True, layer_norm_eps=1e-5, max_position_embeddings=128)
    rob_cfg = transformers.RobertaConfig(
        vocab_size=64, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
        intermediate_size=48, max_position_embeddings=40, pad_token_id=1, type_vocab_size=1,
        hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0, layer_norm_eps=1e-12)
    torch.manual_seed(0)
    esm = transformers.EsmModel(esm_cfg, add_pooling_layer=False).eval()
    torch.manual_seed(1)
    rob = transformers.RobertaModel(rob_cfg, add_pooling_layer=False).eval()
    with torch.no_grad():         # HF zero-initializes biases: make them take part
        for p in list(esm.parameters()) + list(rob.parameters()):
            p.add_(0.02 * torch.randn(p.shape))
    return esm, rob


def _hf_out(model, toks):
    with torch.no_grad():
        return model(input_ids=torch.from_numpy(toks.astype(np.int64)),
                     attention_mask=torch.from_numpy((toks != 1).astype(np.int64))
                     ).last_hidden_state.numpy()


def _fair_esm_names(sd):
    """An HF EsmModel state dict under fair-esm's names, in a 'model.' prefix."""
    table = pconv.esm2_names(2)
    return {"model." + fe: sd[hf] for fe_key, (hf, fe) in table.items()}


@pytest.mark.parametrize("layout", ["hf", "hf_esm_prefix", "fair_esm"])
def test_esm2_converter_matches_jax_and_transformers(hf_models, layout):
    hf, _ = hf_models
    sd = hf.state_dict()
    if layout == "hf_esm_prefix":
        sd = {"esm." + k: v for k, v in sd.items()}
    elif layout == "fair_esm":
        sd = _fair_esm_names(sd)
    state = pconv.esm2_state_from_torch(sd, num_layers=2)
    model = pesm.ESM2(pesm.ESM2Config(**ESM_TINY))
    bridged = from_jax_encoder_params(esm2_params_from_torch(sd, num_layers=2), model)
    assert state.keys() == bridged.keys() == model.state_dict().keys()
    for k in state:
        assert torch.equal(state[k], bridged[k]), k
    model.load_state_dict(state)
    # no <mask>: transformers' EsmModel rescales by the padded length (its
    # embeddings get no attention mask); fair-esm and JAX count non-pad tokens
    toks = _esm_tokens()[[0, 1, 3]]
    toks[1, 3] = pesm.ESM_TOK2IDX["A"]
    with torch.inference_mode():
        got = model(torch.from_numpy(toks)).numpy()
    valid = toks != 1
    np.testing.assert_allclose(got[valid], _hf_out(hf, toks)[valid], rtol=0, atol=ATOL)


def test_chemberta_converter_matches_jax_and_transformers(hf_models):
    _, hf = hf_models
    sd = {"roberta." + k: v for k, v in hf.state_dict().items()}
    state = pconv.chemberta_state_from_torch(sd, num_layers=2)
    model = ChemBERTa(ChemBERTaConfig(**CB_TINY))
    bridged = from_jax_encoder_params(chemberta_params_from_torch(sd, num_layers=2), model)
    assert state.keys() == bridged.keys() == model.state_dict().keys()
    for k in state:
        assert torch.equal(state[k], bridged[k]), k
    model.load_state_dict(state)
    toks = np.array([[0, 10, 11, 12, 2, 1, 1, 1], [0, 20, 21, 22, 23, 24, 25, 2]], np.int32)
    with torch.inference_mode():
        got = model(torch.from_numpy(toks)).numpy()
    valid = toks != 1
    np.testing.assert_allclose(got[valid], _hf_out(hf, toks)[valid], rtol=0, atol=ATOL)


def test_converter_raises_naming_the_missing_weight(hf_models):
    hf, rob = hf_models
    sd = {k: v for k, v in hf.state_dict().items() if "layer.1.attention.self.key" not in k}
    with pytest.raises(KeyError, match=r"encoder\.layer\.1\.attention\.self\.key\.weight"):
        pconv.esm2_state_from_torch(sd, num_layers=2)
    with pytest.raises(KeyError, match=r"encoder\.layer\.2\."):
        pconv.chemberta_state_from_torch(rob.state_dict(), num_layers=3)
    model = ChemBERTa(ChemBERTaConfig(**{**CB_TINY, "num_layers": 3}))
    with pytest.raises(RuntimeError, match="Missing key"):        # a module key left unfilled
        model.load_state_dict(pconv.chemberta_state_from_torch(rob.state_dict(), num_layers=2))


@pytest.mark.parametrize("layout", ["bare", "fair_esm_model", "state_dict", "module",
                                    "safetensors"])
def test_load_torch_state_dict_layouts(hf_models, tmp_path, layout):
    hf, _ = hf_models
    sd = hf.state_dict()
    path = str(tmp_path / ("esm.safetensors" if layout == "safetensors" else "esm.pt"))
    if layout == "safetensors":
        from safetensors.torch import save_file
        save_file({k: v.contiguous() for k, v in sd.items()}, path)
    else:
        torch.save({"bare": sd, "fair_esm_model": {"model": sd, "cfg": {}},
                    "state_dict": {"state_dict": sd, "epoch": 3}, "module": hf}[layout], path)
    got, want = ppipe.load_torch_state_dict(path), jpipe.load_torch_state_dict(path)
    assert got.keys() == want.keys() == sd.keys()
    for k in sd:
        assert np.array_equal(np.asarray(got[k]), np.asarray(want[k])), k


def test_safetensors_absent_raises_clearly(monkeypatch, tmp_path):
    monkeypatch.setitem(sys.modules, "safetensors", None)
    monkeypatch.setitem(sys.modules, "safetensors.torch", None)
    with pytest.raises(ImportError, match="safetensors"):
        ppipe.load_torch_state_dict(str(tmp_path / "esm.safetensors"))


# --- the HF tokenizer --------------------------------------------------------------------------

def _write_tokenizer(path, vocab, merges):
    transformers = pytest.importorskip("transformers")
    path.mkdir()
    with open(path / "vocab.json", "w") as f:
        json.dump(vocab, f)
    with open(path / "merges.txt", "w") as f:
        f.write("\n".join(merges) + "\n")
    tok = transformers.RobertaTokenizerFast(vocab_file=str(path / "vocab.json"),
                                            merges_file=str(path / "merges.txt"))
    tok.save_pretrained(str(path / "saved"))
    return str(path / "saved")


@pytest.fixture(scope="module")
def tok_dir(tmp_path_factory):
    pytest.importorskip("transformers")
    from tests.test_hf_tokenizer import _MERGES, _VOCAB
    return _write_tokenizer(tmp_path_factory.mktemp("tok") / "t", _VOCAB, _MERGES)


def test_hf_tokenizer_matches_jax(tok_dir):
    from druglamp_tpu.chem.hf_tokenizer import HFTokenizer as JHF
    port, ref = phf.HFTokenizer(tok_dir), JHF(tok_dir)
    for attr in ("vocab_size", "pad_id", "cls_id", "sep_id", "mask_id"):
        assert getattr(port, attr) == getattr(ref, attr), attr
    for smi in ["CCO", "CC(=O)N", "c1ccccc1", "C" * 40] + EPOCH_SMILES[:8]:
        assert port.tokenize(smi) == ref.tokenize(smi)
        assert port.tokenize_with_spans(smi) == ref.tokenize_with_spans(smi)
        for n in (None, 8):
            assert port.encode(smi, max_length=n) == ref.encode(smi, max_length=n)
    before = port.vocab_size
    port.extend_from_corpus(["[Na+]"])
    assert port.vocab_size == before


def test_hf_tokenizer_without_transformers_names_the_flag(monkeypatch, tmp_path):
    monkeypatch.setitem(sys.modules, "transformers", None)
    with pytest.raises(ImportError, match="--chemberta-tokenizer") as e:
        phf.HFTokenizer(str(tmp_path))
    assert "transformers" in str(e.value)


def test_vocab_alignment_checks(tok_dir):
    tok = phf.HFTokenizer(tok_dir)
    model = ChemBERTa(ChemBERTaConfig(vocab=tok.vocab_size, hidden=32, num_layers=1,
                                      num_heads=4, intermediate=32))
    phf.check_vocab_alignment(tok, model)
    phf.check_vocab_alignment(tok, model.state_dict())
    rows = lambda n: {"word_embeddings.weight": torch.zeros(n, 8)}  # noqa: E731
    with pytest.raises(ValueError, match="exceeds"):
        phf.check_vocab_alignment(tok, rows(tok.vocab_size - 4))
    with pytest.raises(ValueError, match="regex tokenizer"):
        phf.check_vocab_alignment(SmilesTokenizer(), rows(4096))


# --- generate_embeddings -----------------------------------------------------------------------

@pytest.fixture
def tiny_sizes(monkeypatch):
    """Both packages: the 12-layer ESM-2 entry at the tiny geometry, small buckets."""
    monkeypatch.setattr(jesm, "_ESM2_SIZES", {**jesm._ESM2_SIZES, 12: jesm.ESM2Config(**ESM_TINY)})
    monkeypatch.setattr(pesm, "_ESM2_SIZES", {**pesm._ESM2_SIZES, 12: pesm.ESM2Config(**ESM_TINY)})
    for mod in (jpipe, ppipe):
        monkeypatch.setattr(mod, "_BUCKETS", (16, 32))
        monkeypatch.setattr(mod, "_DRUG_BUCKETS", (24, 48))


def _table(n_drugs=5):
    prots = PROTEINS[:3] + [s[:25] for s in make_proteins(np.random.RandomState(2), 2)]
    return SimpleNamespace(drug2ord={s: i for i, s in enumerate(EPOCH_SMILES[:n_drugs])},
                           prot2ord={p: i for i, p in enumerate(prots)})


def _roberta_ckpt(path, vocab_size, pad_id=1):
    transformers = pytest.importorskip("transformers")
    cfg = transformers.RobertaConfig(
        vocab_size=vocab_size, hidden_size=32, num_hidden_layers=1, num_attention_heads=4,
        intermediate_size=48, max_position_embeddings=128, pad_token_id=pad_id,
        type_vocab_size=1, hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    torch.manual_seed(3)
    torch.save(transformers.RobertaModel(cfg, add_pooling_layer=False).state_dict(), path)
    return str(path)


def _cb_cfg(cls, vocab, pad_id=1):
    return cls(vocab=vocab, hidden=32, num_layers=1, num_heads=4, intermediate=48,
               max_positions=128, pad_id=pad_id)


def _cache_files(d):
    return {p.name: np.load(p) for p in sorted(d.iterdir())}


@pytest.mark.parametrize("pad_id", [1, 0])
def test_generate_embeddings_from_ckpt_matches_jax(hf_models, tiny_sizes, tmp_path, pad_id):
    """One ESM-2 and one ChemBERTa checkpoint file and the checkpoint's own
    tokenizer (its pad id 1, or 0: the model takes the tokenizer's), through
    both packages: the same cache files, entity by entity within 2e-5."""
    from tests.test_hf_tokenizer import _MERGES, _VOCAB
    esm_ckpt = str(tmp_path / "esm.pt")
    torch.save(hf_models[0].state_dict(), esm_ckpt)
    vocab = dict(_VOCAB) if pad_id == 1 else {"<pad>": 0, "<s>": 1, **{
        k: v for k, v in _VOCAB.items() if k not in ("<pad>", "<s>")}}
    tok = _write_tokenizer(tmp_path / "tok", vocab, _MERGES)
    cb_ckpt = _roberta_ckpt(tmp_path / "cb.pt", len(vocab), pad_id)
    table = _table()
    kw = dict(n_layer=12, esm_ckpt=esm_ckpt, chemberta_ckpt=cb_ckpt, chemberta_tokenizer=tok,
              batch=2, verbose=False)
    jpipe.generate_embeddings(table, JCache(str(tmp_path / "jax"), "toy", 32, 64),
                              chemberta_cfg=_cb_cfg(JCBConfig, len(vocab)), **kw)
    ppipe.generate_embeddings(table, EmbeddingCache(str(tmp_path / "port"), "toy", 32, 64),
                              chemberta_cfg=_cb_cfg(ChemBERTaConfig, len(vocab)), device="cpu",
                              **kw)
    got, want = _cache_files(tmp_path / "port"), _cache_files(tmp_path / "jax")
    assert got.keys() == want.keys() and len(got) == 10
    for name in want:
        assert got[name].shape == want[name].shape and got[name].dtype == np.float32, name
        np.testing.assert_allclose(got[name], want[name], rtol=0, atol=ATOL, err_msg=name)
    seq = next(iter(table.prot2ord))
    assert got["toy_0_prot_64_embedded.npy"].shape == (len(seq) + 2, 64)


def test_generate_embeddings_skips_cached_and_is_seeded(tiny_sizes, tmp_path, capsys):
    """Random init (no checkpoint): the warning, the port's own seeded weights
    (two runs equal, another seed differs), and entities already cached are
    not generated again; the regex tokenizer's vocabulary grows the config."""
    table = _table(n_drugs=37)
    made = []
    real = ChemBERTa.__init__

    def record(self, cfg, dtype=torch.float32):
        made.append(cfg)
        real(self, cfg, dtype)

    caches = {}
    for run, seed in (("a", 0), ("b", 0), ("c", 4)):
        cache = EmbeddingCache(str(tmp_path / run), "toy", 32, 64)
        with pytest.MonkeyPatch.context() as m:
            m.setattr(ChemBERTa, "__init__", record)
            ppipe.generate_embeddings(table, cache, n_layer=12, seed=seed, batch=3,
                                      chemberta_cfg=ChemBERTaConfig(**{
                                          **CB_TINY, "vocab": 40, "max_positions": 128}),
                                      device="cpu")
        caches[run] = _cache_files(tmp_path / run)
    err = capsys.readouterr().err
    assert err.count("WARNING: no ESM-2 checkpoint") == 3
    assert err.count("WARNING: no ChemBERTa checkpoint") == 3
    tok = SmilesTokenizer()
    tok.extend_from_corpus(table.drug2ord)
    assert made[0].vocab == tok.vocab_size > 40
    assert all(np.array_equal(caches["a"][k], caches["b"][k]) for k in caches["a"])
    assert not any(np.array_equal(caches["a"][k], caches["c"][k]) for k in caches["a"])
    cache = EmbeddingCache(str(tmp_path / "a"), "toy", 32, 64)
    with pytest.MonkeyPatch.context() as m:
        m.setattr(pesm.ESM2, "forward", lambda self, t: pytest.fail("ran the ESM stage"))
        m.setattr(ChemBERTa, "forward", lambda self, t: pytest.fail("ran the ChemBERTa stage"))
        ppipe.generate_embeddings(table, cache, n_layer=12, chemberta_cfg=ChemBERTaConfig(
            **{**CB_TINY, "vocab": 40, "max_positions": 128}), verbose=False, device="cpu")


def _poison_jax(monkeypatch):
    real_jit = jpipe.jax.jit
    monkeypatch.setattr(jpipe.jax, "jit", lambda f: (lambda *a: real_jit(f)(*a) * jnp.nan))


def _poison_port(monkeypatch):
    monkeypatch.setattr(pesm.ESM2, "forward",
                        lambda self, t: torch.full((*t.shape, 64), float("nan")))


GUARDS = ["non_finite", "regex_tokenizer_with_ckpt", "regex_tokenizer_with_params",
          "foreign_tokenizer"]


@pytest.mark.parametrize("guard", GUARDS)
def test_guards_raise_as_jax_does(hf_models, tiny_sizes, tmp_path, monkeypatch, guard):
    """Each package on its own copy of the case: the same exception type, the
    same message, and nothing written that the guard stops."""
    table = _table(n_drugs=2)
    cb_ckpt = _roberta_ckpt(tmp_path / "cb.pt", 64)
    outcomes = []
    for name, pipe, cache_cls, cfg_cls in (("jax", jpipe, JCache, JCBConfig),
                                           ("port", ppipe, EmbeddingCache, ChemBERTaConfig)):
        cache = cache_cls(str(tmp_path / name), "toy", 32, 64)
        kw = dict(n_layer=12, batch=2, verbose=False, chemberta_cfg=_cb_cfg(cfg_cls, 64))
        if name == "port":
            kw["device"] = "cpu"
        with pytest.MonkeyPatch.context() as m:
            if guard == "non_finite":
                (_poison_jax if name == "jax" else _poison_port)(m)
            elif guard == "regex_tokenizer_with_ckpt":
                kw["chemberta_ckpt"] = cb_ckpt
            elif guard == "regex_tokenizer_with_params":
                sd = torch.load(cb_ckpt)
                kw["chemberta_params"] = (chemberta_params_from_torch(sd, 1) if name == "jax"
                                          else pconv.chemberta_state_from_torch(sd, 1))
            else:
                big = SmilesTokenizer if name == "port" else JTokenizer
                kw.update(chemberta_ckpt=cb_ckpt, tokenizer=big(extra_tokens=[
                    f"x{i}" for i in range(40)]))
            with pytest.raises((RuntimeError, ValueError)) as e:
                pipe.generate_embeddings(table, cache, **kw)
        written = sorted(p.name for p in (tmp_path / name).glob("*.npy")) \
            if (tmp_path / name).exists() else []
        outcomes.append((type(e.value), str(e.value), written))
    assert outcomes[0] == outcomes[1]
    if guard == "non_finite":
        assert outcomes[1][2] == [] and "non-finite ESM" in outcomes[1][1]
    else:
        assert not any("drug" in f for f in outcomes[1][2])


def test_generate_embeddings_needs_a_card_unless_asked(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ppipe.generate_embeddings(_table(), EmbeddingCache(str(tmp_path), "toy"))
