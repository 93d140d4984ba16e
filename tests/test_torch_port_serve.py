"""The port's serving path against the JAX package's: host featurization
(bit-identical), ``Predictor.predict_pairs`` on real pairs with a ragged last
chunk (2e-5 abs), the port's predict CLI on a checkpoint the port wrote, and
the refusal to run a CUDA Predictor without a card."""

import csv

import numpy as np
import pytest
import torch

from druglamp_tpu.chem.featurize import atom_features_matrix as jax_atom_features
from druglamp_tpu.chem.smiles import parse_smiles as jax_parse
from druglamp_tpu.data.dataset import featurize_drug as jax_featurize_drug
from druglamp_tpu.data.dataset import featurize_prot as jax_featurize_prot
from druglamp_tpu.serve import Predictor as JaxPredictor
from druglamp_tpu_torch.chem.featurize import atom_features_matrix
from druglamp_tpu_torch.chem.smiles import parse_smiles
from druglamp_tpu_torch.data.dataset import featurize_drug, featurize_prot
from druglamp_tpu_torch.serve import Predictor, save_checkpoint
from tests.torch_port_util import SCORE_ATOL, build_pair, port_config, tiny_cfg

SMILES = [
    "CC(=O)OC1=CC=CC=C1C(=O)O",                       # aspirin
    "CN1C=NC2=C1C(=O)N(C(=O)N2C)C",                   # caffeine
    "CC(C)CC1=CC=C(C=C1)C(C)C(=O)O",                  # ibuprofen
    "c1ccc2c(c1)cc[nH]2",                             # indole, aromatic + [nH]
    "C[N+](C)(C)CC(=O)[O-]",                          # charges
    "O=C1CCCN1C/C=C/Br",                              # ring + stereo bonds
    "CC(=O)NC1=CC=C(C=C1)O",                          # paracetamol
]
PROTEINS = [
    "MKTAYIAKQRQISFVKSHFSRQ",
    "MSEQNNTEMTFQIQRIYTKDISFEAPNAPHVFQKDWQPEVKLDLDTASSQLADDVYEVVLRVTVTASLGEETAFLCEVQQGGIFSIAGIEGTQ",
    "GSHMLEDPVDAFQPPQEVLKLSKGDX",
    "MVLSPADKTNVKAAWGKVGAHAGEYGAEALERMFLSFPTTKTYFPHFDLSHGSAQVKGHGKKVADALTNAVAHV",
    "ACDEFGHIKLMNPQRSTVWYBZUO",
]
PAIRS = [(SMILES[i], PROTEINS[i % len(PROTEINS)]) for i in range(5)]   # batch 4: ragged tail


@pytest.mark.parametrize("smiles", SMILES)
def test_drug_featurization_is_bit_identical(smiles):
    np.testing.assert_array_equal(atom_features_matrix(parse_smiles(smiles)),
                                  jax_atom_features(jax_parse(smiles)))
    a, b = featurize_drug(smiles, 3, 32), jax_featurize_drug(smiles, 3, 32)
    assert a.n_atoms == b.n_atoms
    np.testing.assert_array_equal(a.node_feats, b.node_feats)
    np.testing.assert_array_equal(a.edges, b.edges)


@pytest.mark.parametrize("seq", PROTEINS + ["A" * 2000, ""])
def test_protein_featurization_is_bit_identical(seq):
    for max_resis, seq_len in ((1022, 2304), (40, 144)):
        a, b = featurize_prot(seq, 0, max_resis, seq_len), jax_featurize_prot(seq, 0, max_resis, seq_len)
        assert a.fill_start == b.fill_start
        assert a.codes.dtype == b.codes.dtype
        np.testing.assert_array_equal(a.codes, b.codes)


@pytest.fixture(scope="module", params=["DrugLAMP", "DrugLAMPwoLLM"])
def predictors(request):
    cfg = tiny_cfg()
    jmodel, params, stats, pmodel = build_pair(request.param, cfg, seed=11)
    jp = JaxPredictor(jmodel, params, stats, cfg, batch_size=4)
    tp = Predictor(pmodel, port_config(cfg), batch_size=4, device="cpu")
    return request.param, jp, tp


def test_featurized_batches_are_bit_identical(predictors):
    _, jp, tp = predictors
    a, b = tp._featurize(PAIRS), jp._featurize(PAIRS)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_predict_pairs_matches_jax(predictors):
    _, jp, tp = predictors
    ref = jp.predict_pairs(PAIRS)
    out = tp.predict_pairs(PAIRS)
    assert out.shape == (len(PAIRS),) and np.all((out >= 0) & (out <= 1))
    np.testing.assert_allclose(out, ref, rtol=0, atol=SCORE_ATOL)
    ref_p, ref_attn = jp.predict_pairs(PAIRS, return_attn=True)
    out_p, attn = tp.predict_pairs(PAIRS, return_attn=True)
    assert attn.shape == ref_attn.shape == (len(PAIRS), 1, 16, 32)
    np.testing.assert_allclose(out_p, ref_p, rtol=0, atol=SCORE_ATOL)
    np.testing.assert_allclose(attn, ref_attn, rtol=0, atol=SCORE_ATOL)


def test_predict_cli_on_port_checkpoint(predictors, tmp_path):
    from druglamp_tpu_torch.cli.predict import main

    name, _, tp = predictors
    save_checkpoint(str(tmp_path / "work"), tp.model, tp.cfg)
    src = tmp_path / "pairs.csv"
    with open(src, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["SMILES", "Protein", "id"])
        w.writerows([(s, p, i) for i, (s, p) in enumerate(PAIRS)])
    dst = tmp_path / "scores.csv"
    rc = main(["--ckpt", str(tmp_path / "work"), "--model", name, "--input", str(src),
               "--output", str(dst), "--batch-size", "4", "--device", "cpu"])
    assert rc == 0
    with open(dst) as f:
        rows = list(csv.DictReader(f))
    assert [r["id"] for r in rows] == [str(i) for i in range(len(PAIRS))]
    scores = np.array([float(r["score"]) for r in rows])
    np.testing.assert_allclose(scores, tp.predict_pairs(PAIRS), rtol=0, atol=1e-6)


def test_predict_cli_refuses_missing_column(tmp_path):
    from druglamp_tpu_torch.cli.predict import main

    src = tmp_path / "bad.csv"
    src.write_text("SMILES,Sequence\nCCO,MKT\n")
    assert main(["--ckpt", str(tmp_path), "--input", str(src), "--output",
                 str(tmp_path / "o.csv"), "--device", "cpu"]) == 2


def test_cuda_predictor_refuses_without_card(predictors):
    _, _, tp = predictors
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Predictor(tp.model, tp.cfg, device="cuda")
