"""The port's native featurization runtime (``chem/native.py`` over its own
copy of the C++ source), the dense host batches (``BatchLoader(compact=False)``)
and ``utils/profiling.py``, on the CPU.

- ``parse_featurize`` and ``assemble_batch`` against the port's Python
  parser and graph arrays and against the JAX package's ``chem/native.py``, on
  ``tests/test_native.py``'s SMILES; the same errors.
- The library is built from the port's source into ``_build/``, not loaded
  from ``native/``; without a compiler nothing is built and the loader takes
  numpy; a compiler without OpenMP's runtime builds it without ``-fopenmp``.
- ``BatchLoader(compact=False)``: batches bit-identical to the JAX package's,
  key for key and dtype for dtype, with ``llm_dtype`` bf16 (the port's uint16
  bit patterns against ``ml_dtypes.bfloat16``) and f32, the adjacency from
  the native packer and from numpy, LLM arrays from a seeded cache, and for
  DrugLAMPwoLLM, a ragged last batch included; ``decode_batch`` passes a dense
  batch through; the prefetch thread yields the inline batches.
- ``device_time_ms(device="cpu")`` is positive; ``trace`` writes a
  non-empty Chrome trace.
"""

import json
import os

import ml_dtypes
import numpy as np
import pytest
import torch

import druglamp_tpu.chem.native as jnative
from druglamp_tpu.data.cache import EmbeddingCache as JCache
from druglamp_tpu.data.dataset import DTIDataset as JDataset
from druglamp_tpu.data.loader import BatchLoader as JBatchLoader
from druglamp_tpu_torch.chem import native
from druglamp_tpu_torch.chem.featurize import atom_features_matrix, drug_graph_arrays
from druglamp_tpu_torch.chem.smiles import parse_smiles
from druglamp_tpu_torch.data import loader as loader_mod
from druglamp_tpu_torch.data.cache import BF16_HOST, EmbeddingCache
from druglamp_tpu_torch.data.dataset import DTIDataset
from druglamp_tpu_torch.data.encoding import decode_batch
from druglamp_tpu_torch.data.loader import BatchLoader
from druglamp_tpu_torch.utils.profiling import device_time_ms, trace
from tests.test_torch_port_host_pipeline import _kw, _seed_cache
from tests.test_torch_port_trainer import _cfg, _toy_dataset

SMILES = ["CCO", "c1ccccc1", "CC(=O)O", "C#N", "[NH4+]", "[Na+].[Cl-]", "c1ccc2ccccc2c1",
          "C[C@H](N)C(=O)O", "F/C=C/F", "Cc1ccncc1Br", "O=C(O)c1ccccc1OC(=O)C"]
B = 4


def _py_edges(mol):
    src, dst = [], []
    for bd in mol.bonds:
        src += [bd.a, bd.b]
        dst += [bd.b, bd.a]
    return np.array([src, dst], np.int32) if src else np.zeros((2, 0), np.int32)


@pytest.fixture(scope="module")
def built():
    if not native.available():
        pytest.fail("the port's native library did not build (g++ is on this machine)")
    return native


@pytest.mark.parametrize("smi", SMILES)
def test_parse_featurize_matches_python_and_the_jax_package(built, smi):
    feats, edges, n = built.parse_featurize(smi)
    mol = parse_smiles(smi)
    assert n == mol.num_atoms
    np.testing.assert_array_equal(feats, atom_features_matrix(mol))
    np.testing.assert_array_equal(edges, _py_edges(mol))
    jf, je, jn = jnative.parse_featurize(smi)
    assert n == jn
    np.testing.assert_array_equal(feats, jf)
    np.testing.assert_array_equal(edges, je)


def test_native_errors_match(built):
    for bad, kw, match in (("C1CC", {}, "unclosed ring"), ("[Zz]", {}, "bracket"),
                           ("C" * 60, {"max_nodes": 8}, "max_nodes"),
                           ("C" * 60, {"max_edges": 8}, "max_edges")):
        with pytest.raises(ValueError, match=match) as got:
            built.parse_featurize(bad, **kw)
        with pytest.raises(ValueError) as want:
            jnative.parse_featurize(bad, **kw)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="outside"):
        built.assemble_batch([np.array([[0, 9], [9, 0]], np.int32)], np.array([2]), 8)


def test_assemble_batch_matches_python_and_the_jax_package(built):
    edge_list, natoms = [], []
    for smi in SMILES[:5]:
        _, edges, n = built.parse_featurize(smi)
        edge_list.append(edges)
        natoms.append(n)
    adj, deg = built.assemble_batch(edge_list, np.array(natoms), N=16)
    jadj, jdeg = jnative.assemble_batch(edge_list, np.array(natoms), N=16)
    np.testing.assert_array_equal(adj, jadj)
    np.testing.assert_array_equal(deg, jdeg)
    for b, smi in enumerate(SMILES[:5]):
        ref = drug_graph_arrays(smi, max_nodes=16)
        np.testing.assert_array_equal(adj[b], ref["adj"])
        np.testing.assert_array_equal(deg[b], ref["degrees"])


def test_the_library_is_the_ports_own_build(built, tmp_path, monkeypatch):
    path = built.library_path()
    assert path.parent == built.BUILD_DIR and path.parent.name == "_build"
    assert path.exists() and path.name.startswith("libdruglamp_native-")
    assert os.path.basename(jnative._lib_path()) == "libdruglamp_native.so"
    assert os.path.realpath(path) != os.path.realpath(jnative._lib_path())
    assert built.SOURCE.parent.name == "native" and built.SOURCE.parent.parent.name == "csrc"
    # without a compiler: nothing is built, the loader says so and takes numpy
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("CXX", "no-such-compiler")
    assert not native._try_build(tmp_path / "lib.so") and not list(tmp_path.iterdir())
    monkeypatch.setenv("DRUGLAMP_NO_NATIVE_BUILD", "1")
    monkeypatch.delenv("CXX")
    assert not native._try_build(tmp_path / "lib.so")


# --- dense batches ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def world(tmp_path_factory):
    cfg = _cfg()
    root = _toy_dataset(str(tmp_path_factory.mktemp("data")), n_train=10, n_eval=6)
    train = DTIDataset(root, "toy", "random", "train.csv", **_kw(cfg))
    jtrain = JDataset(root, "toy", "random", "train.csv", **_kw(cfg))
    cache = _seed_cache(os.path.join(root, "cache"), train.table, cfg)
    return {"train": train, "jtrain": jtrain, "cache": cache}


def _assert_same_batch(got, want, where=""):
    assert set(got) == set(want), where
    for k, v in want.items():
        if isinstance(v, dict):
            _assert_same_batch(got[k], v, f"{where}{k}/")
            continue
        g = got[k]
        if v.dtype == ml_dtypes.bfloat16:
            assert g.dtype == BF16_HOST, k
            v = v.view(np.uint16)
        else:
            assert g.dtype == v.dtype, (where, k, g.dtype, v.dtype)
        np.testing.assert_array_equal(g, v, err_msg=f"{where}{k}")


@pytest.mark.parametrize("adjacency", ["native", "numpy"])
@pytest.mark.parametrize("llm_dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("include_llm", [True, False])
def test_dense_batches_match_the_jax_loader(world, monkeypatch, adjacency, llm_dtype,
                                            include_llm):
    if adjacency == "numpy":
        monkeypatch.setattr(native, "available", lambda: False)
        monkeypatch.setattr(jnative, "available", lambda: False)
    else:
        assert native.available() and jnative.available()
    pdt, jdt = ((torch.bfloat16, ml_dtypes.bfloat16) if llm_dtype == "bfloat16"
                else (np.float32, np.float32))
    port = BatchLoader(world["train"], B, shuffle=True, drop_last=False, seed=3, prefetch=0,
                       embeddings=EmbeddingCache(world["cache"], "toy", 24, 40),
                       include_llm=include_llm, compact=False, llm_dtype=pdt)
    ref = JBatchLoader(world["jtrain"], B, shuffle=True, drop_last=False, seed=3, prefetch=0,
                       embeddings=JCache(world["cache"], "toy", 24, 40),
                       include_llm=include_llm, compact=False, llm_dtype=jdt)
    got, want = list(port.epoch(1)), list(ref.epoch(1))
    assert len(got) == len(want) == 3 and want[-1]["valid"].sum() == 2     # a ragged tail
    for g, w in zip(got, want):
        _assert_same_batch(g, w)
        assert "drug_adj" in g and "drug_adj_packed" not in g
        assert ("xp" in g) == include_llm and "xp_src" not in g
    port.prefetch = 2
    for a, b in zip(port._epoch_uncached(1), got):
        _assert_same_batch(a, b)
    tensors = {k: torch.from_numpy(v) for k, v in got[0].items() if k != "cm"}
    assert decode_batch(tensors) is tensors


def test_dense_loader_rejects_ordinals_and_other_dtypes(world):
    with pytest.raises(ValueError, match="compact"):
        BatchLoader(world["train"], B, shuffle=False, drop_last=False, emb_ordinals=True,
                    compact=False)
    with pytest.raises(ValueError, match="llm_dtype"):
        BatchLoader(world["train"], B, shuffle=False, drop_last=False, llm_dtype=np.float16)


def test_missing_native_packer_is_said_once(world, monkeypatch, capsys):
    monkeypatch.setattr(native, "available", lambda: False)
    monkeypatch.setattr(loader_mod, "_NATIVE_INFO_SHOWN", [])
    port = BatchLoader(world["train"], B, shuffle=False, drop_last=False, prefetch=0,
                       compact=False)
    list(port.epoch(0))
    list(port.epoch(0))
    err = capsys.readouterr().err
    assert err.count(native.INFO_NOT_BUILT) == 1 and "pure-Python fallback" in err


# --- utils/profiling -------------------------------------------------------------------------

def test_device_time_on_the_cpu_and_the_trace(tmp_path):
    x = torch.randn(64, 64)
    assert device_time_ms(torch.mm, x, x, n1=2, n2=6, device="cpu") > 0
    with pytest.raises(ValueError):
        device_time_ms(torch.mm, x, x, n1=4, n2=4, device="cpu")
    with trace(str(tmp_path), device="cpu"):
        torch.mm(x, x)
    (path,) = list(tmp_path.iterdir())
    assert path.name.endswith(".pt.trace.json") and path.stat().st_size > 0
    events = json.loads(path.read_text())["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)


def test_a_compiler_without_openmp_builds_the_serial_library(tmp_path, monkeypatch):
    """A ``CXX`` that fails with ``-fopenmp`` (as one whose OpenMP runtime is
    not installed does): the loader builds the library without it, under the
    serial flags' own name, and loads it; the same arrays."""
    fake = tmp_path / "cxx"
    fake.write_text('#!/bin/sh\nfor a in "$@"; do [ "$a" = -fopenmp ] && '
                    '{ echo "cannot read spec file libgomp.spec" >&2; exit 1; }; done\n'
                    'exec g++ "$@"\n')
    fake.chmod(0o755)
    monkeypatch.setenv("CXX", str(fake))
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_LIB_PATH", None)
    monkeypatch.setattr(native, "_TRIED", False)
    serial = native.library_path(native.SERIAL_FLAGS)
    assert serial != native.library_path()
    assert native.loaded_path() == serial and serial.exists()
    assert not native.library_path().exists()
    smi = SMILES[0]
    assert all(np.array_equal(a, b) for a, b in zip(native.parse_featurize(smi),
                                                    jnative.parse_featurize(smi)))
