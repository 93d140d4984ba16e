"""The plain reference agrees with the program at a tiny size on the CPU when
both compute in float32: the same seeded weights, inputs and draws give the
same losses, first gradients and probabilities to rounding.  (The change
after three AdamW steps is looser: a first AdamW step moves an entry by ±lr
whatever its gradient's size, so rounding in tiny gradients shows.)"""

import pytest

import tiny

F32 = {"loss": 2e-5, "grad": 2e-5, "gradmed": 2e-5, "changemed": 1e-3, "change": 5e-2,
       "prob": 1e-6}


@pytest.mark.parametrize("name", tiny.cells())
def test_the_reference_agrees_with_the_program_in_float32(name):
    cell = tiny.cell(name)
    cell.cfg = {**cell.cfg, "compute_dtype": "float32"}
    cell.limits = {k: 1.0 for k in cell.limits}
    result, _, _ = tiny.run(cell, control="float32")    # a control asks for every number
    numbers = {**{k: c["value"] for k, c in result["checks"].items()}, **result["readings"]}
    for k, v in numbers.items():
        assert v <= F32[k.split(".")[0]], (k, v)


def test_the_benchmarks_inputs_are_the_programs_formats():
    """The frozen featuriser, protein coding and packing give what the program's
    own would give from the same SMILES and residues."""
    import numpy as np

    from druglamp_tpu_torch.chem import featurize
    from druglamp_tpu_torch.data import encoding
    from harness import library

    feats, adj, atoms = library.drug_graphs(library.SMILES, 64)
    for i, smi in enumerate(library.SMILES):
        want = featurize.drug_graph_arrays(smi, 64)
        assert np.array_equal(feats[i], want["node_feats"]) and np.array_equal(adj[i], want["adj"])
        assert atoms[i] == want["n_atoms"]
    bits, ints = library.pack_node_features(feats)
    want_bits, want_ints = encoding.pack_node_feats(feats)
    assert np.array_equal(bits, want_bits) and np.array_equal(ints, want_ints)
    assert np.array_equal(library.pack_bits((adj > 0).astype(np.uint8)),
                          encoding.pack_adjacency((adj > 0).astype(np.uint8)))
    rng = np.random.default_rng(3)
    lengths = rng.integers(5, 61, size=12)          # the library keeps to max_resis (60 here)
    residues = rng.integers(1, 26, size=(12, 60)).astype(np.uint8)
    codes, fill = library.protein_codes(residues, lengths, 144)
    letters = {v: k for k, v in library.CHARPROTSET.items()}
    for i, n in enumerate(lengths):
        seq = "".join(letters[c] for c in residues[i, :n])
        assert np.array_equal(codes[i], featurize.repeat_integer_label_protein(seq, 60, 144))
        assert fill[i] == (144 // (n + 2)) * (n + 2)
