from druglamp_tpu_torch.chem.smiles import Atom, Bond, Molecule, parse_smiles, SmilesError  # noqa: F401
from druglamp_tpu_torch.chem.featurize import (  # noqa: F401
    ATOM_FEATURE_DIM,
    atom_features_matrix,
    drug_graph_arrays,
    integer_label_protein,
    repeat_integer_label_protein,
    CHARPROTSET,
)
from druglamp_tpu_torch.chem.tokenizer import SmilesTokenizer, smiles_token_edges  # noqa: F401
