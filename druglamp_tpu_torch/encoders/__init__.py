"""The frozen encoders (ESM-2, ChemBERTa), their checkpoint converters and
the embedding-cache pipeline behind the CLI's ``--gen-embed``."""
