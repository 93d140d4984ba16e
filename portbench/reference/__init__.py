"""The plain reference: DrugLAMP and its training step in plain PyTorch,
importing nothing of the program."""
