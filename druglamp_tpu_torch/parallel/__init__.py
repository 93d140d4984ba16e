"""Training over several ranks (port of ``druglamp_tpu/parallel/``):
``distributed`` joins torchrun's process group, ``mesh`` lays the ranks out
as a (data, model) grid, shards the batch over the data axis and the wide
layers over the model axis, and reduces across them."""
