"""Data-parallel training over several ranks (port of ``druglamp_tpu/parallel/``):
``distributed`` joins torchrun's process group, ``mesh`` shards the batch and
reduces across the ranks."""

TENSOR_PARALLEL_SLICE = "the tensor-parallel slice"
