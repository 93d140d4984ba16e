"""PyTorch port of druglamp_tpu for NVIDIA Hopper GPUs.

The serving path (``serve.Predictor`` → the DrugLAMP forward variants) runs on
``cuda`` by default, with hand-written CUDA kernels for the PMMA attention
cores (``csrc/``, built at first use by ``kernels/build.py``).  The JAX package
``druglamp_tpu`` is the reference the tests hold this package to; nothing
here imports it or JAX.
"""
