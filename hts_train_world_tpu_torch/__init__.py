"""PyTorch/CUDA port of the WORLD vocoder fast path (for an NVIDIA H100).

The JAX package `hts_train_world_tpu` is the reference; this package
imports nothing of it.  Hot formulations are hand-written CUDA kernels
(`csrc/`, built on first use by `kernels.py`); each has a plain PyTorch
twin, which runs for CPU tensors.
"""
