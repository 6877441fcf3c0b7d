"""PyTorch/CUDA port of minddet_tpu for NVIDIA Hopper (H100).

Mirrors the JAX package's module paths; imports ``torch`` and never
``jax``, ``flax`` or ``minddet_tpu``. Hand-written CUDA kernels live in
``csrc/`` and are built and bound by ``kernels.py``; ``entry.py`` gives the
flagship serving program.
"""
