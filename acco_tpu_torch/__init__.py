"""acco_tpu_torch: the PyTorch/CUDA port of acco_tpu, for NVIDIA Hopper.

It imports torch and never jax, and nothing of the ``acco_tpu`` package:
where it needs a framework-free module of that package it keeps its own
copy. Module names follow the JAX package's, so each module's counterpart
is found by name. The entry point is ``python -m acco_tpu_torch``
(``__main__.py``); its CUDA kernels live in ``csrc/`` and are built at
first use into ``build/`` at the root of the checkout.
"""
