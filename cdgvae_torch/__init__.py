"""cdgvae_torch: the PyTorch/CUDA port of cdgvae_tpu for NVIDIA Hopper.

The module tree mirrors ``cdgvae_tpu`` so each counterpart is easy to find.
Parameters keep the JAX package's names and layouts (``utils/interop.py``
copies a JAX param pytree in). The package imports torch and numpy only.
"""
