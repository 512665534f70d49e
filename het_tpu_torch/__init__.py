"""het_tpu_torch: the PyTorch/CUDA port of het_tpu for NVIDIA Hopper.

The JAX package ``het_tpu`` stays the reference; this package imports
nothing of it.  Entry points run on the GPU unless the caller passes
``device="cpu"``.
"""
