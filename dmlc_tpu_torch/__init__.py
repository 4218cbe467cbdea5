"""PyTorch/CUDA port of ``dmlc_tpu`` for an NVIDIA H100.

The JAX package beside it is the reference. This package imports nothing
from it (nor JAX): modules it needs that are framework-free are copied here
with their imports rewritten. Entry points run on the CUDA device unless the
caller passes ``device="cpu"``; they never fall back to the CPU on their own.
"""
