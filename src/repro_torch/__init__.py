"""ARCAS serving stack ported to PyTorch and CUDA for NVIDIA Hopper.

The JAX package ``repro`` is the reference; this package mirrors its
layout module by module and imports nothing from it.  Entry points run on
``cuda`` unless the caller passes ``device="cpu"``.
"""
