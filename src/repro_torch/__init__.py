"""PyTorch/CUDA port of the ODB reproduction, for an NVIDIA H100.

Mirrors the module names of the JAX package ``repro`` so each counterpart is
easy to find; imports neither JAX nor ``repro``.  Entry points run on the CUDA
card unless the caller passes ``device="cpu"``.
"""
