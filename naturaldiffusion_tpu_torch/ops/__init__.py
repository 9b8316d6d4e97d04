"""Kernels and their plain PyTorch versions.  A CPU tensor takes the plain
version; a CUDA tensor takes the CUDA kernel (``csrc/``) or raises."""
