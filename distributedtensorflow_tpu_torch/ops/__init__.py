"""Ops of the port: the plain PyTorch twins and their CUDA kernels."""
