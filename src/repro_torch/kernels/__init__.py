"""Attention kernels: hand CUDA kernels for Hopper (csrc/), their plain
PyTorch versions, and the oracles."""
