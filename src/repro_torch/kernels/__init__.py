"""Kernels of the port: hand-written CUDA C++ for Hopper (``csrc/``),
their wrappers, and their plain PyTorch versions (``ref.py``)."""
