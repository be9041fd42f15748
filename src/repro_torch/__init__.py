"""PyTorch/CUDA port of the ``repro`` serving system.

Mirrors the reference package module by module
(``repro_torch/serving/blocks.py`` <-> ``repro/serving/blocks.py``).  It
imports ``torch`` and numpy only, never JAX and nothing of ``repro``.
Entry points run on the CUDA card unless the caller passes
``device="cpu"``; the TPU kernels on the served path are hand-written
CUDA C++ for Hopper (``repro_torch/kernels/csrc``).
"""
