"""PyTorch/CUDA port of the ``repro`` package.

Mirrors ``repro`` file for file; each Pallas kernel of ``repro.kernels`` has
a hand-written Hopper kernel here (``kernels/csrc``) beside a plain torch
version.  Imports torch and numpy only, never JAX or ``repro``.
"""
