"""Hand-written Hopper kernels and their plain PyTorch versions.

Each kernel keeps the reference's layout: ``ops.py`` (the wrapper that
launches the CUDA kernel from ``csrc/``), ``ref.py`` (its plain PyTorch
version). ``build.py`` compiles ``csrc/`` with ``nvcc`` at first use.
"""
