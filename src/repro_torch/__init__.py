"""PyTorch/CUDA port of the ``repro`` package for one NVIDIA H100.

Module names mirror ``src/repro/`` so each module's counterpart is easy to
find. The package imports ``torch`` and numpy only: never ``jax`` and
nothing of ``repro`` (what it needs from the numpy-only modules there it
keeps as its own copy). Hand-written Hopper kernels live under
``kernels/``; on a CUDA tensor their wrappers launch the kernel or raise,
and they use their plain PyTorch version only for tensors on the CPU.
"""
