"""PyTorch/CUDA port of the temporal-vectorization serving stack.

The JAX package ``repro`` is the reference; this package mirrors its module
names (``configs``, ``kernels``, ``models``, ``serve``, ``launch``) and runs
on an NVIDIA Hopper card.  Its attention kernels are hand-written CUDA C++
(``csrc/``), built with ``nvcc`` at first use.  Nothing here imports JAX or
any module of ``repro``.
"""
