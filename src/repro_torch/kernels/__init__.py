"""Attention, SSD, the paper's four pumped kernels and the grouped GEMM:
hand-written CUDA (``csrc/``) behind ``ops``, with the plain PyTorch
versions in ``ref``.  Importing this package builds nothing; a kernel is
built at its first launch."""
