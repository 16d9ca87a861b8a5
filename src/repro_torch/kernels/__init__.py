"""Kernels of the port (metering and attention): hand-written CUDA for Hopper
(``csrc/``), their plain PyTorch versions (``ref``), and the
dispatch between them (``ops``)."""
