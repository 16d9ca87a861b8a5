"""PyTorch + CUDA port of the fleet-accounting stack (``repro``).

The mega simulator's bulk phases run on an NVIDIA GPU through
``fleet.mega.run_mega(backend="torch")``; the metering kernels are
hand-written CUDA for Hopper (``kernels/csrc``).  Imports torch and
numpy only.
"""
