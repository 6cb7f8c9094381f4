"""Hand-written CUDA kernels and their wrappers.

Each wrapper launches its kernel for a CUDA tensor, runs the kernel's plain
PyTorch version for a CPU tensor, and counts its launches in ``LAUNCHES``.
Sources are in ``../csrc`` and are built with ``nvcc`` at first use
(``build.py``)."""
