"""Building and loading the hand-written CUDA kernels in ``csrc/``."""
