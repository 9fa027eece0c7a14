"""Hand-written CUDA kernels for Hopper (sources in ``csrc/``), each with a
plain PyTorch version beside it.  Public entry points are in ``ops``."""
