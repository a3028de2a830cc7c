"""Hand-written CUDA kernels for Hopper (sources in csrc/) and their plain PyTorch versions."""
