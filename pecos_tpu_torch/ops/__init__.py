"""Hand-written CUDA kernels for Hopper, their plain PyTorch versions, and the
build that compiles them from ``csrc/`` at first use."""
