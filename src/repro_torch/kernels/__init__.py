"""The port's kernels: hand-written CUDA for Hopper beside plain PyTorch versions."""
