"""PyTorch/CUDA port of the `repro` package for NVIDIA Hopper GPUs.

The JAX package `repro` stays the reference; this package mirrors its module
layout (configs, core, kernels, models, launch) and imports nothing of it,
nor JAX. Every Pallas kernel on a ported path is a hand-written CUDA kernel
here (`csrc/`), built with nvcc at first use and held against a plain
PyTorch version beside it. Entry points run on the card (`device="cuda"`)
unless the caller asks for the CPU, where every kernel call runs its plain
version.
"""
