"""Torch ops of the port; the CUDA kernels' wrappers are in ops.kernels."""
