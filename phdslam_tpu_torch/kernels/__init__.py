"""Wrappers of the hand-written CUDA kernels, each with its plain PyTorch
version and a launch counter."""
