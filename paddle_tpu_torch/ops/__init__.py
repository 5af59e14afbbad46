"""Ops of the port: attention dispatch and the hand-written CUDA kernels."""
