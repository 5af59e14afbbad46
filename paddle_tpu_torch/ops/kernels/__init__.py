"""Hand-written Hopper kernels (CUDA C++ under ``csrc/``), each with a
Python wrapper, a plain PyTorch version and a launch counter.

Importing this package builds nothing: ``build.load`` compiles a source
with nvcc the first time its kernel launches.
"""
