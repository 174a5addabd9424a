"""The benchmark's plain reference of mesh2splat_torch: a frozen copy of the
port's modules (``types``, ``ops/``, ``render/``) in which every kernel call
takes its plain PyTorch version, on any device. It imports nothing of the
program, nor jax, nor the JAX package, and takes only the inputs that the
benchmark makes; it converts and renders them again itself.

The copy fixes the semantics the benchmark holds the program to: a later
change of the program's kernels or ops does not move it.
"""
