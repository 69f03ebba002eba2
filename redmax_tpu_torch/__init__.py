"""redmax_tpu_torch: the PyTorch + CUDA port of redmax_tpu for NVIDIA Hopper.

This package covers the batched MPC main path: constant-S joint scenes,
SDIRK2-bootstrapped BDF2 with fixed-iteration chord Newton, the
factor-reusing adjoint and a batched Adam solve. The inner BDF2 chord solve
runs as a hand-written CUDA kernel (chord_kernel.py, csrc/). Entry points
run on "cuda" unless the caller passes device="cpu".
"""
