"""redmax_tpu_torch: the PyTorch + CUDA port of redmax_tpu for NVIDIA Hopper.

The package does everything the JAX package does: every joint, force and
constraint of the scene builder, the BDF1, BDF2, linearly implicit Euler,
friction, PCG and ode45 tiers, the adjoint gradients, the MPC solvers (Adam,
L-BFGS, MPPI), sharding over a torch.distributed world (parallel.py), and
checkpoints, metrics, scene IO and export. The inner BDF2 chord solve, the
dual-PGS contact QP and the friction sweeps run as hand-written CUDA kernels
(chord_kernel.py, qp_kernel.py, pgs_kernel.py, csrc/). Entry points run on
"cuda" unless the caller passes device="cpu".
"""
