"""Derivative-level dynamics: M, f, dM/dq, K and D, batch-first (the JAX
package's dynamics.py).

The reference derives these tensors by hand (computeValues,
driverRedMaxBDF1.m:190-243). Here they are exact reverse-mode derivatives
of the value-level assembly model.assemble, one reverse pass each batched
over the unit cotangents (adjoint.batched_jacobian):

    K    = df/dq      [B, nr, nr]  (at fixed qdot)
    D    = df/dqdot   [B, nr, nr]  (at fixed q)
    dMdq = dM/dq      [B, nr, nr, nr], dMdq[:, :, :, i] = dM/dq_i

They serve tests and integrators that want the split form; the Newton
solves differentiate their residuals directly.
"""

from typing import Dict, Tuple

import torch

from redmax_tpu_torch.adjoint import batched_jacobian
from redmax_tpu_torch.model import assemble
from redmax_tpu_torch.types import Topology


def compute_Mf(topo: Topology, params: Dict, q, qdot, force_fns: Tuple = (), aux=None):
    """(M [B, nr, nr], f [B, nr]) at batched (q, qdot) [B, nr]."""
    M, f, _ = assemble(topo, params, q, qdot, force_fns, aux)
    return M, f


def compute_values(topo: Topology, params: Dict, q, qdot, force_fns: Tuple = (), aux=None):
    """(M, f, dMdq, K, D): the implicit integrators' quintuple."""
    B, nr = q.shape
    M, f, _ = assemble(topo, params, q, qdot, force_fns, aux)

    def Mf_q(qq):
        Mq, fq, _ = assemble(topo, params, qq, qdot, force_fns, aux)
        return torch.cat([Mq.reshape(B, nr * nr), fq], dim=-1)

    def f_qdot(qd):
        return assemble(topo, params, q, qd, force_fns, aux)[1]

    dMf = batched_jacobian(Mf_q, q)                       # [B, nr*nr + nr, nr]
    dMdq = dMf[:, :nr * nr].reshape(B, nr, nr, nr)
    K = dMf[:, nr * nr:]
    D = batched_jacobian(f_qdot, qdot)
    return M, f, dMdq, K, D
