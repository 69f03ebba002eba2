"""Batched trajectory optimization / MPC.

One "MPC solve" = one horizon-long batched BDF2 rollout + one adjoint
backward pass + one Adam update of the per-lane torque parameters P [B, nr].
The objective is a terminal point-position cost plus regularization
(TaskBDF1PointPos.m:67-107). Lanes are independent: the gradient of the sum
of the lane objectives is the per-lane gradient, and a diverged (NaN) lane
poisons only its own rows of P.
"""

from dataclasses import dataclass
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from redmax_tpu_torch import integrators
from redmax_tpu_torch.model import forward_kinematics
from redmax_tpu_torch.types import State, Topology


@dataclass(frozen=True)
class PointPosTask:
    """Terminal point-position task (TaskBDF1PointPos.m).

    Objective: 0.5 * wp * |x_world(body, xlocal; T) - x_target|^2
             + 0.5 * wreg * |p|^2,   with torques tau = pscale * p.
    """

    body: int
    wp: float = 1.0
    wreg: float = 1e-6
    pscale: float = 1.0


def make_rollout_batched(
    topo: Topology,
    force_fns: Tuple,
    nsteps: int,
    cfg: Optional[integrators.NewtonConfig] = None,
    use_kernel: bool = None,
    backward: str = "reuse",
):
    """(params, tau [B,nr] or [nr], state0 [B,...]) -> final batched State,
    differentiable in tau through the implicit-function adjoint
    (integrators.make_bdf2_step_batched; backward picks its H on the kernel
    route)."""
    cfg = cfg or integrators.NewtonConfig()
    step = integrators.make_bdf2_step_batched(
        topo, force_fns, cfg, differentiable=True, use_kernel=use_kernel, backward=backward
    )
    sim = integrators.make_simulate(step, nsteps)

    def rollout(params: Dict, tau, state0: State):
        final = sim({**params, "tau": tau}, integrators.bdf2_init(state0))
        return State(q=final.q, qdot=final.qdot, aux=final.aux)

    return rollout


def make_objective_batched(
    topo: Topology,
    force_fns: Tuple,
    task: PointPosTask,
    xlocal,
    nsteps: int,
    cfg: Optional[integrators.NewtonConfig] = None,
    use_kernel: bool = None,
    backward: str = "reuse",
):
    """(params, P [B,nr], state0 [B,...], x_targets [B,3]) -> objectives [B]."""
    rollout = make_rollout_batched(topo, force_fns, nsteps, cfg, use_kernel, backward)

    def objective(params: Dict, P, state0: State, x_targets):
        final = rollout(params, task.pscale * P, state0)
        kin = forward_kinematics(topo, params, final.q, final.qdot)
        E = kin.E_wi[:, task.body]                                 # [B,4,4]
        xl = torch.as_tensor(xlocal, dtype=final.q.dtype, device=final.q.device)
        xw = E[:, :3, :3] @ xl + E[:, :3, 3]
        dx = xw - x_targets
        return 0.5 * task.wp * (dx * dx).sum(-1) + 0.5 * task.wreg * (P * P).sum(-1)

    return objective


class MpcResult(NamedTuple):
    p: Any          # optimized torque parameters
    objective: Any  # objective [B] at the last iterate before its update
    grad_norm: Any  # gradient norm [B] at the same iterate


def _adam(lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
    """Adam with optax.adam's defaults (eps_root = 0): returns (init, update),
    update(g, state) -> (step to add, new state). Elementwise, so lanes stay
    independent."""

    def init(P):
        return (torch.zeros_like(P), torch.zeros_like(P), 0)

    def update(g, state):
        mu, nu, count = state
        mu = (1 - b1) * g + b1 * mu
        nu = (1 - b2) * (g * g) + b2 * nu
        count = count + 1
        mu_hat = mu / (1 - b1 ** count)
        nu_hat = nu / (1 - b2 ** count)
        return -lr * (mu_hat / (torch.sqrt(nu_hat) + eps)), (mu, nu, count)

    return init, update


def make_mpc_solver_batched(objective_fn: Callable, iters: int = 1, lr: float = 1e-2):
    """Fixed-iteration Adam MPC solve over an explicitly-batched objective."""
    init, update = _adam(lr)

    def solve(params: Dict, P0, state0: State, x_targets) -> MpcResult:
        P = P0.detach()
        opt_state = init(P)
        for _ in range(iters):
            Pg = P.detach().requires_grad_(True)
            with torch.enable_grad():
                v = objective_fn(params, Pg, state0, x_targets)
                (g,) = torch.autograd.grad(v.sum(), Pg)
            v, gnorm = v.detach(), torch.linalg.vector_norm(g, dim=-1)
            step, opt_state = update(g, opt_state)
            P = P + step
        return MpcResult(p=P, objective=v, grad_norm=gnorm)

    return solve
