"""Trajectory optimization / MPC.

One "MPC solve" = one horizon-long rollout + one adjoint backward pass + one
Adam update of the torque parameters. The objective is a terminal
point-position cost plus regularization (TaskBDF1PointPos.m:67-107).

Two forms, as in the JAX package: the unbatched one (make_rollout,
make_objective, make_mpc_solver: one task, p [nr], BDF1 or BDF2 at op level,
the reference's adjoint driver, driverRedMaxAdjointBDF1.m:15-62) and the
batched one (the *_batched functions: P [B, nr], BDF2 on the kernel route
where the scene qualifies). Lanes are independent: the gradient of the sum
of the lane objectives is the per-lane gradient, and a diverged (NaN) lane
poisons only its own rows of P. The L-BFGS and MPPI solvers are not ported
yet (they raise).
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


def _as_lane(state: State) -> State:
    """An unbatched state as one lane."""
    return State(q=state.q[None], qdot=state.qdot[None],
                 aux={k: v[None] for k, v in state.aux.items()})


def _lane0(state) -> State:
    """Lane 0 of a batched state, as an unbatched State."""
    return State(q=state.q[0], qdot=state.qdot[0], aux={k: v[0] for k, v in state.aux.items()})


def make_rollout(
    topo: Topology,
    force_fns: Tuple,
    nsteps: int,
    integrator: str = "bdf2",
    cfg: Optional[integrators.NewtonConfig] = None,
):
    """(params, tau [nr], state0) -> the State after nsteps, state0 and the
    result unbatched (q [nr]), differentiable in tau (and in any params
    leaf that requires grad) through the implicit-function adjoint of
    integrators.make_bdf1_step or make_bdf2_step ("bdf1" or "bdf2"), run
    as one lane."""
    cfg = cfg or integrators.NewtonConfig()
    if integrator == "bdf1":
        step, init = integrators.make_bdf1_step(topo, force_fns, cfg, differentiable=True), None
    elif integrator == "bdf2":
        step = integrators.make_bdf2_step(topo, force_fns, cfg, differentiable=True)
        init = integrators.bdf2_init
    else:
        raise ValueError(integrator)
    sim = integrators.make_simulate(step, nsteps)

    def rollout(params: Dict, tau, state0: State) -> State:
        s0 = _as_lane(state0)
        return _lane0(sim({**params, "tau": tau}, s0 if init is None else init(s0)))

    return rollout


def _tip_cost(topo, params, task, xlocal, final: State, P, x_targets):
    """The task's cost [B] at a batched final state."""
    kin = forward_kinematics(topo, params, final.q, final.qdot, final.aux)
    E = kin.E_wi[:, task.body]                                     # [B,4,4]
    xl = torch.as_tensor(xlocal, dtype=final.q.dtype, device=final.q.device)
    dx = E[:, :3, :3] @ xl + E[:, :3, 3] - x_targets
    return 0.5 * task.wp * (dx * dx).sum(-1) + 0.5 * task.wreg * (P * P).sum(-1)


def make_objective(
    topo: Topology,
    force_fns: Tuple,
    task: PointPosTask,
    xlocal,
    nsteps: int,
    integrator: str = "bdf2",
    cfg: Optional[integrators.NewtonConfig] = None,
):
    """(params, p [nr], state0, x_target [3]) -> the scalar objective at the
    final step only (TaskBDF1PointPos.calcStep at t* = tEnd,
    TaskBDF1PointPos.m:73-78)."""
    rollout = make_rollout(topo, force_fns, nsteps, integrator, cfg)

    def objective(params: Dict, p, state0: State, x_target):
        final = _as_lane(rollout(params, task.pscale * p, state0))
        return _tip_cost(topo, params, task, xlocal, final, p[None], x_target[None])[0]

    return objective


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
        return _tip_cost(topo, params, task, xlocal, final, P, x_targets)

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


def _adam_solver(objective_fn: Callable, iters: int, lr: float):
    """Fixed-iteration Adam on an objective of P: a scalar of p [nr] or a
    lane vector [B] of P [B, nr] (each lane's gradient is that of the sum)."""
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


def make_mpc_solver(objective_fn: Callable, iters: int = 1, lr: float = 1e-2,
                    method: str = "adam"):
    """Fixed-iteration gradient MPC solve of an unbatched objective
    (make_objective): (params, p0 [nr], state0, x_target) -> MpcResult.
    method "adam" (optax.adam's defaults); "lbfgs", the reference's
    fminunc quasi-Newton coupling, is not ported yet."""
    if method == "lbfgs":
        raise NotImplementedError("make_mpc_solver(method='lbfgs') is not ported yet "
                                  "(the L-BFGS solver; method='adam' is)")
    if method != "adam":
        raise ValueError(method)
    return _adam_solver(objective_fn, iters, lr)


def make_mpc_solver_batched(objective_fn: Callable, iters: int = 1, lr: float = 1e-2):
    """Fixed-iteration Adam MPC solve over an explicitly-batched objective."""
    return _adam_solver(objective_fn, iters, lr)


def make_mppi_solver(*args, **kwargs):
    raise NotImplementedError("make_mppi_solver is not ported yet (the sampling MPPI solver)")


def make_mppi_solver_batched(*args, **kwargs):
    raise NotImplementedError("make_mppi_solver_batched is not ported yet "
                              "(the sampling MPPI solver)")
