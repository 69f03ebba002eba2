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
poisons only its own rows of P. The sampling MPPI solvers take both forms;
the L-BFGS solver is not ported yet (it raises).
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
        raise NotImplementedError("make_mpc_solver(method='lbfgs') is not ported yet: the "
                                  "L-BFGS solver (optax.lbfgs with its zoom line search) "
                                  "comes with parallel.py; method='adam' is ported")
    if method != "adam":
        raise ValueError(method)
    return _adam_solver(objective_fn, iters, lr)


def make_mpc_solver_batched(objective_fn: Callable, iters: int = 1, lr: float = 1e-2):
    """Fixed-iteration Adam MPC solve over an explicitly-batched objective."""
    return _adam_solver(objective_fn, iters, lr)


def _mppi_combine(costs, cand, p0, temperature):
    """Softmax-average the candidates cand [S, ...] by their costs [S], with
    per-candidate failure masking: a diverged (non-finite) candidate gets
    weight 0; if every candidate diverged, the result is p0 with an inf
    cost (never NaN). Returns (p_new, mean_cost)."""
    finite = torch.isfinite(costs)
    costs = torch.where(finite, costs, torch.full_like(costs, float("inf")))
    any_ok = finite.any()
    w = torch.softmax(torch.where(any_ok, -costs / temperature, torch.zeros_like(costs)), dim=0)
    cand = torch.where(any_ok, cand, p0[None])
    p_new = torch.einsum("s,s...->...", w, cand)
    # A masked candidate's weight is exactly 0 but its cost is inf, and
    # 0 * inf = NaN: sum only the finite ones.
    mean_cost = torch.where(finite, w * costs, torch.zeros_like(costs)).sum()
    return p_new, torch.where(any_ok, mean_cost, torch.full_like(mean_cost, float("inf")))


def _candidates(generator, p0, n_samples: int, sigma: float):
    """p0 + sigma N(0, 1) [n_samples, ...], drawn on the generator's device."""
    eps = torch.randn((n_samples,) + tuple(p0.shape), generator=generator, dtype=p0.dtype,
                      device=generator.device)
    return p0[None] + sigma * eps.to(p0.device)


def make_mppi_solver(rollout_cost: Callable, n_samples: int = 256, sigma: float = 0.3,
                     temperature: float = 1.0):
    """Sampling MPC (MPPI) over an unbatched cost: perturb p0 with Gaussian
    noise, roll out every candidate, softmax-average by cost.

    rollout_cost(params, p [nr], state0, x_target) -> scalar (make_objective).
    Returns solve(generator, params, p0 [nr], state0, x_target) -> (p_new
    [nr], mean_cost); generator (a torch.Generator) takes the place of the
    JAX package's key. The candidates run one after another as lanes of
    the lane-of-one objective, with gradients off (MPPI takes none);
    make_mppi_solver_batched runs them as the lanes of one batch.
    """

    def solve(generator, params: Dict, p0, state0: State, x_target):
        cand = _candidates(generator, p0, n_samples, sigma)
        with torch.no_grad():
            costs = torch.stack([rollout_cost(params, p, state0, x_target) for p in cand])
        return _mppi_combine(costs, cand, p0, temperature)

    return solve


def make_mppi_solver_batched(objective_batched: Callable, n_samples: int = 256,
                             sigma: float = 0.3, temperature: float = 1.0):
    """MPPI over an explicitly batched objective (make_objective_batched):
    the candidates are the batch's lanes, so on the card the rollouts run
    on the chord kernel where the scene takes it.

    objective_batched(params, P [S, nr], state0 [S, ...], x_targets [S, 3])
    -> costs [S]. Returns solve(generator, params, p0 [nr], state0
    (unbatched), x_target [3]) -> (p_new [nr], mean_cost): make_mppi_solver's
    result for the same generator state.
    """

    def solve(generator, params: Dict, p0, state0: State, x_target):
        cand = _candidates(generator, p0, n_samples, sigma)
        lanes = lambda v: v.expand(n_samples, *v.shape).contiguous()
        s0 = State(q=lanes(state0.q), qdot=lanes(state0.qdot),
                   aux={k: lanes(v) for k, v in state0.aux.items()})
        tgts = lanes(x_target)
        with torch.no_grad():
            costs = objective_batched(params, cand, s0, tgts)
        return _mppi_combine(costs, cand, p0, temperature)

    return solve
