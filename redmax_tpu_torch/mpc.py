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
poisons only its own rows of P. The sampling MPPI solvers take both forms,
and so does the L-BFGS solver (make_mpc_solver(method="lbfgs"): optax.lbfgs
with its zoom line search, written out here lane by lane).
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


def _value_and_grad(objective_fn: Callable, params: Dict, state0, x_targets):
    """P -> (objective, its gradient in P), both detached: the gradient of a
    lane vector's sum is each lane's own."""

    def vg(P):
        Pg = P.detach().requires_grad_(True)
        with torch.enable_grad():
            v = objective_fn(params, Pg, state0, x_targets)
            (g,) = torch.autograd.grad(v.sum(), Pg)
        return v.detach(), g

    return vg


def _adam_solver(objective_fn: Callable, iters: int, lr: float):
    """Fixed-iteration Adam on an objective of P: a scalar of p [nr] or a
    lane vector [B] of P [B, nr] (each lane's gradient is that of the sum)."""
    init, update = _adam(lr)

    def solve(params: Dict, P0, state0: State, x_targets) -> MpcResult:
        vg = _value_and_grad(objective_fn, params, state0, x_targets)
        P = P0.detach()
        opt_state = init(P)
        for _ in range(iters):
            v, g = vg(P)
            step, opt_state = update(g, opt_state)
            P = P + step
        return MpcResult(p=P, objective=v, grad_norm=torch.linalg.vector_norm(g, dim=-1))

    return solve


def _dot(a, b):
    return (a * b).sum(-1)


def _lane(v):
    """A lane scalar [...] against the lane's vectors [..., n]."""
    return v[..., None]


# optax.lbfgs(memory_size=8): scale_by_lbfgs(scale_init_precond=True), then
# scale(-1), then scale_by_zoom_linesearch(max_linesearch_steps=20,
# initial_guess_strategy="one") with its defaults.
LBFGS_MEMORY = 8
LS_MAX_STEPS = 20
LS_SLOPE_RTOL = 1e-4
LS_CURV_RTOL = 0.9
LS_APPROX_DEC_RTOL = 1e-6
LS_INCREASE = 2.0
LS_INTERVAL_THRESHOLD = 1e-5  # stepsize_precision


class _Lbfgs:
    """The L-BFGS direction of optax.scale_by_lbfgs (Nocedal and Wright,
    Algorithm 7.4), on P [..., n] with its own memory for every lane: the
    last LBFGS_MEMORY differences of iterates and of gradients in a ring.
    Slots not yet written hold zeros and weight 0, which leave the two-loop
    recursion unchanged."""

    def __init__(self, P):
        m = LBFGS_MEMORY
        self.count = 0
        self.prev_p, self.prev_g = torch.zeros_like(P), torch.zeros_like(P)
        self.dw = torch.zeros((m,) + P.shape, dtype=P.dtype, device=P.device)
        self.du = torch.zeros_like(self.dw)
        self.rho = torch.zeros((m,) + P.shape[:-1], dtype=P.dtype, device=P.device)

    def direction(self, g, P):
        """-H g, H the inverse-Hessian estimate after the step to P with
        gradient g there; the memory takes that step's differences first."""
        m, k = LBFGS_MEMORY, self.count
        slot, prev = k % m, (k - 1) % m
        if k > 0:
            dw, du = P - self.prev_p, g - self.prev_g
            vd = _dot(du, dw)
            self.dw[prev], self.du[prev] = dw, du
            self.rho[prev] = torch.where(vd == 0, torch.zeros_like(vd), 1.0 / vd)
            den = _dot(du, du)
            gamma = torch.where(den > 0, vd / den, torch.ones_like(den))
        else:
            # the first step: the identity scaled to a step of length <= 1
            gamma = torch.minimum(torch.ones_like(g[..., 0]),
                                  1.0 / torch.linalg.vector_norm(g, dim=-1))
        order = [(slot + j) % m for j in range(m)]
        vec, alphas = g, {}
        for i in reversed(order):
            alphas[i] = self.rho[i] * _dot(self.dw[i], vec)
            vec = vec + _lane(-alphas[i]) * self.du[i]
        vec = _lane(gamma) * vec
        for i in order:
            beta = self.rho[i] * _dot(self.du[i], vec)
            vec = vec + _lane(alphas[i] - beta) * self.dw[i]
        self.count, self.prev_p, self.prev_g = k + 1, P, g
        return -vec


def _cubicmin(a, fa, fpa, b, fb, c, fc):
    """The critical point of the cubic through (a, fa), (b, fb), (c, fc)
    with slope fpa at a (NaN where there is none)."""
    C, db, dc = fpa, b - a, c - a
    denom = (db * dc) ** 2 * (db - dc)
    r1, r2 = fb - fa - C * db, fc - fa - C * dc
    A = (dc ** 2 * r1 + (-(db ** 2)) * r2) / denom
    B = ((-(dc ** 3)) * r1 + db ** 3 * r2) / denom
    return a + (-B + torch.sqrt(B * B - 3.0 * A * C)) / (3.0 * A)


def _quadmin(a, fa, fpa, b, fb):
    """The critical point of the quadratic through (a, fa), (b, fb) with
    slope fpa at a."""
    db = b - a
    B = (fb - fa - fpa * db) / (db ** 2)
    return a - fpa / (2.0 * B)


def _nan_to_inf(e):
    return torch.where(torch.isnan(e), torch.full_like(e, float("inf")), e)


def _decrease_error(t, v, slope, v0, slope0):
    """How far the Armijo condition, or near a minimum the approximate
    decrease condition of Hager and Zhang (2006), is violated (0 when met;
    inf for a NaN)."""
    armijo = v - v0 - LS_SLOPE_RTOL * t * slope0
    approx = torch.maximum(slope - (2 * LS_SLOPE_RTOL - 1.0) * slope0,
                           v - v0 - LS_APPROX_DEC_RTOL * v0.abs())
    return _nan_to_inf(torch.clamp_min(torch.minimum(approx, armijo), 0.0))


def _curvature_error(slope, slope0):
    return _nan_to_inf(torch.clamp_min(slope.abs() - LS_CURV_RTOL * slope0.abs(), 0.0))


def _zoom_linesearch(vg, P, u, v0, g0):
    """optax.zoom_linesearch (Nocedal and Wright, Algorithms 3.5 and 3.6)
    along u from P, every lane its own search: an interval search from
    stepsize 1 doubling, then a zoom by cubic, quadratic or bisection steps,
    to a stepsize that meets the decrease and curvature conditions, for at
    most LS_MAX_STEPS evaluations; failing that, the best stepsize that
    decreased the objective enough (or 0). Every evaluation runs all lanes;
    a lane whose search has ended keeps its state, as a vmapped while_loop
    does. Returns the stepsize [...]."""
    slope0 = _dot(u, g0)
    zero, one = torch.zeros_like(v0), torch.ones_like(v0)
    s = dict(count=torch.zeros(v0.shape, dtype=torch.long, device=v0.device),
             stepsize=zero, value=v0, slope=slope0,
             found=torch.zeros_like(v0, dtype=torch.bool),
             done=torch.zeros_like(v0, dtype=torch.bool),
             failed=torch.zeros_like(v0, dtype=torch.bool),
             low=zero, value_low=v0, slope_low=slope0, high=zero, value_high=v0,
             slope_high=slope0, cubic_ref=zero, value_cubic_ref=v0,
             safe_stepsize=zero, safe_value=v0)
    W = torch.where
    while True:
        active = ~(s["done"] | s["failed"])
        if not bool(active.any()):
            return s["stepsize"]
        low, high, vlo, vhi = s["low"], s["high"], s["value_low"], s["value_high"]
        # the trial stepsize: the interval search's, or the zoom's
        grown = W(s["count"] == 0, one, LS_INCREASE * s["stepsize"])
        delta = (high - low).abs()
        left, right = torch.minimum(high, low), torch.maximum(high, low)
        mc = _cubicmin(low, vlo, s["slope_low"], high, vhi, s["cubic_ref"], s["value_cubic_ref"])
        use_cubic = (mc > left + 0.2 * delta) & (mc < right - 0.2 * delta)
        mq = _quadmin(low, vlo, s["slope_low"], high, vhi)
        use_quad = ~use_cubic & (mq > left + 0.1 * delta) & (mq < right - 0.1 * delta)
        middle = W(use_cubic, mc, s["cubic_ref"])
        middle = W(use_quad, mq, middle)
        middle = W(~use_cubic & ~use_quad, (low + high) / 2.0, middle)
        found = s["found"]
        t = W(found, middle, grown)
        v, g = vg(P + _lane(t) * u)
        slope = _dot(g, u)
        dec = _decrease_error(t, v, slope, v0, slope0)
        err = torch.maximum(dec, _curvature_error(slope, slope0))
        ok_dec, done = dec <= 0.0, err <= 0.0
        last = s["count"] + 1 >= LS_MAX_STEPS
        new = dict(count=s["count"] + 1, stepsize=t, value=v, slope=slope, done=done)

        # interval search (Algorithm 3.5)
        s_high = (dec > 0.0) | ((v >= s["value"]) & (s["count"] > 0))
        s_low = (slope >= 0.0) & ~s_high
        s_lo = [W(s_low, a, b) for a, b in ((t, s["stepsize"]), (v, s["value"]),
                                             (slope, s["slope"]))]
        s_hi = [W(s_low, a, b) for a, b in ((s["stepsize"], t), (s["value"], v),
                                             (s["slope"], slope))]
        s_safe = [W(ok_dec, t, s["safe_stepsize"]), W(ok_dec, v, s["safe_value"])]
        s_found = s_high | s_low | done

        # zoom (Algorithm 3.6)
        z_better = ok_dec & (v < s["safe_value"])
        z_safe = [W(z_better, t, s["safe_stepsize"]), W(z_better, v, s["safe_value"])]
        z_high_mid = (dec > 0.0) | (v >= vlo)
        z_high_low = (slope * (high - low) >= 0.0) & ~z_high_mid
        trial, lo3 = (t, v, slope), (low, vlo, s["slope_low"])
        hi3 = (high, vhi, s["slope_high"])
        z_hi = [W(z_high_low, b, W(z_high_mid, a, c)) for a, b, c in zip(trial, lo3, hi3)]
        z_lo = [W(~z_high_mid, a, b) for a, b in zip(trial, lo3)]
        moved_high = z_high_mid | z_high_low
        z_ref = [W(moved_high, high, low), W(moved_high, vhi, vlo)]
        z_failed = (last | ((delta <= LS_INTERVAL_THRESHOLD) & (z_safe[0] > 0.0))) & ~done

        pick = lambda z, a: W(found, z, a)
        lo = [pick(z, a) for z, a in zip(z_lo, s_lo)]
        hi = [pick(z, a) for z, a in zip(z_hi, s_hi)]
        new.update(
            found=pick(found, s_found), failed=pick(z_failed, last & ~done),
            low=lo[0], value_low=lo[1], slope_low=lo[2],
            high=hi[0], value_high=hi[1], slope_high=hi[2],
            cubic_ref=pick(z_ref[0], lo[0]), value_cubic_ref=pick(z_ref[1], lo[1]),
            safe_stepsize=pick(z_safe[0], s_safe[0]), safe_value=pick(z_safe[1], s_safe[1]))
        # a failed search takes its safe stepsize, or 0 (the safe one's
        # initial value) where the trial left the domain
        take_safe = new["failed"] & ((new["safe_stepsize"] > 0.0) | torch.isinf(dec))
        new["stepsize"] = W(take_safe, new["safe_stepsize"], t)
        s = {k: W(active, new[k], s[k]) for k in s}


def _lbfgs_solver(objective_fn: Callable, iters: int):
    """Fixed-iteration L-BFGS with a zoom line search (optax.lbfgs(
    memory_size=8)) on an objective of P: a scalar of p [nr] or a lane
    vector [B] of P [B, nr], every lane its own memory and search.
    MpcResult reports the objective and gradient norm at the last
    iteration's start point."""

    def solve(params: Dict, P0, state0: State, x_targets) -> MpcResult:
        vg = _value_and_grad(objective_fn, params, state0, x_targets)
        P = P0.detach()
        lbfgs = _Lbfgs(P)
        for _ in range(iters):
            v, g = vg(P)
            u = lbfgs.direction(g, P)
            P = P + _lane(_zoom_linesearch(vg, P, u, v, g)) * u
        return MpcResult(p=P, objective=v, grad_norm=torch.linalg.vector_norm(g, dim=-1))

    return solve


def make_mpc_solver(objective_fn: Callable, iters: int = 1, lr: float = 1e-2,
                    method: str = "adam"):
    """Fixed-iteration gradient MPC solve: (params, p0, state0, x_target) ->
    MpcResult, for an objective that is a scalar of p [nr] (make_objective)
    or a lane vector [B] of P [B, nr] (make_objective_batched).

    method "adam" (optax.adam's defaults, lr); "lbfgs", the reference's
    fminunc quasi-Newton coupling (driverRedMaxAdjointBDF1.m:17-23):
    optax.lbfgs(memory_size=8) with its zoom line search, so an iteration
    evaluates the objective and its gradient once, then once for each
    line-search step (lr unused)."""
    if method == "lbfgs":
        return _lbfgs_solver(objective_fn, iters)
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
