"""Implicit integrators, batch-first: BDF1, SDIRK2-bootstrapped BDF2, and
the linearly implicit Euler step with hard constraints (dense KKT for
equalities, dual projected Gauss-Seidel for inequalities).

Semantics are those of the JAX package's integrators.py (and of the
reference drivers):

  * BDF1 g = M (q1 - q0 - h qdot0) - h^2 f with qdot1 = (q1 - q0)/h
    (driverRedMaxBDF1.m:160-187).
  * SDIRK2 bootstrap with alpha = (2 - sqrt(2))/2, two substeps, then BDF2
    g = M (q2 - 4/3 q1 + 1/3 q0 - 8/9 h qdot1 + 2/9 h qdot0) - 4/9 h^2 f
    (driverRedMaxBDF2.m:64-293).
  * Newton, every mode of NewtonConfig: the reference's damped Newton with
    backtracking line search (fixed_iters=0), and fixed-iteration chord
    (Newton matrix built once at the predictor), re-evaluated (chord=False),
    guarded and guard_last solves, with the exact or the structured Newton
    matrix and an LU or Gauss-Jordan solver;
    lanes whose residual grew or went non-finite are poisoned to NaN.
  * Linearly implicit Euler: Mrtilde qdot1 = frtilde with one-sidedly
    implicit damping, constraint rows from constraints.assemble_constraints,
    Baumgarte stabilization from params["baumgarte"][2].

Every state tensor is [B, nr]; lanes step in lock-step and never mix. A
state's aux (the Euler-chart joints' charts, [B, G]) goes to every residual
and Newton matrix and through the post-step reparam_all, which switches
charts and remaps the BDF2 history.
"""

import math
from dataclasses import dataclass
from typing import Callable, Dict, NamedTuple, Tuple

import torch

from redmax_tpu_torch.adjoint import (
    ResidualVJP, batched_jacobian, implicit_solve, implicit_solve_custom,
    implicit_solve_factored,
)
from redmax_tpu_torch.constraints import assemble_constraints
from redmax_tpu_torch.linalg import make_solver
from redmax_tpu_torch import forces, metrics
from redmax_tpu_torch.model import (
    _split_closures, assemble, closure_forces, forward_kinematics, jacobians, joint_space_force,
    joint_space_KD_diag, mass_diag, maximal_force, reparam_all, structured_hessian,
)
from redmax_tpu_torch.qp import kkt_solve, qp_pgs_batched
from redmax_tpu_torch.types import State, Topology, lanewise

SDIRK_ALPHA = (2.0 - math.sqrt(2.0)) / 2.0


@dataclass(frozen=True)
class NewtonConfig:
    """Solver configuration; the fields and defaults of the JAX package's
    NewtonConfig (see its docstrings for the meaning of each)."""

    tol: float = 1e-9
    dx_max: float = 1e3
    iter_max: int = 0
    ls_max: int = 20
    fixed_iters: int = 0     # >0 enables fixed-iteration mode
    chord: bool = False      # Newton matrix built once, at the predictor
    hessian: str = "exact"   # "exact" (Jacobian of the residual) or "structured"
    linsolve: str = "lu"     # "lu", "gj" or "gj_pivot"
    predictor: str = "linear"  # BDF2 guess: "linear" or "quadratic"
    dx_clamp: float = 0.0    # per-lane step-norm clamp (0 = off)
    guarded: bool = False
    guard_last: bool = False
    growth_reject: float = 10.0  # reject when |g| grew by more than this
    tol_reject: float = 0.0      # reject when the last |g| exceeds this
    adjoint_reuse_factor: bool = True


def _norm(v):
    return torch.linalg.vector_norm(v, dim=-1)


def _where(mask, a, b):
    """Per-lane select of [B, n] rows (mask [B])."""
    return torch.where(mask[..., None], a, b)


def newton(res_fn: Callable, x0, cfg: NewtonConfig, jac_fn: Callable = None):
    """Newton over batched x0 [B, nr], every branch of the JAX package's
    newton lane by lane.

    res_fn: x [B, nr] -> g [B, nr], lane-separable; jac_fn: x -> H
    [B, nr, nr], the Newton matrix (None: the exact Jacobian of res_fn).
    Returns (x, info): info["diverged"] is the [B] mask of rejected lanes
    and info["iters"] the iterations taken.

    fixed_iters > 0: full steps x -= F^-1 g with F factored at the predictor
    (chord) or at every iterate (chord=False); guarded: at every iteration a
    full step if it did not grow |g|, else a half step if that did not, else
    stay put; guard_last: plain chord iterations, then one guarded one.
    Rejected (NaN-poisoned) lanes: a non-finite result, a residual that grew
    by more than growth_reject (or exceeds tol_reject), or a guarded lane
    that stayed put and never halved its residual. info["factor"] is the last
    factor built; with a guard, info["steps"] [B, k] holds each guarded
    iteration's step (1 full, 0.5 half, 0 stay put).

    fixed_iters == 0: the reference's damped Newton, per lane until
    |g| < tol, iter_max (0: 10 nr) iterations or |dx| > dx_max (which stops
    the lane where it is, without poisoning it), each step -H^-1 g by
    torch.linalg.solve whatever linsolve says, then up to ls_max halvings
    until 0.5|g|^2 decreases (an exhausted search keeps its last trial).
    """
    if jac_fn is None:
        jac_fn = lambda x: batched_jacobian(res_fn, x)
    if cfg.fixed_iters <= 0:
        return _newton_line_search(res_fn, x0, cfg, jac_fn)
    if cfg.guard_last and (not cfg.chord or cfg.guarded):
        raise ValueError("guard_last requires chord=True, guarded=False")
    factor, solve, _ = make_solver(cfg.linsolve)

    def clamp(dx):
        if not cfg.dx_clamp:
            return dx
        nrm = torch.linalg.vector_norm(dx, dim=-1, keepdim=True)
        return dx * torch.clamp(cfg.dx_clamp / torch.clamp(nrm, min=1e-30), max=1.0)

    def guarded_step(x, g, gn, F):
        """One guarded iteration from (x, g(x), |g|): the accepted (x, g,
        |g|) and the step taken [B] (1, 0.5 or 0)."""
        dx = clamp(solve(F, g))
        g_full = res_fn(x - dx)
        gfn = _norm(g_full)
        ok_full = gfn <= gn  # NaN-safe: a non-finite trial counts as grown
        x_half = x - 0.5 * dx
        g_half = res_fn(x_half)
        ghn = _norm(g_half)
        ok_half = ghn <= gn
        x = _where(ok_full, x - dx, _where(ok_half, x_half, x))
        g = _where(ok_full, g_full, _where(ok_half, g_half, g))
        gn = torch.where(ok_full, gfn, torch.where(ok_half, ghn, gn))
        step = torch.where(ok_full, 1.0, torch.where(ok_half, 0.5, 0.0))
        return x, g, gn, step

    x = x0
    g0n = gln = None
    steps = []
    F = factor(jac_fn(x0))
    if cfg.guarded:
        g = res_fn(x)
        gn = g0n = _norm(g)
        for it in range(cfg.fixed_iters):
            if not cfg.chord and it > 0:
                F = factor(jac_fn(x))
            x, g, gn, step = guarded_step(x, g, gn, F)
            steps.append(step)
        gln = gn  # exact: g tracks the final iterate
    else:
        plain = cfg.fixed_iters - (1 if cfg.guard_last else 0)
        for it in range(plain):
            g = res_fn(x)
            gn = _norm(g)
            g0n = gn if g0n is None else g0n
            gln = gn  # residual at the PRE-update iterate (one iteration stale)
            if not cfg.chord and it > 0:
                F = factor(jac_fn(x))
            x = x - clamp(solve(F, g))
        if cfg.guard_last:
            g = res_fn(x)
            gn = _norm(g)
            g0n = gn if g0n is None else g0n
            x, _, gln, step = guarded_step(x, g, gn, F)
            steps.append(step)
    diverged = ~torch.isfinite(x).all(dim=-1) | ~torch.isfinite(gln)
    if steps:
        # a lane that stayed put is rejected only when its solve never
        # halved the residual
        stayput = (torch.stack(steps, dim=-1) == 0).any(dim=-1)
        diverged = diverged | (stayput & (gln > 0.5 * g0n))
    if cfg.growth_reject:
        diverged = diverged | (gln > cfg.growth_reject * g0n)
    if cfg.tol_reject:
        diverged = diverged | (gln > cfg.tol_reject)
    x = _where(diverged, torch.full_like(x, float("nan")), x)
    info = {"iters": cfg.fixed_iters, "diverged": diverged, "factor": F}
    if steps:
        info["steps"] = torch.stack(steps, dim=-1)
    return x, info


def _newton_line_search(res_fn, x0, cfg: NewtonConfig, jac_fn):
    """fixed_iters == 0 (newton's docstring): per-lane done masks; a lane
    that is done keeps its state while the others iterate."""
    iter_max = cfg.iter_max if cfg.iter_max > 0 else 10 * x0.shape[-1]
    B = x0.shape[0]
    x, g = x0, res_fn(x0)
    done = _norm(g) < cfg.tol
    it = torch.zeros(B, dtype=torch.int64, device=x0.device)
    diverged = torch.zeros(B, dtype=torch.bool, device=x0.device)
    while not bool(done.all()):
        dx = -torch.linalg.solve_ex(jac_fn(x), g[..., None])[0][..., 0]
        div = _norm(dx) > cfg.dx_max
        f0 = 0.5 * (g * g).sum(-1)
        # backtracking: alpha = 1, 1/2, ... until f decreases (lanes that
        # diverged or are done skip it)
        alpha = torch.ones_like(f0)
        x_ls, g_ls = x, g
        stop = div | done
        for j in range(max(cfg.ls_max, 1)):
            if bool(stop.all()):
                break
            x_try = x + alpha[..., None] * dx
            g_try = res_fn(x_try)
            accept = 0.5 * (g_try * g_try).sum(-1) < f0
            active = ~stop
            x_ls, g_ls = _where(active, x_try, x_ls), _where(active, g_try, g_ls)
            end = accept | (j + 1 >= cfg.ls_max)
            alpha = torch.where(active & ~end, 0.5 * alpha, alpha)
            stop = stop | (active & end)
        x_new, g_new = _where(div, x, x_ls), _where(div, g, g_ls)
        done_new = div | (_norm(g_new) < cfg.tol) | (it + 1 >= iter_max)
        x, g = _where(done, x, x_new), _where(done, g, g_new)
        it = torch.where(done, it, it + 1)
        diverged = diverged | (~done & div)
        done = done | done_new
    return x, {"iters": it, "diverged": diverged}


# ---------------------------------------------------------------------------
# Residuals
# ---------------------------------------------------------------------------


def _Mf(topo, force_fns, params, q, qdot, aux=None):
    M, f, _ = assemble(topo, params, q, qdot, force_fns, aux)
    return M, f


def _mv(M, v):
    return (M @ v[..., None])[..., 0]


def residual_bdf1(topo, force_fns, params: Dict, q1, q0, qdot0, aux=None):
    h = lanewise(params["h"], 2)
    dqtmp = q1 - q0 - h * qdot0
    qdot1 = (q1 - q0) / h
    M, f = _Mf(topo, force_fns, params, q1, qdot1, aux)
    return _mv(M, dqtmp) - h * h * f


def residual_sdirk2a(topo, force_fns, params: Dict, qa, q0, qdot0, aux=None):
    ah = SDIRK_ALPHA * lanewise(params["h"], 2)
    dqtmp = qa - q0 - ah * qdot0
    qdota = (qa - q0) / ah
    M, f = _Mf(topo, force_fns, params, qa, qdota, aux)
    return _mv(M, dqtmp) - ah * ah * f


def residual_sdirk2b(topo, force_fns, params: Dict, q1, q0, qdot0, qdota, aux=None):
    a = SDIRK_ALPHA
    h = lanewise(params["h"], 2)
    ah = a * h
    dqtmp = q1 - q0 - (2 * a - 1) * h * qdot0 - 2 * (1 - a) * h * qdota
    qdot1 = (q1 - q0 - (1 - a) * h * qdota) / ah
    M, f = _Mf(topo, force_fns, params, q1, qdot1, aux)
    return _mv(M, dqtmp) - ah * ah * f


def residual_bdf2(topo, force_fns, params: Dict, q2, q0, qdot0, q1, qdot1, aux=None):
    h = lanewise(params["h"], 2)
    dqtmp = q2 - (4 / 3) * q1 + (1 / 3) * q0 - (8 / 9) * h * qdot1 + (2 / 9) * h * qdot0
    qdot2 = (3 / (2 * h)) * (q2 - (4 / 3) * q1 + (1 / 3) * q0)
    M, f = _Mf(topo, force_fns, params, q2, qdot2, aux)
    return _mv(M, dqtmp) - (4 / 9) * h * h * f


# ---------------------------------------------------------------------------
# Structured Newton matrices (see model.structured_hessian; cK and cD are
# scalars or per lane [B], as h is; aux is the state's)
# ---------------------------------------------------------------------------


def _hess_bdf1(topo, force_fns):
    def hess(theta, q1, aux=None):
        params, q0, qdot0 = theta
        h = params["h"]
        return structured_hessian(
            topo, params, q1, (q1 - q0) / lanewise(h, 2), -h * h, -h, force_fns, aux
        )

    return hess


def _hess_sdirk2a(topo, force_fns):
    def hess(theta, qa, aux=None):
        params, q0, qdot0 = theta
        ah = SDIRK_ALPHA * params["h"]
        return structured_hessian(
            topo, params, qa, (qa - q0) / lanewise(ah, 2), -ah * ah, -ah, force_fns, aux
        )

    return hess


def _hess_sdirk2b(topo, force_fns):
    def hess(theta, q1, aux=None):
        params, q0, qdot0, qdota = theta
        a = SDIRK_ALPHA
        ah = a * params["h"]
        h2 = lanewise(params["h"], 2)
        qdot1 = (q1 - q0 - (1 - a) * h2 * qdota) / (a * h2)
        return structured_hessian(topo, params, q1, qdot1, -ah * ah, -ah, force_fns, aux)

    return hess


def _hess_bdf2(topo, force_fns):
    def hess(theta, q2, aux=None):
        params, q0, qdot0, q1, qdot1 = theta
        h = params["h"]
        qdot2 = (3 / (2 * lanewise(h, 2))) * (q2 - (4 / 3) * q1 + (1 / 3) * q0)
        return structured_hessian(
            topo, params, q2, qdot2, -(4 / 9) * h * h, -(2 / 3) * h, force_fns, aux
        )

    return hess


# ---------------------------------------------------------------------------
# Step factories
# ---------------------------------------------------------------------------


class Bdf2State(NamedTuple):
    """BDF2 needs two history levels (q_prev/qdot_prev = k-1, q/qdot = k)."""

    q: torch.Tensor
    qdot: torch.Tensor
    q_prev: torch.Tensor
    qdot_prev: torch.Tensor
    k: int           # step counter (0 -> SDIRK2 bootstrap); lanes in lock-step
    aux: Dict = {}


# Per-lane physical parameters (the JAX package's semantics): any of these
# params may carry a leading [B] lane dim, the scenario-sampling /
# system-identification dimension (domain-randomized inertia, timestep,
# gravity, contact, spring and cable coefficients). The base (lane-shared)
# ndim is listed; a leaf with ndim == base + 1 is per lane. The batch-first
# op-level code broadcasts such a leaf against the lanes.
_BATCHABLE = {"tau": 1, "I_i": 2, "g": 1, "h": 0, "body_damping": 1}
# Scalar per-force coefficients that may be [B] (params["forces"][key][p]).
_FORCE_BATCHABLE = ("kn", "kt", "kd", "mu", "k", "d", "L")


def split_batched_params(params: Dict):
    """(shared, batched): split params into lane-shared leaves and the
    per-lane [B, ...] leaves declared in _BATCHABLE / _FORCE_BATCHABLE
    (batched["forces"][key] holds a force's per-lane coefficients)."""
    shared = dict(params)
    batched = {}
    for k, nd in _BATCHABLE.items():
        v = params.get(k)
        if v is not None and v.ndim == nd + 1:
            batched[k] = shared.pop(k)
    bf, sf = {}, {}
    for key, fp in params.get("forces", {}).items():
        bsub = {p: v for p, v in fp.items() if p in _FORCE_BATCHABLE and v.ndim == 1}
        sf[key] = {p: v for p, v in fp.items() if p not in bsub}
        if bsub:
            bf[key] = bsub
    if bf:
        batched["forces"], shared["forces"] = bf, sf
    return shared, batched


def merge_batched_params(shared: Dict, batched: Dict) -> Dict:
    """The inverse of split_batched_params: params from (shared, per-lane
    leaves). Batch-first, the per-lane leaves keep their [B] dim (the JAX
    package merges one lane's slice under vmap)."""
    out = {**shared, **{k: v for k, v in batched.items() if k != "forces"}}
    if "forces" in batched:
        f = dict(shared.get("forces", {}))
        for key, sub in batched["forces"].items():
            f[key] = {**f.get(key, {}), **sub}
        out["forces"] = f
    return out


def _newton_factored(cfg, res_theta_fn, hess_fn):
    """(theta, x0) -> (x*, factor): the forward solve implicit_solve_factored
    wraps (factor None for the line search, which builds no reusable one)."""

    def run(theta, x0):
        jac = (lambda x: hess_fn(theta, x)) if hess_fn else None
        x, info = newton(lambda x: res_theta_fn(theta, x), x0, cfg, jac_fn=jac)
        return x, info.get("factor")

    return run


def _make_solve_T(cfg: NewtonConfig):
    """(H, xbar) -> H^-T xbar for the backward of implicit_solve, matching
    cfg.linsolve: None for "lu" (implicit_solve then takes
    torch.linalg.solve(H^T, .)); the GJ inverse otherwise."""
    if cfg.linsolve == "lu":
        return None
    factor, _, solve_T = make_solver(cfg.linsolve)
    return lambda H, xbar: solve_T(factor(H), xbar)


def _solver(cfg: NewtonConfig, differentiable: bool):
    """(res, hess, theta, x0, aux, why) -> x*: one Newton solve of res(theta,
    x, aux=aux) = 0 from x0, hess(theta, x, aux=aux) its structured matrix
    (None: the exact one); why names the solve's op-level VJP in the
    adjoint's counters (implicit_solve_custom). differentiable routes it
    through implicit_solve_factored (the adjoint reuses the forward factor)
    for a fixed-iteration config with adjoint_reuse_factor, else through
    implicit_solve (the backward builds H at the solution: structured or
    exact, as cfg.hessian says)."""
    _, _, solve_T = make_solver(cfg.linsolve)
    factored = cfg.fixed_iters > 0 and cfg.adjoint_reuse_factor
    solve_T_H = _make_solve_T(cfg)

    def newton_fn(fn, jac, x0):
        return newton(fn, x0, cfg, jac_fn=jac)[0]

    def solve(res, hess, theta, x0, aux, why="route"):
        res_aux = lambda theta, x: res(theta, x, aux=aux)
        hess_aux = None if hess is None else (lambda theta, x: hess(theta, x, aux=aux))
        nf = _newton_factored(cfg, res_aux, hess_aux)
        if not differentiable:
            return nf(theta, x0)[0]
        if factored:
            return implicit_solve_factored(res_aux, nf, solve_T, theta, x0, why=why)
        return implicit_solve(res_aux, newton_fn, hess_aux, solve_T_H, theta, x0, why=why)

    return solve


def make_bdf1_step(
    topo: Topology,
    force_fns: Tuple = (),
    cfg: NewtonConfig = NewtonConfig(),
    differentiable: bool = False,
):
    """One batched BDF1 step State -> State over [B, nr] states, from the
    predictor q0 + h qdot0, then the post-step reparam_all (simLoop,
    driverRedMaxBDF1.m:57-92). differentiable=True: the implicit-function
    VJP (_solver), the reference adjoint (TaskBDF1.m:45-81)."""
    hess = _hess_bdf1(topo, force_fns) if cfg.hessian == "structured" else None
    solve = _solver(cfg, differentiable)

    def res(theta, q1, aux=None):
        params, q0, qdot0 = theta
        return residual_bdf1(topo, force_fns, params, q1, q0, qdot0, aux)

    def step(params: Dict, state: State) -> State:
        q0, qdot0 = state.q, state.qdot
        h = lanewise(params["h"], 2)
        q1 = solve(res, hess, (params, q0, qdot0), q0 + h * qdot0, state.aux)
        q1, qdot1, aux, _, _ = reparam_all(topo, params, q1, (q1 - q0) / h, state.aux)
        return State(q=q1, qdot=qdot1, aux=aux)

    return step


def _reparam(topo, params, s: Bdf2State) -> Bdf2State:
    q, qdot, aux, q_prev, qdot_prev = reparam_all(topo, params, s.q, s.qdot, s.aux,
                                                  s.q_prev, s.qdot_prev)
    return s._replace(q=q, qdot=qdot, aux=aux, q_prev=q_prev, qdot_prev=qdot_prev)


def make_bdf2_step(
    topo: Topology,
    force_fns: Tuple = (),
    cfg: NewtonConfig = NewtonConfig(),
    differentiable: bool = False,
):
    """One batched BDF2 step with SDIRK2 bootstrap at k=0; differentiable as
    make_bdf1_step's. Exposes .bootstrap and .inner, the two phases
    make_simulate runs.
    """
    structured = cfg.hessian == "structured"
    hess_a = _hess_sdirk2a(topo, force_fns) if structured else None
    hess_b = _hess_sdirk2b(topo, force_fns) if structured else None
    hess_2 = _hess_bdf2(topo, force_fns) if structured else None
    solve = _solver(cfg, differentiable)

    def res_a(theta, qa, aux=None):
        params, q0, qdot0 = theta
        return residual_sdirk2a(topo, force_fns, params, qa, q0, qdot0, aux)

    def res_b(theta, q1, aux=None):
        params, q0, qdot0, qdota = theta
        return residual_sdirk2b(topo, force_fns, params, q1, q0, qdot0, qdota, aux)

    def res_2(theta, q2, aux=None):
        params, q0, qdot0, q1, qdot1 = theta
        return residual_bdf2(topo, force_fns, params, q2, q0, qdot0, q1, qdot1, aux)

    def bootstrap(params: Dict, s: Bdf2State) -> Bdf2State:
        with metrics.span("integrators.bootstrap"):
            q0, qdot0 = s.q, s.qdot
            h = lanewise(params["h"], 2)
            ah = SDIRK_ALPHA * h
            qa = solve(res_a, hess_a, (params, q0, qdot0), q0 + ah * qdot0, s.aux, "bootstrap")
            qdota = (qa - q0) / ah
            q1 = solve(res_b, hess_b, (params, q0, qdot0, qdota),
                       qa + (1 - SDIRK_ALPHA) * h * qdota, s.aux, "bootstrap")
            qdot1 = (q1 - q0 - (1 - SDIRK_ALPHA) * h * qdota) / ah
            return _reparam(topo, params, Bdf2State(
                q=q1, qdot=qdot1, q_prev=q0, qdot_prev=qdot0, k=s.k + 1, aux=s.aux))

    def inner(params: Dict, s: Bdf2State) -> Bdf2State:
        with metrics.span("integrators.inner"):
            q0, qdot0 = s.q_prev, s.qdot_prev
            q1, qdot1 = s.q, s.qdot
            h = lanewise(params["h"], 2)
            guess = q1 + h * qdot1
            if cfg.predictor == "quadratic":
                guess = guess + 0.5 * h * (qdot1 - qdot0)
            q2 = solve(res_2, hess_2, (params, q0, qdot0, q1, qdot1), guess, s.aux)
            qdot2 = (3 / (2 * h)) * (q2 - (4 / 3) * q1 + (1 / 3) * q0)
            return _reparam(topo, params, Bdf2State(
                q=q2, qdot=qdot2, q_prev=q1, qdot_prev=qdot1, k=s.k + 1, aux=s.aux))

    def step(params: Dict, s: Bdf2State) -> Bdf2State:
        return bootstrap(params, s) if s.k == 0 else inner(params, s)

    step.bootstrap = bootstrap
    step.inner = inner
    return step


def bdf2_init(state: State) -> Bdf2State:
    return Bdf2State(q=state.q, qdot=state.qdot, q_prev=state.q,
                     qdot_prev=state.qdot, k=0, aux=state.aux)


def make_bdf2_step_batched(
    topo: Topology,
    force_fns: Tuple = (),
    cfg: NewtonConfig = NewtonConfig(),
    differentiable: bool = False,
    use_kernel: bool = None,
    backward: str = "reuse",
):
    """Batched BDF2 step over [B, nr] states, with the inner chord solve on
    the fused chord kernel (chord_kernel.chord_bdf2) when the scene and
    config qualify (any fixed-iteration mode with the structured matrix and
    the GJ solver: chord, chord=False, guarded, guard_last).

    use_kernel: None = the kernel when supported, False = the op-level
    route (make_bdf2_step), True = require the kernel (raises if
    unsupported). On a CUDA tensor the kernel route launches the CUDA
    kernel; on a CPU tensor it runs the kernel's plain PyTorch version.

    differentiable=True wires the implicit-function VJP on the kernel route:
    z = H^-T xbar, then the VJP of residual_bdf2 at the detached solution;
    the kernel itself is never differentiated. That VJP runs on the residual
    VJP kernel (residual_vjp.residual_vjp, with z solved in the same launch
    on the "reuse" backward) where residual_vjp.takes admits the scene
    (constant-S joints, no closure but ground contacts) and, decided in each
    step's backward, residual_vjp.takes_params the params (lane-shared but
    tau) and no params leaf but tau requires grad; else through autograd of
    the op-level residual_bdf2 (force closures included). backward picks H:
      "reuse"   the H^-1 the kernel returned (the chord factor at the
                predictor; the last one built for chord=False);
      "refresh" the structured H rebuilt at the solution x*;
      "exact"   the exact Jacobian of the residual at x*;
    the last two solve by the GJ inverse. The op-level route has no such
    choice (its escape hatch is cfg.hessian="exact" with
    adjoint_reuse_factor=False): a differentiable op-level step with another
    backward than "reuse" raises ValueError, as does an unknown backward.
    """
    from redmax_tpu_torch import chord_kernel, residual_vjp

    qualifies = chord_kernel.supports(topo, force_fns, cfg)
    if use_kernel is None:
        use_kernel = qualifies
    elif use_kernel and not qualifies:
        raise ValueError("scene/config not supported by the chord kernel")
    if backward not in ("reuse", "refresh", "exact"):
        raise ValueError(f"backward={backward!r}")
    if differentiable and backward != "reuse" and not use_kernel:
        raise ValueError(f"backward={backward!r} only applies to the kernel route; this "
                         "scene/config takes the op-level route (use cfg.hessian='exact' "
                         "with adjoint_reuse_factor=False there)")

    base = make_bdf2_step(topo, force_fns, cfg, differentiable=differentiable)
    if not use_kernel:
        return base
    factor, _, solve_T = make_solver(cfg.linsolve)
    hess_2 = _hess_bdf2(topo, force_fns)

    def _res2(theta, x):
        params, q0, qd0, q1, qd1 = theta
        return residual_bdf2(topo, force_fns, params, x, q0, qd0, q1, qd1)

    def _kernel(theta, x0):
        params, q0, qd0, q1, qd1 = theta
        x, hinv = chord_kernel.chord_bdf2(topo, cfg, params, x0, q0, qd0, q1, qd1, force_fns)
        return x, hinv if backward == "reuse" else None

    def _vjp(theta, x, hinv, xbar, z):
        """The residual VJP kernel's cotangents of (tau, q0, qd0, q1, qd1):
        z = H^-T xbar by the forward's H^-1 in the launch ("reuse"), or the z
        that _z solved."""
        params, q0, qd0, q1, qd1 = theta
        if z is None:
            return residual_vjp.residual_vjp(topo, force_fns, params, q0, qd0, q1, qd1, x, xbar,
                                             hinv)
        return residual_vjp.residual_vjp(topo, force_fns, params, q0, qd0, q1, qd1, x, z)

    def _z(theta, x, hinv, xbar):
        """z = H^-T xbar per lane, H as `backward` says."""
        if backward == "reuse":
            return solve_T(hinv, xbar)
        if backward == "refresh":
            H = hess_2(theta, x)
        else:
            H = batched_jacobian(lambda xx: _res2(theta, xx), x)
        return solve_T(factor(H), xbar.to(H.dtype))

    why = residual_vjp.refusal(topo, force_fns)    # the op-level VJP's reason where not None
    vjp = (ResidualVJP(_vjp, residual_vjp.takes_params, backward == "reuse")
           if differentiable and why is None else None)
    started = []   # the kernel's build started (at the first step on the card)

    def inner(params: Dict, s: Bdf2State) -> Bdf2State:
        with metrics.span("integrators.inner"):
            q0, qd0 = s.q_prev, s.qdot_prev
            q1, qd1 = s.q, s.qdot
            h = lanewise(params["h"], 2)
            guess = q1 + h * qd1
            if cfg.predictor == "quadratic":
                guess = guess + 0.5 * h * (qd1 - qd0)
            theta = (params, q0, qd0, q1, qd1)
            if differentiable:
                if vjp is not None and not started and guess.device.type == "cuda":
                    residual_vjp.prepare(topo, force_fns)
                    started.append(True)
                q2 = implicit_solve_custom(_res2, _kernel, _z, theta, guess, vjp=vjp, why=why)
            else:
                q2 = _kernel(theta, guess)[0]
            qdot2 = (3 / (2 * h)) * (q2 - (4 / 3) * q1 + (1 / 3) * q0)
            return _reparam(topo, params, Bdf2State(
                q=q2, qdot=qdot2, q_prev=q1, qdot_prev=qd1, k=s.k + 1, aux=s.aux))

    def step(params: Dict, s: Bdf2State) -> Bdf2State:
        return base.bootstrap(params, s) if s.k == 0 else inner(params, s)

    step.bootstrap = base.bootstrap
    step.inner = inner
    return step


def make_simulate(step_fn: Callable, nsteps: int, record: bool = False,
                  scene_fn: Callable = None):
    """Roll a step function for nsteps and return the final state, and with
    record=True also the history (q [nsteps, B, nr], qdot [nsteps, B, nr])
    of the state after each step. A step function that exposes
    .bootstrap/.inner (BDF2) runs the SDIRK2 bootstrap once, then
    nsteps - 1 inner steps; any other (Euler) is called nsteps times.

    scene_fn(params, t) -> params: the time-dependent scene hook (the
    reference's sceneFcn, called with each step's end time
    t = (k + 1) h, the bootstrap's included, testRedMax.m:569), applied to
    the params given here, not to its own earlier output.
    """
    split = hasattr(step_fn, "bootstrap") and nsteps >= 1

    def simulate(params: Dict, state0):
        def at_t(k):
            return scene_fn(params, (k + 1) * params["h"]) if scene_fn else params

        with metrics.span("integrators.simulate"):
            qs, qds = [], []
            s = step_fn.bootstrap(at_t(0), state0) if split else state0
            inner = step_fn.inner if split else step_fn
            if split and record:
                qs.append(s.q)
                qds.append(s.qdot)
            for k in range(1 if split else 0, nsteps):
                s = inner(at_t(k), s)
                if record:
                    qs.append(s.q)
                    qds.append(s.qdot)
            return (s, (torch.stack(qs), torch.stack(qds))) if record else s

    return simulate


# ---------------------------------------------------------------------------
# Linearly implicit (semi-implicit) Euler with constraints
# ---------------------------------------------------------------------------


def closure_blocks(fns: Tuple, params: Dict, kin, phi):
    """(K, D [B, P, 6, 6], bj, bi) of the ground contacts, springs and cables
    among the closures fns, one 6x6 block a (body j, body i) pair: the
    derivative of body j's wrench by body i's pose (K) or twist (D), in
    closed form (forces.ground_contact_blocks, masks frozen;
    forces.pair_closure_blocks); or None when fns holds none of them.
    Raises on a closure with neither a block nor implicit_KD = False
    (model._split_closures)."""
    gnd, pair, _ = _split_closures(fns)
    dev = phi.device
    out = []
    if gnd:
        bodies = tuple(fn.body for fn in gnd)
        idx = forces.body_index(bodies, dev)
        K, D = forces.ground_contact_blocks(kin.E_wi[:, idx], phi[:, idx],
                                            forces.stack_contact_params(gnd, params))
        out.append((K, D, bodies, bodies))
    p = None
    if pair:
        with metrics.span("forces.pair_closures"):
            p = forces.pair_closure_blocks(pair, params, kin, phi)
    if p is not None:
        out.append(p)
    if not out:
        return None
    return (torch.cat([o[0] for o in out], 1), torch.cat([o[1] for o in out], 1),
            sum((tuple(o[2]) for o in out), ()), sum((tuple(o[3]) for o in out), ()))


def _closure_KD(force_fns: Tuple, params: Dict, kin, phi, J):
    """The force closures' part of the Euler system's left side and f0, from
    closed-form blocks (the JAX package takes Km, Dm by jacfwd of the
    closures, model.maximal_force_KD): (J^T Km J, J^T Dm J [B, nr, nr],
    Dm_strip phi [B, N, 6]). Km and Dm sum the blocks of the closures with
    implicit_KD (ground contacts: forces.ground_contact_blocks, masks
    frozen; springs and cables: forces.pair_closure_blocks), Km
    symmetrized; Dm_strip sums those that also strip their damping force
    from f0 (strip_damping, the default); a closure with custom_KD adds its
    own blocks (SpringDamperM.matlab_KD) after the symmetrization."""
    gnd, pair, _ = _split_closures(force_fns)
    B, N, nr = J.shape[0], kin.E_wi.shape[1], J.shape[-1]
    Jblk = J.reshape(B, N, 6, nr)
    dev = phi.device

    def contract(X, bj, bi):
        return torch.einsum("bpir,bpij,bpjs->brs", Jblk[:, forces.body_index(bj, dev)], X,
                            Jblk[:, forces.body_index(bi, dev)])

    KmJ = DmJ = phi.new_zeros(B, nr, nr)
    fm_strip = torch.zeros_like(phi)
    implicit = gnd + pair
    blk = closure_blocks(implicit, params, kin, phi)
    if blk is not None:
        K, D, bj, bi = blk
        KmJ = contract(K, bj, bi)
        KmJ = 0.5 * (KmJ + KmJ.transpose(-1, -2))
        DmJ = contract(D, bj, bi)
        strip = tuple(fn for fn in implicit if getattr(fn, "strip_damping", True))
        if strip != implicit:
            blk = closure_blocks(strip, params, kin, phi)
        if blk is not None:
            D, bj, bi = blk[1], blk[2], blk[3]
            fm_strip = fm_strip.index_add(
                1, forces.body_index(bj, dev),
                (D @ phi[:, forces.body_index(bi, dev), :, None])[..., 0])
    for fn in force_fns:
        if getattr(fn, "custom_KD", False):
            Kc, Dc = fn.matlab_KD(params, kin, phi)
            Jc = torch.cat([Jblk[:, b] if b >= 0 else torch.zeros_like(Jblk[:, 0])
                            for b in (fn.body1, fn.body2)], dim=1)            # [B, 12, nr]
            KmJ = KmJ + Jc.transpose(-1, -2) @ Kc @ Jc
            DmJ = DmJ + Jc.transpose(-1, -2) @ Dc @ Jc
    return KmJ, DmJ, fm_strip


def euler_system(topo: Topology, force_fns: Tuple, params: Dict, q0, qdot0, aux=None):
    """Assemble the linearly implicit Euler system at batched (q0, qdot0):

        Mrtilde qdot1 = frtilde
        frtilde = Mr qdot0 + h (J^T (f0_m - Mm Jdot qdot0) + f0_r)
        Mrtilde = Mr - h J^T Dm J - h^2 J^T Km J - h Dr - h^2 Kr

    f0 excludes the damping forces: damping is one-sidedly implicit, its
    force is dropped and only D enters the left side (testRedMax.m:476),
    except for a closure with strip_damping = False (SpringDamperM), whose
    damping force stays. Kr and Dr are the closed-form diagonals of
    model.joint_space_KD_diag (penalty limits included). Dm is the body
    damping plus the closures' Dm, Km the closures' symmetrized Km, both
    from closed-form blocks (_closure_KD); closures with implicit_KD =
    False (ForcePointDirection, ForceDeformableSegments) stay explicit in
    f0. h, I_i, g and body_damping may be per lane.

    Returns a dict: kin, J, Jdot, phi, Mr [B,nr,nr], frtilde [B,nr],
    Mrtilde [B,nr,nr], and the pieces the matrix-free PCG tier applies
    against J x: Kr, Dr (diagonals [B,nr]) and KDmJ = h J^T Dm J + h^2 J^T
    Km J [B,nr,nr] of the force closures (None without closures).
    """
    h, h3 = lanewise(params["h"], 2), lanewise(params["h"], 3)
    B = q0.shape[0]
    kin = forward_kinematics(topo, params, q0, qdot0, aux)
    J, Jdot, phi = jacobians(topo, params, kin, qdot0)
    Jt = J.transpose(-1, -2)

    Kr, Dr = joint_space_KD_diag(topo, params, q0, qdot0)        # diagonals [B,nr]
    f0_r = joint_space_force(topo, params, q0, qdot0) - Dr * qdot0

    # maximal_force carries -bd*phi; adding it back leaves Coriolis + gravity
    bd6 = params["body_damping"].repeat_interleave(6, dim=-1)    # Dm = -diag(bd6)
    phif = phi.reshape(B, -1)
    f0_m = maximal_force(topo, params, kin, phi).reshape(B, -1) + bd6 * phif
    if force_fns:
        KmJ, DmJ, fm_strip = _closure_KD(force_fns, params, kin, phi, J)
        _, fm_cl = closure_forces(topo, params, kin, phi, q0, qdot0, force_fns)
        f0_m = f0_m + (fm_cl - fm_strip).reshape(B, -1)

    Ivec = mass_diag(params["I_i"])                              # [(B,) 6N, 1]
    Mr = Jt @ (Ivec * J)
    Mr = 0.5 * (Mr + Mr.transpose(-1, -2))
    frtilde = _mv(Mr, qdot0) + h * (_mv(Jt, f0_m - Ivec[..., 0] * _mv(Jdot, qdot0)) + f0_r)
    Mrtilde = Mr + h3 * (Jt @ (bd6[..., None] * J)) - torch.diag_embed(h * Dr + h * h * Kr)
    KDmJ = None
    if force_fns:
        Mrtilde = Mrtilde - h3 * DmJ - h3 * h3 * KmJ
        KDmJ = h3 * DmJ + h3 * h3 * KmJ
    return {"kin": kin, "J": J, "Jdot": Jdot, "phi": phi,
            "Mr": Mr, "frtilde": frtilde, "Mrtilde": Mrtilde, "Kr": Kr, "Dr": Dr, "KDmJ": KDmJ}


def euler_qp_system(topo, force_fns, constraint_fns, params, q0, qdot0, aux=None):
    """(Mrtilde, frtilde, qp) with qp = None for a scene without constraint
    rows, else the stacked rows (A, b, lo, hi, me): the me equality rows
    first with boxes (-inf, inf), then the inequality rows, an active one
    with box (0, inf) and an inactive one masked to a zero row with
    b = 0 and lo = hi = 0."""
    sys = euler_system(topo, force_fns, params, q0, qdot0, aux)
    if not constraint_fns:
        return sys["Mrtilde"], sys["frtilde"], None
    rows = assemble_constraints(constraint_fns, params, topo, sys["kin"], sys["phi"],
                                q0, qdot0, sys["J"])
    B, dtype = q0.shape[0], q0.dtype
    baum3 = params["baumgarte"][2]
    act = rows["act"]
    me, mi = rows["Geq"].shape[1], rows["Cin"].shape[1]
    rhsG = -rows["geqdot"] - baum3 * rows["geq"]
    rhsC = torch.where(act, -baum3 * rows["cin"], torch.zeros_like(rows["cin"]))
    inf = q0.new_full((B, me), float("inf"))
    zero = q0.new_zeros(B, mi)
    A = torch.cat([rows["Geq"], rows["Cin"] * act.to(dtype)[..., None]], dim=1)
    b = torch.cat([rhsG, rhsC], dim=1)
    lo = torch.cat([-inf, zero], dim=1)
    hi = torch.cat([inf, torch.where(act, float("inf"), 0.0).to(dtype)], dim=1)
    return sys["Mrtilde"], sys["frtilde"], (A, b, lo, hi, me)


def _make_euler_step(topo, force_fns, constraint_fns, ineq_solve: Callable):
    """The Euler step around an inequality solve
    ineq_solve(H, f, A, b, lo, hi) -> (x, lam)."""

    def step(params: Dict, state: State) -> State:
        q0, qdot0 = state.q, state.qdot
        Mrt, frt, qp = euler_qp_system(topo, force_fns, constraint_fns, params, q0, qdot0,
                                       state.aux)
        if qp is None:
            qdot1 = torch.linalg.solve(Mrt, frt[..., None])[..., 0]
        else:
            A, b, lo, hi, me = qp
            if A.shape[1] == me:          # pure equality: dense KKT
                qdot1, _ = kkt_solve(Mrt, A, frt, b)
            else:
                qdot1, _ = ineq_solve(Mrt, frt, A, b, lo, hi)
        q1 = q0 + lanewise(params["h"], 2) * qdot1
        q1, qdot1, aux, _, _ = reparam_all(topo, params, q1, qdot1, state.aux)
        return State(q=q1, qdot=qdot1, aux=aux)

    return step


def make_euler_step(
    topo: Topology,
    force_fns: Tuple = (),
    constraint_fns: Tuple = (),
    pgs_iters: int = 40,
):
    """One linearly implicit Euler step over [B, nr] states, op-level; the
    system assembly is euler_system (docstring there).

    Constraints: equality rows G qdot1 = -gdot - baum3 g via dense KKT;
    with inequality rows in the scene, the dual PGS QP (qp.qp_pgs_batched)
    over all rows. Baumgarte factor from params["baumgarte"][2].
    """
    return _make_euler_step(
        topo, force_fns, constraint_fns,
        lambda *system: qp_pgs_batched(*system, iters=pgs_iters))


def make_euler_step_batched(
    topo: Topology,
    force_fns: Tuple = (),
    constraint_fns: Tuple = (),
    pgs_iters: int = 40,
    use_kernel: bool = None,
):
    """The batched contact-QP tier: the Euler step with its inequality solve
    on the fused dual-PGS kernel (qp_kernel.dual_pgs).

    use_kernel: None = the kernel when the scene has inequality rows,
    False = the op-level route (make_euler_step, qp.qp_pgs_batched),
    True = require the kernel (raises for a scene without inequality rows).
    On a CUDA tensor the kernel route launches the CUDA kernel (float32, else
    it raises; any (nr, rows): a shape outside qp_kernel.INSTANTIATED is
    built at its first launch); on a CPU tensor it runs the kernel's plain
    PyTorch version. Pure-equality scenes solve the dense KKT system and
    launch nothing. tau, h, I_i, g and body_damping
    may be per lane (split_batched_params); the kernel's inputs are per lane
    already.
    """
    from redmax_tpu_torch import qp_kernel

    qualifies = any(c.n_ineq_m or c.n_ineq_r for c in constraint_fns)
    if use_kernel is None:
        use_kernel = qualifies
    elif use_kernel and not qualifies:
        raise ValueError("the scene has no inequality rows for the dual-PGS kernel")
    if not use_kernel:
        return make_euler_step(topo, force_fns, constraint_fns, pgs_iters)
    return _make_euler_step(
        topo, force_fns, constraint_fns,
        lambda *system: qp_kernel.dual_pgs(*system, iters=pgs_iters))
