"""Implicit integrators: SDIRK2-bootstrapped BDF2 with fixed-iteration chord
Newton, batch-first.

Semantics are those of the JAX package's integrators.py (and of the
reference drivers):

  * SDIRK2 bootstrap with alpha = (2 - sqrt(2))/2, two substeps, then BDF2
    g = M (q2 - 4/3 q1 + 1/3 q0 - 8/9 h qdot1 + 2/9 h qdot0) - 4/9 h^2 f
    (driverRedMaxBDF2.m:64-293).
  * Fixed-iteration chord Newton: the structured Newton matrix is built and
    inverted once at the predictor, then `fixed_iters` full steps; lanes
    whose residual grew or went non-finite are poisoned to NaN.

Every state tensor is [B, nr]; lanes step in lock-step and never mix.
Ported here: the unguarded chord branch of `newton`. The damped Newton with
line search, `guarded`, `guard_last`, `chord=False`, the "exact" Hessian and
the "lu" / "gj_pivot" solvers raise (ROADMAP).
"""

import math
from dataclasses import dataclass
from typing import Callable, Dict, NamedTuple, Tuple

import torch

from redmax_tpu_torch.adjoint import implicit_solve_factored
from redmax_tpu_torch.linalg import make_solver
from redmax_tpu_torch.model import assemble, reparam_all, structured_hessian
from redmax_tpu_torch.types import State, Topology

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
    hessian: str = "exact"   # "structured" is the ported mode
    linsolve: str = "lu"     # "gj" is the ported solver
    predictor: str = "linear"  # BDF2 guess: "linear" or "quadratic"
    dx_clamp: float = 0.0    # per-lane step-norm clamp (0 = off)
    guarded: bool = False
    guard_last: bool = False
    growth_reject: float = 10.0  # reject when |g| grew by more than this
    tol_reject: float = 0.0      # reject when the last |g| exceeds this
    adjoint_reuse_factor: bool = True


def newton(res_fn: Callable, x0, cfg: NewtonConfig, jac_fn: Callable = None):
    """Fixed-iteration, unguarded chord Newton over batched x0 [B, nr].

    res_fn: x [B, nr] -> g [B, nr]; jac_fn: x -> H [B, nr, nr] (the
    structured Newton matrix). Returns (x, info) with info["factor"] the
    chord factor H^-1 at the predictor and info["diverged"] the [B] mask of
    rejected (NaN-poisoned) lanes.
    """
    if cfg.fixed_iters <= 0:
        raise NotImplementedError("damped Newton with line search (fixed_iters=0) is a ROADMAP item")
    if cfg.guarded or cfg.guard_last or not cfg.chord:
        raise NotImplementedError("guarded / guard_last / chord=False solves are ROADMAP K1g")
    if jac_fn is None:
        raise NotImplementedError("the exact (jacfwd) Newton matrix is a ROADMAP item")
    factor, solve, _ = make_solver(cfg.linsolve)

    def clamp(dx):
        if not cfg.dx_clamp:
            return dx
        nrm = torch.linalg.vector_norm(dx, dim=-1, keepdim=True)
        return dx * torch.clamp(cfg.dx_clamp / torch.clamp(nrm, min=1e-30), max=1.0)

    F = factor(jac_fn(x0))
    x = x0
    g0n = None
    for _ in range(cfg.fixed_iters):
        g = res_fn(x)
        gn = torch.linalg.vector_norm(g, dim=-1)
        g0n = gn if g0n is None else g0n
        gln = gn  # residual at the PRE-update iterate (one iteration stale)
        x = x - clamp(solve(F, g))
    diverged = ~torch.isfinite(x).all(dim=-1) | ~torch.isfinite(gln)
    if cfg.growth_reject:
        diverged = diverged | (gln > cfg.growth_reject * g0n)
    if cfg.tol_reject:
        diverged = diverged | (gln > cfg.tol_reject)
    x = torch.where(diverged[..., None], torch.full_like(x, float("nan")), x)
    return x, {"iters": cfg.fixed_iters, "diverged": diverged, "factor": F}


# ---------------------------------------------------------------------------
# Residuals
# ---------------------------------------------------------------------------


def _Mf(topo, force_fns, params, q, qdot):
    M, f, _ = assemble(topo, params, q, qdot, force_fns)
    return M, f


def _mv(M, v):
    return (M @ v[..., None])[..., 0]


def residual_sdirk2a(topo, force_fns, params: Dict, qa, q0, qdot0):
    ah = SDIRK_ALPHA * params["h"]
    dqtmp = qa - q0 - ah * qdot0
    qdota = (qa - q0) / ah
    M, f = _Mf(topo, force_fns, params, qa, qdota)
    return _mv(M, dqtmp) - ah * ah * f


def residual_sdirk2b(topo, force_fns, params: Dict, q1, q0, qdot0, qdota):
    a = SDIRK_ALPHA
    h = params["h"]
    ah = a * h
    dqtmp = q1 - q0 - (2 * a - 1) * h * qdot0 - 2 * (1 - a) * h * qdota
    qdot1 = (q1 - q0 - (1 - a) * h * qdota) / ah
    M, f = _Mf(topo, force_fns, params, q1, qdot1)
    return _mv(M, dqtmp) - ah * ah * f


def residual_bdf2(topo, force_fns, params: Dict, q2, q0, qdot0, q1, qdot1):
    h = params["h"]
    dqtmp = q2 - (4 / 3) * q1 + (1 / 3) * q0 - (8 / 9) * h * qdot1 + (2 / 9) * h * qdot0
    qdot2 = (3 / (2 * h)) * (q2 - (4 / 3) * q1 + (1 / 3) * q0)
    M, f = _Mf(topo, force_fns, params, q2, qdot2)
    return _mv(M, dqtmp) - (4 / 9) * h * h * f


# ---------------------------------------------------------------------------
# Structured Newton matrices (see model.structured_hessian)
# ---------------------------------------------------------------------------


def _hess_sdirk2a(topo, force_fns):
    def hess(theta, qa):
        params, q0, qdot0 = theta
        ah = SDIRK_ALPHA * params["h"]
        return structured_hessian(
            topo, params, qa, (qa - q0) / ah, -ah * ah, -ah, force_fns
        )

    return hess


def _hess_sdirk2b(topo, force_fns):
    def hess(theta, q1):
        params, q0, qdot0, qdota = theta
        a = SDIRK_ALPHA
        ah = a * params["h"]
        qdot1 = (q1 - q0 - (1 - a) * params["h"] * qdota) / ah
        return structured_hessian(topo, params, q1, qdot1, -ah * ah, -ah, force_fns)

    return hess


def _hess_bdf2(topo, force_fns):
    def hess(theta, q2):
        params, q0, qdot0, q1, qdot1 = theta
        h = params["h"]
        qdot2 = (3 / (2 * h)) * (q2 - (4 / 3) * q1 + (1 / 3) * q0)
        return structured_hessian(
            topo, params, q2, qdot2, -(4 / 9) * h * h, -(2 / 3) * h, force_fns
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


# Per-lane physical parameters: a leaf with ndim == base + 1 carries a
# leading [B] lane dim. Only the torque is per-lane on this path; the others
# (the system-identification dimension) are ROADMAP K1f.
_BATCHABLE = {"tau": 1}
_LATER = {"I_i": 2, "g": 1, "h": 0, "body_damping": 1}


def split_batched_params(params: Dict):
    """(shared, batched): split params into lane-shared leaves and the
    per-lane [B, ...] leaves. Raises on per-lane leaves not yet ported."""
    for k, nd in _LATER.items():
        if params[k].ndim == nd + 1:
            raise NotImplementedError(f"per-lane {k!r} is ROADMAP K1f")
    shared = dict(params)
    batched = {k: shared.pop(k) for k, nd in _BATCHABLE.items() if params[k].ndim == nd + 1}
    return shared, batched


def _newton_factored(cfg, res_theta_fn, hess_fn):
    """(theta, x0) -> (x*, factor): the forward solve implicit_solve_factored
    wraps."""

    def run(theta, x0):
        jac = (lambda x: hess_fn(theta, x)) if hess_fn else None
        x, info = newton(lambda x: res_theta_fn(theta, x), x0, cfg, jac_fn=jac)
        return x, info["factor"]

    return run


def _reparam(topo, params, s: Bdf2State) -> Bdf2State:
    q, qdot = reparam_all(topo, params, s.q, s.qdot)
    return s._replace(q=q, qdot=qdot)


def make_bdf2_step(
    topo: Topology,
    force_fns: Tuple = (),
    cfg: NewtonConfig = NewtonConfig(),
    differentiable: bool = False,
):
    """One batched BDF2 step with SDIRK2 bootstrap at k=0.

    differentiable=True routes each solve through implicit_solve_factored
    (the adjoint reuses the forward chord factor). Exposes .bootstrap and
    .inner, the two phases make_simulate runs.
    """
    if differentiable and not cfg.adjoint_reuse_factor:
        raise NotImplementedError("the non-reusing adjoint (implicit_solve) is a ROADMAP item")
    structured = cfg.hessian == "structured"
    hess_a = _hess_sdirk2a(topo, force_fns) if structured else None
    hess_b = _hess_sdirk2b(topo, force_fns) if structured else None
    hess_2 = _hess_bdf2(topo, force_fns) if structured else None
    _, _, solve_T = make_solver(cfg.linsolve)

    def _res_a(theta, qa):
        params, q0, qdot0 = theta
        return residual_sdirk2a(topo, force_fns, params, qa, q0, qdot0)

    def _res_b(theta, q1):
        params, q0, qdot0, qdota = theta
        return residual_sdirk2b(topo, force_fns, params, q1, q0, qdot0, qdota)

    def _res_2(theta, q2):
        params, q0, qdot0, q1, qdot1 = theta
        return residual_bdf2(topo, force_fns, params, q2, q0, qdot0, q1, qdot1)

    nf = {"a": _newton_factored(cfg, _res_a, hess_a),
          "b": _newton_factored(cfg, _res_b, hess_b),
          "2": _newton_factored(cfg, _res_2, hess_2)}
    res = {"a": _res_a, "b": _res_b, "2": _res_2}

    def _solve(key, theta, x0):
        split_batched_params(theta[0])
        if differentiable:
            return implicit_solve_factored(res[key], nf[key], solve_T, theta, x0)
        return nf[key](theta, x0)[0]

    def bootstrap(params: Dict, s: Bdf2State) -> Bdf2State:
        q0, qdot0 = s.q, s.qdot
        ah = SDIRK_ALPHA * params["h"]
        qa = _solve("a", (params, q0, qdot0), q0 + ah * qdot0)
        qdota = (qa - q0) / ah
        q1 = _solve("b", (params, q0, qdot0, qdota),
                    qa + (1 - SDIRK_ALPHA) * params["h"] * qdota)
        qdot1 = (q1 - q0 - (1 - SDIRK_ALPHA) * params["h"] * qdota) / ah
        return _reparam(topo, params, Bdf2State(
            q=q1, qdot=qdot1, q_prev=q0, qdot_prev=qdot0, k=s.k + 1, aux=s.aux))

    def inner(params: Dict, s: Bdf2State) -> Bdf2State:
        q0, qdot0 = s.q_prev, s.qdot_prev
        q1, qdot1 = s.q, s.qdot
        h = params["h"]
        guess = q1 + h * qdot1
        if cfg.predictor == "quadratic":
            guess = guess + 0.5 * h * (qdot1 - qdot0)
        q2 = _solve("2", (params, q0, qdot0, q1, qdot1), guess)
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
):
    """Batched BDF2 step over [B, nr] states, with the inner chord solve on
    the fused chord kernel (chord_kernel.chord_bdf2) when the scene and
    config qualify.

    use_kernel: None = the kernel when supported, False = the op-level
    route (make_bdf2_step), True = require the kernel (raises if
    unsupported). On a CUDA tensor the kernel route launches the CUDA
    kernel; on a CPU tensor it runs the kernel's plain PyTorch version.

    differentiable=True wires the implicit-function VJP with the "reuse"
    backward: z = H^-T xbar from the H^-1 the kernel returned (the chord
    factor at the predictor), then one VJP of the op-level residual_bdf2 at
    the detached solution. The kernel itself is never differentiated.
    """
    from redmax_tpu_torch import chord_kernel

    qualifies = chord_kernel.supports(topo, force_fns, cfg)
    if use_kernel is None:
        use_kernel = qualifies
    elif use_kernel and not qualifies:
        raise ValueError("scene/config not supported by the chord kernel")

    base = make_bdf2_step(topo, force_fns, cfg, differentiable=differentiable)
    if not use_kernel:
        return base
    _, _, solve_T = make_solver(cfg.linsolve)

    def _res2(theta, x):
        params, q0, qd0, q1, qd1 = theta
        return residual_bdf2(topo, force_fns, params, x, q0, qd0, q1, qd1)

    def _kernel(theta, x0):
        params, q0, qd0, q1, qd1 = theta
        return chord_kernel.chord_bdf2(topo, cfg, params, x0, q0, qd0, q1, qd1)

    def inner(params: Dict, s: Bdf2State) -> Bdf2State:
        q0, qd0 = s.q_prev, s.qdot_prev
        q1, qd1 = s.q, s.qdot
        h = params["h"]
        guess = q1 + h * qd1
        if cfg.predictor == "quadratic":
            guess = guess + 0.5 * h * (qd1 - qd0)
        theta = (params, q0, qd0, q1, qd1)
        if differentiable:
            q2 = implicit_solve_factored(_res2, _kernel, solve_T, theta, guess)
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


def make_simulate(step_fn: Callable, nsteps: int):
    """Roll a BDF2 step function for nsteps: the SDIRK2 bootstrap once, then
    nsteps - 1 inner steps. Returns the final Bdf2State."""

    def simulate(params: Dict, state0: Bdf2State) -> Bdf2State:
        s = step_fn.bootstrap(params, state0)
        for _ in range(nsteps - 1):
            s = step_fn.inner(params, s)
        return s

    return simulate
