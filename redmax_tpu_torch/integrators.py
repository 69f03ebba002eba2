"""Implicit integrators, batch-first: SDIRK2-bootstrapped BDF2 with
fixed-iteration chord Newton, and the linearly implicit Euler step with hard
constraints (dense KKT for equalities, dual projected Gauss-Seidel for
inequalities).

Semantics are those of the JAX package's integrators.py (and of the
reference drivers):

  * SDIRK2 bootstrap with alpha = (2 - sqrt(2))/2, two substeps, then BDF2
    g = M (q2 - 4/3 q1 + 1/3 q0 - 8/9 h qdot1 + 2/9 h qdot0) - 4/9 h^2 f
    (driverRedMaxBDF2.m:64-293).
  * Fixed-iteration chord Newton: the structured Newton matrix is built and
    inverted once at the predictor, then `fixed_iters` full steps; lanes
    whose residual grew or went non-finite are poisoned to NaN.
  * Linearly implicit Euler: Mrtilde qdot1 = frtilde with one-sidedly
    implicit damping, constraint rows from constraints.assemble_constraints,
    Baumgarte stabilization from params["baumgarte"][2].

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
from redmax_tpu_torch.constraints import assemble_constraints
from redmax_tpu_torch.linalg import make_solver
from redmax_tpu_torch.model import (
    assemble, forward_kinematics, jacobians, joint_space_force, joint_space_KD_diag,
    maximal_force, reparam_all, structured_hessian,
)
from redmax_tpu_torch.qp import kkt_solve, qp_pgs_batched
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
    per-lane [B, ...] leaves. Raises on per-lane leaves not yet ported
    (physical params and contact coefficients)."""
    for k, nd in _LATER.items():
        if params[k].ndim == nd + 1:
            raise NotImplementedError(f"per-lane {k!r} is ROADMAP K1f")
    for key, fp in params.get("forces", {}).items():
        for k in ("kn", "kt", "kd", "mu"):
            if k in fp and fp[k].ndim:
                raise NotImplementedError(f"per-lane contact {k!r} of {key!r} is ROADMAP K1f")
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
    the detached solution (force closures included, through autograd). The
    kernel itself is never differentiated.
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
        return chord_kernel.chord_bdf2(topo, cfg, params, x0, q0, qd0, q1, qd1, force_fns)

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
    """Roll a step function for nsteps and return the final state. A step
    function that exposes .bootstrap/.inner (BDF2) runs the SDIRK2 bootstrap
    once, then nsteps - 1 inner steps; any other (Euler) is called nsteps
    times."""
    split = hasattr(step_fn, "bootstrap") and nsteps >= 1

    def simulate(params: Dict, state0):
        s = step_fn.bootstrap(params, state0) if split else state0
        inner = step_fn.inner if split else step_fn
        for _ in range(nsteps - 1 if split else nsteps):
            s = inner(params, s)
        return s

    return simulate


# ---------------------------------------------------------------------------
# Linearly implicit (semi-implicit) Euler with constraints
# ---------------------------------------------------------------------------


def euler_system(topo: Topology, force_fns: Tuple, params: Dict, q0, qdot0):
    """Assemble the linearly implicit Euler system at batched (q0, qdot0):

        Mrtilde qdot1 = frtilde
        frtilde = Mr qdot0 + h (J^T (f0_m - Mm Jdot qdot0) + f0_r)
        Mrtilde = Mr - h J^T Dm J - h Dr - h^2 Kr

    f0 excludes the damping forces: damping is one-sidedly implicit, its
    force is dropped and only D enters the left side. Kr and Dr are the
    closed-form diagonals of model.joint_space_KD_diag (penalty limits
    included), and without force closures Dm is the body damping alone and
    Km is zero. Force closures raise (their Km/Dm in the Euler system are
    ROADMAP queue 1 item 10).

    Returns a dict: kin, J, Jdot, phi, Mr [B,nr,nr], frtilde [B,nr],
    Mrtilde [B,nr,nr].
    """
    if force_fns:
        raise NotImplementedError(
            "force closures in the Euler system (their Km, Dm) are ROADMAP queue 1 item 10")
    h = params["h"]
    B = q0.shape[0]
    kin = forward_kinematics(topo, params, q0, qdot0)
    J, Jdot, phi = jacobians(topo, params, kin, qdot0)
    Jt = J.transpose(-1, -2)

    Kr, Dr = joint_space_KD_diag(topo, params, q0, qdot0)        # diagonals [B,nr]
    f0_r = joint_space_force(topo, params, q0, qdot0) - Dr * qdot0

    # maximal_force carries -bd*phi; adding it back leaves Coriolis + gravity
    bd6 = params["body_damping"].repeat_interleave(6)            # Dm = -diag(bd6)
    phif = phi.reshape(B, -1)
    f0_m = maximal_force(topo, params, kin, phi).reshape(B, -1) + bd6 * phif

    Ivec = params["I_i"].reshape(-1)
    Mr = Jt @ (Ivec[:, None] * J)
    Mr = 0.5 * (Mr + Mr.transpose(-1, -2))
    frtilde = _mv(Mr, qdot0) + h * (_mv(Jt, f0_m - Ivec * _mv(Jdot, qdot0)) + f0_r)
    Mrtilde = Mr + h * (Jt @ (bd6[:, None] * J)) - torch.diag_embed(h * Dr + h * h * Kr)
    return {"kin": kin, "J": J, "Jdot": Jdot, "phi": phi,
            "Mr": Mr, "frtilde": frtilde, "Mrtilde": Mrtilde}


def euler_qp_system(topo, force_fns, constraint_fns, params, q0, qdot0):
    """(Mrtilde, frtilde, qp) with qp = None for a scene without constraint
    rows, else the stacked rows (A, b, lo, hi, me): the me equality rows
    first with boxes (-inf, inf), then the inequality rows, an active one
    with box (0, inf) and an inactive one masked to a zero row with
    b = 0 and lo = hi = 0."""
    sys = euler_system(topo, force_fns, params, q0, qdot0)
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
        split_batched_params(params)  # only tau may be per-lane
        Mrt, frt, qp = euler_qp_system(topo, force_fns, constraint_fns, params, q0, qdot0)
        if qp is None:
            qdot1 = torch.linalg.solve(Mrt, frt[..., None])[..., 0]
        else:
            A, b, lo, hi, me = qp
            if A.shape[1] == me:          # pure equality: dense KKT
                qdot1, _ = kkt_solve(Mrt, A, frt, b)
            else:
                qdot1, _ = ineq_solve(Mrt, frt, A, b, lo, hi)
        q1 = q0 + params["h"] * qdot1
        q1, qdot1 = reparam_all(topo, params, q1, qdot1)
        return State(q=q1, qdot=qdot1, aux=state.aux)

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
    On a CUDA tensor the kernel route launches the CUDA kernel (float32 and
    an instantiated (nr, rows) shape, else it raises); on a CPU tensor it
    runs the kernel's plain PyTorch version. Pure-equality scenes solve the
    dense KKT system and launch nothing. Only tau may be per-lane
    (split_batched_params).
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
