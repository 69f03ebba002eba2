"""Explicit adaptive integration, batch-first: the reference's ode45 paths
(the JAX package's explicit.py).

Two derivative oracles, as in the reference's cross-implementation check
(matlab/README.md itype table: REDMAX_ODE45 and RECURS_ODE45 "give
numerically the same solution"):

  * dense: qddot = Mr^{-1} f from model.assemble (redmaxFcn,
    matlab/testRedMax.m:361-446), constraints at the acceleration level
    with Baumgarte terms -(Gdot qdot) - 2 b1 G qdot - b2^2 g;
  * recursive O(n): qddot from recursive.rhd_qddot (recursFcn, :211-357),
    equality rows through the Schur complement G M^{-1} G^T built with the
    O(n) M^{-1} product.

The integrator is Dormand-Prince 5(4) with MATLAB ode45's step control
(RelTol 1e-4, AbsTol 1e-6, testRedMax.m:101-103). Each lane carries its own
time, step size and controller state, so its step sequence is that of a
run of the lane alone.
"""

from typing import Callable, Dict, Tuple

import numpy as np
import torch
import torch.autograd.forward_ad as fwAD

from redmax_tpu_torch import model, qp, recursive, se3
from redmax_tpu_torch.constraints import assemble_constraints
from redmax_tpu_torch.scene import _lanes
from redmax_tpu_torch.types import State, Topology

# Dormand-Prince 5(4) tableau (the ode45 pair).
_A = np.array(
    [
        [0, 0, 0, 0, 0, 0],
        [1 / 5, 0, 0, 0, 0, 0],
        [3 / 40, 9 / 40, 0, 0, 0, 0],
        [44 / 45, -56 / 15, 32 / 9, 0, 0, 0],
        [19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729, 0, 0],
        [9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656, 0],
    ]
)
_B5 = np.array([35 / 384, 0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0])
# 4th-order embedded weights. The stepper does not use them: its error
# estimate is the exact stage combination E = _B5 - _B4 (MATLAB ode45's
# hardcoded E fractions equal this difference componentwise).
_B4 = np.array(
    [5179 / 57600, 0, 7571 / 16695, 393 / 640, -92097 / 339200, 187 / 2100, 1 / 40]
)
_C = np.array([0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0])
_E = np.array([71 / 57600, 0.0, -71 / 16695, 71 / 1920, -17253 / 339200, 22 / 525, -1 / 40])

# The last make_ode45 run: its loop iterations (all lanes step together),
# and per lane [B] the controller's steps (accepted and rejected) and the
# accepted ones. Read by chip_smoke.py.
ode45_stats: Dict = {"iterations": 0, "steps": None, "accepted": None}

# How many loop iterations run between two reads of "is any lane still
# going" (each read waits for the card); lanes that are done stay frozen.
EXIT_TEST_EVERY = 4


def _mv(A, v):
    return (A @ v[..., None])[..., 0]


def _twist_matrix(phi):
    """Body twists [..., 6] (w, v) -> their [..., 4, 4] matrices, so that
    d/dt E_wi = E_wi [phi_i]."""
    top = torch.cat([se3.hat3(phi[..., :3]), phi[..., 3:, None]], dim=-1)
    return torch.cat([top, torch.zeros_like(top[..., :1, :])], dim=-2)


def constraint_rates(topo: Topology, params: Dict, constraint_fns: Tuple, q, qdot, aux=None,
                     parts: Dict = None):
    """The constraint rows at (q, qdot) [B, nr] with their rates along qdot:
    (rows, Gdot qdot [B, me], Cdot qdot [B, mi]): the directional
    derivative of G(q) qdot (and of C(q) qdot) along qdot with the qdot
    inside held fixed (the JAX package takes it by jax.jvp through the
    kinematics). A row reads the kinematics through the body frames E_wi,
    and a maximal row is G_m(E_wi) J, so the rate needs no derivative of
    the kinematics: forward-mode AD runs constraints.assemble_constraints
    alone on the duals E_wi + eps E_wi [phi], J + eps Jdot and q + eps qdot
    (Jdot from model.jacobians is dJ/dt along qdot). rows is
    assemble_constraints' dict at (q, qdot). parts: model.assemble's parts
    dict (kin, J, Jdot, phi) at (q, qdot), computed here when None."""
    if parts is None:
        kin = model.forward_kinematics(topo, params, q, qdot, aux)
        J, Jdot, phi = model.jacobians(topo, params, kin, qdot)
    else:
        kin, J, Jdot, phi = parts["kin"], parts["J"], parts["Jdot"], parts["phi"]
    with fwAD.dual_level():
        kin_d = kin._replace(E_wi=fwAD.make_dual(kin.E_wi, kin.E_wi @ _twist_matrix(phi)))
        dual = assemble_constraints(constraint_fns, params, topo, kin_d, phi,
                                    fwAD.make_dual(q, qdot), qdot, fwAD.make_dual(J, Jdot))
        rows = {name: fwAD.unpack_dual(val).primal for name, val in dual.items()}
        rates = []
        for name in ("Geq", "Cin"):
            u = fwAD.unpack_dual(_mv(dual[name], qdot))
            rates.append(u.tangent if u.tangent is not None else torch.zeros_like(u.primal))
    return rows, rates[0], rates[1]


def make_deriv_dense(topo: Topology, force_fns: Tuple = (), constraint_fns: Tuple = ()):
    """deriv(params, t, y [B, 2 nr], aux) -> ydot = [qdot; Mr^{-1} f] with
    acceleration-level constraints (redmaxFcn, testRedMax.m:361-446):
    equality rows by the dense KKT solve, and with inequality rows in the
    scene the dual PGS QP (qp.qp_pgs_batched, 200 sweeps) over all rows, the
    active ones boxed to lambda >= 0 and the others masked. t [B] is unused
    (a scene function wraps deriv)."""

    def deriv(params: Dict, t, y, aux=None):
        nr = topo.nr
        q, qdot = y[:, :nr], y[:, nr:]
        M, f, parts = model.assemble(topo, params, q, qdot, force_fns, aux)
        if not constraint_fns:
            return torch.cat([qdot, torch.linalg.solve(M, f)], dim=-1)
        rows, Gdot_qdot, Cdot_qdot = constraint_rates(topo, params, constraint_fns, q, qdot, aux,
                                                      parts)
        b1, b2 = params["baumgarte"][0], params["baumgarte"][1]
        G = rows["Geq"]
        me, mi = G.shape[1], rows["Cin"].shape[1]
        rhsG = (-(Gdot_qdot + rows["geqddot"]) - 2 * b1 * (_mv(G, qdot) + rows["geqdot"])
                - b2 * b2 * rows["geq"])
        if mi == 0:
            qdd, _ = qp.kkt_solve(M, G, f, rhsG)
        else:
            act = rows["act"]
            Cin = rows["Cin"] * act.to(q.dtype)[..., None]
            rhsC = torch.where(act, -Cdot_qdot - 2 * b1 * _mv(Cin, qdot) - b2 * b2 * rows["cin"],
                               torch.zeros_like(rows["cin"]))
            A = torch.cat([G, Cin], dim=1)
            b = torch.cat([rhsG, rhsC], dim=1)
            B = q.shape[0]
            inf = float("inf")
            lo = torch.cat([q.new_full((B, me), -inf), q.new_zeros(B, mi)], dim=1)
            hi = torch.cat([q.new_full((B, me), inf),
                            torch.where(act, inf, 0.0).to(q.dtype)], dim=1)
            qdd, _ = qp.qp_pgs_batched(M, f, A, b, lo, hi, 200)
        return torch.cat([qdot, qdd], dim=-1)

    return deriv


def make_deriv_recursive(topo: Topology, force_fns: Tuple = (), constraint_fns: Tuple = ()):
    """deriv(params, t, y [B, 2 nr], aux) -> ydot by the O(n) recursive
    hybrid dynamics (recursFcn, testRedMax.m:211-357). Equality rows: lambda
    from the Schur complement G M^{-1} G^T, its columns by the O(n) M^{-1}
    product over G's rows, then one more M^{-1} apply."""

    def deriv(params: Dict, t, y, aux=None):
        nr = topo.nr
        q, qdot = y[:, :nr], y[:, nr:]
        qdd_free, _ = recursive.rhd_qddot(topo, params, q, qdot, force_fns, aux)
        if not constraint_fns:
            return torch.cat([qdot, qdd_free], dim=-1)
        kin = model.forward_kinematics(topo, params, q, qdot, aux)
        J, Jdot, phi = model.jacobians(topo, params, kin, qdot)
        rows, Gdot_qdot, _ = constraint_rates(topo, params, constraint_fns, q, qdot, aux,
                                              {"kin": kin, "J": J, "Jdot": Jdot, "phi": phi})
        b1, b2 = params["baumgarte"][0], params["baumgarte"][1]
        G = rows["Geq"]
        rhsG = -Gdot_qdot - 2 * b1 * (_mv(G, qdot) + rows["geqdot"]) - b2 * b2 * rows["geq"]
        MinvGT = recursive.make_minv_product(topo, params, kin)(G)    # [B, me, nr]
        D = G @ MinvGT.transpose(-1, -2)                               # G M^{-1} G^T
        lam = torch.linalg.solve(D, rhsG - _mv(G, qdd_free))
        qdd = qdd_free + _mv(MinvGT.transpose(-1, -2), lam)
        return torch.cat([qdot, qdd], dim=-1)

    return deriv


def make_ode45(deriv: Callable, rtol: float = 1e-4, atol: float = 1e-6,
               max_steps: int = 1000000):
    """Adaptive Dormand-Prince integrator, batch-first:
    integrate(params, y0 [B, n], t0, t1, aux) -> y1 [B, n].

    MATLAB ode45's controller, per lane (same right-hand side => same step
    sequence in float64, so the reference's ode45 energy certificates,
    which record that solver's drift at RelTol 1e-4, transfer):
      threshold = atol/rtol, hmax = 0.1 (t1 - t0)
      init:  absh = min(hmax, tspan); rh = ||f0 / max(|y0|, thr)||_inf
             / (0.8 rtol^(1/5)); absh = 1/rh if absh rh > 1
      per step: hmin = 16 eps |t|; stretch h to t1 when 1.1 absh >= t1 - t
      err = h ||(sum_j E_j k_j) / max(max(|y|, |y5|), thr)||_inf vs rtol
      reject: first failure absh *= max(0.1, 0.8 (rtol/err)^(1/5)),
              later failures absh *= 0.5
      accept (no failure this step): absh /= max(1.25 (err/rtol)^(1/5), 0.2)
    Every lane steps with its own t, absh and failure flag; deriv gets the
    lanes' stage times t + C_i h [B]. A lane that reached t1 (or max_steps)
    keeps its state while the others go on. The run's counts are left in
    ode45_stats.
    """
    A = [[float(a) for a in row] for row in _A]
    B5 = [float(b) for b in _B5]
    C = [float(c) for c in _C]
    E = [float(e) for e in _E]
    pow_ = 0.2
    threshold = atol / rtol

    def integrate(params: Dict, y0, t0, t1, aux=None):
        dtype, device = y0.dtype, y0.device
        B = y0.shape[0]
        t = torch.as_tensor(t0, dtype=dtype, device=device).expand(B).clone()
        t1 = torch.as_tensor(t1, dtype=dtype, device=device).expand(B)
        eps = torch.finfo(dtype).eps
        y = y0
        f1 = deriv(params, t, y, aux)
        htspan = t1 - t
        hmax = 0.1 * htspan
        absh = torch.minimum(hmax, htspan)
        rh = (f1.abs() / y.abs().clamp(min=threshold)).amax(-1) / (0.8 * rtol ** pow_)
        absh = torch.where(absh * rh > 1.0, 1.0 / rh, absh)
        nofailed = torch.ones(B, dtype=torch.bool, device=device)
        done = htspan <= 0
        steps = torch.zeros(B, dtype=torch.long, device=device)
        accepted = torch.zeros(B, dtype=torch.long, device=device)
        iters = 0
        while True:
            active = ~done & (steps < max_steps)
            if iters % EXIT_TEST_EVERY == 0 and not bool(active.any()):
                break
            iters += 1
            hmin = 16.0 * eps * t.abs()
            absh_c = torch.minimum(hmax, torch.maximum(hmin, absh))
            stretch = 1.1 * absh_c >= (t1 - t)
            h = torch.where(stretch, t1 - t, absh_c)
            hc = h[:, None]

            k = [f1]
            for i in range(1, 6):
                yi = y + hc * sum(A[i][j] * k[j] for j in range(i))
                k.append(deriv(params, t + C[i] * h, yi, aux))
            y5 = y + hc * sum(B5[j] * k[j] for j in range(6))
            k.append(deriv(params, t + h, y5, aux))            # FSAL stage
            # The error from the stage combination, as MATLAB forms it, not
            # from y5 - y4 (whose subtraction cancels ~7 digits and perturbs
            # the ulp-sensitive accept/reject sequence).
            errvec = hc * sum(E[j] * k[j] for j in range(7))
            sc = torch.maximum(y.abs(), y5.abs()).clamp(min=threshold)
            err = (errvec.abs() / sc).amax(-1)
            accept = err <= rtol

            shrink1 = torch.clamp(0.8 * (rtol / err) ** pow_, min=0.1)
            absh_rej = torch.maximum(hmin, torch.where(nofailed, absh_c * shrink1, 0.5 * absh_c))
            temp = 1.25 * (err / rtol) ** pow_
            absh_acc = torch.where(nofailed, torch.where(temp > 0.2, absh_c / temp, absh_c / 0.2),
                                   absh_c)
            absh_new = torch.where(accept, absh_acc, absh_rej)
            up = active & accept
            t = torch.where(up, t + h, t)
            y = torch.where(up[:, None], y5, y)
            f1 = torch.where(up[:, None], k[6], f1)
            absh = torch.where(active, absh_new, absh)
            nofailed = torch.where(active, accept, nofailed)
            done = done | (up & stretch)
            steps = steps + active.long()
            accepted = accepted + up.long()
        ode45_stats.update(iterations=iters, steps=steps, accepted=accepted)
        return y

    return integrate


def simulate_ode45(sc, method: str = "dense", rtol=1e-4, atol=1e-6, state0: State = None,
                   scene_fn: Callable = None):
    """Integrate a CompiledScene over [0, tEnd] from a batched state0 ([B,
    nr]; default: the scene's state0 as one lane) and return the final
    batched State. method: "dense" or "recursive"; scene_fn(params, t):
    the scene's time dependence, t per lane [B]."""
    if method == "dense":
        deriv = make_deriv_dense(sc.topo, sc.force_fns, sc.constraint_fns)
    elif method == "recursive":
        deriv = make_deriv_recursive(sc.topo, sc.force_fns, sc.constraint_fns)
    else:
        raise ValueError(method)
    if scene_fn is not None:
        base = deriv
        deriv = lambda params, t, y, aux=None: base(scene_fn(params, t), t, y, aux)
    if state0 is None:
        state0 = State(q=sc.state0.q[None], qdot=sc.state0.qdot[None], aux=_lanes(sc.state0.aux, 1))
    y1 = make_ode45(deriv, rtol, atol)(sc.params, torch.cat([state0.q, state0.qdot], dim=-1),
                                       0.0, sc.tEnd, state0.aux)
    nr = sc.topo.nr
    return State(q=y1[:, :nr], qdot=y1[:, nr:], aux=state0.aux)
