"""Matrix-free PCG with the projected-block-Jacobi (RHD) preconditioner,
batch-first (the JAX package's pcg.py; the reference's C++ performance
layer, c++/PCG/src/Solver.cpp + ConstraintJoint.cpp):

  * O(n) operator products without forming J (ConstraintJoint::computeJ_x /
    computeJT_x): J x by a root-to-leaf sweep of world twists, J^T y by a
    leaf-to-root sum of wrenches over each subtree;
  * LHS(x) = J^T (Mm - h Dm - h^2 Km)(J x) - h Dr x - h^2 Kr x, the linearly
    implicit Euler system applied matrix-free (Solver::solvePCG,
    Solver.cpp:567-875): Mm and the body damping act on J x body by body,
    the force closures' blocks through their reduced J^T Km J, J^T Dm J;
  * the preconditioner z = Mhat^{-1} r by the RHD three-pass solve
    (Solver::pcdSaad2003; recursive.make_minv_product);
  * the CG loop ([Saad 2003] Alg 9.1) per lane, with its iteration count
    per lane.

For the small reduced sizes of the MPC regime the dense solve is the
faster one; this is the tier for scenes whose nr runs into the hundreds.
"""

from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch
from torch.distributed.device_mesh import DeviceMesh

from redmax_tpu_torch import se3
from redmax_tpu_torch.constraints import assemble_constraints
from redmax_tpu_torch.integrators import euler_system
from redmax_tpu_torch.model import Kinematics, reparam_all
from redmax_tpu_torch.parallel import gather_blocks
from redmax_tpu_torch.recursive import (
    _against, _join, _level_tensors, _mtv, _mv, _pad_q, _rows, _unpad_q, make_minv_product,
)
from redmax_tpu_torch.types import State, Topology, lanewise

# How many CG iterations run between two reads of "is any lane still going"
# (each read waits for the card); lanes that are done stay frozen.
EXIT_TEST_EVERY = 4

# The last pcg call: its per-lane iteration counts [...]. Read by
# chip_smoke.py.
pcg_stats: Dict = {"iters": None}


def make_J_products(topo: Topology, params: Dict, kin: Kinematics):
    """(J_x, JT_y): the Jacobian products by tree sweeps, on x [B, nr] or
    [B, k, nr] and y [B, 6N] or [B, k, 6N].

    J x:   t_w[j] = t_w[parent] + W_j x_j (root to leaf), phi_i = Ad_iw t_w[i];
    J^T y: u_w[i] = Ad_iw^T y_i; s_w[j] = the sum over j's subtree (leaf to
           root); z_j = W_j^T s_w[j],
    with W_j = Ad(E_w,body_j) Sb_j the world-frame subspace columns.
    """
    N = topo.njoints
    lv = _level_tensors(topo, kin.S.device, kin.S.dtype)
    nl = len(lv.members)
    Sb = se3.Ad(se3.inv(params["E0_ji"])) @ kin.S                # [B, N, 6, dmax]
    Ad_bw = se3.Ad(se3.inv(kin.E_wi))
    W = se3.Ad(kin.E_wi) @ Sb

    def J_x(x):
        u = _against(x)
        own = _mv(u(W), _pad_q(topo, x))
        tws = []
        for k in range(nl):
            t = _rows(own, lv.members[k], True)
            if k:
                t = t + _rows(tws[k - 1], lv.ppos[k], True)
            tws.append(t)
        phi = _mv(u(Ad_bw), _join(tws, lv, True))
        return phi.flatten(-2)

    def JT_y(y):
        u = _against(y)
        uw = _mtv(u(Ad_bw), y.unflatten(-1, (N, 6)))
        ss = [None] * nl
        for k in reversed(range(nl)):
            s = _rows(uw, lv.members[k], True)
            if k + 1 < nl:
                s = s.index_add(s.dim() - 2, lv.ppos[k + 1], ss[k + 1])
            ss[k] = s
        return _unpad_q(topo, _mtv(u(W), _join(ss, lv, True)))

    return J_x, JT_y


class PcgResult(NamedTuple):
    x: torch.Tensor        # [..., n] the solution of each lane
    iters: torch.Tensor    # [...] CG iterations of each lane
    resnorm: torch.Tensor  # [...] ||r|| at the end of each lane


def _dot(a, b):
    return (a * b).sum(-1)


def pcg(lhs: Callable, b, precond: Optional[Callable] = None, tol: float = 1e-6,
        maxit: int = 1000) -> PcgResult:
    """Preconditioned CG ([Saad 2003] Alg 9.1; Solver::pcdSaad2003) on every
    lane of b [..., n] at once: lhs and precond map [..., n] -> [..., n]
    lane by lane. The reference's loop: an absolute tolerance on ||r||
    (Solver.h:43, cg_tol = 1e-6) and a zero-curvature guard. A lane stops
    updating once its residual is under tol or its guard tripped; the loop
    ends when every lane has stopped or maxit is reached, which a lane-wise
    run of the JAX package's while_loop does too."""
    z = precond(b) if precond else b
    x, r, p = torch.zeros_like(b), b, z
    rz = _dot(b, z)
    it = torch.zeros(b.shape[:-1], dtype=torch.long, device=b.device)
    done = torch.linalg.vector_norm(b, dim=-1) < tol
    n = 0
    while True:
        active = ~done & (it < maxit)
        if n % EXIT_TEST_EVERY == 0 and not bool(active.any()):
            break
        n += 1
        Ap = lhs(p)
        pAp = _dot(p, Ap)
        ok = pAp.abs() > 1e-300                                  # zero-curvature guard
        alpha = torch.where(ok, rz / pAp, torch.zeros_like(pAp))[..., None]
        x1 = x + alpha * p
        r1 = r - alpha * Ap
        z1 = precond(r1) if precond else r1
        rz1 = _dot(r1, z1)
        p1 = z1 + (rz1 / rz)[..., None] * p
        conv = torch.linalg.vector_norm(r1, dim=-1) < tol
        a = active[..., None]
        x, r, p = torch.where(a, x1, x), torch.where(a, r1, r), torch.where(a, p1, p)
        rz = torch.where(active, rz1, rz)
        it = it + active.long()
        done = done | (active & (conv | ~ok))
    pcg_stats["iters"] = it
    return PcgResult(x=x, iters=it, resnorm=torch.linalg.vector_norm(r, dim=-1))


def _euler_matfree(topo: Topology, force_fns: Tuple, params: Dict, q, qdot, aux):
    """The PCG tiers' shared setup: the system's pieces from
    integrators.euler_system (the dense step's semantics: the closures' Km,
    Dm, one-sidedly implicit damping, body damping), returned as (lhs
    matvec on [B, nr] or [B, k, nr], frtilde [B, nr], the M^{-1}
    preconditioner, the system dict). The matvec applies Mm and the body
    damping per body against J x by the tree sweeps, and never forms Mr."""
    h = params["h"]
    sys = euler_system(topo, force_fns, params, q, qdot, aux)
    J_x, JT_y = make_J_products(topo, params, sys["kin"])
    Ivec = params["I_i"].flatten(-2)                              # [(B,) 6N]
    bd6 = params["body_damping"].repeat_interleave(6, dim=-1)
    Kr, Dr, KD = sys["Kr"], sys["Dr"], sys["KDmJ"]

    def lhs(x):
        u = _against(x)
        lane = (lambda v: u(v) if v.dim() == 2 else v)           # a per-lane [B, 6N] vector
        hx = lanewise(h, x.dim())
        Jx = J_x(x)
        w = lane(Ivec) * Jx + lanewise(h, Jx.dim()) * lane(bd6) * Jx
        out = JT_y(w) - hx * u(Dr) * x - hx * hx * u(Kr) * x
        if KD is not None:
            out = out - _mv(u(KD), x)
        return out

    return lhs, sys["frtilde"], make_minv_product(topo, params, sys["kin"]), sys


def _check_mesh(mesh):
    if mesh is not None and not isinstance(mesh, DeviceMesh):
        raise TypeError(f"mesh= takes a torch DeviceMesh (parallel.make_mesh), got {type(mesh)}")


def _pcg_rows_sharded(mesh, lhs, b, precond, tol, maxit) -> PcgResult:
    """pcg over the rows b [B, k, n] split over the mesh's "model" ranks:
    the rows padded with zero rows to a multiple of the model size (a zero
    right-hand side is converged at the start), this rank's share solved,
    the shares gathered in rank order and the pad dropped. Each row's CG is
    its own program, so the result is the unsharded pcg's."""
    m = mesh.size(mesh.mesh_dim_names.index("model"))
    rows = b.shape[1]
    per = -(-rows // m)
    bp = torch.cat([b, b.new_zeros(b.shape[0], per * m - rows, b.shape[2])], dim=1)
    r = mesh.get_local_rank("model")
    res = pcg(lhs, bp[:, r * per:(r + 1) * per], precond, tol, maxit)
    res = PcgResult(*(x[:, :rows] for x in gather_blocks(res, 1, mesh.get_group("model"))))
    pcg_stats["iters"] = res.iters
    return res


def make_euler_pcg_solver(topo: Topology, force_fns: Tuple = (), tol: float = 1e-6,
                          maxit: int = 1000):
    """The matrix-free linearly implicit Euler velocity solve
    Mrtilde qdot1 = frtilde (Solver::solvePCG) by PCG with the RHD
    preconditioner: solve(params, q, qdot, aux) -> (qdot1 [B, nr],
    PcgResult)."""

    def solve(params: Dict, q, qdot, aux=None):
        lhs, frt, minv, _ = _euler_matfree(topo, force_fns, params, q, qdot, aux)
        res = pcg(lhs, frt, minv, tol, maxit)
        return res.x, res

    return solve


def make_euler_pcg_constrained_solver(
    topo: Topology,
    force_fns: Tuple = (),
    constraint_fns: Tuple = (),
    tol: float = 1e-6,
    maxit: int = 1000,
    mesh=None,
):
    """Equality (loop-closure) rows on the matrix-free Euler solve by the
    Schur complement (Solver::solvePCG's constrained paths,
    Solver.cpp:654-746):

        S = G Mrtilde^{-1} G^T,   S lam = G qdot1_unc - rhsG,
        qdot1 = qdot1_unc - (Mrtilde^{-1} G^T) lam

    with rhsG = -gdot - baum3 g (the dense KKT step's system). The
    reference runs one PCG per constraint row under OpenMP plus one for the
    unconstrained solve; here the me + 1 right-hand sides of every lane are
    lanes of one batched CG ([B, me + 1, nr]), sharing each lane's operator
    and preconditioner. mesh (a parallel.make_mesh DeviceMesh) splits those
    rows over its "model" ranks (the device-parallel form of the
    reference's OpenMP row loop); the result is the unsharded solve's, bit
    for bit.

    Returns solve(params, q, qdot, aux) -> (qdot1 [B, nr], lam [B, me],
    PcgResult over [B, me + 1]).
    """
    _check_mesh(mesh)

    def solve(params: Dict, q, qdot, aux=None):
        lhs, frt, minv, sys = _euler_matfree(topo, force_fns, params, q, qdot, aux)
        rows = assemble_constraints(constraint_fns, params, topo, sys["kin"], sys["phi"], q, qdot,
                                    sys["J"])
        Geq = rows["Geq"]                                          # [B, me, nr]
        rhsG = -rows["geqdot"] - params["baumgarte"][2] * rows["geq"]
        rhs = torch.cat([frt[:, None], Geq], dim=1)
        res = (pcg(lhs, rhs, minv, tol, maxit) if mesh is None
               else _pcg_rows_sharded(mesh, lhs, rhs, minv, tol, maxit))
        qdot1_unc = res.x[:, 0]
        MiGt = res.x[:, 1:].transpose(-1, -2)                      # [B, nr, me]
        lam = torch.linalg.solve(Geq @ MiGt, _mv(Geq, qdot1_unc) - rhsG)
        return qdot1_unc - _mv(MiGt, lam), lam, res

    return solve


def make_euler_pcg_step(
    topo: Topology,
    force_fns: Tuple = (),
    constraint_fns: Tuple = (),
    tol: float = 1e-6,
    maxit: int = 1000,
    mesh=None,
):
    """A linearly implicit Euler step through the PCG tier (the C++ layer's
    step loop, RigidBodyMain.cpp:412-431): the velocity solve (with the
    Schur complement where the scene has equality rows), the position
    update and the reparameterization. (params, State [B, nr]) -> State, the
    contract of integrators.make_euler_step. mesh: as in
    make_euler_pcg_constrained_solver."""
    _check_mesh(mesh)
    eq_only = tuple(c for c in constraint_fns if (c.n_eq_m or c.n_eq_r))
    if len(eq_only) != len(constraint_fns):
        raise NotImplementedError(
            "the PCG tier takes equality (loop-closure) constraints only; inequality rows "
            "need the dense QP path (integrators.make_euler_step)")
    if eq_only:
        vel_solve = make_euler_pcg_constrained_solver(topo, force_fns, eq_only, tol, maxit,
                                                      mesh=mesh)
    else:
        vel_solve = make_euler_pcg_solver(topo, force_fns, tol, maxit)

    def step(params: Dict, state: State) -> State:
        q0 = state.q
        qdot1 = vel_solve(params, q0, state.qdot, state.aux)[0]
        q1 = q0 + lanewise(params["h"], 2) * qdot1
        q1, qdot1, aux, _, _ = reparam_all(topo, params, q1, qdot1, state.aux)
        return State(q=q1, qdot=qdot1, aux=aux)

    return step
