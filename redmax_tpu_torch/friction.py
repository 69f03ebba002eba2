"""Bilateral staggered-projections friction, batch-first over [B] lanes: the
port of the JAX package's friction.py (the reference's eulerFric path,
matlab/testRedMax.m:544-759).

Each step alternates (a) contact passes, maximal against reduced solves
whose velocity difference gives the joint-reaction force
fam = Mmtilde (v_con - v_unc) / h, and (b) friction passes, a box QP over
the tangent-matrix rows with |b| <= mu a, where the contact multipliers a
come from small regularized solves a joint ring at a time
(Joint.computeContactMultiplier). It covers internal (joint) friction on
revolute, prismatic and spherical contact rings and on loop-closure rings,
and external friction on floor contacts, with their own mu
(params["mu"] = [internal, external]).

The rings are static numpy data built at compile (build_friction_model, a
copy of the JAX package's builders); the per-step functions take batched
kinematics. Every projected Gauss-Seidel solve of the step (the contact
passes' dual QPs and the friction pass's box sweeps, 3000 sweeps each) runs
on the K3 kernel, pgs_kernel.pgs_sweeps, on the card and on the CPU. The
step has no gradient (the JAX step's while_loop has none).
"""

import math
from functools import lru_cache
from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch

from redmax_tpu_torch import pgs_kernel, se3
from redmax_tpu_torch.constraints import ConstraintFloor, ConstraintLoop
from redmax_tpu_torch.integrators import closure_blocks
from redmax_tpu_torch.model import (_split_closures, closure_forces, forward_kinematics,
                                    jacobians, joint_space_force, joint_space_KD_diag,
                                    mass_diag, maximal_force, reparam_all)
from redmax_tpu_torch.types import JointType, State, Topology, lanewise

NTHETA = 4
# The diagonal guards of the two kinds of sweep solve: qp_pgs's default
# (the contact passes' QPs) and the friction pass's (friction.py:631).
QP_REG = 1e-10
FRICTION_REG = 1e-12


# ---------------------------------------------------------------------------
# Static contact rings (numpy, built once at compile)
# ---------------------------------------------------------------------------


def _aa_to_mat_np(axis, angle):
    axis = np.asarray(axis, dtype=np.float64)
    n = np.linalg.norm(axis)
    if n < 1e-12:
        return np.eye(3)
    u = axis / n
    K = np.array([[0, -u[2], u[1]], [u[2], 0, -u[0]], [-u[1], u[0], 0]])
    return np.eye(3) + math.sin(angle) * K + (1 - math.cos(angle)) * (K @ K)


def revolute_ring(axis, E_ij, radius=1.0, height=1.0):
    """Static contact ring of one revolute joint in the child-body frame
    (JointRevolute.generateContacts_, JointRevolute.m:35-80):
    (pos_i [C,3], nor_i [C,3], tan_i [C,3]) with C = 16."""
    axis = np.asarray(axis, dtype=np.float64)
    z = np.array([0.0, 0.0, 1.0])
    angle = math.acos(max(-1.0, min(float(axis @ z), 1.0)))
    E_ja = np.eye(4)
    E_ja[:3, :3] = _aa_to_mat_np(np.cross(axis, z), angle)
    E_ia = np.asarray(E_ij, dtype=np.float64) @ E_ja

    pos, nor, tan = [], [], []
    for k in range(NTHETA):
        theta = 2 * math.pi * k / NTHETA
        s, c = math.sin(theta), math.cos(theta)
        n3 = np.array([c, s, 0.0])
        t3 = np.array([-s, c, 0.0])
        p3 = radius * n3.copy()
        for i in range(2):
            zz = height * (i - 0.5)
            p = p3.copy()
            p[2] = zz
            b3 = np.cross(t3, n3)
            R_ac = np.stack([t3, n3, b3], axis=1)
            E_ac = np.eye(4)
            E_ac[:3, :3] = R_ac
            E_ac[:3, 3] = p
            E_ic = E_ia @ E_ac
            t = E_ic[:3, 0]
            n = E_ic[:3, 1]
            b = E_ic[:3, 2]
            x = E_ic[:3, 3]
            pos.append(x); nor.append(-n); tan.append(t)
            bb = -b if i == 0 else b
            pos.append(x); nor.append(bb); tan.append(t)
    return np.stack(pos), np.stack(nor), np.stack(tan)


class Ring(NamedTuple):
    """Static contact-ring data of one joint.

    pos/nor: [C,3] contact points/normals (child-body frame).
    tan: [R,3] tangent of each T-row; row_pos [R,3] the row's contact point.
    limit_map: ((row, (contact ids summed for the bound)), ...); rows not
    listed get zero-width boxes (the reference's idx exclusion).
    """

    joint: int
    pos: np.ndarray
    nor: np.ndarray
    tan: np.ndarray
    row_pos: np.ndarray
    limit_map: Tuple


def revolute_ring_obj(j, axis, E_ij, radius=1.0, height=1.0) -> Ring:
    pos, nor, tan = revolute_ring(axis, E_ij, radius, height)
    lm = tuple((2 * k, (2 * k, 2 * k + 1)) for k in range(len(pos) // 2))
    return Ring(j, pos, nor, tan, pos.copy(), lm)


def prismatic_ring_obj(j, axis, E_ij, sides=(0.5, 0.5, 0.5)) -> Ring:
    """JointPrismatic.generateContacts_ (JointPrismatic.m:35-95): 16 contacts
    on a scaled unit box aligned with the slide axis; every row has the
    axis tangent; pairs share positions. Its joint is -1 until the caller
    sets it (build_friction_model)."""
    axis = np.asarray(axis, dtype=np.float64)
    z = np.array([0.0, 0.0, 1.0])
    angle = math.acos(max(-1.0, min(float(axis @ z), 1.0)))
    E_ja = np.eye(4)
    E_ja[:3, :3] = _aa_to_mat_np(np.cross(axis, z), angle)
    S = np.diag(list(sides) + [1.0])
    E_ia = np.asarray(E_ij) @ S @ E_ja
    tan_i = E_ia[:3, :3] @ z
    tan_i = tan_i / np.linalg.norm(tan_i)
    pos, nor, tan = [], [], []
    corners = {
        (0, 0): ([-0.5, -0.5], [1, 0, 0], [0, 1, 0]),
        (0, 1): ([-0.5, 0.5], [1, 0, 0], [0, -1, 0]),
        (1, 0): ([0.5, -0.5], [-1, 0, 0], [0, 1, 0]),
        (1, 1): ([0.5, 0.5], [-1, 0, 0], [0, -1, 0]),
    }
    for kz in (0, 1):
        zz = kz - 0.5
        for (kx, ky), (xy, n1, n2) in corners.items():
            pa = np.array([xy[0], xy[1], zz])
            pi = E_ia[:3, :3] @ pa + E_ia[:3, 3]
            for na in (n1, n2):
                ni = E_ia[:3, :3] @ np.asarray(na, dtype=np.float64)
                ni = ni / np.linalg.norm(ni)
                pos.append(pi)
                nor.append(ni)
                tan.append(tan_i)
    pos = np.stack(pos)
    lm = tuple((2 * k, (2 * k, 2 * k + 1)) for k in range(len(pos) // 2))
    return Ring(-1, pos, np.stack(nor), np.stack(tan), pos.copy(), lm)._replace()


def spherical_ring_obj(j, E_ij, radius=1.0) -> Ring:
    """JointSphericalExp.generateContacts_ (:93-118): 6 contacts on the
    sphere (3 axes x +-), two tangent rows a contact."""
    E_ij = np.asarray(E_ij)
    pos, nor, tan, row_pos = [], [], [], []
    for k in range(3):
        R_jc = np.eye(3)
        if k == 1:
            R_jc = R_jc[:, [1, 2, 0]]
        elif k == 2:
            R_jc = R_jc[:, [2, 0, 1]]
        for sgn in (-1.0, 1.0):
            R = sgn * R_jc
            x = -radius * R[:, 0]
            E_jc = np.eye(4)
            E_jc[:3, :3] = R
            E_jc[:3, 3] = x
            E_ic = E_ij @ E_jc
            p = E_ic[:3, 3]
            pos.append(p)
            nor.append(E_ic[:3, 0])
            tan.append(E_ic[:3, 1]); row_pos.append(p)
            tan.append(E_ic[:3, 2]); row_pos.append(p)
    lm = tuple(x for i in range(6) for x in ((2 * i, (i,)), (2 * i + 1, (i,))))
    return Ring(j, np.stack(pos), np.stack(nor), np.stack(tan), np.stack(row_pos), lm)


class LoopRing(NamedTuple):
    """Contact ring of a loop-closure constraint (revolute geometry between
    two non-tree bodies; ConstraintLoop.generateContactsJoint_,
    ConstraintLoop.m:79-118)."""

    bodyA: int
    bodyB: int
    pos: np.ndarray        # [C,3] in bodyA frame
    nor: np.ndarray
    tan: np.ndarray        # [C,3] row tangents (one a contact)
    limit_map: Tuple
    eq_offset: int         # first row of this constraint in the stacked Gm
    n_rows: int


def loop_ring_obj(bodyA, bodyB, xA, axisA, eq_offset, radius=1.0, height=1.0) -> LoopRing:
    axis = np.asarray(axisA, dtype=np.float64)
    z = np.array([0.0, 0.0, 1.0])
    angle = math.acos(max(-1.0, min(float(axis @ z), 1.0)))
    E_ac = np.eye(4)
    E_ac[:3, :3] = _aa_to_mat_np(np.cross(axis, z), angle)
    E_ac[:3, 3] = np.asarray(xA, dtype=np.float64)
    pos, nor, tan = [], [], []
    for k in range(NTHETA):
        theta = 2 * math.pi * k / NTHETA
        s_, c_ = math.sin(theta), math.cos(theta)
        nor_c = np.array([c_, s_, 0.0])
        tan_c = np.array([-s_, c_, 0.0])
        for i in range(2):
            p_c = radius * nor_c.copy()
            p_c[2] = height * (i - 0.5)
            bin_c = np.cross(tan_c, nor_c)
            pa = E_ac[:3, :3] @ p_c + E_ac[:3, 3]
            pos.append(pa); nor.append(-(E_ac[:3, :3] @ nor_c))
            tan.append(E_ac[:3, :3] @ tan_c)
            bb = -bin_c if i == 0 else bin_c
            pos.append(pa); nor.append(E_ac[:3, :3] @ bb)
            tan.append(E_ac[:3, :3] @ tan_c)
    pos = np.stack(pos)
    lm = tuple((2 * k, (2 * k, 2 * k + 1)) for k in range(len(pos) // 2))
    return LoopRing(bodyA, bodyB, pos, np.stack(nor), np.stack(tan), lm, eq_offset, 2)


class FrictionModel(NamedTuple):
    """Static friction data: joint rings + loop rings + floor constraints."""

    rings: Tuple  # of Ring
    loop_rings: Tuple  # of LoopRing
    floor_cons: Tuple
    eq_cons: Tuple  # the constraints with maximal equality rows, in stacking order


def _np(a):
    """A constraint param (numpy array or tensor) as a float64 numpy array."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
    return np.asarray(a, dtype=np.float64)


def build_friction_model(topo: Topology, joint_specs, body_specs, constraint_fns,
                         constraint_params: Dict) -> FrictionModel:
    """Contact rings of the revolute, prismatic and spherical joints, and of
    the loop closures, and the floor constraints with external friction. A
    loop ring's geometry comes from its constraint: xA and axisA from
    constraint_params[key] (the builder's arrays or params["constraints"]),
    radius and height from its attributes."""
    rings = []
    for j, spec in enumerate(joint_specs):
        E_ij = np.linalg.inv(np.asarray(body_specs[j].E_ji))
        if spec.jtype == JointType.REVOLUTE:
            rings.append(revolute_ring_obj(j, spec.params["axis"], E_ij,
                                           getattr(spec, "contact_radius", 1.0),
                                           getattr(spec, "contact_height", 1.0)))
        elif spec.jtype == JointType.PRISMATIC:
            r = prismatic_ring_obj(j, spec.params["axis"], E_ij,
                                   getattr(spec, "contact_sides", (0.5, 0.5, 0.5)))
            rings.append(r._replace(joint=j))
        elif spec.jtype == JointType.SPHERICAL:
            rings.append(spherical_ring_obj(j, E_ij))
    floor = tuple(c for c in constraint_fns if isinstance(c, ConstraintFloor))
    eq_cons = tuple(c for c in constraint_fns if c.n_eq_m)
    loop_rings = []
    off = 0
    for c in eq_cons:
        if isinstance(c, ConstraintLoop):
            cp = constraint_params[c.key]
            loop_rings.append(loop_ring_obj(c.bodyA, c.bodyB, _np(cp["xA"]), _np(cp["axisA"]),
                                            off, c.radius, c.height))
        off += c.n_eq_m
    return FrictionModel(rings=tuple(rings), loop_rings=tuple(loop_rings), floor_cons=floor,
                         eq_cons=eq_cons)


def row_counts(fm: FrictionModel) -> Dict[str, int]:
    """The model's row counts: rings, loop rings, floors, maximal equality
    rows and friction rows (the friction pass's m)."""
    nt = (sum(r.tan.shape[0] for r in fm.rings) + sum(r.tan.shape[0] for r in fm.loop_rings)
          + 2 * len(fm.floor_cons))
    return {"rings": len(fm.rings), "loop_rings": len(fm.loop_rings),
            "floors": len(fm.floor_cons), "eq_rows": sum(c.n_eq_m for c in fm.eq_cons),
            "friction_rows": nt}


# ---------------------------------------------------------------------------
# Per-step functions over [B] lanes
# ---------------------------------------------------------------------------

# Device copies of the rings' numpy arrays, by (id, dtype, device); each
# entry keeps its array alive, so an id is never reused while it is cached.
_CONSTS: Dict = {}


def _const(a, like):
    """The numpy array a as a tensor of like's dtype and device, copied to
    the device once."""
    key = (id(a), like.dtype, like.device)
    hit = _CONSTS.get(key)
    if hit is None or hit[0] is not a:
        hit = (a, torch.as_tensor(np.asarray(a), dtype=like.dtype, device=like.device))
        _CONSTS[key] = hit
    return hit[1]


@lru_cache(maxsize=None)
def _limit_matrix(limit_map: Tuple, R: int, C: int) -> np.ndarray:
    """[R, C] 0/1: row r's bound sums |a_c| over the contacts of its entry."""
    L = np.zeros((R, C))
    for row, cids in limit_map:
        L[row, list(cids)] = 1.0
    return L


def _mv(M, v):
    """M [..., m, n] times v [..., n], row by row as a product and a sum over
    n: the same for a lane whatever the batch (a batched matrix-vector
    product takes another summation order at B = 1 on the CPU)."""
    return (M * v[..., None, :]).sum(-1)


def _gamma_rows(vec, pos):
    """Rows v^T Gamma(p): [..., C, 3], [..., C, 3] -> [..., C, 6]."""
    return torch.einsum("...ci,...cij->...cj", vec, se3.Gamma(pos))


def _rel(kin, a: int, b: int):
    """E_ab = E_wa^-1 E_wb [B, 4, 4]."""
    return se3.inv(kin.E_wi[:, a]) @ kin.E_wi[:, b]


def _moved(vec, pos, E):
    """Directions vec [C, 3] and points pos [C, 3] carried by E [B, 4, 4]:
    ([B, C, 3], [B, C, 3])."""
    Rt = E[:, :3, :3].transpose(-1, -2)
    return vec @ Rt, pos @ Rt + E[:, None, :3, 3]


def tangent_matrix(fm: FrictionModel, topo: Topology, kin, params, q, qdot):
    """T [B, nt, 6N]: the rows of each joint ring, then of each loop ring,
    then 2 rows a floor contact."""
    B, N = q.shape[0], topo.njoints
    blocks = []
    for ring in fm.rings:
        j, p = ring.joint, topo.parent[ring.joint]
        tan, rpos = _const(ring.tan, q), _const(ring.row_pos, q)
        Tj = q.new_zeros(B, tan.shape[0], 6 * N)
        Tj[:, :, 6 * j: 6 * j + 6] = _gamma_rows(tan, rpos)
        if p >= 0:
            Tj[:, :, 6 * p: 6 * p + 6] = -_gamma_rows(*_moved(tan, rpos, _rel(kin, p, j)))
        blocks.append(Tj)
    for lr in fm.loop_rings:
        tan, pos = _const(lr.tan, q), _const(lr.pos, q)
        Tj = q.new_zeros(B, tan.shape[0], 6 * N)
        Tj[:, :, 6 * lr.bodyA: 6 * lr.bodyA + 6] = _gamma_rows(tan, pos)
        Tj[:, :, 6 * lr.bodyB: 6 * lr.bodyB + 6] = -_gamma_rows(
            *_moved(tan, pos, _rel(kin, lr.bodyB, lr.bodyA)))
        blocks.append(Tj)
    for con in fm.floor_cons:
        cp = con.p(params)
        E_wi = kin.E_wi[:, con.body]
        E_f = cp["E"]
        x_f = _mv(se3.inv(E_f), E_wi[:, :, 3])                  # [B, 4], last = 1
        x_c = torch.cat([x_f[:, :2], (x_f[:, 2] - cp["radius"])[:, None], x_f[:, 3:]], dim=-1)
        x_b = _mv(se3.inv(E_wi), _mv(E_f, x_c))[:, :3]
        tan_a = E_wi[:, :3, :3].transpose(-1, -2) @ E_f[:3, :2]    # [B, 3, 2]
        Tc = q.new_zeros(B, 2, 6 * N)
        Tc[:, :, 6 * con.body: 6 * con.body + 6] = _gamma_rows(
            tan_a.transpose(-1, -2), x_b[:, None].expand(B, 2, 3))
        blocks.append(Tc)
    if not blocks:
        return q.new_zeros(B, 0, 6 * N)
    return torch.cat(blocks, dim=1)


def _parent_adjoints(topo: Topology, kin):
    """Ad(E_ij^-1 E_ip)^T of each joint with a parent, by joint [B, 6, 6]."""
    return {j: se3.Ad(_rel(kin, j, p)).transpose(-1, -2)
            for j, p in enumerate(topo.parent) if p >= 0}


def scatter_contact_force(fm: FrictionModel, topo: Topology, kin, fam, adT=None):
    """fam [B, 6N] -> per-joint reaction wrenches fc [B, N, 6] (backward
    traversal, Joint.scatterContactForce, Joint.m:652-679). adT: the
    _parent_adjoints of kin, where the caller has them."""
    adT = _parent_adjoints(topo, kin) if adT is None else adT
    f = list(fam.reshape(fam.shape[0], topo.njoints, 6).unbind(1))
    for j in reversed(range(topo.njoints)):
        p = topo.parent[j]
        if p >= 0:
            f[p] = f[p] + _mv(adT[j], f[j])
    return torch.stack(f, dim=1)


class _RingSystem(NamedTuple):
    """One ring's multiplier system at a step: N [B, C, 6 or 12] the normal
    rows on the ring's bodies, Minv [(B,) 6 or 12] their inverse masses,
    the LU factors of H = N Minv N^T + reg I (symmetrized)."""

    N: torch.Tensor
    Minv: torch.Tensor
    lu: Tuple


def _ring_system(Nmat, Minv, SPreg):
    C = Nmat.shape[-2]
    H = (Nmat * Minv[..., None, :]) @ Nmat.transpose(-1, -2) + SPreg * torch.eye(
        C, dtype=Nmat.dtype, device=Nmat.device)
    H = 0.5 * (H + H.transpose(-1, -2))
    return _RingSystem(Nmat, Minv, torch.linalg.lu_factor_ex(H)[:2])


def _ring_solve(sys: _RingSystem, fvec, h):
    """a [B, C] = H^-1 (N (Minv fvec)) h."""
    fq = _mv(sys.N, sys.Minv * fvec) * lanewise(h, 2)
    return torch.linalg.lu_solve(*sys.lu, fq[..., None])[..., 0]


def _joint_ring_systems(fm: FrictionModel, topo: Topology, params, kin, SPreg):
    """_RingSystem of each joint ring (Joint.computeContactMultiplier,
    Joint.m:682-720): on the child body, and on the parent where there is
    one."""
    I = params["I_i"]
    B = kin.E_wi.shape[0]
    out = []
    for ring in fm.rings:
        j, p = ring.joint, topo.parent[ring.joint]
        pos, nor = _const(ring.pos, kin.E_wi), _const(ring.nor, kin.E_wi)
        Nc = _gamma_rows(nor, pos).expand(B, -1, -1)
        if p >= 0:
            Nmat = torch.cat([Nc, -_gamma_rows(*_moved(nor, pos, _rel(kin, p, j)))], dim=-1)
            Minv = torch.cat([1.0 / I[..., j, :], 1.0 / I[..., p, :]], dim=-1)
        else:
            Nmat, Minv = Nc, 1.0 / I[..., j, :]
        out.append(_ring_system(Nmat, Minv, SPreg))
    return out


def _joint_ring_solves(fm, topo, systems, fc, h, adT):
    outs = []
    for ring, sys in zip(fm.rings, systems):
        j, p = ring.joint, topo.parent[ring.joint]
        fvec = torch.cat([fc[:, j], -_mv(adT[j], fc[:, j])], dim=-1) if p >= 0 else fc[:, j]
        outs.append(_ring_solve(sys, fvec, h))
    return outs


def contact_multipliers(fm: FrictionModel, topo: Topology, params, kin, fc, h, SPreg):
    """Each joint ring's multipliers a [B, C] from the joint reaction
    wrenches fc [B, N, 6] (Joint.computeContactMultiplier)."""
    systems = _joint_ring_systems(fm, topo, params, kin, SPreg)
    return _joint_ring_solves(fm, topo, systems, fc, h, _parent_adjoints(topo, kin))


def _loop_ring_systems(fm: FrictionModel, params, kin, SPreg):
    I = params["I_i"]
    B = kin.E_wi.shape[0]
    out = []
    for lr in fm.loop_rings:
        pos, nor = _const(lr.pos, kin.E_wi), _const(lr.nor, kin.E_wi)
        NA = _gamma_rows(nor, pos).expand(B, -1, -1)
        NB = -_gamma_rows(*_moved(nor, pos, _rel(kin, lr.bodyB, lr.bodyA)))
        Minv = torch.cat([1.0 / I[..., lr.bodyA, :], 1.0 / I[..., lr.bodyB, :]], dim=-1)
        out.append(_ring_system(torch.cat([NA, NB], dim=-1), Minv, SPreg))
    return out


def _loop_ring_solves(fm, systems, Gm, lam_eq, h):
    outs = []
    for lr, sys in zip(fm.loop_rings, systems):
        rows = Gm[:, lr.eq_offset: lr.eq_offset + lr.n_rows]
        lam = lam_eq[:, lr.eq_offset: lr.eq_offset + lr.n_rows]
        fcon = _mv(rows.transpose(-1, -2), lam) / lanewise(h, 2)          # [B, 6N]
        fvec = torch.cat([fcon[:, 6 * lr.bodyA: 6 * lr.bodyA + 6],
                          fcon[:, 6 * lr.bodyB: 6 * lr.bodyB + 6]], dim=-1)
        outs.append(_ring_solve(sys, fvec, h))
    return outs


def loop_multipliers(fm: FrictionModel, topo, params, kin, Gm, lam_eq, h, SPreg):
    """Each loop ring's multipliers a [B, C]
    (ConstraintLoop.computeContactMultiplier_, ConstraintLoop.m:120-146):
    fcon = Gm_rows^T lam / h on the two bodies; a solves
    (N Minv N^T + reg) a = (N Minv fcon) h. Gm [B, nem, 6N], lam_eq [B, nem]."""
    return _loop_ring_solves(fm, _loop_ring_systems(fm, params, kin, SPreg), Gm, lam_eq, h)


def _ring_limits(rings, a_rings, mu):
    """mu times each row's sum of |a| over its contacts (at most two: the
    sum is exact in any order, as a matrix product on TF32 would not be)."""
    return [mu * (a.abs()[:, None, :]
                  * _const(_limit_matrix(r.limit_map, r.tan.shape[0], a.shape[-1]), a)).sum(-1)
            for r, a in zip(rings, a_rings)]


def _bounds(lims, B, like):
    if not lims:
        z = like.new_zeros(B, 0)
        return z, z
    lim = torch.cat(lims, dim=-1)
    return -lim, lim


def _floor_limits(fm, a_floor, mu_ext):
    return [(mu_ext * a_floor[:, i])[:, None].expand(-1, 2) for i in range(len(fm.floor_cons))]


def friction_bounds(fm: FrictionModel, a_rings, a_floor, mu_int, mu_ext):
    """Box bounds bl, bu [B, nt] from the joint rings' limit maps and the
    floor rows (a_floor [B, nfloor])."""
    lims = _ring_limits(fm.rings, a_rings, mu_int) + _floor_limits(fm, a_floor, mu_ext)
    return _bounds(lims, a_floor.shape[0], a_floor)


def friction_bounds_full(fm: FrictionModel, a_rings, a_loops, a_floor, mu_int, mu_ext):
    """Bounds bl, bu [B, nt] over [joint rings | loop rings | floor rows];
    the loop rings take the internal mu."""
    lims = (_ring_limits(fm.rings, a_rings, mu_int) + _ring_limits(fm.loop_rings, a_loops, mu_int)
            + _floor_limits(fm, a_floor, mu_ext))
    return _bounds(lims, a_floor.shape[0], a_floor)


def maximal_KD(force_fns: Tuple, params, kin, phi):
    """Km, Dm [B, 6N, 6N] of the force closures: the derivatives of the
    maximal wrenches by the body poses (perturbed in their own frames) and
    twists, as the JAX package's model.maximal_force_KD takes them by
    jacfwd, here from the closed-form blocks (integrators.closure_blocks)
    scattered into place. Closures with implicit_KD = False add nothing; any
    other closure without a block raises with its name."""
    B, N = phi.shape[:2]
    Km = phi.new_zeros(B, N, N, 6, 6)
    Dm = phi.new_zeros(B, N, N, 6, 6)
    blk = closure_blocks(tuple(force_fns), params, kin, phi)
    if blk is not None:
        K, D, bj, bi = blk
        dev = phi.device
        at = (torch.arange(B, device=dev)[:, None], torch.as_tensor(bj, device=dev)[None],
              torch.as_tensor(bi, device=dev)[None])
        Km.index_put_(at, K, accumulate=True)
        Dm.index_put_(at, D, accumulate=True)
    flat = lambda X: X.permute(0, 1, 3, 2, 4).reshape(B, 6 * N, 6 * N)
    return flat(Km), flat(Dm)


# ---------------------------------------------------------------------------
# The staggered-projections Euler step (eulerFric, testRedMax.m:544-759)
# ---------------------------------------------------------------------------


class _Dual:
    """The dual of min 1/2 x^T H x - f^T x with rows A x (<=|=) b (boxes lo,
    hi), set up once a step for every f (qp.qp_pgs_batched's setup:
    H^-1 A^T, D = A H^-1 A^T); solve(f) runs its sweeps on K3."""

    def __init__(self, H, A, b, lo, hi, iters):
        self.lu = torch.linalg.lu_factor_ex(H)[:2]
        self.HinvAT = torch.linalg.lu_solve(*self.lu, A.transpose(-1, -2))
        self.D = A @ self.HinvAT
        self.A, self.b, self.lo, self.hi, self.iters = A, b, lo, hi, iters

    def solve(self, f, active=None):
        """(x [B, n], lam [B, m]); lanes that active marks False are not
        swept (their lam is 0)."""
        Hf = torch.linalg.lu_solve(*self.lu, f[..., None])[..., 0]
        r = _mv(self.A, Hf) - self.b
        lam = pgs_kernel.pgs_sweeps(self.D, r, self.lo, self.hi, self.iters, QP_REG, active)
        return Hf - _mv(self.HinvAT, lam), lam


def make_euler_fric_step(
    topo: Topology,
    force_fns: Tuple,
    fm_model: FrictionModel,
    sp_iter_max: int = 100,
    sp_conv: float = 1e-3,
    sp_reg: float = 1e-6,
    pgs_iters: int = 3000,
):
    """One semi-implicit Euler step with staggered-projections friction over
    [B, nr] states: the JAX package's make_euler_fric_step, lane by lane.

    The reference's eulerFric branches: no external constraints,
    inequality-only (floors), equality-only (loop closures, maximal
    prescriptions) and mixed, with joint rings, loop rings and floor
    friction. Assembly follows the friction step's own rules: Kr, Dr the
    closed-form diagonals; Km, Dm of every closure with implicit_KD
    (maximal_KD; Km symmetrized), f0_m = fm_grav + fm_closures - Dm phi with
    no strip rule, body damping moved from f0 into Dm.

    Each staggered-projections iteration makes a contact pass (two dual-PGS
    QPs where the scene has floor or equality rows, else a solve of each
    side) and, on the lanes that have not converged, a friction pass (the
    box sweeps over the tangent rows); every sweep solve runs on K3
    (pgs_kernel.pgs_sweeps), which skips the lanes that are not in play.
    Each lane keeps its own iteration count and done flag: a lane that is
    done keeps its carry, and one that converges in an iteration takes no
    friction pass. The loop runs while a lane is not done and fewer than
    sp_iter_max iterations have run; the host reads the flags once an
    iteration. A lane whose fam and fbm are all NaN (a diverged float32
    lane) is done too: every pass maps NaN to NaN, so its outputs are those
    of the iterations it skips, and only its count differs. aux["fbm"]
    [B, 6N] is the next step's warm start.

    No gradient: the step runs under torch.no_grad(). After each call,
    step.stats holds {"sp_iters": [B] iterations of each lane,
    "sweep_solves": the K3 solves the call made}.
    """
    _split_closures(force_fns)   # raises on a closure with no exact K/D block
    floors = fm_model.floor_cons
    eq_cons = fm_model.eq_cons
    nim = len(floors)
    nem = sum(c.n_eq_m for c in eq_cons)
    rows = bool(nim or nem)

    @torch.no_grad()
    def step(params: Dict, state: State) -> State:
        q0, qdot0, aux = state.q, state.qdot, state.aux
        B, N = q0.shape[0], topo.njoints
        nm = 6 * N
        h = params["h"]
        h2, h3 = lanewise(h, 2), lanewise(h, 3)
        mu_int, mu_ext = params["mu"][0], params["mu"][1]
        baum3 = params["baumgarte"][2]

        kin = forward_kinematics(topo, params, q0, qdot0, aux)
        J, Jdot, phi = jacobians(topo, params, kin, qdot0)
        Jt = J.transpose(-1, -2)

        Kr, Dr = joint_space_KD_diag(topo, params, q0, qdot0)
        f0_r = joint_space_force(topo, params, q0, qdot0) - Dr * qdot0

        phif = phi.reshape(B, -1)
        fm_grav = maximal_force(topo, params, kin, phi).reshape(B, -1)
        _, fm_cl = closure_forces(topo, params, kin, phi, q0, qdot0, force_fns)
        Km, Dm = maximal_KD(force_fns, params, kin, phi)
        Km = 0.5 * (Km + Km.transpose(-1, -2))
        f0_m = fm_grav + fm_cl.reshape(B, -1) - _mv(Dm, phif)
        bd6 = params["body_damping"].repeat_interleave(6, dim=-1)
        f0_m = f0_m + bd6 * phif
        Dm = Dm - torch.diag_embed(bd6)

        Ivec = mass_diag(params["I_i"])[..., 0]                  # [(B,) 6N]
        MmJ = Ivec[..., None] * J
        Mr = Jt @ MmJ
        Mr = 0.5 * (Mr + Mr.transpose(-1, -2))
        frtilde = _mv(Mr, qdot0) + h2 * (_mv(Jt, f0_m - Ivec * _mv(Jdot, qdot0)) + f0_r)
        Mrtilde = (Mr - h3 * (Jt @ (Dm @ J)) - h3 * h3 * (Jt @ (Km @ J))
                   - torch.diag_embed(h2 * Dr) - torch.diag_embed(h2 * h2 * Kr))
        fmtilde = _mv(MmJ, qdot0) + h2 * f0_m
        Mmtilde = torch.diag_embed(Ivec).expand(B, nm, nm) - h3 * Dm - h3 * h3 * Km

        T = tangent_matrix(fm_model, topo, kin, params, q0, qdot0)
        Tt = T.transpose(-1, -2)

        # floor inequality rows (maximal, masked), then maximal equality rows
        Am, bm, lom, him = [], [], [], []
        if nim:
            Cs, cs, acts = zip(*(con.ineq_m(params, topo, kin, phi, q0, qdot0) for con in floors))
            act = torch.cat(acts, dim=1)
            Am.append(torch.cat(Cs, dim=1) * act.to(q0.dtype)[..., None])
            bm.append(torch.where(act, -baum3 * torch.cat(cs, dim=1), 0.0))
            lom.append(q0.new_zeros(B, nim))
            him.append(torch.where(act, float("inf"), 0.0).to(q0.dtype))
        Gm = q0.new_zeros(B, 0, nm)
        if nem:
            Gs, gs, gds = zip(*(con.eq_m(params, topo, kin, phi, q0, qdot0) for con in eq_cons))
            Gm = torch.cat(Gs, dim=1)
            Am.append(Gm)
            bm.append(-torch.cat(gds, dim=1) - baum3 * torch.cat(gs, dim=1))
            lom.append(q0.new_full((B, nem), -float("inf")))
            him.append(q0.new_full((B, nem), float("inf")))

        Mmt_inv = torch.linalg.inv_ex(Mmtilde)[0]
        if rows:
            A, b, lo, hi = (torch.cat(x, dim=1) for x in (Am, bm, lom, him))
            dual_m = _Dual(Mmtilde, A, b, lo, hi, pgs_iters)
            dual_r = _Dual(Mrtilde, A @ J, b, lo, hi, pgs_iters)
        else:
            Mrt_lu = torch.linalg.lu_factor_ex(Mrtilde)[:2]
        adT = _parent_adjoints(topo, kin)
        ring_sys = _joint_ring_systems(fm_model, topo, params, kin, sp_reg)
        loop_sys = _loop_ring_systems(fm_model, params, kin, sp_reg)
        Hf = T @ (Mmt_inv @ Tt)
        Hf = 0.5 * (Hf + Hf.transpose(-1, -2))
        solves = 0

        def contact_pass(fbm, active):
            """-> (fam [B, 6N], a_floor [B, nim], lam_eq [B, nem])."""
            nonlocal solves
            rhsM = fmtilde + h2 * fbm
            rhsR = frtilde + h2 * _mv(Jt, fbm)
            if rows:
                vuncb, _ = dual_m.solve(rhsM, active)
                solr, lam = dual_r.solve(rhsR, active)
                solves += 2
                a_floor, lam_eq = lam[:, :nim], lam[:, nim:]
            else:
                vuncb = _mv(Mmt_inv, rhsM)
                solr = torch.linalg.lu_solve(*Mrt_lu, rhsR[..., None])[..., 0]
                a_floor, lam_eq = q0.new_zeros(B, 0), q0.new_zeros(B, 0)
            fam = _mv(Mmtilde, _mv(J, solr) - vuncb) / h2
            return fam, a_floor, lam_eq

        def friction_pass(fam, a_floor, lam_eq, active):
            nonlocal solves
            fc = scatter_contact_force(fm_model, topo, kin, fam, adT)
            a_rings = _joint_ring_solves(fm_model, topo, ring_sys, fc, h, adT)
            a_loops = _loop_ring_solves(fm_model, loop_sys, Gm, lam_eq, h)
            bl, bu = friction_bounds_full(fm_model, a_rings, a_loops, a_floor, mu_int, mu_ext)
            ff = _mv(T, _mv(Mmt_inv, fmtilde + h2 * fam))
            bvec = pgs_kernel.pgs_sweeps(Hf, ff, bl, bu, pgs_iters, FRICTION_REG, active)
            solves += 1
            return -_mv(Tt, bvec) / h2

        fbm = aux.get("fbm") if aux else None
        fbm = q0.new_zeros(B, nm) if fbm is None else fbm
        fam, fam0 = q0.new_zeros(B, nm), q0.new_zeros(B, nm)
        a_floor, lam_eq = q0.new_zeros(B, nim), q0.new_zeros(B, nem)
        its = torch.zeros(B, dtype=torch.int64, device=q0.device)
        active = torch.ones(B, dtype=torch.bool, device=q0.device)
        for _ in range(sp_iter_max):
            fam_n, afl_n, lam_n = contact_pass(fbm, active)
            dfam = fam_n - fam0
            num = (dfam * _mv(Mmt_inv, dfam)).sum(-1)
            den = (fam_n * _mv(Mmt_inv, fam_n)).sum(-1)
            conv = num / torch.where(den == 0, torch.ones_like(den), den) < sp_conv
            on = active[:, None]
            fam = torch.where(on, fam_n, fam)
            fam0 = fam
            a_floor = torch.where(on, afl_n, a_floor)
            lam_eq = torch.where(on, lam_n, lam_eq)
            its = its + active.to(its.dtype)
            # a lane whose fam and fbm are NaN throughout sits at a fixed
            # point of the loop (every pass maps NaN to NaN): it leaves with
            # the outputs the remaining iterations would give it
            active = active & ~conv & ~(torch.isnan(fam).all(-1) & torch.isnan(fbm).all(-1))
            if not bool(active.any()):   # the host's one read an iteration
                break
            fbm = torch.where(active[:, None], friction_pass(fam, a_floor, lam_eq, active), fbm)

        rhs_final = frtilde + h2 * _mv(Jt, fam + fbm)
        if rows:
            qdot1, _ = dual_r.solve(rhs_final)
            solves += 1
        else:
            qdot1 = torch.linalg.lu_solve(*Mrt_lu, rhs_final[..., None])[..., 0]
        q1 = q0 + h2 * qdot1
        q1, qdot1, aux2, _, _ = reparam_all(topo, params, q1, qdot1, aux)
        step.stats = {"sp_iters": its, "sweep_solves": solves}
        return State(q=q1, qdot=qdot1, aux={**aux2, "fbm": fbm})

    step.stats = {}
    return step
