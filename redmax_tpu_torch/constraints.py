"""Constraint subsystem: equality/inequality x maximal/reduced rows,
batch-first.

The closures of the JAX package's constraints.py over batched tensors. Each
constraint contributes fixed-size row blocks (static counts set at scene
compile); inequality activity is a boolean mask per lane, so a lane that
switches a contact on or off keeps the same shapes.

Row protocol: a constraint object exposes any of

    eq_m(params, topo, kin, phi, q, qdot)   -> (G [B,k,6N], g [B,k], gdot [B,k])
    eq_r(params, topo, kin, phi, q, qdot)   -> (G [B,k,nr], g [B,k], gdot [B,k])
    ineq_m(...)                             -> (C [B,k,6N], c [B,k], act [B,k] bool)
    ineq_r(...)                             -> (C [B,k,nr], c [B,k], act [B,k] bool)

with static row counts in .n_eq_m / .n_eq_r / .n_ineq_m / .n_ineq_r.
Per-constraint parameters (lane-shared) live in params["constraints"][key].

Ported: ConstraintLoop, ConstraintJointLimit, ConstraintFloor,
ConstraintMultQ. The prescribed-motion and attach-point constraints need
the time-dependent scene hook and the deformables; they raise (not ported
yet).
"""

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from redmax_tpu_torch import se3


class _ConstraintBase:
    n_eq_m = 0
    n_eq_r = 0
    n_ineq_m = 0
    n_ineq_r = 0

    def __init__(self, key: str):
        self.key = key

    def p(self, params: Dict) -> Dict:
        return params["constraints"][self.key]


def _mv(M, v):
    return (M @ v[..., None])[..., 0]


class ConstraintLoop(_ConstraintBase):
    """Loop-closure 'spherical-lite' constraint between two body points: two
    rows along the directions v1, v2 orthonormal to body A's hinge axis in
    the world frame,
        Gm[A] =  v12^T R_wa Gamma(xA),  Gm[B] = -v12^T R_wb Gamma(xB)
        g = v12^T (x_wA - x_wB)
    params: xA [3], xB [3], axisA [3] (the hinge axis of A's joint).
    """

    n_eq_m = 2

    def __init__(self, key, bodyA: int, bodyB: int):
        super().__init__(key)
        self.bodyA = bodyA
        self.bodyB = bodyB

    def _v12(self, R_wa, axis):
        v0 = _mv(R_wa, axis)                                     # [B,3]
        # Branchless argmin/one-hot of |v0|: the world axis least aligned
        # with the hinge seeds the basis (first index on ties).
        v1 = F.one_hot(torch.argmin(v0.abs(), dim=-1), 3).to(v0.dtype)
        v2 = torch.linalg.cross(v0, v1)
        v2 = v2 / torch.linalg.vector_norm(v2, dim=-1, keepdim=True)
        v1 = torch.linalg.cross(v2, v0)
        v1 = v1 / torch.linalg.vector_norm(v1, dim=-1, keepdim=True)
        return torch.stack([v1, v2], dim=-1)                     # [B,3,2]

    def eq_m(self, params, topo, kin, phi, q, qdot):
        cp = self.p(params)
        B, N = q.shape[0], topo.njoints
        E_wa, E_wb = kin.E_wi[:, self.bodyA], kin.E_wi[:, self.bodyB]
        R_wa, R_wb = E_wa[:, :3, :3], E_wb[:, :3, :3]
        v12t = self._v12(R_wa, cp["axisA"]).transpose(-1, -2)    # [B,2,3]
        G = q.new_zeros(B, 2, 6 * N)
        G[:, :, 6 * self.bodyA: 6 * self.bodyA + 6] = v12t @ R_wa @ se3.Gamma(cp["xA"])
        G[:, :, 6 * self.bodyB: 6 * self.bodyB + 6] = -(v12t @ R_wb @ se3.Gamma(cp["xB"]))
        xwA = _mv(R_wa, cp["xA"]) + E_wa[:, :3, 3]
        xwB = _mv(R_wb, cp["xB"]) + E_wb[:, :3, 3]
        g = _mv(v12t, xwA - xwB)
        return G, g, torch.zeros_like(g)


class ConstraintJointLimit(_ConstraintBase):
    """Inequality revolute joint limit. Active-set switching is a mask; the
    row sign selects which bound. params: ql [], qu []."""

    n_ineq_r = 1

    def __init__(self, key, joint_dof: int):
        super().__init__(key)
        self.dof = joint_dof  # index into the flat q

    def ineq_r(self, params, topo, kin, phi, q, qdot):
        cp = self.p(params)
        qj = q[:, self.dof]
        at_lower = qj <= cp["ql"]
        at_upper = qj >= cp["qu"]
        C = q.new_zeros(q.shape[0], 1, topo.nr)
        C[:, 0, self.dof] = torch.where(at_lower, -1.0, 1.0).to(q.dtype)
        c = torch.where(at_lower, cp["ql"] - qj, cp["qu"] - qj)
        return C, c[:, None], (at_lower | at_upper)[:, None]


class ConstraintFloor(_ConstraintBase):
    """Unilateral sphere-vs-plane contact. params: E [4,4] floor frame
    (z-up), radius []."""

    n_ineq_m = 1

    def __init__(self, key, body: int):
        super().__init__(key)
        self.body = body

    def ineq_m(self, params, topo, kin, phi, q, qdot):
        cp = self.p(params)
        B, N = q.shape[0], topo.njoints
        E_wi = kin.E_wi[:, self.body]                            # [B,4,4]
        r, E_f = cp["radius"], cp["E"]
        x_f = _mv(se3.inv(E_f), E_wi[:, :, 3])                   # [B,4], last = 1
        z = x_f[:, 2]
        # contact point: the sphere centre dropped by r along the floor
        # normal, expressed in the body frame
        x_c = torch.cat([x_f[:, :2], (z - r)[:, None], x_f[:, 3:]], dim=-1)
        x_b = _mv(se3.inv(E_wi), _mv(E_f, x_c))
        row = -_mv((E_wi[:, :3, :3] @ se3.Gamma(x_b[:, :3])).transpose(-1, -2), E_f[:3, 2])
        C = q.new_zeros(B, 1, 6 * N)
        C[:, 0, 6 * self.body: 6 * self.body + 6] = row
        return C, (r - z)[:, None], (z < r)[:, None]


class ConstraintMultQ(_ConstraintBase):
    """Gear coupling qB = factor * qA. params: factor []."""

    n_eq_r = 1

    def __init__(self, key, dofA: int, dofB: int):
        super().__init__(key)
        self.dofA = dofA
        self.dofB = dofB

    def eq_r(self, params, topo, kin, phi, q, qdot):
        cp = self.p(params)
        C = q.new_zeros(q.shape[0], 1, topo.nr)
        C[:, 0, self.dofA] = cp["factor"]
        C[:, 0, self.dofB] = -1.0
        g = (cp["factor"] * q[:, self.dofA] - q[:, self.dofB])[:, None]
        return C, g, torch.zeros_like(g)


# What a constraint that is not ported names in its error.
PORTED = "the port's constraints are the loop closure, joint limit, floor and angle coupling"


def _later(name: str):
    def init(self, *a, **k):
        raise NotImplementedError(f"{name} is not ported yet ({PORTED})")

    return type(name, (_ConstraintBase,), {"__init__": init})


# Prescribed motion needs make_simulate's time-dependent scene hook; the
# attach point needs the deformables.
ConstraintPrescJoint = _later("ConstraintPrescJoint")
ConstraintPrescBody = _later("ConstraintPrescBody")
ConstraintPrescJointM = _later("ConstraintPrescJointM")
ConstraintPrescBodyW = _later("ConstraintPrescBodyW")
ConstraintAttachPoint = _later("ConstraintAttachPoint")


def assemble_constraints(constraint_fns: Tuple, params: Dict, topo, kin, phi, q, qdot, J):
    """Stack all constraint rows into reduced space.

    Returns a dict with
      Geq [B,me,nr], geq [B,me], geqdot [B,me]   (maximal rows times J)
      Cin [B,mi,nr], cin [B,mi], act [B,mi] bool
    me/mi are static totals over all constraints (0 if none). The
    acceleration-level rows (geqddot) belong to the explicit tier (queue 1
    item 14).
    """
    B, nr = q.shape[0], topo.nr
    Geq, geq, geqdot, Cin, cin, act = [], [], [], [], [], []
    args = (params, topo, kin, phi, q, qdot)
    for con in constraint_fns:
        if con.n_eq_m:
            G, g, gd = con.eq_m(*args)
            Geq.append(G @ J)
            geq.append(g)
            geqdot.append(gd)
        if con.n_eq_r:
            G, g, gd = con.eq_r(*args)
            Geq.append(G)
            geq.append(g)
            geqdot.append(gd)
        if con.n_ineq_m:
            C, c, a = con.ineq_m(*args)
            Cin.append(C @ J)
            cin.append(c)
            act.append(a)
        if con.n_ineq_r:
            C, c, a = con.ineq_r(*args)
            Cin.append(C)
            cin.append(c)
            act.append(a)

    def cat(lst, *tail, dtype=q.dtype):
        if not lst:
            return torch.zeros(B, 0, *tail, dtype=dtype, device=q.device)
        return torch.cat(lst, dim=1)

    return {
        "Geq": cat(Geq, nr), "geq": cat(geq), "geqdot": cat(geqdot),
        "Cin": cat(Cin, nr), "cin": cat(cin), "act": cat(act, dtype=torch.bool),
    }
