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

The constraints: ConstraintLoop, ConstraintJointLimit, ConstraintFloor,
ConstraintMultQ, the prescribed-motion ones (ConstraintPrescJoint,
ConstraintPrescBody, ConstraintPrescJointM, ConstraintPrescBodyW, whose
targets a scene function sets over time) and ConstraintAttachPoint (a
deformable spring's end). A constraint with acceleration-level targets
also has eq_m_acc / eq_r_acc -> [B,k].
"""

from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F

from redmax_tpu_torch import se3
from redmax_tpu_torch.forces import body_index


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
    radius and height: the joint ring's contact geometry (metadata for
    joint friction; no row reads them).
    """

    n_eq_m = 2

    def __init__(self, key, bodyA: int, bodyB: int, radius: float = 1.0, height: float = 1.0):
        super().__init__(key)
        self.bodyA = bodyA
        self.bodyB = bodyB
        self.radius = radius
        self.height = height

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


def _select_rows(B, cols, width, like):
    """Rows [B, len(cols), width] with -1 at (k, cols[k]), zero elsewhere."""
    G = like.new_zeros(B, len(cols), width)
    for k, c in enumerate(cols):
        G[:, k, c] = -1.0
    return G


def _rows_of(v, B, d):
    """A target [d] (lane-shared) or [B, d] (per lane) as [B, d]."""
    return v.reshape(-1, d).expand(B, d)


class ConstraintPrescJoint(_ConstraintBase):
    """Prescribed joint velocity (matlab/+redmax/ConstraintPrescJoint.m:16-42):
    rows -I on the joint's DOFs with gdot = qdot_target, so that the Euler
    step's rows give qdot = qdot_target; with a q_target in its params also
    the position error g = q_target - q (Baumgarte feedback). params:
    qdot_target [d], optional q_target [d] and qddot_target [d] (the
    acceleration rows, eq_r_acc), set over time by a scene function."""

    def __init__(self, key, dofs: Sequence[int]):
        super().__init__(key)
        self.dofs = tuple(dofs)
        self.n_eq_r = len(self.dofs)

    def eq_r(self, params, topo, kin, phi, q, qdot):
        cp = self.p(params)
        B, d = q.shape[0], len(self.dofs)
        C = _select_rows(B, self.dofs, topo.nr, q)
        if "q_target" in cp:
            g = _rows_of(cp["q_target"], B, d) - q[:, body_index(self.dofs, q.device)]
        else:
            g = q.new_zeros(B, d)
        return C, g, _rows_of(cp["qdot_target"], B, d)

    def eq_r_acc(self, params, topo, kin, phi, q, qdot):
        cp = self.p(params)
        B, d = q.shape[0], len(self.dofs)
        if "qddot_target" not in cp:
            return q.new_zeros(B, d)
        return _rows_of(cp["qddot_target"], B, d)


class ConstraintPrescBody(_ConstraintBase):
    """Prescribed body twist components (matlab/+redmax/ConstraintPrescBody.m:
    17-45, velocity level): rows -e_comp on the body's twist, gdot =
    phi_target. params: phi_target [len(comps)]; comps are 0-based twist
    indices."""

    def __init__(self, key, body: int, comps: Sequence[int]):
        super().__init__(key)
        self.body = body
        self.comps = tuple(comps)
        self.n_eq_m = len(self.comps)

    def eq_m(self, params, topo, kin, phi, q, qdot):
        B, d = q.shape[0], len(self.comps)
        G = _select_rows(B, [6 * self.body + c for c in self.comps], 6 * topo.njoints, q)
        return G, q.new_zeros(B, d), _rows_of(self.p(params)["phi_target"], B, d)


class ConstraintPrescJointM(_ConstraintBase):
    """A revolute joint prescribed by one maximal row
    (matlab/+redmax/ConstraintPrescJointM.m:31-60): the hinge-axis angular
    component of the joint frame's relative twist,
        Gm[child] = row_a(Ad_ji),  Gm[parent] = -row_a(Ad_ji Ad(E_ip)),
    with E_ip = E_wi[child]^-1 E_wi[parent], and gdot = qdot_target
    (velocity level only, as the reference enforces). axis_idx: 0, 1, 2 for
    an x, y, z hinge axis. params: qdot_target []."""

    n_eq_m = 1

    def __init__(self, key, joint: int, parent_joint: int, axis_idx: int):
        super().__init__(key)
        self.joint = joint
        self.parent = parent_joint
        self.axis_idx = axis_idx

    def eq_m(self, params, topo, kin, phi, q, qdot):
        B, N = q.shape[0], topo.njoints
        Ad_ji = se3.Ad(params["E0_ji"][..., self.joint, :, :])
        E_ip = se3.inv(kin.E_wi[:, self.joint]) @ kin.E_wi[:, self.parent]
        G = q.new_zeros(B, 1, 6 * N)
        G[:, 0, 6 * self.joint: 6 * self.joint + 6] = Ad_ji[..., self.axis_idx, :]
        G[:, 0, 6 * self.parent: 6 * self.parent + 6] = -(Ad_ji @ se3.Ad(E_ip))[:, self.axis_idx]
        return G, q.new_zeros(B, 1), _rows_of(self.p(params)["qdot_target"], B, 1)


class ConstraintPrescBodyW(_ConstraintBase):
    """Prescribed body motion with world-frame linear targets (the
    ConstraintPrescBody of the reference's sceneFcn13/20,
    testRedMaxScenes.m:1237-1279): vt_w (world linear velocity) and wt_i
    (body angular velocity) become the twist target
        phi_t = [wt_i; R^T vt_w],
    and the acceleration target (eq_m_acc)
        phidot_t = [wtdot_i; R^T vtdot_w - w x (R^T vt_w)],
    on the components comps (0-based). params: vt_w, wt_i, vtdot_w, wtdot_i
    [3], set over time by a scene function."""

    def __init__(self, key, body: int, comps: Sequence[int]):
        super().__init__(key)
        self.body = body
        self.comps = tuple(comps)
        self.n_eq_m = len(self.comps)

    def _targets(self, params, kin, phi):
        cp = self.p(params)
        B = phi.shape[0]
        R = kin.E_wi[:, self.body, :3, :3]
        vt_i = _mv(R.transpose(-1, -2), cp["vt_w"].expand(B, 3))
        w = phi[:, self.body, :3]
        phi_t = torch.cat([cp["wt_i"].expand(B, 3), vt_i], dim=-1)
        phidot_t = torch.cat([cp["wtdot_i"].expand(B, 3),
                              _mv(R.transpose(-1, -2), cp["vtdot_w"].expand(B, 3))
                              - torch.linalg.cross(w, vt_i)], dim=-1)
        sel = body_index(self.comps, phi.device)
        return phi_t[:, sel], phidot_t[:, sel]

    def eq_m(self, params, topo, kin, phi, q, qdot):
        B, d = q.shape[0], len(self.comps)
        G = _select_rows(B, [6 * self.body + c for c in self.comps], 6 * topo.njoints, q)
        return G, q.new_zeros(B, d), self._targets(params, kin, phi)[0]

    def eq_m_acc(self, params, topo, kin, phi, q, qdot):
        return self._targets(params, kin, phi)[1]


class ConstraintAttachPoint(_ConstraintBase):
    """Welds a point-mass node to a point r of a rigid body, or to the world
    point r for body = -1 (matlab/+redmax/ConstraintAttachSpring.m:23-60):
    g = x_pt - x_node, G = [R_b Gamma(r) on the body, -I on the node's
    linear twist]. params: r [3]."""

    n_eq_m = 3

    def __init__(self, key, body: int, node_body: int):
        super().__init__(key)
        self.body = body
        self.node = node_body

    def eq_m(self, params, topo, kin, phi, q, qdot):
        r = self.p(params)["r"]
        B, N = q.shape[0], topo.njoints
        G = q.new_zeros(B, 3, 6 * N)
        G[:, :, 6 * self.node + 3: 6 * self.node + 6] = -torch.eye(3, dtype=q.dtype,
                                                                   device=q.device)
        x_node = kin.E_wi[:, self.node, :3, 3]
        if self.body >= 0:
            E_b = kin.E_wi[:, self.body]
            G[:, :, 6 * self.body: 6 * self.body + 6] = E_b[:, :3, :3] @ se3.Gamma(r)
            x_pt = _mv(E_b[:, :3, :3], r.expand(B, 3)) + E_b[:, :3, 3]
        else:
            x_pt = r.expand(B, 3)
        g = x_pt - x_node
        return G, g, torch.zeros_like(g)


def assemble_constraints(constraint_fns: Tuple, params: Dict, topo, kin, phi, q, qdot, J):
    """Stack all constraint rows into reduced space.

    Returns a dict with
      Geq [B,me,nr], geq [B,me], geqdot [B,me]   (maximal rows times J)
      Cin [B,mi,nr], cin [B,mi], act [B,mi] bool
      geqddot [B,me]                            (the acceleration-level
                                                 targets: eq_m_acc / eq_r_acc
                                                 where a constraint has them)
    me/mi are static totals over all constraints (0 if none). No Euler step
    reads geqddot; the acceleration-level (explicit) tier will.
    """
    B, nr = q.shape[0], topo.nr
    Geq, geq, geqdot, geqddot, Cin, cin, act = [], [], [], [], [], [], []
    args = (params, topo, kin, phi, q, qdot)

    def acc_rows(con, nrows):
        for name in ("eq_m_acc", "eq_r_acc"):
            if hasattr(con, name):
                return getattr(con, name)(*args)
        return q.new_zeros(B, nrows)

    for con in constraint_fns:
        if con.n_eq_m:
            G, g, gd = con.eq_m(*args)
            Geq.append(G @ J)
            geq.append(g)
            geqdot.append(gd)
            geqddot.append(acc_rows(con, con.n_eq_m))
        if con.n_eq_r:
            G, g, gd = con.eq_r(*args)
            Geq.append(G)
            geq.append(g)
            geqdot.append(gd)
            geqddot.append(acc_rows(con, con.n_eq_r))
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
        "Geq": cat(Geq, nr), "geq": cat(geq), "geqdot": cat(geqdot), "geqddot": cat(geqddot),
        "Cin": cat(Cin, nr), "cin": cat(cin), "act": cat(act, dtype=torch.bool),
    }
