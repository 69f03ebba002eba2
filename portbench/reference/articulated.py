"""Reduced-coordinate dynamics of a tree of revolute joints (RedMax, Wang et
al. 2019), written out plainly for the reference.

Joint i owns body i and has one DOF about a constant unit axis in its own
frame. With E_wi the body frames, the world column of DOF a is
W_a = Ad(E_wa) Sb_a (Sb_a the axis twist in body a's frame), the body
Jacobian J_i,a = anc(i, a) Ad(E_wi)^-1 W_a, the body twists phi = J qdot and

    Jdot_i,a = anc(i, a) Ad(E_wi)^-1 Ad(E_wa) ad(phi_a) Sb_a - ad(phi_i) J_i,a.

M = sum_i J_i^T Mm_i J_i and f = fr + sum_i J_i^T fm_i - J^T Mm Jdot qdot,
fm_i = ad(phi_i)^T Mm_i phi_i + [0; m_i R_i^T g] - bd_i phi_i + closures.

The structured Newton matrix H = M + cK Kt + cD Dt keeps the terms that do
not differentiate the kinematic geometry: the joint springs and dampers,
each body's local force blocks through a frozen J, the closures' blocks and
-2 J^T Mm Jdot (RedMax's structured stiffness and damping).
"""

from dataclasses import dataclass, field
from typing import List

import torch

from portbench.reference import se3


@dataclass
class Scene:
    """A compiled revolute tree: every tensor in one dtype on one device."""

    parent: List[int]       # parent joint of each joint (-1: the world)
    axis: torch.Tensor      # [N, 3] unit joint axes, joint frame
    E0_pj: torch.Tensor     # [N, 4, 4] joint frame in its parent's joint frame at q = 0
    E0_ji: torch.Tensor     # [N, 4, 4] body frame in its joint's frame
    I: torch.Tensor         # [N, 6] diagonal body inertia (Ixx, Iyy, Izz, m, m, m)
    body_damping: torch.Tensor  # [N]
    stiffness: torch.Tensor     # [N]
    damping: torch.Tensor       # [N]
    qrest: torch.Tensor         # [N]
    g: torch.Tensor         # [3] gravity
    h: float                # time step
    closures: list = field(default_factory=list)   # force pieces (reference/forces)

    @property
    def n(self):
        return len(self.parent)

    def __post_init__(self):
        n, dt, dev = self.n, self.I.dtype, self.I.device
        anc = torch.zeros(n, n, dtype=torch.float64)
        for i in range(n):
            a = i
            while a >= 0:
                anc[i, a] = 1.0
                a = self.parent[a]
        # anc[i, a] = 1 where joint a is body i's ancestor or i itself
        self.anc = anc.to(dt).to(dev)
        # the axis twists in their bodies' frames
        S = torch.cat([self.axis, torch.zeros_like(self.axis)], -1)
        self.Sb = (se3.Ad(se3.inv(self.E0_ji)) @ S[..., None])[..., 0]
        # FK by pointer doubling: round k composes each frame with its 2^k-th
        # ancestor's (index n: the world, the identity)
        ptr = [p if p >= 0 else n for p in self.parent] + [n]
        self.rounds = []
        while any(p != n for p in ptr[:n]):
            self.rounds.append(torch.tensor(ptr, device=dev))
            ptr = [ptr[p] for p in ptr]

    # what the solver and the modes ask of a scene (another kind of scene, in a
    # module of its own, gives the same methods)
    def mass_and_force(self, q, qdot, tau):
        return mass_and_force(self, q, qdot, tau)

    def structured_hessian(self, q, qdot, cK, cD):
        return structured_hessian(self, q, qdot, cK, cD)

    def point_world(self, q, body, xlocal):
        return point_world(self, q, body, xlocal)

    def chord_work(self):
        """What harness/flops.py counts a chord solve of: the joints (parent,
        type (1: revolute), DOFs) and the closures' contacts, springs and cables."""
        spec = [c.chord_spec() for c in self.closures]
        n = self.n
        return {"parent": tuple(self.parent), "jtype": (1,) * n, "ndof": (1,) * n,
                "contacts": sum(c.get("contacts", 0) for c in spec),
                "springs": sum((c.get("springs", ()) for c in spec), ()),
                "cables": sum((c.get("cables", ()) for c in spec), ())}


def transl(p, dtype, device):
    E = torch.eye(4, dtype=dtype, device=device)
    E[:3, 3] = torch.as_tensor(p, dtype=dtype, device=device)
    return E


def cuboid_inertia(sides, density):
    """(Ixx, Iyy, Izz, m, m, m) of a solid cuboid about its centre."""
    x, y, z = (float(s) for s in sides)
    m = density * x * y * z
    return [m / 12 * (y * y + z * z), m / 12 * (z * z + x * x), m / 12 * (x * x + y * y), m, m, m]


def kinematics(sc: Scene, q, qdot):
    """Body frames E_wi [B, N, 4, 4], J and Jdot [B, N, 6, N], twists phi [B, N, 6]."""
    B, N = q.shape
    Q = torch.zeros(B, N, 4, 4, dtype=q.dtype, device=q.device)
    Q[..., :3, :3] = se3.rot_axis(sc.axis, q)
    Q[..., 3, 3] = 1.0
    E = torch.cat([sc.E0_pj @ Q, torch.eye(4, dtype=q.dtype, device=q.device).expand(B, 1, 4, 4)], 1)
    for ptr in sc.rounds:
        E = E[:, ptr] @ E
    E_wi = E[:, :N] @ sc.E0_ji
    Sb, anc = sc.Sb, sc.anc
    Ad_wi = se3.Ad(E_wi)
    Ad_iw = se3.Ad(se3.inv(E_wi))
    W = (Ad_wi @ Sb[..., None])[..., 0]                                 # [B, N, 6]
    J = torch.einsum("bikl,bal->bika", Ad_iw, W) * anc[None, :, None, :]
    phi = torch.einsum("bika,ba->bik", J, qdot)
    adphi = se3.ad(phi)
    Wdot = (Ad_wi @ (adphi @ Sb[..., None]))[..., 0]
    Jdot = torch.einsum("bikl,bal->bika", Ad_iw, Wdot) * anc[None, :, None, :] - adphi @ J
    return E_wi, J, Jdot, phi


def _Mm(I):
    return torch.diag_embed(I)


def _body_forces(sc: Scene, E_wi, phi):
    """fm [B, N, 6]: Coriolis, gravity and body damping, closures excluded."""
    I = sc.I
    Rtg = torch.einsum("bnji,j->bni", E_wi[..., :3, :3], sc.g)
    fcor = (se3.ad(phi).transpose(-1, -2) @ (I * phi)[..., None])[..., 0]
    fgrav = torch.cat([torch.zeros_like(Rtg), I[:, 3:4] * Rtg], -1)
    return fcor + fgrav - sc.body_damping[:, None] * phi


def mass_and_force(sc: Scene, q, qdot, tau):
    """M [B, N, N] and f [B, N] at (q, qdot) with joint torques tau [B, N]."""
    E_wi, J, Jdot, phi = kinematics(sc, q, qdot)
    fm = _body_forces(sc, E_wi, phi)
    for c in sc.closures:
        fm = fm + c.wrenches(E_wi, phi)
    MmJ = _Mm(sc.I) @ J                                                # [B, N, 6, N]
    Jt = J.transpose(-1, -2)
    M = (Jt @ MmJ).sum(1)
    Jdq = (Jdot @ qdot[:, None, :, None])                              # [B, N, 6, 1]
    f_body = Jt @ (fm[..., None] - _Mm(sc.I) @ Jdq)                    # [B, N, N, 1]
    fr = tau + sc.stiffness * (sc.qrest - q) - sc.damping * qdot
    return M, fr + f_body.sum(1)[..., 0]


def structured_hessian(sc: Scene, q, qdot, cK, cD):
    """H = M + cK Kt + cD Dt [B, N, N] at (q, qdot)."""
    E_wi, J, Jdot, phi = kinematics(sc, q, qdot)
    I = sc.I
    w, v = phi[..., :3], phi[..., 3:]
    m = I[:, 3, None, None]
    B, N = q.shape
    K = torch.zeros(B, N, 6, 6, dtype=q.dtype, device=q.device)
    D = torch.zeros_like(K)
    Rtg = torch.einsum("bnji,j->bni", E_wi[..., :3, :3], sc.g)
    K[..., 3:, :3] = m * se3.hat(Rtg)
    hw = se3.hat(w)
    D[..., :3, :3] = se3.hat(I[:, :3] * w) - hw * I[:, None, :3]
    D[..., 3:, :3] = m * se3.hat(v)
    D[..., 3:, 3:] = -m * hw
    D = D - sc.body_damping[:, None, None] * torch.eye(6, dtype=q.dtype, device=q.device)
    for c in sc.closures:
        Kc, Dc = c.blocks(E_wi, phi, sc.h, torch.linalg.vector_norm(sc.g))
        K, D = K + Kc, D + Dc
    Jt = J.transpose(-1, -2)
    MmJ = _Mm(I) @ J
    M = (Jt @ MmJ).sum(1)
    Kt = (Jt @ K @ J).sum(1) - torch.diag_embed(sc.stiffness.expand(B, N))
    Dt = (Jt @ D @ J).sum(1) - torch.diag_embed(sc.damping.expand(B, N)) \
        - 2.0 * (MmJ.transpose(-1, -2) @ Jdot).sum(1)
    return M + cK * Kt + cD * Dt


def point_world(sc: Scene, q, body: int, xlocal):
    """World position [B, 3] of the body-frame point xlocal [3] of a body."""
    E_wi = kinematics(sc, q, torch.zeros_like(q))[0][:, body]
    xl = torch.as_tensor(xlocal, dtype=q.dtype, device=q.device)
    return (E_wi[:, :3, :3] @ xl[:, None])[..., 0] + E_wi[:, :3, 3]
