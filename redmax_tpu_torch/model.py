"""Kinematics and dynamics assembly, batch-first.

Every function takes a static Topology, a SceneParams dict (lane-shared
tensors, except tau, which may be [B, nr]) and batched (q, qdot) [B, nr];
every output carries the leading [B] lane dimension. Lanes never mix.

  * Forward kinematics: local joint transforms per type group, then the
    world chain by static pointer doubling (O(log depth) batched 4x4 rounds).
  * Jacobian in world-frame column form:
        W[:, r]  = Ad(E_w,body_a) Sb_a[:, d]       (column r = DOF d of joint a)
        J[i, r]  = anc(i, a) * Ad(E_i<-w) W[:, r]
        Jdot[i, r] = anc * Ad(E_i<-w) Wdot[:, r] - ad(phi_i) J[i, r]
  * Assembly: M = J^T Mm J, fqvv = -J^T Mm Jdot qdot, f = fr + J^T fm + fqvv.
  * Force closures (forces.py) add to fm. All ground contacts of a scene are
    evaluated in one batched pass, and their closed-form K/D blocks join the
    per-body blocks of the structured Newton matrix.
"""

from functools import lru_cache
from typing import Any, Dict, NamedTuple, Tuple

import torch

from redmax_tpu_torch import forces, se3
from redmax_tpu_torch.joints import joint_QSSdot
from redmax_tpu_torch.types import MAX_NDOF, NDOF, JointType, Topology


class Kinematics(NamedTuple):
    Q: Any        # [B,N,4,4] local joint transforms
    E_wj: Any     # [B,N,4,4] joint frames in world
    E_wi: Any     # [B,N,4,4] body frames in world
    S: Any        # [B,N,6,MAX_NDOF] padded motion subspaces (joint frame)
    Sdot: Any     # [B,N,6,MAX_NDOF]


def joint_params_for(params: Dict, jt: int) -> Dict:
    return params.get("joint", {}).get(str(int(jt)), {})


def _ground_contacts(force_fns: Tuple) -> Tuple:
    """The scene's ForceGroundCuboid closures; raises on any other closure
    type (their K/D blocks are not ported: ROADMAP queue 1 item 10)."""
    for fn in force_fns:
        if not isinstance(fn, forces.ForceGroundCuboid):
            raise NotImplementedError(
                f"force closure {type(fn).__name__} is not ported yet (ROADMAP queue 1 item 10)")
    return force_fns


class _Index(NamedTuple):
    """A topology's index tensors on one device (see _index_tensors)."""

    groups: Tuple   # per joint type: (jt, members [G], q indices [G, d])
    rounds: Tuple   # FK pointer-doubling schedule, [N+1] each
    dofj: Any       # [nr] owning joint of each reduced DOF
    col: Any        # [nr] flat (joint, dof) index into [N * MAX_NDOF]
    anc: Any        # [N, nr] bool: joint of DOF r is body i's ancestor or i


@lru_cache(maxsize=None)
def _index_tensors(topo: Topology, device: torch.device) -> _Index:
    """Built from the topology's numpy tables once per (topology, device), so
    that the kinematics copy nothing from host to device after their first
    call (each such copy blocks the host on the stream)."""
    def T(a):
        return torch.as_tensor(a, device=device)

    groups = []
    for jt, members in topo.type_groups().items():
        d = NDOF[JointType(jt)]
        idx = torch.as_tensor([[topo.qstart[m] + k for k in range(d)] for m in members],
                              dtype=torch.long, device=device).reshape(len(members), d)
        groups.append((jt, torch.as_tensor(members, dtype=torch.long, device=device), idx))
    dofj = topo.dof_joint()
    return _Index(
        groups=tuple(groups),
        rounds=tuple(T(ptr) for ptr in topo.doubling_rounds()),
        dofj=T(dofj),
        col=T(dofj * MAX_NDOF + topo.dof_index()),
        anc=T(topo.ancestor_mask()[:, dofj] > 0),
    )


def forward_kinematics(topo: Topology, params: Dict, q, qdot) -> Kinematics:
    """Joint transforms and subspaces per type group, then the world chain."""
    B = q.shape[0]
    N = topo.njoints
    dtype, device = q.dtype, q.device
    index = _index_tensors(topo, device)
    Q = torch.empty(B, N, 4, 4, dtype=dtype, device=device)
    S = torch.zeros(B, N, 6, MAX_NDOF, dtype=dtype, device=device)
    Sdot = torch.zeros(B, N, 6, MAX_NDOF, dtype=dtype, device=device)
    for jt, mem, idx in index.groups:
        jt_enum = JointType(jt)
        d = NDOF[jt_enum]
        Qg, Sg, Sdotg = joint_QSSdot(
            jt_enum, q[:, idx], qdot[:, idx], joint_params_for(params, jt)
        )
        Q[:, mem] = Qg
        S[:, mem, :, :d] = Sg
        Sdot[:, mem, :, :d] = Sdotg

    E_pj = params["E0_pj"] @ Q                                   # [B,N,4,4]
    eye = torch.eye(4, dtype=dtype, device=device).expand(B, 1, 4, 4)
    E_ext = torch.cat([E_pj, eye], dim=1)                        # node N = world
    for ptr in index.rounds:
        E_ext = E_ext[:, ptr] @ E_ext
    E_wj = E_ext[:, :N]
    E_wi = E_wj @ params["E0_ji"]
    return Kinematics(Q=Q, E_wj=E_wj, E_wi=E_wi, S=S, Sdot=Sdot)


def jacobians(topo: Topology, params: Dict, kin: Kinematics, qdot):
    """Dense J, Jdot [B, 6N, nr] plus body twists phi [B, N, 6]."""
    B = qdot.shape[0]
    N, nr = topo.njoints, topo.nr
    index = _index_tensors(topo, qdot.device)
    dofj, col = index.dofj, index.col
    ancd = index.anc.to(qdot.dtype)                              # [N, nr]

    def cols(A):
        """[B,N,6,MAX_NDOF] -> the reduced columns [B,nr,6]."""
        return A.transpose(-1, -2).reshape(B, N * MAX_NDOF, 6)[:, col]

    A0_ij = se3.Ad(se3.inv(params["E0_ji"]))                     # [N,6,6]
    Sb = A0_ij @ kin.S                                           # body-frame S
    Sbdot = A0_ij @ kin.Sdot
    Ad_wb = se3.Ad(kin.E_wi)[:, dofj]                            # [B,nr,6,6]
    Ad_bw = se3.Ad(se3.inv(kin.E_wi))                            # [B,N,6,6]

    W = torch.einsum("brkl,brl->brk", Ad_wb, cols(Sb))           # [B,nr,6]
    Jblk = ancd[:, None, :] * torch.einsum("bikl,brl->bikr", Ad_bw, W)  # [B,N,6,nr]
    J = Jblk.reshape(B, 6 * N, nr)

    phi = (J @ qdot[..., None]).reshape(B, N, 6)                 # body twists
    adphi = se3.ad(phi)                                          # [B,N,6,6]
    Sbdot_eff = adphi @ Sb + Sbdot
    Wdot = torch.einsum("brkl,brl->brk", Ad_wb, cols(Sbdot_eff))
    Jdotblk = ancd[:, None, :] * torch.einsum("bikl,brl->bikr", Ad_bw, Wdot) - adphi @ Jblk
    Jdot = Jdotblk.reshape(B, 6 * N, nr)
    return J, Jdot, phi


def joint_space_force(topo: Topology, params: Dict, q, qdot):
    """Reduced-space joint forces fr [B, nr]: torque, stiffness, damping, limits."""
    fr = params["tau"] + params["stiffness"] * (params["qrest"] - q) - params["damping"] * qdot
    hitL = (q < params["qlimL"]).to(q.dtype)
    hitU = (q > params["qlimU"]).to(q.dtype)
    fr = fr + hitL * (params["qlimK"] * (params["qlimL"] - q) - params["qlimD"] * qdot)
    fr = fr + hitU * (params["qlimK"] * (params["qlimU"] - q) - params["qlimD"] * qdot)
    return fr


def joint_space_KD_diag(topo: Topology, params: Dict, q, qdot):
    """Diagonals of Kr = dfr/dq and Dr = dfr/dqdot [B, nr] in closed form."""
    hit = (q < params["qlimL"]).to(q.dtype) + (q > params["qlimU"]).to(q.dtype)
    Kd = -params["stiffness"] - hit * params["qlimK"]
    Dd = -params["damping"] - hit * params["qlimD"]
    return Kd, Dd


def local_force_blocks(topo: Topology, params: Dict, kin: Kinematics, phi):
    """[B,N,6,6] per-body stiffness/damping blocks of the local maximal forces
    (Coriolis + gravity + body viscous damping), in closed form
    (pallas_step.local_force_blocks_closed of the JAX package). With
    phi = (w, v) and I = diag(Irot, m I3):
      K[3:6, 0:3] = m hat(R^T g)
      D[0:3, 0:3] = hat(Irot w) - hat(w) Irot,  D[3:6, 0:3] = m hat(v),
      D[3:6, 3:6] = -m hat(w),  minus bd on the diagonal.
    """
    I = params["I_i"]                                            # [N,6]
    Irot = I[:, :3]
    m = I[:, 3][:, None, None]
    w, v = phi[..., :3], phi[..., 3:]
    Rtg = torch.einsum("bnji,j->bni", kin.E_wi[..., :3, :3], params["g"])
    Z = torch.zeros_like(se3.hat3(w))
    K = torch.cat([
        torch.cat([Z, Z], dim=-1),
        torch.cat([m * se3.hat3(Rtg), Z], dim=-1),
    ], dim=-2)
    hw = se3.hat3(w)
    D = torch.cat([
        torch.cat([se3.hat3(Irot * w) - hw * Irot[:, None, :], Z], dim=-1),
        torch.cat([m * se3.hat3(v), -m * hw], dim=-1),
    ], dim=-2)
    bd = params["body_damping"]
    D = D - bd[:, None, None] * torch.eye(6, dtype=phi.dtype, device=phi.device)
    return K, D


def maximal_force(topo: Topology, params: Dict, kin: Kinematics, phi):
    """Maximal (per-body wrench) forces fm [B, N, 6]: Coriolis + gravity +
    body damping."""
    I = params["I_i"]
    fcor = torch.einsum("bnji,bnj->bni", se3.ad(phi), I * phi)   # ad(phi)^T (M phi)
    grav_i = torch.einsum("bnji,j->bni", kin.E_wi[..., :3, :3], params["g"])
    fgrav = torch.cat([torch.zeros_like(grav_i), I[:, 3][:, None] * grav_i], dim=-1)
    return fcor + fgrav - params["body_damping"][:, None] * phi


def closure_forces(topo: Topology, params: Dict, kin: Kinematics, phi, q, qdot,
                   force_fns: Tuple):
    """Sum of the registered force closures: (fr_cl [B, nr], fm_cl [B, N, 6])."""
    gnd = _ground_contacts(force_fns)
    fm = forces.ground_contact_wrenches(gnd, params, kin, phi) if gnd else torch.zeros_like(phi)
    return torch.zeros_like(q), fm


def structured_hessian(topo: Topology, params: Dict, q, qdot, cK, cD, force_fns: Tuple = ()):
    """Structured Newton matrix H = M + cK*K~ + cD*D~ [B, nr, nr].

    K~/D~ keep every term that does not differentiate the kinematic geometry:
    joint-space Kr/Dr, the local maximal force blocks contracted through a
    frozen J, and the quadratic-velocity damping -2 J^T Mm Jdot. Ground
    contacts add their closed-form per-body blocks
    (forces.ground_contact_blocks) with the one-step proximity-margin
    activation, hh = params["h"], gmag = |g|.
    """
    gnd = _ground_contacts(force_fns)
    kin = forward_kinematics(topo, params, q, qdot)
    J, Jdot, phi = jacobians(topo, params, kin, qdot)
    B, N, nr = q.shape[0], topo.njoints, topo.nr

    Krd, Drd = joint_space_KD_diag(topo, params, q, qdot)
    Kmb, Dmb = local_force_blocks(topo, params, kin, phi)
    if gnd:
        idx = forces.body_index(tuple(fn.body for fn in gnd), q.device)
        Kc, Dc = forces.ground_contact_blocks(
            kin.E_wi[:, idx], phi[:, idx], forces.stack_contact_params(gnd, params),
            params["h"], torch.linalg.vector_norm(params["g"]))
        Kmb, Dmb = Kmb.index_add(1, idx, Kc), Dmb.index_add(1, idx, Dc)
    Jblk = J.reshape(B, N, 6, nr)
    Kt = torch.diag_embed(Krd) + torch.einsum("bnir,bnis->brs", Jblk, Kmb @ Jblk)
    Dt = torch.diag_embed(Drd) + torch.einsum("bnir,bnis->brs", Jblk, Dmb @ Jblk)

    MmJ = params["I_i"].reshape(-1)[:, None] * J
    M = MmJ.transpose(-1, -2) @ J
    Dt = Dt - 2.0 * (MmJ.transpose(-1, -2) @ Jdot)
    return M + cK * Kt + cD * Dt


def assemble(topo: Topology, params: Dict, q, qdot, force_fns: Tuple = ()):
    """Full reduced assembly: (M [B,nr,nr], f [B,nr], aux dict).

    force_fns: static tuple of force closures compiled from the scene's
    force list (forces.py)."""
    _ground_contacts(force_fns)  # raises before any work on an unported closure
    kin = forward_kinematics(topo, params, q, qdot)
    J, Jdot, phi = jacobians(topo, params, kin, qdot)
    B = q.shape[0]

    fr = joint_space_force(topo, params, q, qdot)
    fm = maximal_force(topo, params, kin, phi)
    if force_fns:
        fr_cl, fm_cl = closure_forces(topo, params, kin, phi, q, qdot, force_fns)
        fr, fm = fr + fr_cl, fm + fm_cl
    MmJ = params["I_i"].reshape(-1)[:, None] * J                 # block-diag Mm
    MmJt = MmJ.transpose(-1, -2)
    M = MmJt @ J
    fqvv = -(MmJt @ (Jdot @ qdot[..., None]))[..., 0]
    f = fr + (J.transpose(-1, -2) @ fm.reshape(B, -1, 1))[..., 0] + fqvv
    aux = {"kin": kin, "J": J, "Jdot": Jdot, "phi": phi, "fm": fm, "fr": fr}
    return M, f, aux


def energies(topo: Topology, params: Dict, q, qdot, force_fns: Tuple = ()):
    """Kinetic and potential energy (T [B], V [B]):
      T = 1/2 sum_i phi_i^T M_i phi_i
      V = -sum_i m_i g . p_wi + 1/2 k (q - qrest)^2 + limit penalties
        + force energies.
    """
    gnd = _ground_contacts(force_fns)
    kin = forward_kinematics(topo, params, q, qdot)
    _, _, phi = jacobians(topo, params, kin, qdot)
    I = params["I_i"]
    T = 0.5 * (phi * (I * phi)).sum((-1, -2))
    V = -(I[:, 3] * (kin.E_wi[..., :3, 3] @ params["g"])).sum(-1)
    dq = q - params["qrest"]
    V = V + 0.5 * (params["stiffness"] * dq * dq).sum(-1)
    dqL = (q < params["qlimL"]).to(q.dtype) * (params["qlimL"] - q)
    dqU = (q > params["qlimU"]).to(q.dtype) * (params["qlimU"] - q)
    V = V + 0.5 * (params["qlimK"] * (dqL * dqL + dqU * dqU)).sum(-1)
    if gnd:
        V = V + forces.ground_contact_energy(gnd, params, kin)
    return T, V


def reparam_all(topo: Topology, params: Dict, q, qdot):
    """Post-step reparameterization: the identity for the constant-S joint
    types (exp-map rescales and Euler chart switches come with queue 1
    item 11)."""
    return q, qdot
