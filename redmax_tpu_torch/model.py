"""Kinematics and dynamics assembly, batch-first.

Every function takes a static Topology, a SceneParams dict and batched
(q, qdot) [B, nr]; every output carries the leading [B] lane dimension.
Lanes never mix. tau, I_i, body_damping, g, h and the force coefficients may
be per lane (types.SceneParams): they broadcast against the lane dim.

  * Forward kinematics: local joint transforms per type group, then the
    world chain by static pointer doubling (O(log depth) batched 4x4 rounds).
  * Jacobian in world-frame column form:
        W[:, r]  = Ad(E_w,body_a) Sb_a[:, d]       (column r = DOF d of joint a)
        J[i, r]  = anc(i, a) * Ad(E_i<-w) W[:, r]
        Jdot[i, r] = anc * Ad(E_i<-w) Wdot[:, r] - ad(phi_i) J[i, r]
  * Assembly: M = J^T Mm J, fqvv = -J^T Mm Jdot qdot, f = fr + J^T fm + fqvv.
  * Force closures (forces.py) add to fm. All ground contacts of a scene are
    evaluated in one batched pass, and their closed-form K/D blocks join the
    per-body blocks of the structured Newton matrix; springs and cables add
    closed-form blocks between pairs of bodies. The closures with
    implicit_KD = False (SpringDamperM, ForcePointDirection,
    ForceDeformableSegments) add their wrenches and energies and no block.
"""

from functools import lru_cache
from typing import Any, Dict, NamedTuple, Tuple

import torch

from redmax_tpu_torch import euler, forces, metrics, se3
from redmax_tpu_torch.joints import EXP_ROTATION, joint_QSSdot, joint_reparam
from redmax_tpu_torch.types import EULER_CHART_TYPES, MAX_NDOF, NDOF, JointType, Topology, lanewise


class Kinematics(NamedTuple):
    Q: Any        # [B,N,4,4] local joint transforms
    E_wj: Any     # [B,N,4,4] joint frames in world
    E_wi: Any     # [B,N,4,4] body frames in world
    S: Any        # [B,N,6,MAX_NDOF] padded motion subspaces (joint frame), per lane
    Sdot: Any     # [B,N,6,MAX_NDOF]


def joint_params_for(params: Dict, jt: int) -> Dict:
    return params.get("joint", {}).get(str(int(jt)), {})


def _split_closures(force_fns: Tuple) -> Tuple[Tuple, Tuple, Tuple]:
    """(ground contacts, springs and cables, explicit closures) of the
    scene's closures, each in force_fns order. The explicit ones are those
    with implicit_KD = False (forces.EXPLICIT_CLOSURES, or a closure added
    with SceneBuilder.add_force that says so): each is evaluated by its own
    call and energy and gives no Newton-matrix block, as the JAX package's
    maximal_force_KD leaves them out. Raises on any other closure (its K/D
    blocks would need autodiff)."""
    gnd, pair, other = [], [], []
    for fn in force_fns:
        if isinstance(fn, forces.ForceGroundCuboid):
            gnd.append(fn)
        elif isinstance(fn, forces.PAIR_CLOSURES):
            pair.append(fn)
        elif not getattr(fn, "implicit_KD", True):
            other.append(fn)
        else:
            raise NotImplementedError(
                f"force closure {type(fn).__name__}: its K/D blocks have no closed form here "
                "(set implicit_KD = False to keep it explicit)")
    return tuple(gnd), tuple(pair), tuple(other)


class _Index(NamedTuple):
    """A topology's index tensors on one device (see _index_tensors)."""

    groups: Tuple   # per joint type: (jt, members [G], q indices [G, d])
    rounds: Tuple   # FK pointer-doubling schedule, [N+1] each
    dofj: Any       # [nr] owning joint of each reduced DOF
    col: Any        # [nr] flat (joint, dof) index into [N * MAX_NDOF]
    anc: Any        # [N, nr] bool: joint of DOF r is body i's ancestor or i
    charts: Dict    # Euler-chart type -> its members' columns [G] of aux["euler_chart"]


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
    ej = topo.euler_joints()
    charts = {jt: torch.as_tensor([ej.index(m) for m in members], dtype=torch.long, device=device)
              for jt, members in topo.type_groups().items() if JointType(jt) in EULER_CHART_TYPES}
    return _Index(
        groups=tuple(groups),
        rounds=tuple(T(ptr) for ptr in topo.doubling_rounds()),
        dofj=T(dofj),
        col=T(dofj * MAX_NDOF + topo.dof_index()),
        anc=T(topo.ancestor_mask()[:, dofj] > 0),
        charts=charts,
    )


def _charts(aux, cols):
    """The chart indices [B, G] of one Euler-chart type group from the
    state's aux (columns cols of aux["euler_chart"] [B, G_euler])."""
    if not aux or "euler_chart" not in aux:
        raise ValueError("the scene has Euler-chart joints: pass the state's aux "
                         "({'euler_chart': int64 [B, G]})")
    return aux["euler_chart"][..., cols]


def forward_kinematics(topo: Topology, params: Dict, q, qdot, aux=None) -> Kinematics:
    """Joint transforms and subspaces per type group, then the world chain.
    A constant-S group's [G, 6, d] columns broadcast over the lanes; a
    q-dependent group fills its own per-lane [B, G, 6, d] columns. aux: the
    state's aux, whose aux["euler_chart"] [B, G] gives the Euler-chart
    joints their charts (unused without such joints)."""
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
        pg = joint_params_for(params, jt)
        if jt in index.charts:
            pg = {**pg, "chart": _charts(aux, index.charts[jt])}
        Qg, Sg, Sdotg = joint_QSSdot(jt_enum, q[:, idx], qdot[:, idx], pg)
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

    # body twists; one lane goes through the batched product as two, since
    # at B = 1 the CPU's matrix-vector product sums in another order: a
    # lane's phi is then the same whatever its batch
    Jb, qb = (J, qdot) if B > 1 else (torch.cat([J, J]), torch.cat([qdot, qdot]))
    phi = (Jb @ qb[..., None])[:B].reshape(B, N, 6)
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
    I = params["I_i"]                                            # [(B,) N, 6]
    Irot = I[..., :3]
    m = I[..., 3, None, None]
    w, v = phi[..., :3], phi[..., 3:]
    Rtg = _gravity_body(kin, params["g"])
    Z = torch.zeros_like(se3.hat3(w))
    K = torch.cat([
        torch.cat([Z, Z], dim=-1),
        torch.cat([m * se3.hat3(Rtg), Z], dim=-1),
    ], dim=-2)
    hw = se3.hat3(w)
    D = torch.cat([
        torch.cat([se3.hat3(Irot * w) - hw * Irot[..., None, :], Z], dim=-1),
        torch.cat([m * se3.hat3(v), -m * hw], dim=-1),
    ], dim=-2)
    bd = params["body_damping"]
    D = D - bd[..., None, None] * torch.eye(6, dtype=phi.dtype, device=phi.device)
    return K, D


def _gravity_body(kin: Kinematics, g):
    """R_wi^T g [B, N, 3]: gravity [3] or per lane [B, 3] in each body frame."""
    R = kin.E_wi[..., :3, :3]
    return torch.einsum("bnji,bj->bni", R, g.expand(R.shape[0], 3))


def mass_diag(I):
    """The block-diagonal Mm as a column [(B,) 6N, 1] from I_i [(B,) N, 6]."""
    return I.flatten(-2)[..., None]


def maximal_force(topo: Topology, params: Dict, kin: Kinematics, phi):
    """Maximal (per-body wrench) forces fm [B, N, 6]: Coriolis + gravity +
    body damping."""
    I = params["I_i"]
    fcor = torch.einsum("bnji,bnj->bni", se3.ad(phi), I * phi)   # ad(phi)^T (M phi)
    grav_i = _gravity_body(kin, params["g"])
    fgrav = torch.cat([torch.zeros_like(grav_i), I[..., 3, None] * grav_i], dim=-1)
    return fcor + fgrav - params["body_damping"][..., None] * phi


def closure_forces(topo: Topology, params: Dict, kin: Kinematics, phi, q, qdot,
                   force_fns: Tuple):
    """Sum of the registered force closures: (fr_cl [B, nr], fm_cl [B, N, 6])."""
    gnd, pair, other = _split_closures(force_fns)
    fm = forces.ground_contact_wrenches(gnd, params, kin, phi) if gnd else torch.zeros_like(phi)
    if pair:
        with metrics.span("forces.pair_closures"):
            fm = fm + forces.pair_closure_wrenches(pair, params, kin, phi)
    fr = torch.zeros_like(q)
    for fn in other:
        fr_a, fm_a = fn(params, kin, None, phi, q, qdot)
        fr, fm = fr + fr_a, fm + fm_a
    return fr, fm


def structured_hessian(topo: Topology, params: Dict, q, qdot, cK, cD, force_fns: Tuple = (),
                       aux=None):
    """Structured Newton matrix H = M + cK*K~ + cD*D~ [B, nr, nr].

    K~/D~ keep every term that does not differentiate the kinematic geometry:
    joint-space Kr/Dr, the local maximal force blocks contracted through a
    frozen J, and the quadratic-velocity damping -2 J^T Mm Jdot. Ground
    contacts add their closed-form per-body blocks
    (forces.ground_contact_blocks) with the one-step proximity-margin
    activation, hh = params["h"], gmag = |g| (per lane where those are). cK
    and cD are scalars or per lane [B]. Springs and cables add
    J_b^T K_bc J_c (and the same with D) for every pair of their body points
    (forces.pair_closure_blocks), the blocks that couple two bodies
    included: the JAX package's jacfwd Km, Dm in closed form. aux: the
    state's aux (forward_kinematics).
    """
    gnd, pair, _ = _split_closures(force_fns)
    kin = forward_kinematics(topo, params, q, qdot, aux)
    J, Jdot, phi = jacobians(topo, params, kin, qdot)
    B, N, nr = q.shape[0], topo.njoints, topo.nr

    Krd, Drd = joint_space_KD_diag(topo, params, q, qdot)
    Kmb, Dmb = local_force_blocks(topo, params, kin, phi)
    if gnd:
        idx = forces.body_index(tuple(fn.body for fn in gnd), q.device)
        Kc, Dc = forces.ground_contact_blocks(
            kin.E_wi[:, idx], phi[:, idx], forces.stack_contact_params(gnd, params),
            lanewise(params["h"], 3), lanewise(torch.linalg.vector_norm(params["g"], dim=-1), 3))
        Kmb, Dmb = Kmb.index_add(1, idx, Kc), Dmb.index_add(1, idx, Dc)
    Jblk = J.reshape(B, N, 6, nr)
    Kt = torch.diag_embed(Krd) + torch.einsum("bnir,bnis->brs", Jblk, Kmb @ Jblk)
    Dt = torch.diag_embed(Drd) + torch.einsum("bnir,bnis->brs", Jblk, Dmb @ Jblk)
    if pair:
        with metrics.span("forces.pair_closures"):
            Kp, Dp, bj, bi = forces.pair_closure_blocks(pair, params, kin, phi)
        Jj, Ji = Jblk[:, forces.body_index(bj, q.device)], Jblk[:, forces.body_index(bi, q.device)]
        Kt = Kt + torch.einsum("bpir,bpij,bpjs->brs", Jj, Kp, Ji)
        Dt = Dt + torch.einsum("bpir,bpij,bpjs->brs", Jj, Dp, Ji)

    MmJ = mass_diag(params["I_i"]) * J
    M = MmJ.transpose(-1, -2) @ J
    Dt = Dt - 2.0 * (MmJ.transpose(-1, -2) @ Jdot)
    return M + lanewise(cK, 3) * Kt + lanewise(cD, 3) * Dt


def assemble(topo: Topology, params: Dict, q, qdot, force_fns: Tuple = (), aux=None):
    """Full reduced assembly: (M [B,nr,nr], f [B,nr], parts dict).

    force_fns: static tuple of force closures compiled from the scene's
    force list (forces.py); aux: the state's aux (forward_kinematics)."""
    _split_closures(force_fns)  # raises before any work on a closure with no K/D
    kin = forward_kinematics(topo, params, q, qdot, aux)
    J, Jdot, phi = jacobians(topo, params, kin, qdot)
    B = q.shape[0]

    fr = joint_space_force(topo, params, q, qdot)
    fm = maximal_force(topo, params, kin, phi)
    if force_fns:
        fr_cl, fm_cl = closure_forces(topo, params, kin, phi, q, qdot, force_fns)
        fr, fm = fr + fr_cl, fm + fm_cl
    MmJ = mass_diag(params["I_i"]) * J
    MmJt = MmJ.transpose(-1, -2)
    M = MmJt @ J
    fqvv = -(MmJt @ (Jdot @ qdot[..., None]))[..., 0]
    f = fr + (J.transpose(-1, -2) @ fm.reshape(B, -1, 1))[..., 0] + fqvv
    return M, f, {"kin": kin, "J": J, "Jdot": Jdot, "phi": phi, "fm": fm, "fr": fr}


def energies(topo: Topology, params: Dict, q, qdot, force_fns: Tuple = (), aux=None):
    """Kinetic and potential energy (T [B], V [B]):
      T = 1/2 sum_i phi_i^T M_i phi_i
      V = -sum_i m_i g . p_wi + 1/2 k (q - qrest)^2 + limit penalties
        + force energies.
    aux: the state's aux (forward_kinematics).
    """
    gnd, pair, other = _split_closures(force_fns)
    kin = forward_kinematics(topo, params, q, qdot, aux)
    _, _, phi = jacobians(topo, params, kin, qdot)
    I = params["I_i"]
    T = 0.5 * (phi * (I * phi)).sum((-1, -2))
    V = -(I[..., 3] * (kin.E_wi[..., :3, 3] * params["g"][..., None, :]).sum(-1)).sum(-1)
    dq = q - params["qrest"]
    V = V + 0.5 * (params["stiffness"] * dq * dq).sum(-1)
    dqL = (q < params["qlimL"]).to(q.dtype) * (params["qlimL"] - q)
    dqU = (q > params["qlimU"]).to(q.dtype) * (params["qlimU"] - q)
    V = V + 0.5 * (params["qlimK"] * (dqL * dqL + dqU * dqU)).sum(-1)
    if gnd:
        V = V + forces.ground_contact_energy(gnd, params, kin)
    if pair:
        V = V + forces.pair_closure_energy(pair, params, kin)
    for fn in other:
        if hasattr(fn, "energy"):
            V = V + fn.energy(params, kin, q, qdot)
    return T, V


def reparam_all(topo: Topology, params: Dict, q, qdot, aux=None, q_prev=None, qdot_prev=None):
    """Post-step reparameterization (Joint.reparam, Joint.m:372-379) of
    (q, qdot) [B, nr] per type group: the exp-map rescale of SPHERICAL and
    FREE3D rotations (joints.joint_reparam) and the 12-chart switch of the
    Euler-chart joints (euler.reparam_spherical), which also updates
    aux["euler_chart"] and remaps the previous step's q_prev, qdot_prev (the
    BDF2 history, JointSpherical.m:96-103) of the lanes that switch; the
    identity for a scene without such joints. Returns (q, qdot, aux, q_prev,
    qdot_prev), the last two None where they were not given."""
    index = _index_tensors(topo, q.device)
    B = q.shape[0]
    for jt, _, idx in index.groups:
        jt_enum = JointType(jt)
        if jt_enum in EULER_CHART_TYPES:
            cols = index.charts[jt]
            ridx = idx[:, EULER_CHART_TYPES[jt_enum]]
            flat = ridx.reshape(-1)
            qp = q if q_prev is None else q_prev
            qdp = qdot if qdot_prev is None else qdot_prev
            ch, qg, qdg, qpg, qdpg = euler.reparam_spherical(
                _charts(aux, cols), q[:, ridx], qdot[:, ridx], qp[:, ridx], qdp[:, ridx])
            aux = {**aux, "euler_chart": aux["euler_chart"].index_copy(1, cols, ch)}
            q = q.index_copy(1, flat, qg.reshape(B, -1))
            qdot = qdot.index_copy(1, flat, qdg.reshape(B, -1))
            if q_prev is not None:
                q_prev = q_prev.index_copy(1, flat, qpg.reshape(B, -1))
                qdot_prev = qdot_prev.index_copy(1, flat, qdpg.reshape(B, -1))
            continue
        if jt_enum not in EXP_ROTATION:
            continue
        qg, qdg = joint_reparam(jt_enum, q[:, idx], qdot[:, idx])
        flat = idx.reshape(-1)
        q = q.index_copy(1, flat, qg.reshape(B, -1))
        qdot = qdot.index_copy(1, flat, qdg.reshape(B, -1))
    return q, qdot, aux, q_prev, qdot_prev
