"""Recursive O(n) hybrid dynamics (RHD), batch-first, and the O(n) M^{-1} x
product that preconditions the PCG tier (the JAX package's recursive.py;
matlab/+redmax/Joint.m:263-450, rhdPass1/2/3 and computeMinvProd).

The tree recursions run level by level: all joints of one depth update
together, one batched op over [B, |level|] per level, so the sequential
work is the tree's depth. Each pass keeps one tensor per level; a level's
parents are the level before it (Topology.levels), so a child reads its
parent by its position there (_Levels.ppos). Joint quantities are padded to
MAX_NDOF columns: S [B, N, 6, MAX_NDOF] has zero columns past a joint's
DOFs, and the Psi inverse puts identity on the padding and masks it back to
zero (a FIXED joint inverts a pure identity block, masked to exact zeros).

Quantities are in each joint's frame:
    I_j   = Ad_ij^T diag(I_i) Ad_ij      (joint-frame inertia)
    Ad_jp = Ad((E0_pj Q)^{-1})           (parent joint -> joint)
Prescribed joints (hybrid dynamics: known qddot, solve for tau) take the
presc branches of rhdPass2/3: Pi = Ihat, and tau is read back.
"""

from functools import lru_cache
from typing import Any, Dict, NamedTuple, Tuple

import torch

from redmax_tpu_torch import se3
from redmax_tpu_torch.model import (
    Kinematics, _gravity_body, _index_tensors, closure_forces, forward_kinematics,
    joint_space_force,
)
from redmax_tpu_torch.types import MAX_NDOF, Topology


class _Levels(NamedTuple):
    """A topology's level tables on one device (see _level_tensors)."""

    members: Tuple      # per level: its joints [n_l]
    ppos: Tuple         # per level: each member's parent's position in the level before [n_l]
                        # (None for level 0, whose members are roots)
    inv: Any            # [N]: position of joint j in the levels' concatenation
    mask2: Tuple        # per level: dof mask outer product [n_l, MAX_NDOF, MAX_NDOF]
    pad_fix: Tuple      # per level: identity on the padding [n_l, MAX_NDOF, MAX_NDOF]


@lru_cache(maxsize=None)
def _level_tensors(topo: Topology, device: torch.device, dtype: torch.dtype) -> _Levels:
    """Built once per (topology, device, dtype), so that no level loop copies
    host to device after its first call."""
    levels = topo.levels
    members, ppos, mask2, pad_fix = [], [], [], []
    dm = torch.zeros(topo.njoints, MAX_NDOF, dtype=dtype)
    for j in range(topo.njoints):
        dm[j, :topo.ndof[j]] = 1.0
    eye = torch.eye(MAX_NDOF, dtype=dtype)
    for k, level in enumerate(levels):
        members.append(torch.as_tensor(level, dtype=torch.long, device=device))
        ppos.append(None if k == 0 else torch.as_tensor(
            [levels[k - 1].index(topo.parent[j]) for j in level], dtype=torch.long, device=device))
        m = dm[list(level)]
        m2 = m[:, :, None] * m[:, None, :]
        mask2.append(m2.to(device))
        pad_fix.append((eye * (1.0 - m2)).to(device))
    order = [j for level in levels for j in level]
    inv = torch.empty(topo.njoints, dtype=torch.long)
    inv[torch.as_tensor(order)] = torch.arange(topo.njoints)
    return _Levels(tuple(members), tuple(ppos), inv.to(device), tuple(mask2), tuple(pad_fix))


@lru_cache(maxsize=None)
def _presc_masks(topo: Topology, presc: Tuple[int, ...], device: torch.device):
    """Per level: bool [n_l], True at a prescribed joint."""
    return tuple(torch.as_tensor([j in presc for j in level], dtype=torch.bool, device=device)
                 for level in topo.levels)


def _pad_q(topo: Topology, x):
    """Flat [..., nr] -> padded [..., N, MAX_NDOF] (a scatter through the
    DOFs' flat (joint, dof) columns)."""
    col = _index_tensors(topo, x.device).col
    out = x.new_zeros(*x.shape[:-1], topo.njoints * MAX_NDOF)
    return out.index_copy(-1, col, x).reshape(*x.shape[:-1], topo.njoints, MAX_NDOF)


def _unpad_q(topo: Topology, xp):
    """Padded [..., N, MAX_NDOF] -> flat [..., nr] (a gather)."""
    col = _index_tensors(topo, xp.device).col
    return xp.reshape(*xp.shape[:-2], topo.njoints * MAX_NDOF).index_select(-1, col)


def _mv(A, v):
    return (A @ v[..., None])[..., 0]


def _mtv(A, v):
    return (A.transpose(-1, -2) @ v[..., None])[..., 0]


def _against(x):
    """A per-lane [B, ...] tensor against x [B, ...] or, with k right-hand
    sides a lane, [B, k, ...]."""
    return (lambda t: t[:, None]) if x.dim() == 3 else (lambda t: t)


def _rows(X, idx, vector: bool):
    """The rows idx of the joint axis of X: [..., N, 6] (vector) or
    [..., N, a, b]."""
    return X.index_select(X.dim() - (2 if vector else 3), idx)


def _join(parts, lv: _Levels, vector: bool):
    """Per-level tensors back to joint order along the joint axis."""
    X = torch.cat(parts, dim=parts[0].dim() - (2 if vector else 3))
    return _rows(X, lv.inv, vector)


def _joint_frames(topo: Topology, params: Dict, kin: Kinematics):
    """(Ad_ij [N, 6, 6] body -> joint, I_j [(B,) N, 6, 6], Ad_jp [B, N, 6, 6])
    in joint frames."""
    Ad_ij = se3.Ad(se3.inv(params["E0_ji"]))
    I = params["I_i"]
    Mi = I[..., :, None] * torch.eye(6, dtype=I.dtype, device=I.device)
    I_j = Ad_ij.transpose(-1, -2) @ Mi @ Ad_ij
    Ad_jp = se3.Ad(se3.inv(params["E0_pj"] @ kin.Q))
    return Ad_ij, I_j, Ad_jp


def _psi(S_l, Ih, lv: _Levels, k: int):
    """(Psi [.., n, d, d], Ih S): Psi = (S^T Ih S)^{-1} on each joint's DOFs,
    zero on the padding."""
    SIS = S_l.transpose(-1, -2) @ Ih @ S_l
    Psi = torch.linalg.inv(SIS + lv.pad_fix[k]) * lv.mask2[k]
    return Psi, Ih @ S_l


def _articulated(I_j, Ad_jp, S, lv: _Levels, presc=None):
    """The leaf-to-root pass of the inertias shared by rhd_qddot and
    make_minv_product: per level (Ihat, Psi, Pi). presc: per-level bool
    masks (Pi = Ihat at a prescribed joint) or None."""
    nl = len(lv.members)
    Ihat, Psi, Pi = [None] * nl, [None] * nl, [None] * nl
    for k in reversed(range(nl)):
        mem = lv.members[k]
        Ih = _rows(I_j, mem, False).expand(S.shape[0], -1, 6, 6)
        if k + 1 < nl:
            A = _rows(Ad_jp, lv.members[k + 1], False)
            Ih = Ih.index_add(1, lv.ppos[k + 1], A.transpose(-1, -2) @ Pi[k + 1] @ A)
        S_l = _rows(S, mem, False)
        Psi_l, IS = _psi(S_l, Ih, lv, k)
        Pi_l = Ih - IS @ Psi_l @ IS.transpose(-1, -2)
        if presc is not None:
            Pi_l = torch.where(presc[k][:, None, None], Ih, Pi_l)
        Ihat[k], Psi[k], Pi[k] = Ih, Psi_l, Pi_l
    return Ihat, Psi, Pi


def rhd_qddot(
    topo: Topology,
    params: Dict,
    q,
    qdot,
    force_fns: Tuple = (),
    aux=None,
    presc: Tuple[int, ...] = (),
    presc_qddot=None,
):
    """Forward/hybrid dynamics at batched (q, qdot) [B, nr].

    presc: static tuple of prescribed joint indices; presc_qddot [(B,) nr]
    holds their known accelerations (rows of free joints ignored). aux: the
    state's aux (forward_kinematics). Returns (qddot [B, nr], tau_presc
    [B, nr]: the torque at the prescribed joints' DOFs, zero elsewhere).
    """
    B = q.shape[0]
    dtype, device = q.dtype, q.device
    lv = _level_tensors(topo, device, dtype)
    nl = len(lv.members)
    kin = forward_kinematics(topo, params, q, qdot, aux)
    Ad_ij, I_j, Ad_jp = _joint_frames(topo, params, kin)
    S, Sdot = kin.S, kin.Sdot
    qdotp = _pad_q(topo, qdot)
    # tauTotal: tau + stiffness - damping [+ limits] per joint (rhdPass2)
    frp = _pad_q(topo, joint_space_force(topo, params, q, qdot))
    pm = _presc_masks(topo, tuple(presc), device) if presc else None
    qdd_presc = (_pad_q(topo, presc_qddot.expand(B, -1)) if presc_qddot is not None
                 else torch.zeros_like(qdotp))

    # ---- Pass 1 (root -> leaf): V, eta ----------------------------------
    Sqdot = _mv(S, qdotp)
    Vs = []
    for k in range(nl):
        Vl = _rows(Sqdot, lv.members[k], True)
        if k:
            Vl = Vl + _mv(_rows(Ad_jp, lv.members[k], False), _rows(Vs[k - 1], lv.ppos[k], True))
        Vs.append(Vl)
    V = _join(Vs, lv, True)
    adV = se3.ad(V)
    eta = _mv(adV, Sqdot) + _mv(Sdot, qdotp)

    # External wrenches in the body frame (closures, body damping, gravity)
    # -> joint frame. phi_b = Ad_ij V is the body twist.
    phi_b = _mv(Ad_ij, V)
    if force_fns:
        _, fm = closure_forces(topo, params, kin, phi_b, q, qdot, force_fns)
    else:
        fm = torch.zeros_like(phi_b)
    fm = fm - params["body_damping"][..., None] * phi_b
    grav = _gravity_body(kin, params["g"]) * params["I_i"][..., 3, None]
    Fext = _mtv(Ad_ij, torch.cat([torch.zeros_like(grav), grav], dim=-1) + fm)
    Bself = -_mv(adV.transpose(-1, -2) @ I_j, V) - Fext

    # ---- Pass 2 (leaf -> root): Ihat, Bhat, Psi, Pi, beta ---------------
    Ihat, Psi, Pi = _articulated(I_j, Ad_jp, S, lv, pm)
    Bhat, beta = [None] * nl, [None] * nl
    for k in reversed(range(nl)):
        mem = lv.members[k]
        Bh = _rows(Bself, mem, True)
        if k + 1 < nl:
            A = _rows(Ad_jp, lv.members[k + 1], False)
            Bh = Bh.index_add(1, lv.ppos[k + 1], _mtv(A, beta[k + 1]))
        S_l, Ih, eta_l = _rows(S, mem, False), Ihat[k], _rows(eta, mem, True)
        inner = _mv(Psi[k], _rows(frp, mem, True) - _mtv(S_l, _mv(Ih, eta_l) + Bh))
        beta_l = Bh + _mv(Ih, eta_l + _mv(S_l, inner))
        if pm is not None:
            beta_presc = Bh + _mv(Ih, eta_l + _mv(S_l, _rows(qdd_presc, mem, True)))
            beta_l = torch.where(pm[k][:, None], beta_presc, beta_l)
        Bhat[k], beta[k] = Bh, beta_l

    # ---- Pass 3 (root -> leaf): qddot, Vdot, tau at prescribed joints ----
    qdds, taus, Vdots = [], [], []
    for k in range(nl):
        mem = lv.members[k]
        S_l, Ih, eta_l = _rows(S, mem, False), Ihat[k], _rows(eta, mem, True)
        tmp = (_mv(_rows(Ad_jp, mem, False), _rows(Vdots[k - 1], lv.ppos[k], True)) if k
               else torch.zeros_like(eta_l))
        SIte = _mtv(S_l, _mv(Ih, tmp + eta_l))
        qdd = _mv(Psi[k], _rows(frp, mem, True) - SIte - _mtv(S_l, Bhat[k]))
        if pm is not None:
            qdd = torch.where(pm[k][:, None], _rows(qdd_presc, mem, True), qdd)
        Vd = _mv(S_l, qdd) + eta_l + tmp
        if pm is not None:
            tau = _mtv(S_l, _mv(Ih, Vd) + Bhat[k])
            taus.append(torch.where(pm[k][:, None], tau, torch.zeros_like(tau)))
        qdds.append(qdd)
        Vdots.append(Vd)
    qddot = _unpad_q(topo, _join(qdds, lv, True))
    tau = _unpad_q(topo, _join(taus, lv, True)) if pm is not None else torch.zeros_like(qddot)
    return qddot, tau


def make_minv_product(topo: Topology, params: Dict, kin: Kinematics):
    """O(n) y = M^{-1} x by the three-pass preconditioner solve
    (Joint.computeMinvProdInit/2/3, matlab/+redmax/Joint.m:364-450).

    The init pass (Ihat, Psi, Pi; no velocity terms) runs here once;
    minv(x [B, nr] or [B, k, nr]) then runs passes 2-3 on the k right-hand
    sides of each lane at once and returns y of x's shape.
    """
    S = kin.S
    dtype, device = S.dtype, S.device
    lv = _level_tensors(topo, device, dtype)
    nl = len(lv.members)
    _, I_j, Ad_jp = _joint_frames(topo, params, kin)
    Ihat, Psi, _ = _articulated(I_j, Ad_jp, S, lv)
    S_l = [_rows(S, m, False) for m in lv.members]
    A_l = [None] + [_rows(Ad_jp, lv.members[k], False) for k in range(1, nl)]

    def minv(x):
        u = _against(x)
        xp = _pad_q(topo, x)
        ax = xp.dim() - 2
        # Pass 2 (leaf -> root): Bhat, beta
        Bhat, beta = [None] * nl, [None] * nl
        for k in reversed(range(nl)):
            xl = _rows(xp, lv.members[k], True)
            Bh = torch.zeros_like(xl)
            if k + 1 < nl:
                Bh = Bh.index_add(ax, lv.ppos[k + 1], _mtv(u(A_l[k + 1]), beta[k + 1]))
            inner = _mv(u(Psi[k]), xl - _mtv(u(S_l[k]), Bh))
            Bhat[k], beta[k] = Bh, Bh + _mv(u(Ihat[k]), _mv(u(S_l[k]), inner))
        # Pass 3 (root -> leaf): y, Vdot
        ys, Vdots = [], []
        for k in range(nl):
            xl = _rows(xp, lv.members[k], True)
            tmp = (_mv(u(A_l[k]), _rows(Vdots[k - 1], lv.ppos[k], True)) if k
                   else torch.zeros_like(xl))
            SIt = _mtv(u(S_l[k]), _mv(u(Ihat[k]), tmp))
            y = _mv(u(Psi[k]), xl - SIt - _mtv(u(S_l[k]), Bhat[k]))
            ys.append(y)
            Vdots.append(_mv(u(S_l[k]), y) + tmp)
        return _unpad_q(topo, _join(ys, lv, True))

    return minv
