"""Per-joint-type kernels, batch-first over [..., G, d].

Each type is given by its local transform Q(q) (child-joint frame wrt
parent-joint frame), its motion subspace S(q) and Sdot = (dS/dq) qdot, all in
closed form. FIXED, REVOLUTE, PRISMATIC, PLANAR and TRANSLATIONAL have a
constant S (Sdot = 0). UNIVERSAL (R = Rx(q0) Ry(q1)), SPHERICAL (exp-map ball
joint, R = exp(hat(q)), S = [Jr(q); 0] with Jr the SO(3) right Jacobian),
FREE3D (translation q[0:3] then an exp-map ball joint q[3:6]) and FREE2D
(planar x, y, theta) have an S that moves with q. The JAX package takes
jax.jvp of S for their Sdot; here it is written out, each coefficient with
the Taylor branch of the function it differentiates, so both agree to
roundoff. SPHERICAL and FREE3D carry the post-step exp-map rescale
(joint_reparam). SPHERICAL_EULER (R from the joint's Euler chart,
S = [T; 0]) and FREE3D_EULER (translation q[0:3] then an Euler-chart ball
joint q[3:6]) read their per-lane chart index from params["chart"]
(euler.py; the chart switch after each step is model.reparam_all's), with
Sdot in closed form too. FREE_ST (R = exp(hat(q[0:3])), the translation
q[3:6] in the rotated frame) and COMPOSITE_RP (a revolute then a prismatic
joint) have closed-form S and Sdot. The spline joints (SPLINE_CURVE, a
cyclic cubic B-spline of control frames; SPLINE_SURFACE, a bicubic patch of
six basis motions) and make_composite (any two joints in series) are
products of exponentials Q = C exp(xi_1 phi_1(q)) ... exp(xi_n phi_n(q)),
whose S and Sdot follow in closed form from the factors (_poe): the JAX
package takes them by jacfwd and jax.jvp of Q.
"""

import math
from functools import lru_cache

import numpy as np
import torch

from redmax_tpu_torch import euler, se3
from redmax_tpu_torch.types import NDOF, JointType

CONSTANT_S_TYPES = (
    JointType.FIXED,
    JointType.REVOLUTE,
    JointType.PRISMATIC,
    JointType.PLANAR,
    JointType.TRANSLATIONAL,
)
# Exp-map rotation DOFs of the joints with a post-step rescale: q[slice].
EXP_ROTATION = {JointType.SPHERICAL: slice(0, 3), JointType.FREE3D: slice(3, 6),
                JointType.FREE_ST: slice(0, 3)}


def _eye_E(q):
    """Identity transforms [..., G, 4, 4] for q [..., G, d]."""
    return torch.eye(4, dtype=q.dtype, device=q.device).expand(*q.shape[:-1], 4, 4)


def _translation_E(p):
    """[..., 3] translations -> pure-translation transforms [..., 4, 4]."""
    I3 = torch.eye(3, dtype=p.dtype, device=p.device).expand(*p.shape[:-1], 3, 3)
    return se3.make_E(I3, p)


def _rotation_E(R):
    return se3.make_E(R, torch.zeros(*R.shape[:-2], 3, dtype=R.dtype, device=R.device))


def _Q_revolute(q, axis):
    """Rotation about the axis by q: R = exp(hat(a q)) (JointRevolute.m:29).

    The axis is unit-normalised at scene build time, where this equals the
    fused kernel's closed form c I + (1 - c) a a^T + s hat(a); the
    exponential itself, as the JAX package takes it, also gives its gradient
    into the axis (params["joint"]), the component along a included. Smooth
    everywhere, including q = 0.
    """
    return _rotation_E(se3.exp_so3(axis * q))


def _cols(*cols):
    """Columns [..., 6] -> S [..., 6, d]."""
    return torch.stack(cols, dim=-1)


def _sqrt_clamped(s):
    """(sg, sqrt(sg)) with sg = max(s, 1e-12): the closed forms' argument."""
    sg = torch.clamp(s, min=1e-12)
    return sg, torch.sqrt(sg)


def so3_right_jacobian(r):
    """Jr(r) = I - a(s) W + b(s) W^2 [..., 3, 3], s = |r|^2, W = hat(r),
    a = (1 - cos t)/t^2, b = (t - sin t)/t^3 (t = |r|), Taylor below s = 0.04:
    the exp-map S (redmax_tpu/joints.py::so3_right_jacobian)."""
    return _right_jacobian_and_dot(r, None)[0]


def _right_jacobian_and_dot(r, rd):
    """(Jr(r), dJr/dr . rd) [..., 3, 3]; the second is None without rd. The
    derivative differentiates each branch of a and b: the closed forms'
    a' = (t sin t / 2 - (1 - cos t)) / s^2,
    b' = ((1 - cos t) t - 3 (t - sin t)) / (2 s^2 t) above s = 0.04, the
    Taylor polynomials' own derivatives below (jax.jvp of the JAX S)."""
    s = (r * r).sum(-1)
    sg, th = _sqrt_clamped(s)
    small = s < 0.04
    sn, cs = torch.sin(th), torch.cos(th)
    a = torch.where(small, 0.5 - s / 24.0 + s * s / 720.0, (1.0 - cs) / sg)
    b = torch.where(small, 1.0 / 6.0 - s / 120.0 + s * s / 5040.0, (th - sn) / (sg * th))
    W = se3.hat3(r)
    W2 = W @ W
    I3 = torch.eye(3, dtype=r.dtype, device=r.device)
    Jr = I3 - a[..., None, None] * W + b[..., None, None] * W2
    if rd is None:
        return Jr, None
    ap = torch.where(small, -1.0 / 24.0 + s / 360.0,
                     (0.5 * th * sn - (1.0 - cs)) / (sg * sg))
    bp = torch.where(small, -1.0 / 120.0 + s / 2520.0,
                     ((1.0 - cs) * th - 3.0 * (th - sn)) / (2.0 * sg * sg * th))
    sd = (2.0 * (r * rd).sum(-1))[..., None, None]
    Wd = se3.hat3(rd)
    dJr = (-(ap[..., None, None] * sd) * W - a[..., None, None] * Wd
           + (bp[..., None, None] * sd) * W2 + b[..., None, None] * (Wd @ W + W @ Wd))
    return Jr, dJr


def so3_right_jacobian_inv(r):
    """Jr(r)^-1 = I + W/2 + d(s) W^2, d = (1 - (t/2) cot(t/2)) / s, with the
    Taylor d = 1/12 + s/720 + s^2/30240 + s^3/1209600 below s < 1 in float32
    and s < 0.04 in float64 (the closed form cancels; float32 wants the wide
    branch). Valid for t < 2 pi; the reparam keeps t <= 1.5 pi."""
    s = (r * r).sum(-1)
    sg, th = _sqrt_clamped(s)
    half = 0.5 * th
    small = s < (1.0 if r.dtype == torch.float32 else 0.04)
    sn = torch.where(small, torch.ones_like(s), torch.sin(half))
    d = torch.where(small, 1.0 / 12.0 + s / 720.0 + s * s / 30240.0 + s * s * s / 1209600.0,
                    (1.0 - half * torch.cos(half) / sn) / sg)
    W = se3.hat3(r)
    I3 = torch.eye(3, dtype=r.dtype, device=r.device)
    return I3 + 0.5 * W + d[..., None, None] * (W @ W)


def exp_so3_and_dot(w, wd):
    """(R, dR/dw . wd) [..., 3, 3] of se3.exp_so3: R = I + A W + C W^2 with
    A = sin t / t, C = (1 - cos t)/t^2 (Taylor below t^2 = 1e-8), and
    dR = A' sd W + A Wd + C' sd W^2 + C (Wd W + W Wd), sd = 2 w.wd."""
    t = (w * w).sum(-1)
    small = t < se3._T_SMALL
    ts = torch.where(small, torch.ones_like(t), t)
    th = torch.sqrt(ts)
    sn, cs = torch.sin(th), torch.cos(th)
    A = torch.where(small, 1.0 - t / 6.0 + t * t / 120.0, sn / th)
    C = torch.where(small, 0.5 - t / 24.0 + t * t / 720.0, (1.0 - cs) / ts)
    Ap = torch.where(small, -1.0 / 6.0 + t / 60.0, (th * cs - sn) / (2.0 * ts * th))
    Cp = torch.where(small, -1.0 / 24.0 + t / 360.0, (0.5 * th * sn - (1.0 - cs)) / (ts * ts))
    W, Wd = se3.hat3(w), se3.hat3(wd)
    W2 = W @ W
    sd = (2.0 * (w * wd).sum(-1))[..., None, None]
    I3 = torch.eye(3, dtype=w.dtype, device=w.device)
    R = I3 + A[..., None, None] * W + C[..., None, None] * W2
    dR = ((Ap[..., None, None] * sd) * W + A[..., None, None] * Wd
          + (Cp[..., None, None] * sd) * W2 + C[..., None, None] * (Wd @ W + W @ Wd))
    return R, dR


def _rot_cols(M):
    """[..., 3, 3] -> the columns [M[:, k]; 0] as [..., 6, 3]."""
    return torch.cat([M, torch.zeros_like(M)], dim=-2)


def _universal(q, qdot):
    """R = Rx(q0) Ry(q1); S = [[c1, 0, s1; 0], [ey; 0]]; only column 0 moves,
    Sdot[:, 0] = [-s1, 0, c1; 0] qdot1 (redmax_tpu/joints.py::_S_universal)."""
    c0, s0 = torch.cos(q[..., 0]), torch.sin(q[..., 0])
    c1, s1 = torch.cos(q[..., 1]), torch.sin(q[..., 1])
    z, one = torch.zeros_like(c0), torch.ones_like(c0)
    R = torch.stack([
        torch.stack([c1, z, s1], dim=-1),
        torch.stack([s0 * s1, c0, -s0 * c1], dim=-1),
        torch.stack([-c0 * s1, s0, c0 * c1], dim=-1),
    ], dim=-2)
    S = _cols(torch.stack([c1, z, s1, z, z, z], dim=-1), torch.stack([z, one, z, z, z, z], dim=-1))
    qd1 = qdot[..., 1]
    Sdot = _cols(torch.stack([-s1 * qd1, z, c1 * qd1, z, z, z], dim=-1),
                 torch.stack([z, z, z, z, z, z], dim=-1))
    return _rotation_E(R), S, Sdot


def _spherical(q, qdot):
    """R = exp(hat(q)), S = [Jr(q); 0], Sdot = [dJr; 0]."""
    Jr, dJr = _right_jacobian_and_dot(q, qdot)
    return _rotation_E(se3.exp_so3(q)), _rot_cols(Jr), _rot_cols(dJr)


def _free3d(q, qdot):
    """Q = [exp(hat(r)) | p], p = q[0:3], r = q[3:6]: translation columns
    [0; R^T e_k] (Sdot: [0; dR^T e_k]), rotation columns those of SPHERICAL."""
    r, rd = q[..., 3:6], qdot[..., 3:6]
    R, dR = exp_so3_and_dot(r, rd)
    Jr, dJr = _right_jacobian_and_dot(r, rd)
    trans = torch.cat([torch.zeros_like(R), R.transpose(-1, -2)], dim=-2)
    dtrans = torch.cat([torch.zeros_like(dR), dR.transpose(-1, -2)], dim=-2)
    S = torch.cat([trans, _rot_cols(Jr)], dim=-1)
    Sdot = torch.cat([dtrans, _rot_cols(dJr)], dim=-1)
    return se3.make_E(R, q[..., 0:3]), S, Sdot


def _free2d(q, qdot):
    """Q = [Rz(th) | (x, y, 0)]: columns [0; Rz^T ex], [0; Rz^T ey], [ez; 0];
    the first two turn with th: Sdot = d/dth of them times thdot."""
    c, s = torch.cos(q[..., 2]), torch.sin(q[..., 2])
    z, one = torch.zeros_like(c), torch.ones_like(c)
    R = torch.stack([
        torch.stack([c, -s, z], dim=-1),
        torch.stack([s, c, z], dim=-1),
        torch.stack([z, z, one], dim=-1),
    ], dim=-2)
    p = torch.stack([q[..., 0], q[..., 1], z], dim=-1)
    S = _cols(torch.stack([z, z, z, c, -s, z], dim=-1), torch.stack([z, z, z, s, c, z], dim=-1),
              torch.stack([z, z, one, z, z, z], dim=-1))
    thd = qdot[..., 2]
    Sdot = _cols(torch.stack([z, z, z, -s * thd, -c * thd, z], dim=-1),
                 torch.stack([z, z, z, c * thd, -s * thd, z], dim=-1),
                 torch.stack([z, z, z, z, z, z], dim=-1))
    return se3.make_E(R, p), S, Sdot


def _spherical_euler(q, qdot, chart):
    """R = euler_R(chart, q), S = [T; 0], Sdot = [Tdot; 0]
    (redmax_tpu/joints.py::_S_spherical_euler, its jax.jvp in closed form)."""
    T, Tdot = euler.euler_T_and_dot(chart, q, qdot)
    return _rotation_E(euler.euler_R(chart, q)), _rot_cols(T), _rot_cols(Tdot)


def _free3d_euler(q, qdot, chart):
    """Q = [euler_R(chart, r) | p], p = q[0:3], r = q[3:6]: translation
    columns [0; R^T e_k] with d(R^T)/dt = -hat(w) R^T, w = T rdot the body
    angular velocity; rotation columns those of SPHERICAL_EULER."""
    r, rd = q[..., 3:6], qdot[..., 3:6]
    R = euler.euler_R(chart, r)
    T, Tdot = euler.euler_T_and_dot(chart, r, rd)
    Rt = R.transpose(-1, -2)
    dRt = -se3.hat3((T @ rd[..., None])[..., 0]) @ Rt
    S = torch.cat([torch.cat([torch.zeros_like(Rt), Rt], dim=-2), _rot_cols(T)], dim=-1)
    Sdot = torch.cat([torch.cat([torch.zeros_like(dRt), dRt], dim=-2), _rot_cols(Tdot)], dim=-1)
    return se3.make_E(R, q[..., 0:3]), S, Sdot


def _free_st(q, qdot):
    """Q = [R | R p], R = exp(hat(r)), r = q[0:3], p = q[3:6] (the
    translation acts in the rotated frame): rotation columns
    [Jr; -hat(p) Jr], translation columns [0; I]; Sdot's rotation columns
    [dJr; -hat(pdot) Jr - hat(p) dJr] (redmax_tpu/joints.py::_S_free_st)."""
    r, p = q[..., 0:3], q[..., 3:6]
    Jr, dJr = _right_jacobian_and_dot(r, qdot[..., 0:3])
    R = se3.exp_so3(r)
    hp = se3.hat3(p)
    I3 = torch.eye(3, dtype=q.dtype, device=q.device).expand_as(Jr)
    Z = torch.zeros_like(Jr)
    S = torch.cat([torch.cat([Jr, -hp @ Jr], dim=-2), torch.cat([Z, I3], dim=-2)], dim=-1)
    dS = torch.cat([dJr, -se3.hat3(qdot[..., 3:6]) @ Jr - hp @ dJr], dim=-2)
    Sdot = torch.cat([dS, torch.cat([Z, Z], dim=-2)], dim=-1)
    return se3.make_E(R, (R @ p[..., None])[..., 0]), S, Sdot


def _composite_rp(q, qdot, params):
    """A revolute joint (axis1) then a prismatic one (axis2): Q = [R1 | R1 a2 q1],
    S = [[a1; -q1 (a2 x a1)], [0; a2]], only the first column moving."""
    a1, a2 = params["axis1"], params["axis2"]                    # [G, 3]
    R = se3.exp_so3(a1 * q[..., 0:1])
    t = (R @ (a2 * q[..., 1:2])[..., None])[..., 0]
    c = torch.linalg.cross(a2, a1).expand_as(t)
    z = torch.zeros_like(t)
    S = _cols(torch.cat([a1.expand_as(t), -q[..., 1:2] * c], dim=-1),
              torch.cat([z, a2.expand_as(t)], dim=-1))
    Sdot = _cols(torch.cat([z, -qdot[..., 1:2] * c], dim=-1), torch.cat([z, z], dim=-1))
    return se3.make_E(R, t), S, Sdot


def _poe(C, xi, phi, dphi, dphid, qdot):
    """(Q, S, Sdot) of a product of exponentials Q = C E_1 ... E_n,
    E_i = exp(xi_i phi_i(q)), C constant in q: C [..., 4, 4], the unit
    twists xi [..., n, 6], phi [..., n], dphi [..., n, d] = dphi_i/dq_k,
    dphid [..., n, d] = its time derivative, qdot [..., d]. With
    R_i = E_{i+1} ... E_n and a_i = Ad(R_i^-1) xi_i,
        S_k = sum_i dphi_ik a_i,
        Sdot_k = sum_i dphid_ik a_i - dphi_ik ad(sig_i) a_i,
    where sig_i = sum_{j>i} phidot_j a_j is R_i's body velocity
    (d/dt Ad(R_i^-1) = -ad(sig_i) Ad(R_i^-1))."""
    n = xi.shape[-2]
    E = se3.exp6(xi * phi[..., None])                            # [..., n, 4, 4]
    Q = C
    for i in range(n):
        Q = Q @ E[..., i, :, :]
    phidot = (dphi * qdot[..., None, :]).sum(-1)                 # [..., n]
    S = Sdot = sig = Rinv = None
    for i in reversed(range(n)):
        a = xi[..., i, :] if Rinv is None else (se3.Ad(Rinv) @ xi[..., i, :, None])[..., 0]
        Si = a[..., :, None] * dphi[..., i, None, :]
        Sdi = a[..., :, None] * dphid[..., i, None, :]
        if sig is not None:
            Sdi = Sdi - (se3.ad(sig) @ a[..., None]) * dphi[..., i, None, :]
        S, Sdot = (Si, Sdi) if S is None else (S + Si, Sdot + Sdi)
        v = phidot[..., i, None] * a
        sig = v if sig is None else sig + v
        Einv = se3.inv(E[..., i, :, :])
        Rinv = Einv if Rinv is None else Rinv @ Einv
    return Q, S, Sdot


# The cubic B-spline coefficient matrix (JointSplineCurve.m:15-20) and the
# row sums of its rows i-1.. for i = 2, 3, 4 (Btilde_i, :187-201).
_BSPLINE = (np.array([[1, -3, 3, -1], [4, 0, -6, 3], [1, 3, 3, -3], [0, 0, 0, 1]],
                     dtype=np.float64) / 6.0)
_BSUM = np.stack([_BSPLINE[i - 1:].sum(axis=0) for i in (2, 3, 4)])   # [3, 4]
# The surface joint's basis twists, columns of JointSplineSurface's E
# (Eq. 25): translations along x, y, z, then rotations about x, y, z.
_SURF_XI = np.concatenate([np.eye(6)[3:], np.eye(6)[:3]])             # [6 factors, 6]


def _powers(x):
    """([1, x, x^2, x^3], its first and second derivatives) [..., 4] each."""
    o, z = torch.ones_like(x), torch.zeros_like(x)
    return (torch.stack([o, x, x * x, x * x * x], dim=-1),
            torch.stack([z, o, 2.0 * x, 3.0 * x * x], dim=-1),
            torch.stack([z, z, 2.0 * o, 6.0 * x], dim=-1))


_TABLES = {"bsum": _BSUM, "bspline": _BSPLINE, "surf_xi": _SURF_XI}


@lru_cache(maxsize=None)
def _table(name: str, dtype, device):
    """One of the constant tables as a tensor, made once per (dtype, device):
    no host-to-device copy after the first call."""
    return torch.as_tensor(_TABLES[name], dtype=dtype, device=device)


def _const(name, like):
    return _table(name, like.dtype, like.device)


def _spline_curve(q, qdot, params):
    """JointSplineCurve (matlab/+redmax/JointSplineCurve.m:112-139): the
    cyclic cubic B-spline of ncfs control frames Cs with relative twists
    dCs. With qq = q mod ncfs (a Python-style remainder, as jnp.mod),
    cell k = clip(floor(qq), 0, ncfs - 1) and u = qq - k:
        Q = Cs[k] prod_{i=2..4} exp(dCs[(k + i - 1) mod ncfs] Btilde_i(u)),
    floor being constant inside a cell (du/dq = 1)."""
    Cs, dCs = params["Cs"], params["dCs"]                        # [G, ncfs, 4, 4], [G, ncfs, 6]
    ncfs = Cs.shape[-3]
    qq = torch.remainder(q[..., 0], ncfs)
    k = torch.clamp(torch.floor(qq), 0, ncfs - 1)
    u = qq - k
    k = k.long()
    g = torch.arange(Cs.shape[0], device=q.device)
    ki = torch.remainder(k[..., None] + torch.arange(1, 4, device=q.device), ncfs)
    xi = dCs[g[:, None], ki]                                     # [..., G, 3, 6]
    bs = _const("bsum", q)
    p0, p1, p2 = (torch.einsum("ij,...j->...i", bs, x) for x in _powers(u))
    qd = qdot[..., 0, None]
    return _poe(Cs[g, k], xi, p0, p1[..., None], (p2 * qd)[..., None], qdot)


def _spline_surface(q, qdot, params):
    """JointSplineSurface (matlab/+redmax/JointSplineSurface.m:85-95): a
    4x4 patch of control values cs [G, 4, 4, 6]: Q = prod_{i=1..6}
    exp(e_i phi_i), phi_i = (B v(q2))^T cs[..., i] (B v(q1)), v(x) = [1, x,
    x^2, x^3], e_i the basis twists."""
    cs = params["cs"]
    Bm = _const("bspline", q)
    v1, d1, dd1 = (x @ Bm.T for x in _powers(q[..., 0]))         # B v(q1) and derivatives
    v2, d2, dd2 = (x @ Bm.T for x in _powers(q[..., 1]))
    form = lambda l, r: torch.einsum("...a,...abi,...b->...i", l, cs, r)   # [..., G, 6]
    phi = form(v2, v1)
    dphi = torch.stack([form(v2, d1), form(d2, v1)], dim=-1)                # [..., G, 6, 2]
    qd1, qd2 = qdot[..., 0, None], qdot[..., 1, None]
    f12 = form(d2, d1)
    dphid = torch.stack([form(v2, dd1) * qd1 + f12 * qd2,
                         f12 * qd1 + form(dd2, v1) * qd2], dim=-1)
    xi = _const("surf_xi", q).expand(*phi.shape, 6)
    C = torch.eye(4, dtype=q.dtype, device=q.device).expand(*q.shape[:-1], 4, 4)
    return _poe(C, xi, phi, dphi, dphid, qdot)


# S(q) in closed form from q alone, per lane [..., G, 6, d]; FREE2D and FREE_ST
# have no kernel branch (op level only).
_QDEP = {JointType.UNIVERSAL: _universal, JointType.SPHERICAL: _spherical,
         JointType.FREE3D: _free3d, JointType.FREE2D: _free2d, JointType.FREE_ST: _free_st}
# S(q) on the joint's Euler chart (params["chart"], per lane).
_EULER = {JointType.SPHERICAL_EULER: _spherical_euler, JointType.FREE3D_EULER: _free3d_euler}
# S(q) in closed form from q and the joint's own params, per lane.
_PARAM_QDEP = {JointType.COMPOSITE_RP: _composite_rp, JointType.SPLINE_CURVE: _spline_curve,
               JointType.SPLINE_SURFACE: _spline_surface}


def joint_QSSdot(jt: JointType, q, qdot, params):
    """(Q [..., G, 4, 4], S, Sdot) for a group of G joints of type jt: S and
    Sdot are [G, 6, d] for the constant-S types (Sdot = 0) and
    [..., G, 6, d] for the q-dependent ones.

    q, qdot: [..., G, d] (leading batch dims); params: per-type arrays [G, ...],
    and for the Euler-chart types params["chart"], the int64 chart index
    [..., G] of each joint and lane.
    """
    if jt in _QDEP:
        return _QDEP[jt](q, qdot)
    if jt in _PARAM_QDEP:
        return _PARAM_QDEP[jt](q, qdot, params)
    if jt in _EULER:
        return _EULER[jt](q, qdot, params["chart"])
    G = q.shape[-2]
    dtype, device = q.dtype, q.device
    if jt == JointType.FIXED:
        Q, S = _eye_E(q), torch.zeros(G, 6, 0, dtype=dtype, device=device)
    elif jt == JointType.REVOLUTE:
        a = params["axis"]
        Q, S = _Q_revolute(q, a), torch.cat([a, torch.zeros_like(a)], dim=-1)[:, :, None]
    elif jt == JointType.PRISMATIC:
        a = params["axis"]
        Q, S = _translation_E(a * q), torch.cat([torch.zeros_like(a), a], dim=-1)[:, :, None]
    elif jt == JointType.PLANAR:
        Bp = params["plane"]                                   # [G, 3, 2]
        Q = _translation_E(torch.einsum("gkd,...gd->...gk", Bp, q))
        S = torch.cat([torch.zeros_like(Bp), Bp], dim=-2)
    else:  # TRANSLATIONAL
        I3 = torch.eye(3, dtype=dtype, device=device).expand(G, 3, 3)
        Q, S = _translation_E(q), torch.cat([torch.zeros_like(I3), I3], dim=-2)
    return Q, S, torch.zeros_like(S)


def make_composite(jt1: JointType, jt2: JointType):
    """Two joints in series as one (matlab/+redmax/JointComposite.m:38-72):
    a function (q, qdot, params) -> (Q, S, Sdot) over [..., G, d1 + d2],
    params {"p1": the first joint's params, "p2": the second's}, with
    Q = Q1 Q2, S = [Ad(Q2^-1) S1, S2] and
    Sdot = [Ad(Q2^-1) S1dot - ad(S2 qdot2) Ad(Q2^-1) S1, S2dot].
    Scenes build such a joint as two joints with a massless link between
    them (SceneBuilder.joint_composite)."""
    n1 = NDOF[jt1]

    def qssdot(q, qdot, params):
        Q1, S1, Sd1 = joint_QSSdot(jt1, q[..., :n1], qdot[..., :n1], params.get("p1", {}))
        Q2, S2, Sd2 = joint_QSSdot(jt2, q[..., n1:], qdot[..., n1:], params.get("p2", {}))
        A = se3.Ad(se3.inv(Q2))
        sig = (S2 @ qdot[..., n1:, None])[..., 0]
        AS1 = A @ S1
        S2, Sd2 = S2.expand(*AS1.shape[:-1], S2.shape[-1]), Sd2.expand(*AS1.shape[:-1], S2.shape[-1])
        return (Q1 @ Q2, torch.cat([AS1, S2], dim=-1),
                torch.cat([A @ Sd1 - se3.ad(sig) @ AS1, Sd2], dim=-1))

    return qssdot


def reparam_exp(w):
    """If |w| > 1.5 pi, w -> (1 - 2 pi/|w|) w (the same rotation), applied
    twice, branch-free; grad-safe at w = 0 (redmax_tpu/se3.py::reparam_exp)."""
    def once(w):
        n2 = (w * w).sum(-1, keepdim=True)
        n = torch.sqrt(torch.where(n2 < 1.0, torch.ones_like(n2), n2))
        return torch.where(n2 > (1.5 * math.pi) ** 2, (1.0 - 2.0 * math.pi / n) * w, w)

    return once(once(w))


def joint_reparam(jt: JointType, q, qdot):
    """Post-step reparameterization of a group [..., G, d] of joints of type
    jt: the exp-map rescale of SPHERICAL and FREE3D rotations, with
    rdot_new = Jr(r_new)^-1 Jr(r) rdot (the same body angular velocity) on
    the joints whose r changed; the identity for the other types."""
    rot = EXP_ROTATION.get(jt)
    if rot is None:
        return q, qdot
    r, rdot = q[..., rot], qdot[..., rot]
    r_new = reparam_exp(r)
    changed = ((r_new - r).abs() > 0).any(-1, keepdim=True)
    w = (so3_right_jacobian(r) @ rdot[..., None])
    rdot_new = torch.where(changed, (so3_right_jacobian_inv(r_new) @ w)[..., 0], rdot)
    return (torch.cat([q[..., :rot.start], r_new, q[..., rot.stop:]], dim=-1),
            torch.cat([qdot[..., :rot.start], rdot_new, qdot[..., rot.stop:]], dim=-1))
