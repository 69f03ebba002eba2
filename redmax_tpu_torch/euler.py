"""The 12 Euler-angle charts of the ball joints, branchless and batch-first.

Each chart is R = R_a(q1) R_b(q2) R_c(q3) for an axis triple (a, b, c) of
the static 12-row table AXES (the reference's JointSpherical.m:4-17 order):
0 XYX, 1 XZX, 2 YZY, 3 YXY, 4 ZXZ, 5 ZYZ, 6 XYZ, 7 XZY, 8 YZX, 9 YXZ,
10 ZXY, 11 ZYX; the default chart is XYZ (6). The chart index is a per-lane
integer tensor (int64, one per joint), so every function gathers its axis
rows by index and selects with torch.where; none branches in Python on a
chart value. The angle extraction uses two closed forms:

  Tait-Bryan (a, b, c distinct), eps = parity of (a, b, c):
      beta  = asin(eps R[a, c])
      alpha = atan2(-eps R[b, c], R[c, c])
      gamma = atan2(-eps R[a, b], R[a, a])
  proper Euler (a == c), third axis n, eps = parity of (a, b, n):
      beta  = acos(R[a, a])
      alpha = atan2(R[b, a], -eps R[n, a])
      gamma = atan2(R[a, b],  eps R[a, n])

The body angular-velocity map is T = [Rc^T Rb^T e_a, Rc^T e_b, e_c] and its
time derivative follows from d(Rx^T)/dt = -qdot_x hat(e_x) Rx^T for each
axis factor. The port's own copy of redmax_tpu/euler.py (the tables
included).
"""

from functools import lru_cache

import numpy as np
import torch

from redmax_tpu_torch import se3

# Axis triples (a, b, c) per chart, axes x = 0, y = 1, z = 2.
AXES = np.array(
    [
        [0, 1, 0], [0, 2, 0], [1, 2, 1], [1, 0, 1], [2, 0, 2], [2, 1, 2],
        [0, 1, 2], [0, 2, 1], [1, 2, 0], [1, 0, 2], [2, 0, 1], [2, 1, 0],
    ],
    dtype=np.int64,
)
# The third axis of a proper-Euler chart (for a Tait-Bryan chart, c).
_THIRD = np.array([3 - (t[0] + t[1]) if t[0] == t[2] else t[2] for t in AXES])
_PROPER = np.array([t[0] == t[2] for t in AXES])


def _parity(a, b, c):
    return 1 if [a, b, c] in ([0, 1, 2], [1, 2, 0], [2, 0, 1]) else -1


# Parity eps of (a, b, c) for a Tait-Bryan chart, of (a, b, n) for a proper one.
EPS_SIGN = np.array(
    [_parity(t[0], t[1], int(_THIRD[i])) if _PROPER[i] else _parity(*t)
     for i, t in enumerate(AXES.tolist())],
    dtype=np.int64,
)
DEFAULT_CHART = 6  # XYZ
NCHARTS = len(AXES)


@lru_cache(maxsize=None)
def _tables(device: torch.device):
    """(AXES [12, 3], third [12], proper [12], eps [12]) on device, made once
    per device so that a step copies nothing from the host."""
    t = lambda a: torch.as_tensor(a, device=device)
    return t(AXES), t(_THIRD), t(_PROPER), t(EPS_SIGN)


def _unit(k, dtype):
    """The coordinate axes e_k [..., 3] for axis indices k [...]."""
    return torch.eye(3, dtype=dtype, device=k.device)[k]


def _axis_rot(e, theta):
    """Rotation by theta [...] about the unit coordinate axis e [..., 3]:
    exp(hat(e) theta) = cos I + sin hat(e) + (1 - cos) e e^T."""
    c, s = torch.cos(theta)[..., None, None], torch.sin(theta)[..., None, None]
    I3 = torch.eye(3, dtype=e.dtype, device=e.device)
    return c * I3 + s * se3.hat3(e) + (1.0 - c) * (e[..., :, None] * e[..., None, :])


def _axes_of(chart, dtype):
    t = _tables(chart.device)[0][chart]
    return _unit(t[..., 0], dtype), _unit(t[..., 1], dtype), _unit(t[..., 2], dtype)


def euler_R(chart, q):
    """R_a(q1) R_b(q2) R_c(q3) [..., 3, 3] for charts [...] and angles [..., 3]."""
    ea, eb, ec = _axes_of(chart, q.dtype)
    return _axis_rot(ea, q[..., 0]) @ _axis_rot(eb, q[..., 1]) @ _axis_rot(ec, q[..., 2])


def _mv(M, v):
    return (M @ v[..., None])[..., 0]


def euler_T_and_dot(chart, q, qdot=None):
    """(T, Tdot) [..., 3, 3]: T = [Rc^T Rb^T e_a, Rc^T e_b, e_c] (w_body =
    T qdot) and, with qdot, its time derivative
    Tdot = [-qd3 e_c x T_0 - qd2 Rc^T (e_b x Rb^T e_a), -qd3 e_c x T_1, 0];
    Tdot is None without qdot."""
    ea, eb, ec = _axes_of(chart, q.dtype)
    RbT = _axis_rot(eb, q[..., 1]).transpose(-1, -2)
    RcT = _axis_rot(ec, q[..., 2]).transpose(-1, -2)
    u = _mv(RbT, ea)
    t0, t1 = _mv(RcT, u), _mv(RcT, eb)
    T = torch.stack([t0, t1, ec], dim=-1)
    if qdot is None:
        return T, None
    qd2, qd3 = qdot[..., 1, None], qdot[..., 2, None]
    d0 = -qd3 * torch.linalg.cross(ec, t0) - qd2 * _mv(RcT, torch.linalg.cross(eb, u))
    d1 = -qd3 * torch.linalg.cross(ec, t1)
    return T, torch.stack([d0, d1, torch.zeros_like(d1)], dim=-1)


def euler_T(chart, q):
    """The chart's body angular-velocity map T [..., 3, 3] (euler_T_and_dot)."""
    return euler_T_and_dot(chart, q)[0]


def det3(A):
    """Determinants [...] of [..., 3, 3] matrices (cofactor expansion)."""
    return (A[..., 0, 0] * (A[..., 1, 1] * A[..., 2, 2] - A[..., 1, 2] * A[..., 2, 1])
            - A[..., 0, 1] * (A[..., 1, 0] * A[..., 2, 2] - A[..., 1, 2] * A[..., 2, 0])
            + A[..., 0, 2] * (A[..., 1, 0] * A[..., 2, 1] - A[..., 1, 1] * A[..., 2, 0]))


def euler_detT(chart, q):
    return det3(euler_T(chart, q))


def _solve3(A, b):
    """A^-1 b [..., 3] for [..., 3, 3] A (the adjugate over the determinant)."""
    c0 = torch.linalg.cross(A[..., :, 1], A[..., :, 2])
    c1 = torch.linalg.cross(A[..., :, 2], A[..., :, 0])
    c2 = torch.linalg.cross(A[..., :, 0], A[..., :, 1])
    adj = torch.stack([c0, c1, c2], dim=-2)   # rows: the adjugate's
    return _mv(adj, b) / (c0 * A[..., :, 0]).sum(-1)[..., None]


def _clip_unit(x):
    """x clipped to [-1, 1] with the gradient of jnp.clip: 1 inside and at a
    bound, 0 past it, applied as a product (so that asin' or acos' = inf at
    the bound gives NaN there past it, as in the JAX package)."""
    m = ((x >= -1.0) & (x <= 1.0)).to(x.dtype)
    return x * m + x.detach().clamp(-1.0, 1.0) * (1.0 - m)


def euler_inv_all(R):
    """Angles of R [..., 3, 3] in all 12 charts at once: [..., 12, 3], both
    closed forms over the chart table, selected per chart."""
    axes, third, proper, eps_i = _tables(R.device)
    a, b, c, n = axes[:, 0], axes[:, 1], axes[:, 2], third
    eps = eps_i.to(R.dtype)
    beta_tb = torch.asin(_clip_unit(eps * R[..., a, c]))
    alpha_tb = torch.atan2(-eps * R[..., b, c], R[..., c, c])
    gamma_tb = torch.atan2(-eps * R[..., a, b], R[..., a, a])
    beta_pe = torch.acos(_clip_unit(R[..., a, a]))
    alpha_pe = torch.atan2(R[..., b, a], -eps * R[..., n, a])
    gamma_pe = torch.atan2(R[..., a, b], eps * R[..., a, n])
    q_tb = torch.stack([alpha_tb, beta_tb, gamma_tb], dim=-1)
    q_pe = torch.stack([alpha_pe, beta_pe, gamma_pe], dim=-1)
    return torch.where(proper[:, None], q_pe, q_tb)


def _pick(q_all, chart):
    """q_all [..., 12, 3] at charts [...] -> [..., 3]."""
    return torch.gather(q_all, -2, chart[..., None, None].expand(*chart.shape, 1, 3))[..., 0, :]


def euler_inv(chart, R):
    """Angles of R [..., 3, 3] in charts [...] (the reference's getEulerInv)."""
    return _pick(euler_inv_all(R), chart)


def reparam_spherical(chart, q, qdot, q1, qdot1):
    """The chart switch (JointSpherical.reparam_, JointSpherical.m:63-103),
    per joint and lane: where |det T(chart, q)| <= 0.5, re-express the
    current and the previous rotation (q1, the BDF2 history) in the chart
    that maximizes min(|det T(R)|, |det T(R1)|) over the 12 charts, with
    qdot -> T_new^-1 T_old qdot and the same for qdot1. Both paths are
    computed and selected per lane. charts [...], angles [..., 3]; returns
    (chart', q', qdot', q1', qdot1')."""
    T_old = euler_T(chart, q)
    keep = det3(T_old).abs() > 0.5
    q_all = euler_inv_all(euler_R(chart, q))
    q1_all = euler_inv_all(euler_R(chart, q1))
    every = torch.arange(NCHARTS, device=chart.device).expand(*chart.shape, NCHARTS)
    score = torch.minimum(torch.nan_to_num(euler_detT(every, q_all).abs()),
                          torch.nan_to_num(euler_detT(every, q1_all).abs()))
    new = score.argmax(-1)
    q_new, q1_new = _pick(q_all, new), _pick(q1_all, new)
    qdot_new = _solve3(euler_T(new, q_new), _mv(T_old, qdot))
    qdot1_new = _solve3(euler_T(new, q1_new), _mv(euler_T(chart, q1), qdot1))
    k3 = keep[..., None]
    return (torch.where(keep, chart, new), torch.where(k3, q, q_new),
            torch.where(k3, qdot, qdot_new), torch.where(k3, q1, q1_new),
            torch.where(k3, qdot1, qdot1_new))
