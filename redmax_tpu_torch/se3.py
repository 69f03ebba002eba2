"""Batched SE(3)/se(3) operations (the subset forward kinematics, the
Jacobians, the constraint rows, the spline joints and the exporters use).

Conventions (those of the JAX package's se3.py):

  * A twist is phi = [w; v] in R^6, ANGULAR part first.
  * Homogeneous transforms E in R^{4x4}.
  * Adjoint     Ad(E)   = [[R, 0], [hat(p) R, R]]
  * Lie bracket ad(phi) = [[hat(w), 0], [hat(v), hat(w)]]

Every function takes arbitrary leading batch dimensions: an input of shape
(..., 4, 4) gives an output of shape (..., 6, 6) and so on.
"""

import torch

# exp_so3 switches to its Taylor series below theta^2 = 1e-8 (theta < 1e-4).
_T_SMALL = 1e-8


def hat3(w):
    """(..., 3) -> (..., 3, 3) skew-symmetric matrix."""
    z = torch.zeros_like(w[..., 0])
    return torch.stack(
        [
            torch.stack([z, -w[..., 2], w[..., 1]], dim=-1),
            torch.stack([w[..., 2], z, -w[..., 0]], dim=-1),
            torch.stack([-w[..., 1], w[..., 0], z], dim=-1),
        ],
        dim=-2,
    )


def _with_bottom_row(top):
    """Append the constant [0 0 0 1] row to a (..., 3, 4) block."""
    bottom = torch.zeros_like(top[..., :1, :])
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def make_E(R, p):
    """Assemble (..., 4, 4) from rotation (..., 3, 3) and translation (..., 3)."""
    return _with_bottom_row(torch.cat([R, p[..., None]], dim=-1))


def inv(E):
    """SE(3) inverse."""
    R = E[..., :3, :3]
    p = E[..., :3, 3:]
    Rt = R.transpose(-1, -2)
    return _with_bottom_row(torch.cat([Rt, -Rt @ p], dim=-1))


def Ad(E):
    """(..., 4, 4) -> (..., 6, 6) adjoint."""
    R = E[..., :3, :3]
    p = E[..., :3, 3]
    top = torch.cat([R, torch.zeros_like(R)], dim=-1)
    bottom = torch.cat([hat3(p) @ R, R], dim=-1)
    return torch.cat([top, bottom], dim=-2)


def ad(phi):
    """(..., 6) -> (..., 6, 6) spatial cross product."""
    W = hat3(phi[..., :3])
    V = hat3(phi[..., 3:])
    top = torch.cat([W, torch.zeros_like(W)], dim=-1)
    bottom = torch.cat([V, W], dim=-1)
    return torch.cat([top, bottom], dim=-2)


def Gamma(r):
    """(..., 3) -> (..., 3, 6) point-velocity matrix [hat(r)^T, I3]."""
    I3 = torch.eye(3, dtype=r.dtype, device=r.device).expand(*r.shape[:-1], 3, 3)
    return torch.cat([hat3(r).transpose(-1, -2), I3], dim=-1)


def exp_so3(w):
    """Rodrigues' formula: (..., 3) -> (..., 3, 3).

    The coefficients are smooth functions of t = |w|^2 (Taylor series below
    _T_SMALL), so the map and its derivatives stay finite at w = 0; the sqrt
    only sees t where t >= _T_SMALL.
    """
    t = (w * w).sum(-1)
    small = t < _T_SMALL
    ts = torch.where(small, torch.ones_like(t), t)
    th = torch.sqrt(ts)
    a = torch.where(small, 1.0 - t / 6.0 + t * t / 120.0, torch.sin(th) / th)
    b = torch.where(small, 0.5 - t / 24.0 + t * t / 720.0, (1.0 - torch.cos(th)) / ts)
    W = hat3(w)
    I3 = torch.eye(3, dtype=w.dtype, device=w.device)
    return I3 + a[..., None, None] * W + b[..., None, None] * (W @ W)


def unhat3(S):
    """(..., 3, 3) -> (..., 3): the vector of a skew-symmetric matrix."""
    return torch.stack([S[..., 2, 1], S[..., 0, 2], S[..., 1, 0]], dim=-1)


def _coefs(t):
    """(sin th / th, (1 - cos th)/th^2, (th - sin th)/th^3) of th^2 = t, with
    their Taylor series below _T_SMALL (the JAX package's _sinc_sq,
    _cosc_sq, _sincc_sq)."""
    small = t < _T_SMALL
    ts = torch.where(small, torch.ones_like(t), t)
    th = torch.sqrt(ts)
    sn = torch.sin(th)
    a = torch.where(small, 1.0 - t / 6.0 + t * t / 120.0, sn / th)
    b = torch.where(small, 0.5 - t / 24.0 + t * t / 720.0, (1.0 - torch.cos(th)) / ts)
    c = torch.where(small, 1.0 / 6.0 - t / 120.0 + t * t / 5040.0, (th - sn) / (ts * th))
    return a, b, c


def exp6(phi):
    """SE(3) exponential of twists (..., 6) -> (..., 4, 4): R = I + a W + b W^2,
    p = (I + b W + c W^2) v (the JAX package's se3.exp)."""
    w, v = phi[..., :3], phi[..., 3:]
    a, b, c = (x[..., None, None] for x in _coefs((w * w).sum(-1)))
    W = hat3(w)
    W2 = W @ W
    I3 = torch.eye(3, dtype=phi.dtype, device=phi.device)
    R = I3 + a * W + b * W2
    p = ((I3 + b * W + c * W2) @ v[..., None])[..., 0]
    return make_E(R, p)


def log6(E):
    """SE(3) logarithm (..., 4, 4) -> (..., 6) (the JAX package's se3.log):
    w from the skew part of R by atan2, v = V^-1 p."""
    R, p = E[..., :3, :3], E[..., :3, 3]
    u = unhat3(0.5 * (R - R.transpose(-1, -2)))
    s2 = (u * u).sum(-1)
    c = 0.5 * (R.diagonal(dim1=-2, dim2=-1).sum(-1) - 1.0)
    small = s2 < _T_SMALL
    s = torch.sqrt(torch.where(small, torch.ones_like(s2), s2))
    scale = torch.where(small, 1.0 + s2 / 6.0 + 0.075 * s2 * s2, torch.atan2(s, c) / s)
    w = scale[..., None] * u
    t = (w * w).sum(-1)
    small = t < _T_SMALL
    ts = torch.where(small, torch.ones_like(t), t)
    a, b, _ = _coefs(ts)
    coef = torch.where(small, 1.0 / 12.0 + t / 720.0, (1.0 - a / (2.0 * b)) / ts)
    W = hat3(w)
    I3 = torch.eye(3, dtype=E.dtype, device=E.device)
    Vinv = I3 - 0.5 * W + coef[..., None, None] * (W @ W)
    return torch.cat([w, (Vinv @ p[..., None])[..., 0]], dim=-1)


def mat_to_q(R):
    """(..., 3, 3) rotation -> (..., 4) quaternion [w x y z], branchless: all
    four Shepperd candidates evaluated, the best selected by mask (the JAX
    package's mat_to_q; the reference's se3.matToQ, se3.m:202, branches and
    agrees up to the sign convention)."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def safe_sqrt(x):
        return torch.sqrt(torch.clamp_min(x, 1e-30))

    S0 = safe_sqrt(tr + 1.0) * 2
    q0 = torch.stack([0.25 * S0, (m21 - m12) / S0, (m02 - m20) / S0, (m10 - m01) / S0], dim=-1)
    S1 = safe_sqrt(1.0 + m00 - m11 - m22) * 2
    q1 = torch.stack([(m21 - m12) / S1, 0.25 * S1, (m01 + m10) / S1, (m02 + m20) / S1], dim=-1)
    S2 = safe_sqrt(1.0 + m11 - m00 - m22) * 2
    q2 = torch.stack([(m02 - m20) / S2, (m01 + m10) / S2, 0.25 * S2, (m12 + m21) / S2], dim=-1)
    S3 = safe_sqrt(1.0 + m22 - m00 - m11) * 2
    q3 = torch.stack([(m10 - m01) / S3, (m02 + m20) / S3, (m12 + m21) / S3, 0.25 * S3], dim=-1)
    use0 = tr > 0
    use1 = (m00 > m11) & (m00 > m22) & ~use0
    use2 = (m11 > m22) & ~((m00 > m11) & (m00 > m22)) & ~use0
    return torch.where(use0[..., None], q0, torch.where(
        use1[..., None], q1, torch.where(use2[..., None], q2, q3)))
