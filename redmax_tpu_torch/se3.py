"""Batched SE(3)/se(3) operations (the subset forward kinematics, the
Jacobians and the constraint rows use).

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
