"""The few SE(3) operations the reference needs, batch-first.

A twist is [w; v] (angular first); Ad(E) = [[R, 0], [hat(p) R, R]];
ad(phi) = [[hat(w), 0], [hat(v), hat(w)]].
"""

import torch


def hat(w):
    """(..., 3) -> (..., 3, 3) skew matrix."""
    x, y, z = w.unbind(-1)
    o = torch.zeros_like(x)
    return torch.stack([o, -z, y, z, o, -x, -y, x, o], -1).reshape(*w.shape, 3)


def inv(E):
    """Inverse of (..., 4, 4) rigid transforms."""
    Rt = E[..., :3, :3].transpose(-1, -2)
    bottom = torch.zeros_like(E[..., 3:, :])
    bottom[..., 0, 3] = 1.0
    return torch.cat([torch.cat([Rt, -Rt @ E[..., :3, 3:]], -1), bottom], -2)


def Ad(E):
    """(..., 4, 4) -> (..., 6, 6)."""
    R = E[..., :3, :3]
    return torch.cat([torch.cat([R, torch.zeros_like(R)], -1),
                      torch.cat([hat(E[..., :3, 3]) @ R, R], -1)], -2)


def ad(phi):
    """(..., 6) -> (..., 6, 6)."""
    W, V = hat(phi[..., :3]), hat(phi[..., 3:])
    return torch.cat([torch.cat([W, torch.zeros_like(W)], -1), torch.cat([V, W], -1)], -2)


def rot_axis(axis, q):
    """Rotations [B, N, 3, 3] by angles q [B, N] about unit axes [N, 3]
    (Rodrigues)."""
    K = hat(axis)                                              # [N, 3, 3]
    s, c = torch.sin(q)[..., None, None], torch.cos(q)[..., None, None]
    I3 = torch.eye(3, dtype=q.dtype, device=q.device)
    return I3 + s * K + (1 - c) * (K @ K)
