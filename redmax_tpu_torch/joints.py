"""Per-joint-type kernels for the constant-S joint types.

FIXED, REVOLUTE, PRISMATIC, PLANAR and TRANSLATIONAL have a motion subspace
S that is constant in the joint frame, so Sdot = 0. Each type is given by its
local transform Q(q) (child-joint frame wrt parent-joint frame) in closed
form and its constant S. The q-dependent types (universal, spherical, free,
spline, composite) are ROADMAP queue 1 item 11.
"""

import torch

from redmax_tpu_torch import se3
from redmax_tpu_torch.types import JointType

CONSTANT_S_TYPES = (
    JointType.FIXED,
    JointType.REVOLUTE,
    JointType.PRISMATIC,
    JointType.PLANAR,
    JointType.TRANSLATIONAL,
)


def require_supported(jt: JointType) -> None:
    if jt not in CONSTANT_S_TYPES:
        raise NotImplementedError(
            f"joint type {jt.name}: only the constant-S types are ported "
            "(the q-dependent types are ROADMAP queue 1 item 11)"
        )


def _eye_E(q):
    """Identity transforms [..., G, 4, 4] for q [..., G, d]."""
    return torch.eye(4, dtype=q.dtype, device=q.device).expand(*q.shape[:-1], 4, 4)


def _translation_E(p):
    """[..., 3] translations -> pure-translation transforms [..., 4, 4]."""
    I3 = torch.eye(3, dtype=p.dtype, device=p.device).expand(*p.shape[:-1], 3, 3)
    return se3.make_E(I3, p)


def _Q_revolute(q, axis):
    """Rotation about the unit axis by q: R = c I + (1 - c) a a^T + s hat(a).

    Closed form (the fused kernel's, pallas_step.py fk_and_J); the axis is
    unit-normalised at scene build time. Smooth everywhere, including q = 0.
    """
    th = q[..., 0]
    c = torch.cos(th)[..., None, None]
    s = torch.sin(th)[..., None, None]
    aaT = axis[:, :, None] * axis[:, None, :]
    I3 = torch.eye(3, dtype=q.dtype, device=q.device)
    R = c * I3 + (1.0 - c) * aaT + s * se3.hat3(axis)
    return se3.make_E(R, torch.zeros(*R.shape[:-2], 3, dtype=q.dtype, device=q.device))


def joint_QSSdot(jt: JointType, q, qdot, params):
    """(Q [..., G, 4, 4], S [G, 6, d], Sdot [G, 6, d]) for a group of G
    joints of type jt; S is constant, so Sdot = 0.

    q, qdot: [..., G, d] (leading batch dims); params: per-type arrays [G, ...].
    """
    require_supported(jt)
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
