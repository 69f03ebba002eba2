"""Scene zoo: the scenes whose joints this package covers.

``scene_chain`` is the MPC benchmark scene (a 12-link revolute chain by
default) and ``scene_chain_ground`` the same chain with penalty ground
contact on every link (the differentiable-contact MPC scene);
``scene_00_serial_chain`` is the reference's scene 0, whose f64
trajectory dump gates the BDF2 step; ``scene_floor_chain`` is the contact-QP
benchmark scene (every joint limited, a floor sphere on every link). The
other scenes of the JAX package's zoo are ROADMAP queue 1 item 12.
"""

import math

import numpy as np

from redmax_tpu_torch.scene import SceneBuilder, transl
from redmax_tpu_torch.types import JointType


def scene_00_serial_chain() -> SceneBuilder:
    """scenesRedMax.m case 0: 5 cuboids, alternating revolute(y)/fixed."""
    b = SceneBuilder(name="Simple serial chain")
    b.Hexpected = {"bdf1": -1.2705398823489915e05, "bdf2": 2.6058008179021417e03}
    for i in range(5):
        body = b.body_cuboid(1.0, (10, 1, 1), E_ji=transl([5, 0, 0]))
        E_pj = np.eye(4) if i == 0 else transl([10, 0, 0])
        if i % 2 == 0:
            b.joint(
                JointType.REVOLUTE,
                None if i == 0 else i - 1,
                body,
                E_pj=E_pj,
                axis=(0, 1, 0),
                q=[math.pi / 4],
            )
        else:
            b.joint(JointType.FIXED, i - 1, body, E_pj=E_pj)
    return b


def scene_chain(
    nlinks: int = 12,
    link_len: float = 1.0,
    density: float = 1.0,
    stiffness: float = 0.0,
    damping: float = 1.0,
    h: float = 1e-2,
    tEnd: float = 0.5,
    grav=(0.0, 0.0, -980.0),
) -> SceneBuilder:
    """Parametric serial revolute chain (nlinks DOF), alternating y/z axes so
    the chain moves in 3D — the MPC benchmark scene."""
    b = SceneBuilder(name=f"chain-{nlinks}", h=h, tEnd=tEnd, grav=grav)
    sides = (link_len, 0.1 * link_len, 0.1 * link_len)
    for i in range(nlinks):
        body = b.body_cuboid(density, sides, E_ji=transl([link_len / 2, 0, 0]))
        axis = (0, 1, 0) if i % 2 == 0 else (0, 0, 1)
        j = b.joint(
            JointType.REVOLUTE,
            None if i == 0 else i - 1,
            body,
            E_pj=np.eye(4) if i == 0 else transl([link_len, 0, 0]),
            axis=axis,
        )
        if stiffness:
            b.set_stiffness(j, stiffness)
        if damping:
            b.set_damping(j, damping)
    return b


def scene_chain_ground(
    nlinks: int = 12,
    link_len: float = 1.0,
    density: float = 1.0,
    damping: float = 1.0,
    h: float = 1e-2,
    tEnd: float = 0.5,
    floor_z: float = None,
    kn: float = 1e4,
    kt: float = 1e2,
    kd: float = 3e1,
    mu: float = 0.5,
    contact_links=None,
) -> SceneBuilder:
    """scene_chain + penalty ground contact (ForceGroundCuboid) on every
    link: the differentiable-contact MPC scene (the role of matlab-diff
    scene 11, ForceGroundCuboid.m + scenesRedMax.m:290-311, composed with the
    chain generator). The floor plane is z-up at floor_z (default: 1.5 link
    lengths below the root, so a swinging chain strikes it mid-horizon).
    contact_links limits contact to a subset of link indices (default: all)."""
    b = scene_chain(nlinks=nlinks, link_len=link_len, density=density,
                    damping=damping, h=h, tEnd=tEnd)
    b.name = f"chain-ground-{nlinks}"
    if floor_z is None:
        floor_z = -1.5 * link_len
    E_g = np.eye(4)
    E_g[2, 3] = floor_z
    for i in (range(nlinks) if contact_links is None else contact_links):
        b.force_ground_cuboid(i, E_ground=E_g, kn=kn, kt=kt, kd=kd, mu=mu)
    return b


def scene_floor_chain(nlinks: int = 6, h: float = 1e-2) -> SceneBuilder:
    """Revolute chain (y axes, joint damping 1), every joint limited to
    +-0.6 pi and a floor sphere (radius 0.1) fixed at the middle of every
    link over a floor at z = -2: nlinks joint-limit rows plus nlinks floor
    rows for the contact QP. Links (joints 2i) and spheres (2i+1) interleave."""
    b = SceneBuilder(name=f"floor-chain-{nlinks}", h=h, tEnd=0.5, grav=(0.0, 0.0, -980.0))
    for i in range(nlinks):
        body = b.body_cuboid(1.0, (1.0, 0.1, 0.1), E_ji=transl([0.5, 0, 0]))
        j = b.joint(JointType.REVOLUTE, None if i == 0 else 2 * (i - 1), body,
                    E_pj=np.eye(4) if i == 0 else transl([1.0, 0, 0]), axis=(0, 1, 0))
        b.set_damping(j, 1.0)
        b.constraint_joint_limit(j, -0.6 * math.pi, 0.6 * math.pi)
        s = b.body_sphere(0.1, 0.1)
        b.joint(JointType.FIXED, j, s, E_pj=transl([0.5, 0, 0]))
        b.constraint_floor(s, E=transl([0, 0, -2.0]))
    return b
