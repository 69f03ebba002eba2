"""Scene zoo: the scenes whose joints this package covers.

``scene_chain`` is the MPC benchmark scene (a 12-link revolute chain by
default), ``scene_chain_ground`` the same chain with penalty ground
contact on every link (the differentiable-contact MPC scene) and
``scene_spring_chain`` the same chain with three spring closures (the
spring-MPC scene); ``scene_00_serial_chain``, ``scene_10_loop``,
``scene_12_spring_damper`` and ``scene_13_cables`` are the reference's
scenes 0, 10, 12 and 13, whose f64 trajectory dumps gate the BDF2 step;
``scene_floor_chain`` is the contact-QP benchmark scene (every joint
limited, a floor sphere on every link). The other scenes of the JAX
package's zoo are ROADMAP queue 1 item 12.
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


def scene_10_loop() -> SceneBuilder:
    """scenesRedMax.m case 10: a four-bar-style loop closed by a stiff
    ForcePointPoint (k = 1e7)."""
    b = SceneBuilder(name="Loop")
    b.Hexpected = {"bdf1": 1.2376477982839792e03, "bdf2": 4.1146190850293169e03}
    sides = [(20, 1, 1), (1, 1, 10), (1, 1, 10), (20, 1, 1), (1, 1, 10)]
    E_ji = [np.eye(4), transl([0, 0, -5]), transl([0, 0, -5]), transl([10, 0, 0]),
            transl([0, 0, -5])]
    E_pj = [np.eye(4), transl([-10, 0, 0]), transl([10, 0, 0]), transl([0, 0, -10]),
            transl([10, 0, 0])]
    parents = [None, 0, 0, 1, 3]
    for i in range(5):
        body = b.body_cuboid(1.0, sides[i], E_ji=E_ji[i])
        if i == 0:
            b.joint(JointType.FIXED, None, body, E_pj=E_pj[i])
        else:
            b.joint(JointType.REVOLUTE, parents[i], body, E_pj=E_pj[i], axis=(0, 1, 0),
                    qdot=[5.0] if i == 4 else [0.0])
    b.force_point_point(2, 3, [0, 0, -5], [10, 0, 0], k=1e7, d=0.0)
    return b


def scene_12_spring_damper() -> SceneBuilder:
    """scenesRedMax.m case 12: a two-link chain with two stiff spring-dampers
    (world to link 2, link 1 to link 2)."""
    b = SceneBuilder(name="Spring-damper")
    b.Hexpected = {"bdf1": -2.2145412057327565e04, "bdf2": -8.9887693524038732e03}
    b0 = b.body_cuboid(1.0, (10, 1, 1), E_ji=transl([5, 0, 0]))
    b.joint(JointType.REVOLUTE, None, b0, axis=(0, 1, 0))
    b1 = b.body_cuboid(1.0, (10, 1, 1), E_ji=transl([5, 0, 0]))
    b.joint(JointType.REVOLUTE, 0, b1, E_pj=transl([10, 0, 0]), axis=(0, 1, 0))
    b.force_spring_damper(-1, 1, [-5, 0, -5], [0, 0, -2], k=1e6, d=1e3)
    b.force_spring_damper(0, 1, [0, 0, 2], [0, 0, 2], k=1e6, d=1e3)
    return b


def scene_13_cables() -> SceneBuilder:
    """scenesRedMax.m case 13: a tension-only cable routed over two links to a
    stiff prismatic slider (N = 4: fixed root, two revolute links, the
    slider; nr = 3)."""
    b = SceneBuilder(name="Cables")
    b.Hexpected = {"bdf1": -3.1874892332895153e04, "bdf2": -2.7872894793863266e04}
    b0 = b.body_cuboid(1.0, (0.1, 0.1, 0.1))
    b.joint(JointType.FIXED, None, b0)
    b1 = b.body_cuboid(1.0, (10, 1, 1), E_ji=transl([5, 0, 0]))
    b.joint(JointType.REVOLUTE, 0, b1, axis=(0, 1, 0), q=[math.pi / 2])
    b2 = b.body_cuboid(1.0, (10, 1, 1), E_ji=transl([5, 0, 0]))
    b.joint(JointType.REVOLUTE, 1, b2, E_pj=transl([10, 0, 0]), axis=(0, 1, 0), q=[-math.pi / 2])
    b3 = b.body_cuboid(1.0, (1, 1, 1))
    j3 = b.joint(JointType.PRISMATIC, 0, b3, E_pj=transl([10, 0, 0]), axis=(1, 0, 0))
    b.set_stiffness(j3, 1e4)
    b.set_damping(j3, 1e3)
    b.force_cable([b3, b1, b2], [[0, 0, 0], [-4, 0, 1], [-4, 0, 1]], k=1e6, d=1e3)
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


def scene_spring_chain(nlinks: int = 12, h: float = 1e-2) -> SceneBuilder:
    """The spring-MPC scene: scene_chain(nlinks) (alternating y/z axes, joint
    damping 1) with three spring closures: a spring-damper from a world
    anchor 6 above the base to the tip (k 2e3, d 20), a body-body
    spring-damper bracing links 2 and 8 (k 1e3, d 10) and a zero-rest
    point-point coupler between links 5 and 11 (k 50, d 2). Both rest lengths
    are set from the initial configuration. Needs nlinks >= 12 (the closures
    name links 8 and 11)."""
    b = SceneBuilder(name=f"spring-chain-{nlinks}", h=h, tEnd=0.5, grav=(0.0, 0.0, -980.0))
    for i in range(nlinks):
        body = b.body_cuboid(1.0, (1.0, 0.1, 0.1), E_ji=transl([0.5, 0, 0]))
        j = b.joint(JointType.REVOLUTE, None if i == 0 else i - 1, body,
                    E_pj=np.eye(4) if i == 0 else transl([1.0, 0, 0]),
                    axis=(0, 1, 0) if i % 2 == 0 else (0, 0, 1))
        b.set_damping(j, 1.0)
    b.force_spring_damper(-1, nlinks - 1, [0.0, 0.0, 6.0], [0.5, 0, 0], k=2e3, d=20.0)
    b.force_spring_damper(2, 8, [0.5, 0, 0.05], [0.5, 0, -0.05], k=1e3, d=10.0)
    b.force_point_point(5, 11, xl1=(0.5, 0, 0.05), xl2=(0.5, 0, -0.05), k=50.0, d=2.0)
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
