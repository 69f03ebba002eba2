"""Scene zoo: the scenes whose joints this package covers.

``scene_chain`` is the MPC benchmark scene (a 12-link revolute chain by
default), ``scene_chain_ground`` the same chain with penalty ground
contact on every link (the differentiable-contact MPC scene) and
``scene_spring_chain`` the same chain with three spring closures (the
spring-MPC scene) and ``scene_qdep_chain`` a chain of universal or exp-map
spherical joints (the q-dependent-joint MPC scenes); ``scene_00_serial_chain``,
``scene_06_free2d`` to ``scene_13_cables`` are the reference's scenes 0 and
6-13 (7 and 9 with exponential coordinates), whose f64 trajectory dumps gate
the BDF2 step; ``scene_floor_chain`` is the contact-QP benchmark scene (every
joint limited, a floor sphere on every link). The other scenes of the JAX
package's zoo are not ported yet.
"""

import math

import numpy as np
import torch

from redmax_tpu_torch import joints, se3
from redmax_tpu_torch.scene import SceneBuilder, transl
from redmax_tpu_torch.types import JointType


def _rot(axis, angle) -> np.ndarray:
    """Rotation about axis by angle as a [4, 4] transform (Rodrigues, float64)."""
    E = np.eye(4)
    w = torch.tensor(axis, dtype=torch.float64) * angle
    E[:3, :3] = se3.exp_so3(w).numpy()
    return E


def _euler_xyz_S(q) -> np.ndarray:
    """Body angular-velocity map (3x3) of the XYZ Euler chart R = Rx Ry Rz at
    q: columns Rz^T Ry^T ex, Rz^T ey, ez."""
    c1, s1 = math.cos(q[1]), math.sin(q[1])
    c2, s2 = math.cos(q[2]), math.sin(q[2])
    return np.array([[c1 * c2, s2, 0.0], [-c1 * s2, c2, 0.0], [s1, 0.0, 1.0]])


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


def scene_06_free2d() -> SceneBuilder:
    """scenesRedMax.m case 6: a single free 2D body, y-down gravity."""
    b = SceneBuilder(name="Free2D joint", h=5e-3, tEnd=0.4, grav=(0, -980, 0))
    b.Hexpected = {"bdf1": 2.0322933333333378e04, "bdf2": 2.1283333333333332e04}
    b0 = b.body_cuboid(1.0, (1, 1, 1))
    b.joint(JointType.FREE2D, None, b0, q=[-10, -10, 0], qdot=[50, 200, 20])
    return b


def scene_07_spherical(exp_coords: bool = True) -> SceneBuilder:
    """scenesRedMax.m case 7: a spherical double pendulum, h = 2e-3, with
    exponential coordinates. The reference's Euler chart (XYZ) starts joint 1
    at q = (pi/8, 0, 0) with chart rates (2, 2, 2); the exp-map joint gets
    the same rotation and body angular velocity: qdot = Jr(q)^-1 S_xyz qdot_c."""
    if not exp_coords:
        raise NotImplementedError("the Euler-chart spherical joint is not ported yet "
                                  "(exp_coords=True: the exp-map chart)")
    b = SceneBuilder(name="Spherical joint", h=2e-3, tEnd=1.0)
    q1 = np.array([math.pi / 8, 0.0, 0.0])
    w1 = _euler_xyz_S(q1) @ np.array([2.0, 2.0, 2.0])
    Jr = joints.so3_right_jacobian(torch.tensor(q1)).numpy()
    b0 = b.body_cuboid(1.0, (1, 1, 10), E_ji=transl([0, 0, -5]))
    b.joint(JointType.SPHERICAL, None, b0, q=q1, qdot=np.linalg.solve(Jr, w1))
    b1 = b.body_cuboid(1.0, (1, 1, 10), E_ji=transl([0, 0, -5]))
    b.joint(JointType.SPHERICAL, 0, b1, E_pj=transl([0, 0, -10]), q=[math.pi / 2, 0, 0])
    return b


def scene_08_universal() -> SceneBuilder:
    """scenesRedMax.m case 8: three universal joints."""
    b = SceneBuilder(name="Universal joint")
    b.Hexpected = {"bdf1": -2.5276246935781084e04, "bdf2": -1.3781281283808785e03}
    for i in range(3):
        body = b.body_cuboid(1.0, (1, 1, 10), E_ji=transl([0, 0, -5]))
        b.joint(JointType.UNIVERSAL, None if i == 0 else i - 1, body,
                E_pj=np.eye(4) if i == 0 else transl([0, 0, -10]),
                q=[math.pi / 8, 0] if i % 2 == 0 else [0, math.pi / 8])
    return b


def scene_09_free3d(exp_coords: bool = True) -> SceneBuilder:
    """scenesRedMax.m case 9: a tumbling free body, h = 5e-2, tEnd = 6, weak
    gravity, with exponential coordinates (at q = 0 the Euler chart's S_rot
    is I too, so qdot carries over)."""
    if not exp_coords:
        raise NotImplementedError("the Euler-chart free joint is not ported yet "
                                  "(exp_coords=True: the exp-map chart)")
    b = SceneBuilder(name="Free3D joint", h=5e-2, tEnd=6.0, grav=(0, 0, -1))
    b0 = b.body_cuboid(1.0, (1, 1, 1))
    b.joint(JointType.FREE3D, None, b0, qdot=[0, 0, 3, 0.2, 0.4, 0.6])
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


def scene_11_ground() -> SceneBuilder:
    """scenesRedMax.m case 11: a free 2D cuboid bouncing on frictional
    ground, h = 5e-4."""
    b = SceneBuilder(name="Free2D with ground", h=5e-4, tEnd=0.6, grav=(0, -980, 0))
    b.Hexpected = {"bdf1": -4.4208045000000002e03, "bdf2": -2.7811251900394832e03}
    b0 = b.body_cuboid(1.0, (3, 1, 1))
    b.joint(JointType.FREE2D, None, b0, q=[-1, 2, 0], qdot=[5, 70, 2])
    b.force_ground_cuboid(b0, E_ground=_rot([1, 0, 0], -math.pi / 2), kn=1e5, kt=1e2, kd=3e1,
                          mu=0.5)
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


def scene_qdep_chain(jtype: str = "universal", njoints: int = 6) -> SceneBuilder:
    """A serial chain of njoints universal ("universal"), exp-map spherical
    ("spherical") or revolute ("revolute", axes alternating y/z) joints,
    links 1 long (cuboids 1 x 0.1 x 0.1), joint damping 1, h = 1e-2: the
    port's own copy of benchmarks/qdep_ablation.py:42-65 (its MPC solves run
    universal-6 and spherical-4, both nr = 12)."""
    jt = {"revolute": JointType.REVOLUTE, "spherical": JointType.SPHERICAL,
          "universal": JointType.UNIVERSAL}[jtype]
    b = SceneBuilder(name=f"{jtype}-chain-{njoints}", h=1e-2, tEnd=0.5, grav=(0.0, 0.0, -980.0))
    for i in range(njoints):
        body = b.body_cuboid(1.0, (1.0, 0.1, 0.1), E_ji=transl([0.5, 0, 0]))
        kw = {"axis": (0, 1, 0) if i % 2 == 0 else (0, 0, 1)} if jt == JointType.REVOLUTE else {}
        j = b.joint(jt, None if i == 0 else i - 1, body,
                    E_pj=np.eye(4) if i == 0 else transl([1.0, 0, 0]), **kw)
        b.set_damping(j, 1.0)
    return b
