"""Scene zoo: the reference's test scenes and the procedural ones.

``scene_00_serial_chain`` to ``scene_14_joint_limits`` are the reference's
scenes 0-14 (matlab-diff/scenesRedMax.m), each with its energy certificates
(Hexpected); 7 and 9 build Euler-chart ball joints with exp_coords=False
(the reference's parameterization, for certificate parity) and exp-map ones
by default. ``scene_m2_single_revolute``, ``scene_m1_simpler_chain`` and
``scene_100_adjoint`` are cases -2, -1 and 100/101. ``SCENES`` and
``build_scene`` mirror the JAX package's table. ``scene_chain`` is the MPC
benchmark scene (a 12-link revolute chain by default),
``scene_chain_ground`` the same chain with penalty ground contact on every
link (the differentiable-contact MPC scene), ``scene_spring_chain`` the
same chain with three spring closures (the spring-MPC scene) and
``scene_qdep_chain`` a chain of universal or exp-map spherical joints (the
q-dependent-joint MPC scenes); ``scene_floor_chain`` is the contact-QP
benchmark scene (every joint limited, a floor sphere on every link);
``scene_tree``, ``scene_bridge`` and ``scene_umbrella`` are the procedural
scenes of the reference's RigidBodyCreator.
"""

import math

import numpy as np
import torch

from redmax_tpu_torch import joints, model, se3
from redmax_tpu_torch.scene import CompiledScene, SceneBuilder, transl
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


def scene_01_revolute_axes() -> SceneBuilder:
    """scenesRedMax.m case 1: three bodies, revolute axes z/y/z."""
    b = SceneBuilder(name="Different revolute axes")
    b.Hexpected = {"bdf1": -3.8359074258588909e04, "bdf2": -9.7138545812971279e02}
    axes = [(0, 0, 1), (0, 1, 0), (0, 0, 1)]
    qs = [0.0, math.pi / 2, math.pi / 2]
    for i in range(3):
        body = b.body_cuboid(1.0, (10, 1, 1), E_ji=transl([5, 0, 0]))
        b.joint(JointType.REVOLUTE, None if i == 0 else i - 1, body,
                E_pj=np.eye(4) if i == 0 else transl([10, 0, 0]), axis=axes[i], q=[qs[i]])
    return b


def scene_02_branching() -> SceneBuilder:
    """scenesRedMax.m case 2: a branching tree with revolute x/z/x/y."""
    b = SceneBuilder(name="Branching")
    b.Hexpected = {"bdf1": -2.2826101928480086e04, "bdf2": -2.4159349151742754e02}
    sides = [(1, 1, 10), (1, 20, 1), (1, 1, 10), (1, 1, 10)]
    E_ji = [transl([0, 0, -5]), transl([0, 0, 0]), transl([0, 0, -5]), transl([0, 0, -5])]
    axes = [(1, 0, 0), (0, 0, 1), (1, 0, 0), (0, 1, 0)]
    E_pj = [transl([0, 0, 15]), transl([0, 0, -10]), transl([0, -10, 0]), transl([0, 10, 0])]
    parents = [None, 0, 1, 1]
    qs = [0.0, 0.0, math.pi / 4, math.pi / 4]
    for i in range(4):
        body = b.body_cuboid(1.0, sides[i], E_ji=E_ji[i])
        b.joint(JointType.REVOLUTE, parents[i], body, E_pj=E_pj[i], axis=axes[i], q=[qs[i]])
    return b


def scene_03_prismatic() -> SceneBuilder:
    """scenesRedMax.m case 3: a prismatic (x) root and a revolute (y)
    pendulum."""
    b = SceneBuilder(name="Prismatic joint")
    b.Hexpected = {"bdf1": -3.7579402399569808e04, "bdf2": -6.1132876082600706e02}
    b0 = b.body_cuboid(1.0, (20, 1, 1))
    b.joint(JointType.PRISMATIC, None, b0, axis=(1, 0, 0))
    b1 = b.body_cuboid(1.0, (1, 1, 10), E_ji=transl([0, 0, -5]))
    b.joint(JointType.REVOLUTE, 0, b1, E_pj=transl([-10, 0, 0]), axis=(0, 1, 0),
            q=[math.pi / 2])
    return b


def scene_04_planar() -> SceneBuilder:
    """scenesRedMax.m case 4: a planar root and two revolute pendulums."""
    b = SceneBuilder(name="Planar joint")
    b.Hexpected = {"bdf1": -4.5738939646068720e04, "bdf2": -4.7000178355609387e02}
    b0 = b.body_cuboid(1.0, (10, 10, 1))
    b.joint(JointType.PLANAR, None, b0)
    b1 = b.body_cuboid(1.0, (1, 1, 10), E_ji=transl([0, 0, -5]))
    b.joint(JointType.REVOLUTE, 0, b1, E_pj=transl([-5, 0, 0]), axis=(0, 1, 0),
            q=[math.pi / 2])
    b2 = b.body_cuboid(1.0, (1, 1, 10), E_ji=transl([0, 0, -5]))
    b.joint(JointType.REVOLUTE, 0, b2, E_pj=transl([0, -5, 0]), axis=(1, 0, 0),
            q=[math.pi / 4])
    return b


def scene_05_translational() -> SceneBuilder:
    """scenesRedMax.m case 5: a translational root, zero gravity, tEnd = 2."""
    b = SceneBuilder(name="Translational joint", tEnd=2.0, grav=(0, 0, 0))
    b.Hexpected = {"bdf1": 3.3661704151378050e04, "bdf2": 3.3377464890219308e04}
    b0 = b.body_cuboid(1.0, (10, 10, 1))
    b.joint(JointType.TRANSLATIONAL, None, b0)
    b1 = b.body_cuboid(1.0, (1, 1, 10), E_ji=transl([0, 0, -5]))
    b.joint(JointType.REVOLUTE, 0, b1, E_pj=transl([-5, 0, 0]), axis=(0, 1, 0), qdot=[-10.0])
    b2 = b.body_cuboid(1.0, (1, 1, 10), E_ji=transl([0, 0, -5]))
    b.joint(JointType.REVOLUTE, 0, b2, E_pj=transl([0, -5, 0]), axis=(1, 0, 0), qdot=[10.0])
    return b


def scene_06_free2d() -> SceneBuilder:
    """scenesRedMax.m case 6: a single free 2D body, y-down gravity."""
    b = SceneBuilder(name="Free2D joint", h=5e-3, tEnd=0.4, grav=(0, -980, 0))
    b.Hexpected = {"bdf1": 2.0322933333333378e04, "bdf2": 2.1283333333333332e04}
    b0 = b.body_cuboid(1.0, (1, 1, 1))
    b.joint(JointType.FREE2D, None, b0, q=[-10, -10, 0], qdot=[50, 200, 20])
    return b


def scene_07_spherical(exp_coords: bool = True) -> SceneBuilder:
    """scenesRedMax.m case 7: a spherical double pendulum, h = 2e-3. The
    reference's Euler chart (XYZ) starts joint 1 at q = (pi/8, 0, 0) with
    chart rates (2, 2, 2); exp_coords=False builds those SPHERICAL_EULER
    joints (with the certificates), exp_coords=True exp-map joints with the
    same rotation and body angular velocity: qdot = Jr(q)^-1 S_xyz qdot_c."""
    b = SceneBuilder(name="Spherical joint", h=2e-3, tEnd=1.0)
    q1, qd1 = np.array([math.pi / 8, 0.0, 0.0]), np.array([2.0, 2.0, 2.0])
    if exp_coords:
        jt = JointType.SPHERICAL
        qd1 = np.linalg.solve(joints.so3_right_jacobian(torch.tensor(q1)).numpy(),
                              _euler_xyz_S(q1) @ qd1)
    else:
        jt = JointType.SPHERICAL_EULER
        b.Hexpected = {"bdf1": -8.7859815791305155e03, "bdf2": 8.6544602745403390e03}
    b0 = b.body_cuboid(1.0, (1, 1, 10), E_ji=transl([0, 0, -5]))
    b.joint(jt, None, b0, q=q1, qdot=qd1)
    b1 = b.body_cuboid(1.0, (1, 1, 10), E_ji=transl([0, 0, -5]))
    b.joint(jt, 0, b1, E_pj=transl([0, 0, -10]), q=[math.pi / 2, 0, 0])
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
    gravity; exp_coords=False builds the reference's FREE3D_EULER joint
    (with the certificates), exp_coords=True the exp-map FREE3D one (at
    q = 0 both charts have S_rot = I, so qdot carries over)."""
    b = SceneBuilder(name="Free3D joint", h=5e-2, tEnd=6.0, grav=(0, 0, -1))
    if not exp_coords:
        b.Hexpected = {"bdf1": 4.3970920953724946e00, "bdf2": 4.5466508559364156e00}
    b0 = b.body_cuboid(1.0, (1, 1, 1))
    b.joint(JointType.FREE3D if exp_coords else JointType.FREE3D_EULER, None, b0,
            qdot=[0, 0, 3, 0.2, 0.4, 0.6])
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


def scene_14_joint_limits() -> SceneBuilder:
    """scenesRedMax.m case 14: a three-link chain with penalty joint limits
    [-pi/2, 0] (k 1e5, d 1e2) and joint damping 1e2, h = 5e-3."""
    b = SceneBuilder(name="Joint limits", h=5e-3)
    b.Hexpected = {"bdf1": -2.5928305306546572e04, "bdf2": -1.8476279319765570e04}
    for i in range(3):
        body = b.body_cuboid(1.0, (10, 1, 1), E_ji=transl([5, 0, 0]))
        if i == 0:
            j = b.joint(JointType.REVOLUTE, None, body, E_pj=_rot([0, 1, 0], math.pi / 2),
                        axis=(0, 1, 0), q=[0.0])
        else:
            j = b.joint(JointType.REVOLUTE, i - 1, body, E_pj=transl([10, 0, 0]),
                        axis=(0, 1, 0), q=[-math.pi / 6])
        b.set_limits(j, lower=-math.pi / 2, upper=0.0, k=1e5, d=1e2)
        b.set_damping(j, 1e2)
    return b


def scene_m2_single_revolute() -> SceneBuilder:
    """Case -2 'Single revolute' (scenesRedMax.m:13-26): one cuboid on a
    y-axis hinge, qdot(0) = 1."""
    b = SceneBuilder(name="Single revolute")
    body = b.body_cuboid(1.0, (2, 0.2, 0.2), E_ji=transl([1, 0, 0]))
    b.joint(JointType.REVOLUTE, None, body, axis=(0, 1, 0), qdot=[1.0])
    return b


def scene_m1_simpler_chain(nbodies: int = 1) -> SceneBuilder:
    """Case -1 'Simpler serial chain' (scenesRedMax.m:27-51): 10 x 1 x 1
    links, stiffness 1e6, damping 1e4."""
    b = SceneBuilder(name="Simpler serial chain")
    for i in range(nbodies):
        body = b.body_cuboid(1.0, (10, 1, 1), E_ji=transl([5, 0, 0]))
        j = b.joint(JointType.REVOLUTE, None if i == 0 else i - 1, body,
                    E_pj=np.eye(4) if i == 0 else transl([10, 0, 0]), axis=(0, 1, 0),
                    q=[0.0] if i == 0 else [math.pi / 4], qdot=[1.0])
        b.set_stiffness(j, 1e6)
        b.set_damping(j, 1e4)
    return b


def scene_100_adjoint(nbodies: int = 2) -> SceneBuilder:
    """Cases 100/101: the two-link chain of the adjoint point-position task
    (stiffness and damping 1e4)."""
    b = SceneBuilder(name="Adjoint")
    for i in range(nbodies):
        body = b.body_cuboid(1.0, (10, 1, 1), E_ji=transl([5, 0, 0]))
        j = b.joint(JointType.REVOLUTE, None if i == 0 else i - 1, body,
                    E_pj=np.eye(4) if i == 0 else transl([10, 0, 0]), axis=(0, 1, 0),
                    q=[math.pi / 2] if i == 0 else [math.pi / 4], qdot=[1.0])
        b.set_stiffness(j, 1e4)
        b.set_damping(j, 1e4)
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


def scene_tree(depth: int = 4, branch: int = 2, link_len: float = 1.0,
               density: float = 1.0, h: float = 1e-2, tEnd: float = 0.5) -> SceneBuilder:
    """Procedural branching tree (RigidBodyCreator::loadSimpleTree/loadTree):
    `branch` children per joint down to `depth` levels, alternating y/z
    hinge axes, joint damping 1 (depth 4, branch 2: N = nr = 15)."""
    b = SceneBuilder(name=f"tree-d{depth}b{branch}", h=h, tEnd=tEnd)
    sides = (link_len, 0.1 * link_len, 0.1 * link_len)

    def add(parent, level, offset):
        body = b.body_cuboid(density, sides, E_ji=transl([link_len / 2, 0, 0]))
        E_pj = np.eye(4) if parent is None else transl([link_len, offset, 0])
        j = b.joint(JointType.REVOLUTE, parent, body, E_pj=E_pj,
                    axis=(0, 1, 0) if level % 2 == 0 else (0, 0, 1))
        b.set_damping(j, 1.0)
        if level + 1 < depth:
            for k in range(branch):
                add(j, level + 1, 0.05 * link_len * (k - (branch - 1) / 2))

    add(None, 0, 0.0)
    return b


def scene_bridge(nplanks: int = 8, density: float = 1.0, h: float = 1e-2,
                 tEnd: float = 0.5) -> SceneBuilder:
    """Procedural plank bridge closed by a loop constraint
    (RigidBodyCreator::loadSimpleBridge/loadBridge): a sagging revolute
    chain of planks from a fixed block, its far end loop-closed to a fixed
    anchor placed at the chain's tip (8 planks: N = 10, nr = 8). The anchor
    comes from this package's forward kinematics, in float64 on the CPU
    whatever device the scene is compiled for, so the loop starts satisfied."""
    b = SceneBuilder(name=f"bridge-{nplanks}", h=h, tEnd=tEnd)
    plank = (1.0, 0.4, 0.1)
    b0 = b.body_cuboid(density, (0.2, 0.4, 0.2))
    b.joint(JointType.FIXED, None, b0)
    prev, sag = 0, 0.3  # a sagging arc (a taut horizontal bridge is a singular four-bar)
    for i in range(nplanks):
        dq = -sag if i < nplanks // 2 else sag * (2.0 if i == nplanks // 2 else 1.0)
        body = b.body_cuboid(density, plank, E_ji=transl([0.5, 0, 0]))
        j = b.joint(JointType.REVOLUTE, prev, body, E_pj=transl([0.2 if i == 0 else 1.0, 0, 0]),
                    axis=(0, 1, 0), q=[dq])
        b.set_damping(j, 0.5)
        prev = j
    tmp = b.compile(dtype=torch.float64, device="cpu")
    kin0 = model.forward_kinematics(tmp.topo, tmp.params, tmp.state0.q[None],
                                    tmp.state0.qdot[None])
    tip = (kin0.E_wi[0, prev] @ torch.tensor([0.5, 0.0, 0.0, 1.0], dtype=torch.float64))[:3]
    anchor = b.body_cuboid(density, (0.2, 0.4, 0.2))
    b.joint(JointType.FIXED, 0, anchor, E_pj=transl(tip.numpy()))
    b.constraint_loop(prev, anchor, [0.5, 0, 0], [0.0, 0, 0])
    return b


def scene_umbrella(nribs: int = 6, density: float = 1.0, h: float = 1e-2,
                   tEnd: float = 0.5) -> SceneBuilder:
    """Procedural umbrella (RigidBodyCreator::loadUmbrella): a prismatic
    slider (stiffness 50, damping 5) on a fixed central pole driving `nribs`
    hinged ribs through stiff spring-dampers (6 ribs: N = 8, nr = 7, 6
    spring-dampers)."""
    b = SceneBuilder(name=f"umbrella-{nribs}", h=h, tEnd=tEnd)
    pole = b.body_cuboid(density, (0.1, 0.1, 2.0))
    b.joint(JointType.FIXED, None, pole)
    slider = b.body_cuboid(density, (0.2, 0.2, 0.2))
    js = b.joint(JointType.PRISMATIC, 0, slider, E_pj=transl([0, 0, 0.5]), axis=(0, 0, 1))
    b.set_stiffness(js, 50.0)
    b.set_damping(js, 5.0)
    for k in range(nribs):
        th = 2 * math.pi * k / nribs
        c, s_ = math.cos(th), math.sin(th)
        R = np.eye(4)
        R[:3, :3] = np.array([[c, -s_, 0], [s_, c, 0], [0, 0, 1]])
        R[:3, 3] = [0, 0, 1.0]
        rib = b.body_cuboid(density, (1.0, 0.05, 0.05), E_ji=transl([0.5, 0, 0]))
        j = b.joint(JointType.REVOLUTE, 0, rib, E_pj=R, axis=(0, 1, 0), q=[-math.pi / 4])
        b.set_damping(j, 0.2)
        b.force_spring_damper(1, rib, [0.1 * c, 0.1 * s_, 0], [0.3, 0, 0], k=200.0, d=2.0)
    return b


# The JAX package's scene table (redmax_tpu/scenes.py::SCENES); case 101
# 'Adjoint BDF2' is the builder of 100 (its task picks BDF2).
SCENES = {
    0: scene_00_serial_chain,
    1: scene_01_revolute_axes,
    2: scene_02_branching,
    3: scene_03_prismatic,
    4: scene_04_planar,
    5: scene_05_translational,
    6: scene_06_free2d,
    7: scene_07_spherical,
    8: scene_08_universal,
    9: scene_09_free3d,
    10: scene_10_loop,
    11: scene_11_ground,
    12: scene_12_spring_damper,
    13: scene_13_cables,
    14: scene_14_joint_limits,
    100: scene_100_adjoint,
    101: scene_100_adjoint,
    -2: scene_m2_single_revolute,
    -1: scene_m1_simpler_chain,
}


def build_scene(sid: int, dtype=torch.float64, device="cuda", **kw) -> CompiledScene:
    """Scene sid of SCENES (kw to its builder) compiled in dtype on device."""
    return SCENES[sid](**kw).compile(dtype=dtype, device=device)
