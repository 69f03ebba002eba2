"""The scene zoo of the reference's feature-rich MATLAB variant
(testRedMaxScenes.m): every case of the JAX package's scenes_matlab.py, with
the same ids, names, h, tEnd, gravity, Baumgarte factors and energy
certificates (Hexpected["euler"], held to 1e-2 as
matlab/testRedMax.m:170-177 holds it). Defaults (matlab/+redmax/Scene.m:
29-53): tspan [0, 2], h 1e-2, grav [0, 0, -980], baumgarte [5, 5, 5],
density 1.

The cases with joint friction or frictional contact (27-31, 33) compile
with their friction model and step under staggered projections
(make_step("euler_fric"), friction.py; certificates Hexpected["euler_fric"]).
Cases 26 and 34 read the reference's OBJ meshes, whose paths their builders
take (obj=).
Cases 5, 9, 13, 20, 32 (and 33) drive their targets over time through a
scene function (SCENE_FNS), the reference's sceneFcn, which
integrators.make_simulate calls at each step's end time; each is
branchless (torch.where over time windows) and takes t as a tensor,
0-d or per lane [B].
"""

import math
from functools import lru_cache
from typing import Callable, Dict

import numpy as np
import torch

from redmax_tpu_torch.scene import CompiledScene, SceneBuilder, transl
from redmax_tpu_torch.scenes import _rot
from redmax_tpu_torch.types import JointType

# The cases with friction (their step is "euler_fric") and the cases that
# read an OBJ mesh.
FRICTION = (27, 28, 29, 30, 31, 33)
OBJ_CASES = (26, 34)


def _need_obj(sid: int, name: str, obj):
    if obj is None:
        raise FileNotFoundError(f"mscene {sid} reads the reference's {name}: pass its path "
                                f"as obj=")
    return obj


def mscene_m1() -> SceneBuilder:
    """case -1: two-link chain, q = [pi/2, pi/4]."""
    b = SceneBuilder(name="Simpler serial chain", h=1e-2, tEnd=2.0)
    b.Hexpected = {"euler": -3697.4545694454454861}
    qs = [math.pi / 2, math.pi / 4]
    for i in range(2):
        body = b.body_cuboid(1.0, (10, 1, 1), E_ji=transl([5, 0, 0]))
        b.joint(
            JointType.REVOLUTE,
            None if i == 0 else i - 1,
            body,
            E_pj=np.eye(4) if i == 0 else transl([10, 0, 0]),
            axis=(0, 1, 0),
            q=[qs[i]],
        )
    return b


def mscene_00() -> SceneBuilder:
    """case 0: 5-cuboid chain, alternating revolute/fixed, tEnd=2."""
    b = SceneBuilder(name="Simple serial chain", h=1e-2, tEnd=2.0)
    b.Hexpected = {"euler": -5930.8171118834870867}
    for i in range(5):
        body = b.body_cuboid(1.0, (10, 1, 1), E_ji=transl([5, 0, 0]))
        E_pj = np.eye(4) if i == 0 else transl([10, 0, 0])
        if i % 2 == 0:
            b.joint(
                JointType.REVOLUTE, None if i == 0 else i - 1, body,
                E_pj=E_pj, axis=(0, 1, 0), q=[math.pi / 4],
            )
        else:
            b.joint(JointType.FIXED, i - 1, body, E_pj=E_pj)
    return b


def mscene_01() -> SceneBuilder:
    """case 1: revolute axes z/y/z, q = [0, pi/2, pi/2]."""
    b = SceneBuilder(name="Different revolute axes", h=1e-2, tEnd=2.0)
    b.Hexpected = {"euler": -9423.2594023734018265}
    axes = [(0, 0, 1), (0, 1, 0), (0, 0, 1)]
    qs = [0.0, math.pi / 2, math.pi / 2]
    for i in range(3):
        body = b.body_cuboid(1.0, (10, 1, 1), E_ji=transl([5, 0, 0]))
        b.joint(
            JointType.REVOLUTE, None if i == 0 else i - 1, body,
            E_pj=np.eye(4) if i == 0 else transl([10, 0, 0]),
            axis=axes[i], q=[qs[i]],
        )
    return b


def mscene_04() -> SceneBuilder:
    """case 4: four-bar loop closed with ConstraintLoop, qdot5 = 5."""
    b = SceneBuilder(name="Loop", h=1e-2, tEnd=2.0)
    b.Hexpected = {"euler": 3987.2011847696289806}
    sides = [(20, 1, 1), (1, 1, 10), (1, 1, 10), (20, 1, 1), (1, 1, 10)]
    E_ji = [np.eye(4), transl([0, 0, -5]), transl([0, 0, -5]),
            transl([10, 0, 0]), transl([0, 0, -5])]
    E_pj = [np.eye(4), transl([-10, 0, 0]), transl([10, 0, 0]),
            transl([0, 0, -10]), transl([10, 0, 0])]
    parents = [None, 0, 0, 1, 3]
    for i in range(5):
        body = b.body_cuboid(1.0, sides[i], E_ji=E_ji[i])
        if i == 0:
            b.joint(JointType.FIXED, None, body, E_pj=E_pj[i])
        else:
            qdot = [5.0] if i == 4 else [0.0]
            b.joint(JointType.REVOLUTE, parents[i], body, E_pj=E_pj[i],
                    axis=(0, 1, 0), qdot=qdot)
    b.constraint_loop(2, 3, [0, 0, -5], [10, 0, 0])
    return b


def mscene_06() -> SceneBuilder:
    """case 6: two-link chain with QP joint limits on joint 2."""
    b = SceneBuilder(name="Joint limits (QP)", h=1e-2, tEnd=2.0)
    b.Hexpected = {"euler": 36957.4447830002754927}
    for i in range(2):
        body = b.body_cuboid(1.0, (10, 1, 1), E_ji=transl([5, 0, 0]))
        b.joint(
            JointType.REVOLUTE, None if i == 0 else i - 1, body,
            E_pj=np.eye(4) if i == 0 else transl([10, 0, 0]), axis=(0, 1, 0),
        )
        if i > 0:
            b.constraint_joint_limit(i, -math.pi / 4, math.pi / 4)
    return b


def mscene_07() -> SceneBuilder:
    """case 7: three-link chain with gear constraints q_{i} = 0.5 q_{i-1}."""
    b = SceneBuilder(name="Equality constrained angles", h=2e-2, tEnd=2.0)
    b.Hexpected = {"euler": 42645.1541420989669859}
    for i in range(3):
        body = b.body_cuboid(1.0, (10, 1, 1), E_ji=transl([5, 0, 0]))
        b.joint(
            JointType.REVOLUTE, None if i == 0 else i - 1, body,
            E_pj=np.eye(4) if i == 0 else transl([10, 0, 0]), axis=(0, 1, 0),
        )
        if i > 0:
            b.constraint_multq(i - 1, i, 0.5)
    return b


def mscene_08() -> SceneBuilder:
    """case 8: 'Equality and loop' — 7 bodies, ConstraintLoop + MultQ."""
    b = SceneBuilder(name="Equality and loop", h=2e-2, tEnd=2.0)
    b.Hexpected = {"euler": 14677.4348748325592169}
    sides = [(10, 1, 1), (1, 1, 10), (1, 1, 10), (10, 1, 1),
             (1, 1, 10), (1, 1, 10), (1, 1, 10)]
    E_ji = [np.eye(4), transl([0, 0, -5]), transl([0, 0, -5]), transl([-5, 0, 0]),
            transl([0, 0, 5]), transl([0, 0, 5]), transl([0, 0, -5])]
    E_pj = [np.eye(4), transl([5, 0, 0]), transl([0, 0, -10]), transl([0, 0, -10]),
            transl([-10, 0, 0]), transl([0, 0, 10]), transl([-5, 0, 0])]
    parents = [None, 0, 1, 2, 3, 4, 3]
    for i in range(7):
        body = b.body_cuboid(1.0, sides[i], E_ji=E_ji[i])
        if i == 0:
            b.joint(JointType.FIXED, None, body, E_pj=E_pj[i])
        else:
            qdot = [10.0] if i == 6 else [0.0]
            b.joint(JointType.REVOLUTE, parents[i], body, E_pj=E_pj[i],
                    axis=(0, 1, 0), qdot=qdot)
    b.constraint_loop(5, 0, [0, 0, 5], [-5, 0, 0])
    b.constraint_multq(2, 5, 0.5)
    return b


def mscene_02() -> SceneBuilder:
    """case 2 'Branching': revolute x/z/x/y tree."""
    b = SceneBuilder(name="Branching", h=1e-2, tEnd=2.0)
    b.Hexpected = {"euler": -1123.9825362491046690,
                   "ode45": -3.2850447782984702,
                   "ode45_recursive": -3.2850447686942061}
    sides = [(1, 1, 10), (1, 20, 1), (1, 1, 10), (1, 1, 10)]
    E_ji = [transl([0, 0, -5]), np.eye(4), transl([0, 0, -5]), transl([0, 0, -5])]
    axes = [(1, 0, 0), (0, 0, 1), (1, 0, 0), (0, 1, 0)]
    E_pj = [transl([0, 0, 15]), transl([0, 0, -10]),
            transl([0, -10, 0]), transl([0, 10, 0])]
    parents = [None, 0, 1, 1]
    qs = [0.0, 0.0, math.pi / 4, math.pi / 4]
    for i in range(4):
        body = b.body_cuboid(1.0, sides[i], E_ji=E_ji[i])
        b.joint(JointType.REVOLUTE, parents[i], body, E_pj=E_pj[i],
                axis=axes[i], q=[qs[i]])
    return b


def mscene_03() -> SceneBuilder:
    """case 3 'Spherical joint' (exp coords), euler only, tEnd=3."""
    b = SceneBuilder(name="Spherical joint", h=1e-2, tEnd=3.0)
    b.Hexpected = {"euler": 7788.8055603543098186}
    for i in range(2):
        body = b.body_cuboid(1.0, (1, 1, 10), E_ji=transl([0, 0, -5]))
        q = [math.pi / 8, 0.0, 0.0]
        qdot = [0.0, 0.0, 2.0] if i == 0 else None
        b.joint(JointType.SPHERICAL, None if i == 0 else 0, body,
                E_pj=np.eye(4) if i == 0 else transl([0, 0, -10]),
                q=q, qdot=qdot)
    return b


def mscene_05() -> SceneBuilder:
    """case 5 'Joint torque': time-windowed torque schedule via scene_fn."""
    b = SceneBuilder(name="Joint torque", h=5e-2, tEnd=10.0, grav=(0, 0, 0))
    b.Hexpected = {"euler": 170.5971183034905607,
                   "ode45": 160.820781710469,
                   "ode45_recursive": 160.820781707015}
    for i in range(3):
        body = b.body_cuboid(1.0, (10, 1, 1), E_ji=transl([5, 0, 0]))
        b.joint(JointType.REVOLUTE, None if i == 0 else i - 1, body,
                E_pj=np.eye(4) if i == 0 else transl([10, 0, 0]), axis=(0, 1, 0))
    return b


def mscene_14() -> SceneBuilder:
    """case 14 'Universal joint': 3 universal joints."""
    b = SceneBuilder(name="Universal joint", h=1e-2, tEnd=2.0)
    b.Hexpected = {"euler": 9679.3365423127470422,
                   "ode45": -0.8577782794236555,
                   "ode45_recursive": -0.8577782593856682}
    for i in range(3):
        body = b.body_cuboid(1.0, (1, 1, 10), E_ji=transl([0, 0, -5]))
        q = [math.pi / 8, 0] if i % 2 == 0 else [0, math.pi / 8]
        b.joint(JointType.UNIVERSAL, None if i == 0 else i - 1, body,
                E_pj=np.eye(4) if i == 0 else transl([0, 0, -10]), q=q)
    return b


def mscene_15() -> SceneBuilder:
    """case 15 'Prismatic joint': slider-crank-like loop with ConstraintLoop."""
    b = SceneBuilder(name="Prismatic joint", h=1e-2, tEnd=2.0)
    b.Hexpected = {"euler": -17427.8561972516035894,
                   "ode45": 2.5092171060550754,
                   "ode45_recursive": 2.5092171102578504}
    b0 = b.body_cuboid(1.0, (22, 1, 1))
    b.joint(JointType.FIXED, None, b0)
    b1 = b.body_cuboid(1.0, (1, 1, 10), E_ji=transl([0, 0, -5]))
    b.joint(JointType.REVOLUTE, 0, b1, E_pj=transl([-11, 0, 0]), axis=(0, 1, 0))
    b2 = b.body_cuboid(1.0, (22, 1, 1), E_ji=transl([11, 0, 0]))
    b.joint(JointType.PRISMATIC, 1, b2, E_pj=transl([0, 0, -10]), axis=(1, 0, 0))
    b3 = b.body_cuboid(1.0, (1, 1, 10), E_ji=transl([0, 0, 5]))
    b.joint(JointType.REVOLUTE, 2, b3, E_pj=transl([22, 0, 0]), axis=(0, 1, 0))
    b4 = b.body_cuboid(1.0, (1, 1, 10), E_ji=transl([0, 0, -5]))
    b.joint(JointType.REVOLUTE, 2, b4, E_pj=transl([11, 0, 0]), axis=(0, 1, 0),
            q=[3 * math.pi / 4])
    b.constraint_loop(3, 0, [0, 0, 5], [11, 0, 0])
    return b


def mscene_16() -> SceneBuilder:
    """case 16 'Planar joint'."""
    b = SceneBuilder(name="Planar joint", h=1e-2, tEnd=2.0)
    b.Hexpected = {"euler": 1027.3404900101377279,
                   "ode45": -5.7644270894088550,
                   "ode45_recursive": -5.7644270883174613}
    b0 = b.body_cuboid(1.0, (10, 10, 1))
    b.joint(JointType.PLANAR, None, b0)
    b1 = b.body_cuboid(1.0, (1, 1, 10), E_ji=transl([0, 0, -5]))
    b.joint(JointType.REVOLUTE, 0, b1, E_pj=transl([-5, 0, 0]), axis=(0, 1, 0),
            q=[math.pi / 2])
    b2 = b.body_cuboid(1.0, (1, 1, 10), E_ji=transl([0, 0, -5]))
    b.joint(JointType.REVOLUTE, 0, b2, E_pj=transl([0, -5, 0]), axis=(1, 0, 0),
            q=[math.pi / 4])
    return b


def mscene_17() -> SceneBuilder:
    """case 17 'Translational joint', zero gravity."""
    b = SceneBuilder(name="Translational joint", h=1e-2, tEnd=2.0, grav=(0, 0, 0))
    b.Hexpected = {"euler": 836.2350063173605577,
                   "ode45": 835.418079875333,
                   "ode45_recursive": 835.418079875333}
    b0 = b.body_cuboid(1.0, (10, 10, 1))
    b.joint(JointType.TRANSLATIONAL, None, b0)
    b1 = b.body_cuboid(1.0, (1, 1, 10), E_ji=transl([0, 0, -5]))
    b.joint(JointType.REVOLUTE, 0, b1, E_pj=transl([-5, 0, 0]), axis=(0, 1, 0),
            qdot=[2.0])
    b2 = b.body_cuboid(1.0, (1, 1, 10), E_ji=transl([0, 0, -5]))
    b.joint(JointType.REVOLUTE, 0, b2, E_pj=transl([0, -5, 0]), axis=(1, 0, 0),
            qdot=[1.0])
    return b


def mscene_18() -> SceneBuilder:
    """case 18 'Free joint': tumbling unit cube, weak gravity, tEnd=7."""
    b = SceneBuilder(name="Free joint", h=1e-2, tEnd=7.0, grav=(0, 0, -1))
    b.Hexpected = {"euler": 4.5116666666668817,
                   "ode45": 4.5466342688068924,
                   "ode45_recursive": 4.5466342688068826}
    b0 = b.body_cuboid(1.0, (1, 1, 1))
    b.joint(JointType.FREE3D, None, b0, qdot=[0, 0, 3, 0.2, 0.4, 0.6])
    return b


def mscene_19() -> SceneBuilder:
    """case 19 'Composite joint': revolute(x) o prismatic(x), h=2e-2."""
    b = SceneBuilder(name="Composite joint", h=2e-2, tEnd=2.0)
    b.Hexpected = {"euler": 918.5086593280602756,
                   "ode45": -8.7962825142917609,
                   "ode45_recursive": -8.7962825142149086}
    b0 = b.body_cuboid(1.0, (1, 1, 10), E_ji=transl([0, 0, 5]))
    b.joint(JointType.COMPOSITE_RP, None, b0, axis1=(1, 0, 0), axis2=(1, 0, 0),
            q=[0.1, 0.0], qdot=[0.0, 1.0])
    return b


def mscene_23() -> SceneBuilder:
    """case 23 'Point-to-point spring': 4-link chain + 3 zero-rest springs."""
    b = SceneBuilder(name="Point-to-point spring", h=1e-2, tEnd=2.0)
    b.Hexpected = {"euler": 2125.1442936080966319,
                   "ode45": -0.2671194856266084,
                   "ode45_recursive": -0.2671194855411159}
    for i in range(4):
        body = b.body_cuboid(1.0, (10, 1, 1), E_ji=transl([5, 0, 0]))
        q = [math.pi / 2] if i == 0 else [math.pi / 16]
        b.joint(JointType.REVOLUTE, None if i == 0 else i - 1, body,
                E_pj=np.eye(4) if i == 0 else transl([10, 0, 0]),
                axis=(0, 1, 0), q=q)
        if i > 0:
            b.force_point_point(i - 1, i, [-1, 0, 0], [5, 0, 0], k=1e2)
    return b


def mscene_24() -> SceneBuilder:
    """case 24 'Spring damper' (matlab sign conventions), euler only."""
    b = SceneBuilder(name="Spring damper", h=1e-2, tEnd=2.0)
    b.Hexpected = {"euler": -18398.2926338097677217}
    b0 = b.body_cuboid(1.0, (10, 1, 1), E_ji=transl([5, 0, 0]))
    b.joint(JointType.FIXED, None, b0)
    b1 = b.body_cuboid(1.0, (10, 1, 1), E_ji=transl([5, 0, 0]))
    b.joint(JointType.REVOLUTE, 0, b1, E_pj=transl([10, 0, 0]), axis=(0, 1, 0),
            q=[math.pi / 2])
    b2 = b.body_cuboid(1.0, (10, 1, 1), E_ji=transl([5, 0, 0]))
    b.joint(JointType.REVOLUTE, 1, b2, E_pj=transl([10, 0, 0]), axis=(0, 1, 0),
            q=[-math.pi / 2])
    b.force_spring_damper_m(0, 1, [-2, 0, -0.5], [1, 0.5, -0.5], k=1e6, d=1e3)
    return b


def mscene_09() -> SceneBuilder:
    """case 9 'Hybrid dynamics': chain with a prescribed root joint whose
    velocity follows a sigmoid profile (sceneFcn09), zero gravity, tEnd=10."""
    b = SceneBuilder(name="Hybrid dynamics", h=2e-2, tEnd=10.0, grav=(0, 0, 0))
    b.Hexpected = {"euler": 199570.9300431804149412}
    for i in range(3):
        body = b.body_cuboid(1.0, (10, 1, 1), E_ji=transl([5, 0, 0]))
        b.joint(JointType.REVOLUTE, None if i == 0 else i - 1, body,
                E_pj=np.eye(4) if i == 0 else transl([10, 0, 0]), axis=(0, 1, 0))
    b.constraint_presc_joint(0, [0.0])
    self_c = b.constraints[-1][1]
    self_c["q_target"] = np.zeros(1)
    return b


def mscene_10() -> SceneBuilder:
    """case 10 'External world force': chain + SpringPointDirection +
    body damping 1e1 (the sceneFcn10 wext is wiped by computeMassGrav and
    is a no-op in every integrator — replicated by omission)."""
    b = SceneBuilder(name="External world force", h=1e-2, tEnd=2.0, grav=(0, 0, 0))
    b.Hexpected = {"euler": 1088.3425711375120954,
                   "ode45": 1210.7099042740403547,
                   "ode45_recursive": 1210.7099042740396726}
    for i in range(3):
        body = b.body_cuboid(1.0, (10, 1, 1), E_ji=transl([5, 0, 0]))
        b.joint(JointType.REVOLUTE, None if i == 0 else i - 1, body,
                E_pj=np.eye(4) if i == 0 else transl([10, 0, 0]), axis=(0, 1, 0))
        b.set_body_damping(body, 1e1)
    b.force_point_direction(2, [5, 0, 0], [0, 0, 1], 1e3)
    return b


def mscene_11() -> SceneBuilder:
    """case 11 'Joint stiffness and damping', zero gravity, tEnd=5."""
    b = SceneBuilder(name="Joint stiffness and damping", h=2e-2, tEnd=5.0,
                     grav=(0, 0, 0))
    b.Hexpected = {"euler": 2659.7218894234238178,
                   "ode45": 2898.56113448227,
                   "ode45_recursive": 2898.56113448227}
    for i in range(3):
        body = b.body_cuboid(1.0, (10, 1, 1), E_ji=transl([5, 0, 0]))
        qdot = [1.0] if i == 0 else None
        j = b.joint(JointType.REVOLUTE, None if i == 0 else i - 1, body,
                    E_pj=np.eye(4) if i == 0 else transl([10, 0, 0]),
                    axis=(0, 1, 0), qdot=qdot)
        b.set_stiffness(j, 1e4)
        b.set_damping(j, 1e3)
    return b


def mscene_13() -> SceneBuilder:
    """case 13 'Maximal hybrid dynamics': 4-link chain, last body's motion
    prescribed in world frame (comps wy, vx, vz), h=5e-2, tEnd=10."""
    b = SceneBuilder(name="Maximal hybrid dynamics", h=5e-2, tEnd=10.0)
    b.Hexpected = {"euler": -765.6565884021354123,
                   "ode45": 18805.7787972479818563}
    sides = [(1, 1, 10), (10, 1, 1), (1, 1, 10), (10, 1, 1)]
    E_ji = [transl([0, 0, -5]), transl([5, 0, 0]), transl([0, 0, 5]), transl([5, 0, 0])]
    E_pj = [np.eye(4), transl([0, 0, -10]), transl([10, 0, 0]), transl([0, 0, 10])]
    for i in range(4):
        body = b.body_cuboid(1.0, sides[i], E_ji=E_ji[i])
        b.joint(JointType.REVOLUTE, None if i == 0 else i - 1, body,
                E_pj=E_pj[i], axis=(0, 1, 0))
    b.constraint_presc_body_w(3, [1, 3, 5])  # wy, vx, vz (matlab comps 2,4,6)
    return b


def mscene_20() -> SceneBuilder:
    """case 20 'Reduced/maximal hybrid dynamics': 5-link chain; last body
    world-prescribed AND joint 3 sigmoid-prescribed, h=5e-2, tEnd=10."""
    b = SceneBuilder(name="Reduced/maximal hybrid dynamics", h=5e-2, tEnd=10.0)
    b.Hexpected = {"euler": 50368.3587015155280824,
                   "ode45": 72822.5867580034246203}
    sides = [(1, 1, 10), (10, 1, 1), (10, 1, 1), (1, 1, 10), (10, 1, 1)]
    E_ji = [transl([0, 0, -5]), transl([5, 0, 0]), transl([5, 0, 0]),
            transl([0, 0, 5]), transl([5, 0, 0])]
    E_pj = [np.eye(4), transl([0, 0, -10]), transl([10, 0, 0]),
            transl([10, 0, 0]), transl([0, 0, 10])]
    for i in range(5):
        body = b.body_cuboid(1.0, sides[i], E_ji=E_ji[i])
        b.joint(JointType.REVOLUTE, None if i == 0 else i - 1, body,
                E_pj=E_pj[i], axis=(0, 1, 0))
    b.constraint_presc_body_w(4, [1, 3, 5])
    b.constraint_presc_joint(2, [0.0])
    return b


def mscene_12() -> SceneBuilder:
    """case 12 'Mass-springs': 2-link chain + two DeformableSprings.

    h=5e-3, tEnd=1; one 3-node spring from a world point to the tip body,
    one 2-node spring between body 1 and body 2 (testRedMaxScenes.m:363-399).
    """
    b = SceneBuilder(name="Mass-springs", h=5e-3, tEnd=1.0)
    b.Hexpected = {"euler": -11740.4013565295099397,
                   "ode45": -0.0345395920267038}
    for i in range(2):
        body = b.body_cuboid(1.0, (10, 1, 1), E_ji=transl([5, 0, 0]))
        b.joint(
            JointType.REVOLUTE, None if i == 0 else i - 1, body,
            E_pj=np.eye(4) if i == 0 else transl([10, 0, 0]), axis=(0, 1, 0),
        )
    m = 0.1 * 10.0  # 0.1 * prod(sides) * density
    b.deformable_spring(3, 1e5, m, -1, [30.0, 0.0, 10.0], 1, [5.0, 0.0, 0.0])
    b.deformable_spring(2, 1e5, m, 0, [0.0, 0.0, 0.0], 1, [0.0, 0.0, 0.0])
    return b


def mscene_21() -> SceneBuilder:
    """case 21 'Spline curve joint': revolute + cyclic B-spline curve joint
    + revolute (testRedMaxScenes.m:608-632), h=5e-3."""
    b = SceneBuilder(name="Spline curve joint", h=5e-3, tEnd=2.0)
    b.Hexpected = {"euler": -30627.8479814097263443,
                   "ode45": -18.5261468464450445,
                   "ode45_recursive": -18.5261468157405034}
    b0 = b.body_cuboid(1.0, (1, 1, 10), E_ji=transl([0, 0, -5]))
    b.joint(JointType.REVOLUTE, None, b0, axis=(0, 1, 0))
    cf = []
    for R_ang, p in [(math.pi, [-10, 0, 0]), (math.pi / 2, [0, 0, -2]),
                     (0.0, [10, 0, 0]), (-math.pi / 2, [0, 0, 2])]:
        E = _rot([0, 1, 0], R_ang)
        E[:3, 3] = p
        cf.append(E)
    b1 = b.body_cuboid(1.0, (10, 1, 1), E_ji=transl([5, 0, 0]))
    b.joint(JointType.SPLINE_CURVE, 0, b1, E_pj=transl([0, 0, -10]),
            control_frames=cf, q=[0.0])
    b2 = b.body_cuboid(1.0, (10, 1, 1), E_ji=transl([5, 0, 0]))
    b.joint(JointType.REVOLUTE, 1, b2, E_pj=transl([10, 0, 0]), axis=(0, 1, 0),
            q=[15 * math.pi / 16])
    return b


def mscene_22() -> SceneBuilder:
    """case 22 'Spline surface joint' (testRedMaxScenes.m:633-669)."""
    b = SceneBuilder(name="Spline surface joint", h=1e-2, tEnd=2.0)
    b.Hexpected = {"euler": 2154.9740571399888722,
                   "ode45": -1.4604474127263529,
                   "ode45_recursive": -1.4604474130101153}
    b0 = b.body_cuboid(1.0, (1, 1, 10), E_ji=transl([0, 0, -5]))
    b.joint(JointType.REVOLUTE, None, b0, axis=(1, 0, 0), q=[math.pi / 8])
    t0, r0 = 15.0, math.pi / 4
    cs = np.zeros((4, 4, 6))
    for i1 in range(4):
        s1 = i1 / 3.0
        x = (1 - s1) * (-t0) + s1 * t0
        a = (1 - s1) * (-r0) + s1 * r0
        for i2 in range(4):
            s2 = i2 / 3.0
            y = (1 - s2) * (-t0) + s2 * t0
            z = 0.05 * (x * x + y * y)
            bb = (1 - s1) * (-r0) + s1 * r0
            cs[i1, i2] = [x, y, z, a, bb, 0.0]
    b1 = b.body_cuboid(1.0, (1, 1, 10), E_ji=transl([0, 0, -5]))
    b.joint(JointType.SPLINE_SURFACE, 0, b1, E_pj=transl([0, 0, -14]),
            control_values=cs, q=[0.5, 0.5])
    b2 = b.body_cuboid(1.0, (1, 1, 10), E_ji=transl([0, 0, -5]))
    b.joint(JointType.REVOLUTE, 1, b2, E_pj=transl([0, 0, -10]), axis=(0, 1, 0),
            q=[math.pi / 4])
    return b


def mscene_25() -> SceneBuilder:
    """case 25 'Composite body': cuboid + cylinder merged rigidly
    (testRedMaxScenes.m:734-762)."""
    b = SceneBuilder(name="Composite body", h=1e-2, tEnd=2.0)
    b.Hexpected = {"euler": 1261.6057602036726166,
                   "ode45": -11.2086902930313954,
                   "ode45_recursive": -11.2086902929768257}
    Ecyl = _rot([0, 1, 0], math.pi / 2)
    Ecyl[:3, 3] = [5, 0, -10]
    body = b.body_composite([
        (("cuboid", 1.0, (1, 1, 10)), transl([0, 0, -5])),
        (("cylinder", 1.0, 1.0, 10.0), Ecyl),
    ])
    b.joint(JointType.REVOLUTE, None, body, axis=(0, 1, 0))
    return b


def mscene_26(obj=None) -> SceneBuilder:
    """case 26 'Obj body': two-link chain of OBJ-mesh cuboids
    (testRedMaxScenes.m:763-795); obj: the path of the reference's
    cuboid.obj."""
    b = SceneBuilder(name="Obj body", h=1e-2, tEnd=1.0)
    b.Hexpected = {"euler": 59.8820887155682158,
                   "ode45": -0.0441469434412625,
                   "ode45_recursive": -0.0441469434378234}
    E0 = transl([0.5, 0, -1.5])
    obj = _need_obj(26, "cuboid.obj", obj)
    b0 = b.body_mesh_obj(1.0, obj)
    b.set_body_transform(b0, E0 @ b.bodies[b0].E_oi)
    b.joint(JointType.REVOLUTE, None, b0, axis=(0, 1, 0))
    b1 = b.body_mesh_obj(1.0, obj)
    b.set_body_transform(b1, E0 @ b.bodies[b1].E_oi)
    b.joint(JointType.REVOLUTE, 0, b1, E_pj=transl([0, 0, -3]), axis=(0, 1, 0))
    return b


def mscene_27() -> SceneBuilder:
    """case 27: two-link revolute chain with internal joint friction.

    Root joint tilted by Rx(pi/4); axes z; fric=true, mu=[0.6, 0.6], tEnd=1.
    """
    b = SceneBuilder(name="Internal friction revolute", h=1e-2, tEnd=1.0)
    b.fric = True
    b.Hexpected = {"euler_fric": -137371.1285153437056579}
    for i in range(2):
        body = b.body_cuboid(1.0, (10, 1, 1), E_ji=transl([5, 0, 0]))
        b.joint(
            JointType.REVOLUTE, None if i == 0 else i - 1, body,
            E_pj=_rot([1, 0, 0], math.pi / 4) if i == 0 else transl([10, 0, 0]),
            axis=(0, 0, 1),
        )
    return b


def mscene_28() -> SceneBuilder:
    """case 28 'Internal friction spherical': two exp-ball joints, mu=5."""
    b = SceneBuilder(name="Internal friction spherical", h=1e-2, tEnd=1.0)
    b.fric = True
    b.mu = np.array([5.0, 0.6])
    b.Hexpected = {"euler_fric": -184565.9459125697612762}
    for i in range(2):
        body = b.body_cuboid(1.0, (10, 1, 1), E_ji=transl([5, 0, 0]))
        b.joint(JointType.SPHERICAL, None if i == 0 else i - 1, body,
                E_pj=np.eye(4) if i == 0 else transl([10, 0, 0]))
    return b


def mscene_29() -> SceneBuilder:
    """case 29 'Internal friction prismatic': two x-sliders tilted Ry(pi/3),
    mu=0.8, contact box sides [5,0.5,5]."""
    b = SceneBuilder(name="Internal friction prismatic", h=1e-2, tEnd=1.0)
    b.fric = True
    b.mu = np.array([0.8, 0.6])
    b.Hexpected = {"euler_fric": -256391.5065969563729595}
    for i in range(2):
        body = b.body_cuboid(1.0, (10, 1, 1), E_ji=transl([5, 0, 0]))
        b.joint(JointType.PRISMATIC, None if i == 0 else i - 1, body,
                E_pj=_rot([0, 1, 0], math.pi / 3) if i == 0 else transl([10, 0, 0]),
                axis=(1, 0, 0))
        b.joints[-1].contact_sides = (5.0, 0.5, 5.0)
    return b


def mscene_31() -> SceneBuilder:
    """case 31: 'External friction' — 2-link chain + sphere on a floor.

    fric=true, mu=[0.1, 0.2], baumgarte(3)=0.1/h, tEnd=2.
    """
    b = SceneBuilder(name="External friction", h=1e-2, tEnd=2.0)
    b.fric = True
    b.mu = np.array([0.1, 0.2])
    b.baumgarte = np.array([5.0, 5.0, 0.1 / 1e-2])
    b.Hexpected = {"euler_fric": -90558.1346001959173009}
    qs = [math.pi / 4, -math.pi / 4]
    for i in range(2):
        body = b.body_cuboid(1.0, (10, 1, 1), E_ji=transl([5, 0, 0]))
        b.joint(
            JointType.REVOLUTE, None if i == 0 else i - 1, body,
            E_pj=np.eye(4) if i == 0 else transl([10, 0, 0]),
            axis=(0, 1, 0), q=[qs[i]],
        )
    bs = b.body_sphere(1.0, 1.0)
    b.joint(JointType.FIXED, 1, bs, E_pj=transl([10, 0, 0]))
    b.constraint_floor(bs, E=transl([0, 0, -15]))
    return b


def mscene_34(obj=None) -> SceneBuilder:
    """case 34 'Gears': OBJ gear meshes on cylinder axles coupled by
    ConstraintMultQ(factor=-1), cm-g-s units, tEnd=1; obj: the path of the
    reference's gears.obj."""
    b = SceneBuilder(name="Gears", h=1e-2, tEnd=1.0)
    b.Hexpected = {"euler": -39.5338848225347874,
                   "ode45": -0.1839463800738486,
                   "ode45_recursive": -0.1839463800694148}
    E0 = _rot([1, 0, 0], math.pi / 2)
    obj = _need_obj(34, "gears.obj", obj)
    # main bar (fixed)
    b0 = b.body_cuboid(1.0, (1, 1, 6))
    b.joint(JointType.FIXED, None, b0, E_pj=_rot([0, 0, 1], math.pi))
    # top axle
    b1 = b.body_cylinder(1.0, 0.2, 3.5, E_ji=_rot([1, 0, 0], math.pi / 2))
    b.joint(JointType.REVOLUTE, 0, b1, E_pj=transl([0, -0.25, 2]), axis=(0, 1, 0))
    # top gear
    b2 = b.body_mesh_obj(0.1, obj)
    b.set_body_transform(b2, E0 @ b.bodies[b2].E_oi)
    b.joint(JointType.FIXED, 1, b2, E_pj=transl([0, -0.35, 0]))
    # bottom axle
    b3 = b.body_cylinder(1.0, 0.2, 3.0, E_ji=_rot([1, 0, 0], math.pi / 2))
    b.joint(JointType.REVOLUTE, 0, b3, E_pj=transl([0, -0.5, -2]), axis=(0, 1, 0))
    # bottom gear
    b4 = b.body_mesh_obj(0.1, obj)
    b.set_body_transform(b4, E0 @ b.bodies[b4].E_oi)
    b.joint(JointType.FIXED, 3, b4, E_pj=transl([0, -0.1, 0]))
    # bottom bar
    b5 = b.body_cuboid(1.0, (5, 0.25, 0.25), E_ji=transl([0, 1.5, 0]))
    b.joint(JointType.FIXED, 3, b5)
    # top bar
    b6 = b.body_cuboid(1.0, (7, 0.25, 0.25), E_ji=transl([2, 1.75, 0]))
    b.joint(JointType.FIXED, 1, b6)
    b.constraint_multq(1, 3, -1.0)
    return b


def mscene_35() -> SceneBuilder:
    """case 35 '2D free joint': JointFree2D + revolute(z), y-down weak
    gravity, tEnd=10."""
    b = SceneBuilder(name="2D free joint", h=1e-2, tEnd=10.0, grav=(0, -1, 0))
    b.Hexpected = {"euler": 166.9232451756938644,
                   "ode45": 167.0835245643319240,
                   "ode45_recursive": 167.0835245643339135}
    b0 = b.body_cuboid(1.0, (10, 1, 1))
    b.joint(JointType.FREE2D, None, b0, qdot=[0, 0, 1])
    b1 = b.body_cuboid(1.0, (10, 1, 1), E_ji=transl([5, 0, 0]))
    b.joint(JointType.REVOLUTE, 0, b1, E_pj=transl([5, 0, 0]), axis=(0, 0, 1),
            qdot=[-1.0])
    return b


def _fourbar(b, root_free=False, ring_geom=False):
    """Shared 4-bar geometry of scenes 30/32/33 (testRedMaxScenes.m:877-1018)."""
    a_, b_, c_ = 6.0, 12.0, 14.0
    s_ = 0.5 * (a_ + b_ + c_)
    z = 2 * math.sqrt(s_ * (s_ - a_) * (s_ - b_) * (s_ - c_)) / a_
    x = math.sqrt(14 * 14 - z * z)
    th = math.atan2(z, x)
    b0 = b.body_cuboid(1.0, (10, 0.5, 0.5))
    if root_free:
        b.joint(JointType.FREE_ST, None, b0, E_pj=transl([0, 0, 1]))
    else:
        b.joint(JointType.REVOLUTE, None, b0, E_pj=transl([0, 0, 10]),
                axis=(0, 1, 0), q=[math.pi])
    b1 = b.body_cuboid(1.0, (4, 0.5, 0.5), E_ji=transl([2, 0, 0]))
    b.joint(JointType.REVOLUTE, 0, b1, E_pj=transl([-5, 0, 0]), axis=(0, 1, 0))
    E2 = _rot([0, 1, 0], -th); E2[:3, 3] = [0.5 * x, 0, 0.5 * z]
    b2 = b.body_cuboid(1.0, (14, 0.5, 0.5), E_ji=E2)
    b.joint(JointType.REVOLUTE, 1, b2, E_pj=transl([4, 0, 0]), axis=(0, 1, 0))
    x2 = x - 6.0
    th2 = math.atan2(z, x2)
    E3 = _rot([0, 1, 0], -th2); E3[:3, 3] = [-0.5 * x2, 0, -0.5 * z]
    b3 = b.body_cuboid(1.0, (12, 0.5, 0.5), E_ji=E3)
    b.joint(JointType.REVOLUTE, 2, b3, E_pj=transl([x, 0, z]), axis=(0, 1, 0))
    if ring_geom:
        for j in (1, 2, 3):
            b.joints[j].contact_radius = 0.5
            b.joints[j].contact_height = 0.5
        b.constraint_loop(3, 0, [-6, 0, 0], [5, 0, 0], radius=0.5, height=0.5)
    else:
        b.constraint_loop(3, 0, [-6, 0, 0], [5, 0, 0])


def mscene_30() -> SceneBuilder:
    """case 30 'Internal friction 4-bar linkage': loop + joint rings, mu=0.3."""
    b = SceneBuilder(name="Internal friction 4-bar linkage", h=5e-3, tEnd=1.0)
    b.fric = True
    b.mu = np.array([0.3, 0.6])
    b.baumgarte = np.array([5.0, 5.0, 1.0 / 5e-3])
    b.Hexpected = {"euler_fric": -14581.1508526040543074}
    _fourbar(b, ring_geom=True)
    return b


def mscene_33() -> SceneBuilder:
    """case 33 'External friction 4-bar linkage': a driven 4-bar WALKER —
    free-floating linkage on floor-contact spheres with a maximal
    prescribed drive (testRedMaxScenes.m:1019-1093)."""
    b = SceneBuilder(name="External friction 4-bar linkage", h=5e-3, tEnd=1.0)
    b.fric = True
    b.mu = np.array([0.8, 0.8])
    b.baumgarte = np.array([5.0, 5.0, 0.1 / 5e-3])
    b.Hexpected = {"euler_fric": 19598.8605086512579874}
    _fourbar(b, root_free=True, ring_geom=True)
    # front + back spheres on the root body
    s1 = b.body_sphere(1.0, 1.0, E_ji=transl([-5, 0, 0]))
    b.joint(JointType.FIXED, 0, s1)
    b.constraint_floor(s1)
    s2 = b.body_sphere(1.0, 1.0, E_ji=transl([5, 0, 0]))
    b.joint(JointType.FIXED, 0, s2)
    b.constraint_floor(s2)
    # middle cylinder on joint 3 (body index 2) + two side spheres
    cyl = b.body_cylinder(1.0, 0.5, 5.0, E_ji=_rot([1, 0, 0], math.pi / 2))
    b.joint(JointType.FIXED, 2, cyl)
    s3 = b.body_sphere(1.0, 1.0, E_ji=transl([0, 2.5, 0]))
    b.joint(JointType.FIXED, cyl, s3)
    b.constraint_floor(s3)
    s4 = b.body_sphere(1.0, 1.0, E_ji=transl([0, -2.5, 0]))
    b.joint(JointType.FIXED, cyl, s4)
    b.constraint_floor(s4)
    b.constraint_presc_joint_m(1)
    return b


def mscene_32() -> SceneBuilder:
    """case 32 'Prescribed joint via maximal constraint': driven 4-bar."""
    b = SceneBuilder(name="Prescribed joint via maximal constraint",
                     h=5e-3, tEnd=1.0)
    b.baumgarte = np.array([5.0, 5.0, 0.1 / 5e-3])
    b.Hexpected = {"euler": 4641.9162041538456833}
    _fourbar(b)
    b.constraint_presc_joint_m(1)
    return b


def _col(t):
    """t (0-d or per lane [B]) against a [..., k] target: [1] or [B, 1]."""
    return t.reshape(t.shape + (1,))


@lru_cache(maxsize=None)
def _vec_of(v: tuple, dtype, device):
    return torch.tensor(v, dtype=dtype, device=device)


def _vec(v, like):
    """A constant vector in like's dtype and device, made once per (v, dtype,
    device): the scene functions run every step, and a host-to-device copy
    would wait for the card each time."""
    return _vec_of(tuple(v), like.dtype, like.device)


def _sigmoid_target(t, t0, t1, a, bb):
    """The reference's sigmoid joint target b / (1 + exp(-a s)),
    s = 2 ((t - t0)/(t1 - t0) - 1/2), with its first and second time
    derivatives (testRedMaxScenes.m:1203-1225, 1259-1279)."""
    s = 2.0 * ((t - t0) / (t1 - t0) - 0.5)
    qv = bb / (1 + torch.exp(-a * s))
    dq = -(2 * a * bb * torch.exp(a * ((2 * (t - t0)) / (t0 - t1) + 1))) / (
        (t0 - t1) * (torch.exp(a * ((2 * t - 2 * t0) / (t0 - t1) + 1)) + 1) ** 2
    )
    ddq = (8 * a**2 * bb * torch.exp(2 * a * ((2 * (t - t0)) / (t0 - t1) + 1))) / (
        (t0 - t1) ** 2 * (torch.exp(a * ((2 * t - 2 * t0) / (t0 - t1) + 1)) + 1) ** 3
    ) - (4 * a**2 * bb * torch.exp(a * ((2 * (t - t0)) / (t0 - t1) + 1))) / (
        (t0 - t1) ** 2 * (torch.exp(a * ((2 * t - 2 * t0) / (t0 - t1) + 1)) + 1) ** 2
    )
    return qv, dq, ddq


def _with_constraint(params, key, **targets):
    cons = dict(params["constraints"])
    cons[key] = {**cons[key], **targets}
    return {**params, "constraints": cons}


def scene_fn_05(params, t):
    """sceneFcn05 (testRedMaxScenes.m:1186-1199): the joint torques by time
    window."""
    tau0 = params["tau"]
    c = _col(t)
    tau = torch.where(c < 3.0, _vec([0.0, 0.0, 1e2], tau0),
                      torch.where(c < 6.0, _vec([0.0, 1e2, -1e2], tau0),
                                  _vec([1e2, -1e2, 0.0], tau0)))
    return {**params, "tau": tau}


def scene_fn_09(params, t):
    """sceneFcn09 (testRedMaxScenes.m:1203-1225): the root joint follows the
    sigmoid q(t) = 1.5 pi / (1 + exp(-7 s)) up to t = 7, then rests."""
    t = t.to(params["h"].dtype)
    qv, dq, _ = _sigmoid_target(t, 0.0, 7.0, 7.0, 1.5 * math.pi)
    qv = torch.where(t < 7.0, qv, torch.full_like(qv, 1.5 * math.pi))
    dq = torch.where(t < 7.0, dq, torch.zeros_like(dq))
    return _with_constraint(params, next(iter(params["constraints"])),
                            qdot_target=_col(dq), q_target=_col(qv))


def _presc_body_profile(t):
    """The piecewise world linear velocity vt_w and body angular velocity
    wt_i of sceneFcn13/20 (testRedMaxScenes.m:1237-1279), with their time
    derivatives, each [..., 3]."""
    c = _col(t)
    ey, ex = _vec([0.0, 1.0, 0.0], t), _vec([1.0, 0.0, 0.0], t)
    z3 = torch.zeros_like(ey)
    in1 = c < 2.0
    in2 = (c >= 2.0) & (c < 4.0)
    in3 = (c >= 4.0) & (c < 6.0)
    in4 = (c >= 6.0) & (c < 8.0)
    wt = torch.where(in1, ey * -c, torch.where(in2, ey * (c - 4.0), torch.where(
        in3, ey * (c - 4.0), torch.where(in4, ey * -(c - 8.0), z3))))
    vt = torch.where(in3, ex * (-2 * (c - 4.0)), torch.where(in4, ex * (2 * (c - 8.0)), z3))
    wtd = torch.where(in1, -ey, torch.where(in2 | in3, ey, torch.where(in4, -ey, z3)))
    vtd = torch.where(in3, -2.0 * ex, torch.where(in4, 2.0 * ex, z3))
    return vt, wt, vtd, wtd


def scene_fn_13(params, t):
    """sceneFcn13: the prescribed world-frame motion of the last body (the
    constraint with a vt_w target)."""
    vt, wt, vtd, wtd = _presc_body_profile(t.to(params["h"].dtype))
    key = next(k for k, v in params["constraints"].items() if "vt_w" in v)
    return _with_constraint(params, key, vt_w=vt, wt_i=wt, vtdot_w=vtd, wtdot_i=wtd)


def scene_fn_20(params, t):
    """sceneFcn20: the body profile of scene_fn_13 and joint 3 on the
    sigmoid to pi/2 over t in [0, 10] (the constraint with a qdot_target)."""
    params = scene_fn_13(params, t)
    qv, dq, ddq = _sigmoid_target(t.to(params["h"].dtype), 0.0, 10.0, 7.0, math.pi / 2)
    key = next(k for k, v in params["constraints"].items() if "qdot_target" in v)
    return _with_constraint(params, key, q_target=_col(qv), qdot_target=_col(dq),
                            qddot_target=_col(ddq))


def _drive(params, speed):
    """The maximal-prescribed joint (the constraint whose only target is
    qdot_target) driven at a constant speed."""
    cons = dict(params["constraints"])
    key = next(k for k, v in cons.items() if set(v) == {"qdot_target"})
    cons[key] = {"qdot_target": torch.full((), speed, dtype=params["h"].dtype,
                                           device=params["h"].device)}
    return {**params, "constraints": cons}


def scene_fn_32(params, t):
    """sceneFcn32: the driven joint at -4 pi."""
    return _drive(params, -2.0 * (2.0 * math.pi))


def scene_fn_33(params, t):
    """sceneFcn33: the driven joint at +4 pi."""
    return _drive(params, 2.0 * (2.0 * math.pi))


M_SCENES: Dict[int, Callable[..., SceneBuilder]] = {
    -1: mscene_m1, 0: mscene_00, 1: mscene_01, 2: mscene_02, 3: mscene_03, 4: mscene_04,
    5: mscene_05, 6: mscene_06, 7: mscene_07, 8: mscene_08, 9: mscene_09, 10: mscene_10,
    11: mscene_11, 12: mscene_12, 13: mscene_13, 14: mscene_14, 15: mscene_15,
    16: mscene_16, 17: mscene_17, 18: mscene_18, 19: mscene_19, 20: mscene_20,
    21: mscene_21, 22: mscene_22, 23: mscene_23, 24: mscene_24, 25: mscene_25,
    26: mscene_26, 27: mscene_27, 28: mscene_28, 29: mscene_29, 30: mscene_30,
    31: mscene_31, 32: mscene_32, 33: mscene_33, 34: mscene_34, 35: mscene_35,
}
# The scene function of each case that has one.
SCENE_FNS: Dict[int, Callable] = {5: scene_fn_05, 9: scene_fn_09, 13: scene_fn_13,
                                  20: scene_fn_20, 32: scene_fn_32, 33: scene_fn_33}


def build_mscene(sid: int, obj=None, **compile_kw) -> CompiledScene:
    """Compile reference case sid; obj: the OBJ path of cases 26 and 34;
    compile_kw goes to SceneBuilder.compile (dtype, device)."""
    make = M_SCENES[sid]
    return (make(obj=obj) if sid in OBJ_CASES else make()).compile(**compile_kw)
