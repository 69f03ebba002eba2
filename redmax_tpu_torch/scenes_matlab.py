"""Scenes of the reference's feature-rich variant that exercise the linearly
implicit Euler path and the constraint subsystem. Each stores the
reference's Euler energy certificate (Hexpected["euler"], held to 1e-2).
Defaults: tspan [0, 2], h 1e-2, grav [0, 0, -980], baumgarte [5, 5, 5],
density 1.

Ported: case 4 (loop closure, dense KKT), case 6 (joint limit, dual PGS)
and case 7 (gear couplings). The rest of the zoo is not ported yet.
"""

import math
from typing import Callable, Dict

import numpy as np

from redmax_tpu_torch.scene import CompiledScene, SceneBuilder, transl
from redmax_tpu_torch.types import JointType


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


M_SCENES: Dict[int, Callable[[], SceneBuilder]] = {4: mscene_04, 6: mscene_06, 7: mscene_07}


def build_mscene(sid: int, **compile_kw) -> CompiledScene:
    """Compile reference case `sid`; compile_kw goes to SceneBuilder.compile
    (dtype, device)."""
    if sid not in M_SCENES:
        raise NotImplementedError(f"mscene {sid} is not ported yet (the ported cases: "
                                  f"{sorted(M_SCENES)})")
    return M_SCENES[sid]().compile(**compile_kw)
