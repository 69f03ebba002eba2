"""Core data model: joint types, static scene topology, and dynamic state.

A scene compiles once into:

  * ``Topology`` — static (Python-level, hashable) structural data: parent
    indices, joint types, reduced-DOF offsets, ancestor masks.
  * ``SceneParams`` — a nested dict of tensors: transforms, inertias,
    stiffnesses, torques, gravity.
  * ``State`` — the dynamic state (q, qdot), batch-first: every tensor
    carries a leading [B] lane dimension on the batched paths.
"""

import enum
from dataclasses import dataclass, field
from typing import Any, Dict, List, Tuple

import numpy as np


class JointType(enum.IntEnum):
    """Joint zoo (same values as the JAX package's JointType)."""

    FIXED = 0
    REVOLUTE = 1
    PRISMATIC = 2
    PLANAR = 3
    TRANSLATIONAL = 4
    UNIVERSAL = 5
    SPHERICAL = 6
    FREE2D = 7
    FREE3D = 8
    SPHERICAL_EULER = 9
    SPLINE_CURVE = 10
    FREE3D_EULER = 11
    SPLINE_SURFACE = 12
    COMPOSITE_RP = 13
    FREE_ST = 14


NDOF: Dict[JointType, int] = {
    JointType.FIXED: 0,
    JointType.REVOLUTE: 1,
    JointType.PRISMATIC: 1,
    JointType.PLANAR: 2,
    JointType.TRANSLATIONAL: 3,
    JointType.UNIVERSAL: 2,
    JointType.SPHERICAL: 3,
    JointType.FREE2D: 3,
    JointType.FREE3D: 6,
    JointType.SPHERICAL_EULER: 3,
    JointType.SPLINE_CURVE: 1,
    JointType.FREE3D_EULER: 6,
    JointType.SPLINE_SURFACE: 2,
    JointType.COMPOSITE_RP: 2,
    JointType.FREE_ST: 6,
}

MAX_NDOF = 6


@dataclass(frozen=True)
class Topology:
    """Static structure of a compiled scene. Hashable.

    Joint i owns body i (same index). Joints are stored in topological order
    (parent before child); the root has parent -1.
    """

    njoints: int
    nr: int                       # total reduced DOFs
    parent: Tuple[int, ...]       # parent joint index per joint (-1 = root)
    jtype: Tuple[int, ...]        # JointType value per joint
    qstart: Tuple[int, ...]       # offset of each joint's DOFs in the flat q
    ndof: Tuple[int, ...]         # DOFs per joint

    def ancestor_mask(self) -> np.ndarray:
        """anc[i, a] = 1.0 iff joint a is an ancestor of i or i itself."""
        n = self.njoints
        anc = np.zeros((n, n), dtype=np.float64)
        for i in range(n):
            a = i
            while a >= 0:
                anc[i, a] = 1.0
                a = self.parent[a]
        return anc

    def doubling_rounds(self) -> Tuple[np.ndarray, ...]:
        """Static pointer-doubling schedule for the FK world chain.

        Round k holds ptr_k[i] = the 2^k-th ancestor of joint i (or the
        virtual world node N when exhausted). Composing
        E[i] <- E[ptr_k[i]] @ E[i] for k = 0.. gives every world transform
        in O(log depth) batched 4x4 matmul rounds.
        """
        n = self.njoints
        ptr = np.array([p if p >= 0 else n for p in self.parent] + [n], dtype=np.int64)
        rounds = []
        while np.any(ptr[:n] != n):
            rounds.append(ptr.copy())
            ptr = ptr[ptr]
        return tuple(rounds)

    def dof_joint(self) -> np.ndarray:
        """Map each reduced DOF to its owning joint index: shape [nr]."""
        out = np.zeros(self.nr, dtype=np.int64)
        for i in range(self.njoints):
            out[self.qstart[i]: self.qstart[i] + self.ndof[i]] = i
        return out

    def dof_index(self) -> np.ndarray:
        """Map each reduced DOF to its index within its joint: shape [nr]."""
        out = np.zeros(self.nr, dtype=np.int64)
        for i in range(self.njoints):
            out[self.qstart[i]: self.qstart[i] + self.ndof[i]] = np.arange(self.ndof[i])
        return out

    def type_groups(self) -> Dict[int, Tuple[int, ...]]:
        """Joint indices grouped by type (static grouping for batched evaluation)."""
        groups: Dict[int, List[int]] = {}
        for i, t in enumerate(self.jtype):
            groups.setdefault(t, []).append(i)
        return {t: tuple(g) for t, g in groups.items()}


@dataclass
class State:
    """Reduced-coordinate state. q, qdot: shape [B, nr] on the batched paths.

    aux holds per-joint discrete state (Euler charts); it stays empty for the
    joint types this package implements.
    """

    q: Any
    qdot: Any
    aux: Any = field(default_factory=dict)


# SceneParams is a nested dict with this layout (the JAX package's layout):
#
#   {
#     "E0_pj":   [N, 4, 4]   joint-wrt-parent-joint rest transform
#     "E0_ji":   [N, 4, 4]   body-wrt-joint transform
#     "I_i":     [N, 6]      diagonal body-frame inertia
#     "body_damping": [N]    viscous body damping
#     "g":       [3]         gravity
#     "h":       []          timestep
#     "stiffness", "damping", "qrest", "tau": [nr]  (tau may be [B, nr])
#     "qlimL", "qlimU", "qlimK", "qlimD": [nr]  penalty joint limits
#     "baumgarte": [3], "mu": [2]
#     "joint": { str(JointType): per-type param array [G, ...] }  (e.g. axes)
#     "constraints": {}, "forces": {}
#   }
SceneParams = Dict[str, Any]
