"""Scene construction and compilation.

``SceneBuilder`` is the user-facing API: add bodies and joints, then
``compile()`` flattens everything into a ``CompiledScene`` — static Topology
+ SceneParams (a dict of tensors, in the JAX package's layout) + initial
State — on which the dynamics run as plain functions of batched tensors.

Constraints (loop closure, joint limit, floor contact, gear coupling) and
forces (penalty ground contact) are kept as (object, params) pairs and
compiled into ``constraint_fns`` / ``force_fns`` plus
``params["constraints"]`` / ``params["forces"]``. The other forces,
deformables, the prescribed-motion and attach-point constraints and friction
are not ported yet (ROADMAP queue 1 items 10, 13 and 15); their SceneBuilder
methods raise.
"""

import math
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from redmax_tpu_torch import constraints as con_mod
from redmax_tpu_torch import forces as forces_mod
from redmax_tpu_torch import integrators, model
from redmax_tpu_torch.joints import require_supported
from redmax_tpu_torch.types import NDOF, JointType, State, Topology

_BIG = 1e8  # default joint limit bounds and limit stiffness


@dataclass
class _BodySpec:
    density: float
    inertia: np.ndarray          # [6] diagonal
    E_ji: np.ndarray             # [4,4] body wrt joint
    name: str = ""
    sides: Optional[np.ndarray] = None
    radius: Optional[float] = None
    damping: float = 0.0         # viscous body damping


@dataclass
class _JointSpec:
    jtype: JointType
    parent: int                  # joint index, -1 for root
    body: int                    # body index (same as joint index)
    E_pj: np.ndarray             # [4,4]
    params: Dict[str, np.ndarray] = field(default_factory=dict)
    q: Optional[np.ndarray] = None
    qdot: Optional[np.ndarray] = None
    stiffness: float = 0.0
    damping: float = 0.0
    qrest: Optional[np.ndarray] = None
    qlimL: float = -_BIG
    qlimU: float = _BIG
    qlimK: float = _BIG
    qlimD: float = 0.0
    name: str = ""


def _np_inertia_cuboid(sides, density):
    sides = np.asarray(sides, dtype=np.float64)
    mass = density * np.prod(sides)
    s2 = sides * sides
    return np.array(
        [
            mass / 12.0 * (s2[1] + s2[2]),
            mass / 12.0 * (s2[2] + s2[0]),
            mass / 12.0 * (s2[0] + s2[1]),
            mass,
            mass,
            mass,
        ]
    )


def _np_inertia_sphere(radius, density):
    mass = density * 4.0 / 3.0 * math.pi * radius**3
    i = 0.4 * mass * radius * radius
    return np.array([i, i, i, mass, mass, mass])


def _np_inertia_cylinder(radius, height, density):
    mass = density * math.pi * radius * radius * height
    ix = mass * (3 * radius * radius + height * height) / 12.0
    iz = 0.5 * mass * radius * radius
    return np.array([ix, ix, iz, mass, mass, mass])


def transl(p) -> np.ndarray:
    E = np.eye(4)
    E[:3, 3] = p
    return E


def _not_ported(what: str, item: str):
    raise NotImplementedError(f"{what} is not ported yet (ROADMAP queue 1 item {item})")


class SceneBuilder:
    """Imperative scene assembly, compiled once to tensors.

    Joint i owns body i; insertion order must be topological (parent before
    child).
    """

    def __init__(self, name="", h=1e-2, tEnd=1.0, grav=(0.0, 0.0, -980.0)):
        self.name = name
        self.h = h
        self.tEnd = tEnd
        self.grav = np.asarray(grav, dtype=np.float64)
        self.bodies: List[_BodySpec] = []
        self.joints: List[_JointSpec] = []
        self.constraints: List[Tuple[Any, Dict[str, Any]]] = []  # (object, params)
        self.forces: List[Tuple[Any, Dict[str, Any]]] = []       # (object, params)
        self.baumgarte = np.array([5.0, 5.0, 5.0])
        self.fric = False
        self.mu = np.array([0.6, 0.6])
        self.Hexpected: Dict[str, float] = {}

    # -- bodies ------------------------------------------------------------
    def _add_body(self, spec: _BodySpec) -> int:
        self.bodies.append(spec)
        return len(self.bodies) - 1

    @staticmethod
    def _E(E_ji):
        return np.eye(4) if E_ji is None else np.asarray(E_ji, dtype=np.float64)

    def body_cuboid(self, density, sides, E_ji=None, name="") -> int:
        return self._add_body(_BodySpec(
            density=density, inertia=_np_inertia_cuboid(sides, density),
            E_ji=self._E(E_ji), name=name, sides=np.asarray(sides, dtype=np.float64),
        ))

    def body_sphere(self, density, radius, E_ji=None, name="") -> int:
        return self._add_body(_BodySpec(
            density=density, inertia=_np_inertia_sphere(radius, density),
            E_ji=self._E(E_ji), name=name, radius=radius,
        ))

    def body_cylinder(self, density, radius, height, E_ji=None, name="") -> int:
        return self._add_body(_BodySpec(
            density=density, inertia=_np_inertia_cylinder(radius, height, density),
            E_ji=self._E(E_ji), name=name,
        ))

    def set_body_damping(self, body: int, d: float) -> None:
        self.bodies[body].damping = d

    # -- joints ------------------------------------------------------------
    def joint(self, jtype: JointType, parent: Optional[int], body: int, E_pj=None,
              q=None, qdot=None, name="", **jparams) -> int:
        require_supported(jtype)
        d = NDOF[jtype]
        if body != len(self.joints):
            raise ValueError("joint i must own body i (add in order)")
        params = {}
        if jtype in (JointType.REVOLUTE, JointType.PRISMATIC):
            axis = np.asarray(jparams.pop("axis"), dtype=np.float64)
            params["axis"] = axis / np.linalg.norm(axis)
        elif jtype == JointType.PLANAR:
            plane = np.asarray(
                jparams.pop("plane", np.array([[1.0, 0, 0], [0, 1.0, 0]]).T),
                dtype=np.float64,
            )
            params["plane"] = plane / np.linalg.norm(plane, axis=0, keepdims=True)
        spec = _JointSpec(
            jtype=jtype,
            parent=-1 if parent is None else parent,
            body=body,
            E_pj=np.eye(4) if E_pj is None else np.asarray(E_pj, dtype=np.float64),
            params=params,
            q=np.zeros(d) if q is None else np.atleast_1d(np.asarray(q, dtype=np.float64)),
            qdot=np.zeros(d) if qdot is None else np.atleast_1d(np.asarray(qdot, dtype=np.float64)),
            name=name,
        )
        for k, v in jparams.items():
            setattr(spec, k, v)
        self.joints.append(spec)
        return len(self.joints) - 1

    def set_stiffness(self, j: int, k: float) -> None:
        self.joints[j].stiffness = k

    def set_damping(self, j: int, d: float) -> None:
        self.joints[j].damping = d

    def set_limits(self, j: int, lower=-_BIG, upper=_BIG, k=_BIG, d=0.0) -> None:
        self.joints[j].qlimL = lower
        self.joints[j].qlimU = upper
        self.joints[j].qlimK = k
        self.joints[j].qlimD = d

    # -- not ported yet ----------------------------------------------------
    def force_point_point(self, *a, **k):
        _not_ported("ForcePointPoint", "10")

    def force_spring_damper(self, *a, **k):
        _not_ported("ForceSpringDamper", "10")

    def force_cable(self, *a, **k):
        _not_ported("ForceCable", "10")

    def deformable_spring(self, *a, **k):
        _not_ported("deformable springs", "10")

    def constraint_presc_joint(self, *a, **k):
        _not_ported("prescribed-motion constraints", "13")

    constraint_presc_joint_m = constraint_presc_body = constraint_presc_joint

    # -- forces ------------------------------------------------------------
    def force_ground_cuboid(self, body, E_ground=None, kn=1.0, kt=0.0, kd=0.0, mu=0.0) -> None:
        """Penalty ground contact on the 8 corners of a cuboid body; the floor
        is the z = 0 plane of E_ground (z-up)."""
        sides = self.bodies[body].sides
        if sides is None:
            raise ValueError("ground contact requires a cuboid body")
        self.forces.append((
            forces_mod.ForceGroundCuboid(f"f{len(self.forces)}", body),
            {"E": self._E(E_ground), "sides": sides, "kn": np.float64(kn),
             "kt": np.float64(kt), "kd": np.float64(kd), "mu": np.float64(mu)},
        ))

    # -- constraints -------------------------------------------------------
    def _con_key(self) -> str:
        return f"c{len(self.constraints)}"

    def _dof(self, joint: int) -> int:
        return sum(NDOF[self.joints[j].jtype] for j in range(joint))

    def constraint_loop(self, bodyA, bodyB, xA, xB) -> None:
        """Loop closure; body A's joint must be revolute (its axis defines
        the basis of the two constrained directions)."""
        axisA = self.joints[bodyA].params["axis"]
        self.constraints.append((
            con_mod.ConstraintLoop(self._con_key(), bodyA, bodyB),
            {"xA": np.asarray(xA, dtype=np.float64), "xB": np.asarray(xB, dtype=np.float64),
             "axisA": np.asarray(axisA, dtype=np.float64)},
        ))

    def constraint_joint_limit(self, joint: int, ql: float, qu: float) -> None:
        self.constraints.append((
            con_mod.ConstraintJointLimit(self._con_key(), self._dof(joint)),
            {"ql": np.float64(ql), "qu": np.float64(qu)},
        ))

    def constraint_floor(self, body: int, E=None) -> None:
        radius = self.bodies[body].radius
        if radius is None:
            raise ValueError("floor contact requires a sphere body")
        self.constraints.append((
            con_mod.ConstraintFloor(self._con_key(), body),
            {"E": self._E(E), "radius": np.float64(radius)},
        ))

    def constraint_multq(self, jointA: int, jointB: int, factor: float) -> None:
        self.constraints.append((
            con_mod.ConstraintMultQ(self._con_key(), self._dof(jointA), self._dof(jointB)),
            {"factor": np.float64(factor)},
        ))

    # -- compile -----------------------------------------------------------
    def compile(self, dtype=torch.float64, device="cuda") -> "CompiledScene":
        if self.fric:
            _not_ported("frictional stepping", "15")
        N = len(self.joints)
        if N != len(self.bodies):
            raise ValueError("every body needs a joint")
        qstart, ndof = [], []
        off = 0
        for js in self.joints:
            if js.parent >= js.body:
                raise ValueError("insertion order must be topological")
            qstart.append(off)
            ndof.append(NDOF[js.jtype])
            off += NDOF[js.jtype]
        nr = off
        topo = Topology(
            njoints=N,
            nr=nr,
            parent=tuple(js.parent for js in self.joints),
            jtype=tuple(int(js.jtype) for js in self.joints),
            qstart=tuple(qstart),
            ndof=tuple(ndof),
        )

        def T(a):
            return torch.as_tensor(np.asarray(a, dtype=np.float64), dtype=dtype, device=device)

        def per_dof(getter, default=0.0):
            out = np.full(nr, default, dtype=np.float64)
            for i, js in enumerate(self.joints):
                out[qstart[i]: qstart[i] + ndof[i]] = getter(js)
            return out

        q0 = np.zeros(nr)
        qdot0 = np.zeros(nr)
        qrest = np.zeros(nr)
        for i, js in enumerate(self.joints):
            sl = slice(qstart[i], qstart[i] + ndof[i])
            q0[sl] = js.q
            qdot0[sl] = js.qdot
            qrest[sl] = js.q if js.qrest is None else js.qrest

        jt_params: Dict[str, Dict[str, Any]] = {}
        for jt, members in topo.type_groups().items():
            keys = set()
            for m in members:
                keys |= set(self.joints[m].params.keys())
            if keys:
                jt_params[str(int(jt))] = {
                    k: T(np.stack([self.joints[m].params[k] for m in members]))
                    for k in sorted(keys)
                }

        params: Dict[str, Any] = {
            "E0_pj": T(np.stack([j.E_pj for j in self.joints])),
            "E0_ji": T(np.stack([b.E_ji for b in self.bodies])),
            "I_i": T(np.stack([b.inertia for b in self.bodies])),
            "body_damping": T([b.damping for b in self.bodies]),
            "g": T(self.grav),
            "h": T(self.h),
            "stiffness": T(per_dof(lambda j: j.stiffness)),
            "damping": T(per_dof(lambda j: j.damping)),
            "tau": T(np.zeros(nr)),
            "qrest": T(qrest),
            "qlimL": T(per_dof(lambda j: j.qlimL, -_BIG)),
            "qlimU": T(per_dof(lambda j: j.qlimU, _BIG)),
            "qlimK": T(per_dof(lambda j: j.qlimK, _BIG)),
            "qlimD": T(per_dof(lambda j: j.qlimD, 0.0)),
            "baumgarte": T(self.baumgarte),
            "mu": T(self.mu),
            "joint": jt_params,
            "constraints": {obj.key: {k: T(v) for k, v in cp.items()}
                            for obj, cp in self.constraints},
            "forces": {obj.key: {k: T(v) for k, v in fp.items()} for obj, fp in self.forces},
        }
        state0 = State(q=T(q0), qdot=T(qdot0), aux={})
        return CompiledScene(
            name=self.name, topo=topo, params=params, state0=state0,
            force_fns=tuple(obj for obj, _ in self.forces),
            constraint_fns=tuple(obj for obj, _ in self.constraints),
            h=self.h, tEnd=self.tEnd, Hexpected=dict(self.Hexpected),
        )


@dataclass
class CompiledScene:
    name: str
    topo: Topology
    params: Dict[str, Any]
    state0: State
    force_fns: tuple
    constraint_fns: tuple
    h: float
    tEnd: float
    Hexpected: Dict[str, float]

    @property
    def nsteps(self) -> int:
        return math.ceil(self.tEnd / self.h)

    def assemble(self, q, qdot):
        """(M [B,nr,nr], f [B,nr], aux) at batched (q, qdot) [B, nr]."""
        return model.assemble(self.topo, self.params, q, qdot, self.force_fns)

    def energies(self, q, qdot):
        """(T [B], V [B]) at batched (q, qdot) [B, nr]."""
        return model.energies(self.topo, self.params, q, qdot, self.force_fns)

    def make_step(self, integrator: str, cfg: Optional["integrators.NewtonConfig"] = None):
        """A batched step function over [B, nr] states: "bdf2" or "euler"
        (the op-level routes; the kernel routes are
        integrators.make_bdf2_step_batched / make_euler_step_batched)."""
        if integrator == "bdf2":
            return integrators.make_bdf2_step(self.topo, self.force_fns,
                                              cfg or integrators.NewtonConfig())
        if integrator == "euler":
            return integrators.make_euler_step(self.topo, self.force_fns, self.constraint_fns)
        if integrator in ("bdf1", "euler_fric"):
            _not_ported(f"the {integrator!r} step", "13" if integrator == "bdf1" else "15")
        raise ValueError(integrator)

    def initial_state(self, integrator: str, B: int = 1):
        """state0 broadcast to B lanes, as the integrator's state type."""
        s = State(q=self.state0.q.expand(B, -1).contiguous(),
                  qdot=self.state0.qdot.expand(B, -1).contiguous(), aux={})
        return integrators.bdf2_init(s) if integrator == "bdf2" else s
