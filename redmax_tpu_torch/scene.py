"""Scene construction and compilation.

``SceneBuilder`` is the user-facing API: add bodies and joints, then
``compile()`` flattens everything into a ``CompiledScene`` — static Topology
+ SceneParams (a dict of tensors, in the JAX package's layout) + initial
State — on which the dynamics run as plain functions of batched tensors.

Bodies are cuboids, spheres, cylinders, OBJ meshes and rigid composites
(mesh.py); every joint type, and two joints in series through a massless
link (joint_composite). Constraints (loop closure, joint limit, floor
contact, gear coupling, prescribed motion, a deformable spring's attached
ends) and forces (penalty ground contact, point-point springs, spring-dampers
of both variants, cables, a constant point force, a deformable spring's
segments, any closure given to add_force) are kept as (object, params)
pairs and compiled into ``constraint_fns`` / ``force_fns`` plus
``params["constraints"]`` / ``params["forces"]``; a spring-damper's or
cable's rest length L = 0 is set at compile from the initial configuration,
and so are a deformable spring's node positions and segment lengths.
A scene that sets fric also compiles its friction model (friction.py: the
contact rings of its joints and loop closures, its floor contacts) and
starts aux["fbm"] at zeros [6N]; its step is make_step("euler_fric").
"""

import math
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from redmax_tpu_torch import constraints as con_mod
from redmax_tpu_torch import forces as forces_mod
from redmax_tpu_torch import friction, integrators, joints, mesh, model, se3
from redmax_tpu_torch.euler import DEFAULT_CHART
from redmax_tpu_torch.types import EULER_CHART_TYPES, NDOF, JointType, State, Topology

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
    E_oi: Optional[np.ndarray] = None    # a mesh body's inertial frame in its OBJ frame
    mesh: Optional[Tuple[np.ndarray, np.ndarray]] = None   # (V, F) of a mesh body


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
        # (node bodies, body0, r0, body1, r1, force key) of each deformable spring
        self._deform_inits: List[Tuple] = []
        # editing paths of critical points (sceneio's #spline stanza): metadata
        self.spline_paths: List[Dict[str, Any]] = []

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

    def body_mesh_obj(self, density, obj_path, name="") -> int:
        """A body from an OBJ mesh (BodyMeshObj): its diagonal inertia and
        inertial frame E_oi by mesh.mesh_mass_properties. As in the
        reference, set_body_transform(body, E0 @ E_oi) then places it
        (testRedMaxScenes.m:781)."""
        V, F = mesh.read_obj(obj_path)
        I6, E_oi = mesh.mesh_mass_properties(V, F, density)
        return self._add_body(_BodySpec(density=density, inertia=I6, E_ji=np.eye(4), name=name,
                                        E_oi=E_oi, mesh=(V, F)))

    def body_composite(self, parts, name="") -> int:
        """A rigid composite (BodyComposite) of (part, E) pairs in the joint
        frame, a part an inertia [6] or ("cuboid", density, sides),
        ("cylinder", density, radius, height), ("sphere", density, radius);
        its E_ji is the composite's inertial frame (testRedMaxScenes.m:760)."""
        inertias, Es = [], []
        for part, E in parts:
            if isinstance(part, tuple):
                kind = part[0]
                if kind == "cuboid":
                    I6 = _np_inertia_cuboid(part[2], part[1])
                elif kind == "cylinder":
                    I6 = _np_inertia_cylinder(part[2], part[3], part[1])
                elif kind == "sphere":
                    I6 = _np_inertia_sphere(part[2], part[1])
                else:
                    raise ValueError(kind)
            else:
                I6 = np.asarray(part, dtype=np.float64)
            inertias.append(I6)
            Es.append(np.asarray(E, dtype=np.float64))
        I6, E_jc = mesh.composite_mass_properties(inertias, Es)
        return self._add_body(_BodySpec(density=0.0, inertia=I6, E_ji=E_jc, name=name))

    def set_body_damping(self, body: int, d: float) -> None:
        self.bodies[body].damping = d

    def set_body_transform(self, body: int, E_ji) -> None:
        self.bodies[body].E_ji = np.asarray(E_ji, dtype=np.float64)

    # -- joints ------------------------------------------------------------
    def joint(self, jtype: JointType, parent: Optional[int], body: int, E_pj=None,
              q=None, qdot=None, name="", **jparams) -> int:
        """Joint `body` of type jtype under the joint `parent` (None: the
        root). Type params: axis (REVOLUTE, PRISMATIC), plane (PLANAR),
        axis1 and axis2 (COMPOSITE_RP), control_frames [ncfs of 4x4]
        (SPLINE_CURVE: the relative twists dCs[j] = log(C_{j-1}^-1 C_j),
        cyclic, JointSplineCurve.m:44-57), control_values [4, 4, 6]
        (SPLINE_SURFACE). Other keywords become attributes of the joint's
        spec (as the reference scenes set contact_sides, ...)."""
        d = NDOF[jtype]
        if body != len(self.joints):
            raise ValueError("joint i must own body i (add in order)")
        params = {}
        unit = lambda a: np.asarray(a, dtype=np.float64) / np.linalg.norm(a)
        if jtype in (JointType.REVOLUTE, JointType.PRISMATIC):
            params["axis"] = unit(jparams.pop("axis"))
        elif jtype == JointType.PLANAR:
            plane = np.asarray(
                jparams.pop("plane", np.array([[1.0, 0, 0], [0, 1.0, 0]]).T),
                dtype=np.float64,
            )
            params["plane"] = plane / np.linalg.norm(plane, axis=0, keepdims=True)
        elif jtype == JointType.SPLINE_CURVE:
            Cs = np.stack([np.asarray(C, dtype=np.float64)
                           for C in jparams.pop("control_frames")])
            prev = np.roll(Cs, 1, axis=0)
            rel = torch.as_tensor(np.linalg.inv(prev) @ Cs, dtype=torch.float64)
            params["Cs"], params["dCs"] = Cs, se3.log6(rel).numpy()
        elif jtype == JointType.COMPOSITE_RP:
            params["axis1"] = unit(jparams.pop("axis1"))
            params["axis2"] = unit(jparams.pop("axis2"))
        elif jtype == JointType.SPLINE_SURFACE:
            params["cs"] = np.asarray(jparams.pop("control_values"), dtype=np.float64)
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

    def joint_composite(self, jt1: JointType, jt2: JointType, parent: Optional[int], body: int,
                        E_pj=None, q=None, qdot=None, name="", p1: Optional[Dict] = None,
                        p2: Optional[Dict] = None) -> Tuple[int, int]:
        """Two joints in series for any (jt1, jt2) (JointComposite.m:38-72):
        jt1 owns a massless link body at the composite's joint frame and jt2
        (E_pj = I) owns `body`, which is Q = Q1 Q2 with S = [Ad(Q2^-1) S1,
        S2] (joints.make_composite). q, qdot concatenate the two joints'
        coordinates; p1, p2 are their type params ({"axis": ...}). The
        link adds nothing to the mass matrix or gravity, and every DOF moves
        the real body, so Mr stays positive definite. Create `body` just
        before. Returns the two joint indices."""
        if body != len(self.joints):
            raise ValueError("create the composite's body immediately before joint_composite")
        self.bodies.insert(body, _BodySpec(density=0.0, inertia=np.zeros(6), E_ji=np.eye(4),
                                           name=(name or "composite") + "_link"))
        d1, d2 = NDOF[jt1], NDOF[jt2]
        q = np.zeros(d1 + d2) if q is None else np.atleast_1d(np.asarray(q, dtype=np.float64))
        qdot = np.zeros(d1 + d2) if qdot is None else np.atleast_1d(
            np.asarray(qdot, dtype=np.float64))
        j1 = self.joint(jt1, parent, body, E_pj=E_pj, q=q[:d1], qdot=qdot[:d1],
                        name=(name or "composite") + "_1", **(p1 or {}))
        j2 = self.joint(jt2, j1, body + 1, E_pj=np.eye(4), q=q[d1:], qdot=qdot[d1:],
                        name=(name or "composite") + "_2", **(p2 or {}))
        return j1, j2

    def set_stiffness(self, j: int, k: float) -> None:
        self.joints[j].stiffness = k

    def set_damping(self, j: int, d: float) -> None:
        self.joints[j].damping = d

    def set_limits(self, j: int, lower=-_BIG, upper=_BIG, k=_BIG, d=0.0) -> None:
        self.joints[j].qlimL = lower
        self.joints[j].qlimU = upper
        self.joints[j].qlimK = k
        self.joints[j].qlimD = d

    # -- forces ------------------------------------------------------------
    def _force_key(self) -> str:
        return f"f{len(self.forces)}"

    def force_ground_cuboid(self, body, E_ground=None, kn=1.0, kt=0.0, kd=0.0, mu=0.0) -> None:
        """Penalty ground contact on the 8 corners of a cuboid body; the floor
        is the z = 0 plane of E_ground (z-up)."""
        sides = self.bodies[body].sides
        if sides is None:
            raise ValueError("ground contact requires a cuboid body")
        self.forces.append((
            forces_mod.ForceGroundCuboid(self._force_key(), body),
            {"E": self._E(E_ground), "sides": sides, "kn": np.float64(kn),
             "kt": np.float64(kt), "kd": np.float64(kd), "mu": np.float64(mu)},
        ))

    def force_point_point(self, body1, body2, xl1, xl2, k, d=0.0) -> None:
        """Zero-rest-length spring and damper between point xl1 of body1 and
        point xl2 of body2 (body -1: a world point, xl in world coordinates)."""
        self.forces.append((
            forces_mod.ForcePointPoint(self._force_key(), body1, body2),
            {"xl1": np.asarray(xl1, dtype=np.float64), "xl2": np.asarray(xl2, dtype=np.float64),
             "k": np.float64(k), "d": np.float64(d)},
        ))

    def force_spring_damper(self, body1, body2, xl1, xl2, k, d=0.0, L=0.0) -> None:
        """Strain spring and damper between two body points; L = 0 sets the
        rest length to their distance in the initial configuration at compile
        (ForceSpringDamper.init_, ForceSpringDamper.m:38-59)."""
        self.forces.append((
            forces_mod.ForceSpringDamper(self._force_key(), body1, body2),
            {"xl1": np.asarray(xl1, dtype=np.float64), "xl2": np.asarray(xl2, dtype=np.float64),
             "k": np.float64(k), "d": np.float64(d), "L": np.float64(L)},
        ))

    def force_cable(self, bodies, xls, k, d=0.0, L=0.0) -> None:
        """Tension-only cable through the points xls [P, 3] of bodies; L = 0
        sets the rest length to the summed segment lengths at compile."""
        self.forces.append((
            forces_mod.ForceCable(self._force_key(), bodies),
            {"xls": np.asarray(xls, dtype=np.float64), "k": np.float64(k),
             "d": np.float64(d), "L": np.float64(L)},
        ))

    def force_spring_damper_m(self, body1, body2, xl1, xl2, k, d=0.0, L=0.0) -> None:
        """The feature-rich variant's spring-damper (forces.SpringDamperM, its
        own sign conventions); L = 0 sets the rest length at compile."""
        self.forces.append((
            forces_mod.SpringDamperM(self._force_key(), body1, body2),
            {"xl1": np.asarray(xl1, dtype=np.float64), "xl2": np.asarray(xl2, dtype=np.float64),
             "k": np.float64(k), "d": np.float64(d), "L": np.float64(L)},
        ))

    def force_point_direction(self, body, xl, d, k) -> None:
        """The constant world force k d at the body point xl
        (forces.ForcePointDirection)."""
        self.forces.append((
            forces_mod.ForcePointDirection(self._force_key(), body),
            {"xl": np.asarray(xl, dtype=np.float64), "d": np.asarray(d, dtype=np.float64),
             "k": np.float64(k)},
        ))

    def add_force(self, force_obj, fparams: Dict[str, Any]) -> None:
        """Register a closure of the forces.py protocol with its params
        (params["forces"][force_obj.key]); one with no closed-form K/D
        blocks must set implicit_KD = False (model._split_closures)."""
        self.forces.append((force_obj, fparams))

    # -- deformables -------------------------------------------------------
    def deformable_spring(self, nnodes, stiffness, mass, body0, r0, body1, r1,
                          damping=0.0) -> List[int]:
        """A serial point-mass spring of nnodes nodes (DeformableSpring with
        ConstraintAttachSpring, matlab/+redmax/DeformableSpring.m): each
        node a translational root joint carrying a point mass mass/nnodes
        (rotational inertia 1e-9, never excited), the segments a
        forces.ForceDeformableSegments, the two ends attached to the point
        r0 of body0 and r1 of body1 (body -1 or None: a world point) by
        constraints.ConstraintAttachPoint. The nodes start evenly spaced
        between the ends and the rest lengths are those segments' lengths,
        both set at compile (DeformableSpring.initGeometry_). Returns the
        node bodies."""
        node_ids = []
        eps = 1e-9
        for _ in range(nnodes):
            b = self._add_body(_BodySpec(
                density=0.0, inertia=np.array([eps, eps, eps] + [mass / nnodes] * 3),
                E_ji=np.eye(4), name=f"defnode{len(self.bodies)}"))
            j = self.joint(JointType.TRANSLATIONAL, None, b)
            if damping:
                self.set_damping(j, damping)
            node_ids.append(b)
        key = self._force_key()
        self.forces.append((forces_mod.ForceDeformableSegments(key, node_ids),
                            {"K": np.float64(stiffness), "L": np.zeros(nnodes - 1)}))
        body0 = -1 if body0 is None else body0
        body1 = -1 if body1 is None else body1
        for body, r, node in ((body0, r0, node_ids[0]), (body1, r1, node_ids[-1])):
            self.constraints.append((con_mod.ConstraintAttachPoint(self._con_key(), body, node),
                                     {"r": np.asarray(r, dtype=np.float64)}))
        self._deform_inits.append((node_ids, body0, r0, body1, r1, key))
        return node_ids

    # -- constraints -------------------------------------------------------
    def _con_key(self) -> str:
        return f"c{len(self.constraints)}"

    def _dof(self, joint: int) -> int:
        return sum(NDOF[self.joints[j].jtype] for j in range(joint))

    def constraint_loop(self, bodyA, bodyB, xA, xB, radius=1.0, height=1.0) -> None:
        """Loop closure; body A's joint must be revolute (its axis defines
        the basis of the two constrained directions). radius and height
        (the joint ring's contact geometry) are kept on the constraint as
        metadata."""
        axisA = self.joints[bodyA].params["axis"]
        self.constraints.append((
            con_mod.ConstraintLoop(self._con_key(), bodyA, bodyB, radius, height),
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

    def constraint_presc_joint(self, joint: int, qdot_target) -> None:
        """Prescribe the velocity of a joint's DOFs (ConstraintPrescJoint);
        a scene function may set q_target, qdot_target, qddot_target."""
        start, d = self._dof(joint), NDOF[self.joints[joint].jtype]
        self.constraints.append((
            con_mod.ConstraintPrescJoint(self._con_key(), range(start, start + d)),
            {"qdot_target": np.atleast_1d(np.asarray(qdot_target, np.float64))},
        ))

    def constraint_presc_joint_m(self, joint: int) -> None:
        """Prescribe a revolute joint by one maximal row
        (ConstraintPrescJointM); its qdot_target is set by a scene
        function."""
        axis = np.asarray(self.joints[joint].params["axis"])
        self.constraints.append((
            con_mod.ConstraintPrescJointM(self._con_key(), joint, self.joints[joint].parent,
                                          int(np.argmax(np.abs(axis)))),
            {"qdot_target": np.float64(0.0)},
        ))

    def constraint_presc_body_w(self, body: int, comps) -> None:
        """World-frame prescribed body motion on the twist components comps
        (ConstraintPrescBodyW); its targets are set by a scene function."""
        z = np.zeros(3)
        self.constraints.append((
            con_mod.ConstraintPrescBodyW(self._con_key(), body, comps),
            {"vt_w": z, "wt_i": z, "vtdot_w": z, "wtdot_i": z},
        ))

    def constraint_presc_body(self, body: int, comps, phi_target) -> None:
        """Prescribed body twist components (ConstraintPrescBody)."""
        self.constraints.append((
            con_mod.ConstraintPrescBody(self._con_key(), body, comps),
            {"phi_target": np.atleast_1d(np.asarray(phi_target, np.float64))},
        ))

    # -- compile -----------------------------------------------------------
    def _init_deformables(self) -> None:
        """Each deformable spring's node positions (its joints' q) evenly
        spaced between its ends, and its segments' rest lengths
        (DeformableSpring.initGeometry_, DeformableSpring.m:61-91), the ends
        placed by forward kinematics of the joints' initial q in float64."""
        if not self._deform_inits:
            return
        E_wi = []
        for i, js in enumerate(self.joints):
            pj = {k: torch.as_tensor(v, dtype=torch.float64)[None] for k, v in js.params.items()}
            if js.jtype in EULER_CHART_TYPES:
                pj["chart"] = torch.full((1,), DEFAULT_CHART, dtype=torch.int64)
            q = torch.as_tensor(js.q, dtype=torch.float64)[None]
            Q = joints.joint_QSSdot(js.jtype, q, torch.zeros_like(q), pj)[0][0].numpy()
            E_wj = js.E_pj @ Q if js.parent < 0 else E_wi[js.parent][1] @ js.E_pj @ Q
            E_wi.append((E_wj @ self.bodies[i].E_ji, E_wj))

        def world_pt(b, r):
            if b < 0:
                return np.asarray(r, dtype=np.float64)
            E = E_wi[b][0]
            return E[:3, :3] @ np.asarray(r) + E[:3, 3]

        for node_ids, body0, r0, body1, r1, fkey in self._deform_inits:
            x0, x1 = world_pt(body0, r0), world_pt(body1, r1)
            n = len(node_ids)
            xs = [(1 - i / (n - 1)) * x0 + (i / (n - 1)) * x1 for i in range(n)]
            for i, b in enumerate(node_ids):
                self.joints[b].q = xs[i].copy()
            for obj, fp in self.forces:
                if obj.key == fkey:
                    fp["L"] = np.array([np.linalg.norm(xs[i + 1] - xs[i]) for i in range(n - 1)])

    def compile(self, dtype=torch.float64, device="cuda") -> "CompiledScene":
        self._init_deformables()
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
        aux0 = {}
        if self.fric:
            aux0["fbm"] = torch.zeros(6 * N, dtype=dtype, device=device)
        if topo.euler_joints():
            aux0["euler_chart"] = torch.full((len(topo.euler_joints()),), DEFAULT_CHART,
                                             dtype=torch.int64, device=device)
        state0 = State(q=T(q0), qdot=T(qdot0), aux=aux0)
        self._init_rest_lengths(topo, params, state0, dtype)
        constraint_fns = tuple(obj for obj, _ in self.constraints)
        friction_model = None
        if self.fric:
            friction_model = friction.build_friction_model(
                topo, self.joints, self.bodies, constraint_fns,
                {obj.key: cp for obj, cp in self.constraints})
        return CompiledScene(
            name=self.name, topo=topo, params=params, state0=state0,
            force_fns=tuple(obj for obj, _ in self.forces), constraint_fns=constraint_fns,
            h=self.h, tEnd=self.tEnd, Hexpected=dict(self.Hexpected),
            friction_model=friction_model,
        )


    def _init_rest_lengths(self, topo, params, state0, dtype) -> None:
        """L = 0 of a spring-damper or cable -> its length in the initial
        configuration (ForceSpringDamper.init_ / ForceCable.init_, called
        from Scene.init in the reference, Scene.m:117), from the body frames
        in the compile dtype, as the JAX package computes it."""
        auto = [(obj, fp) for obj, fp in self.forces
                if isinstance(obj, (forces_mod.ForceSpringDamper, forces_mod.SpringDamperM,
                                    forces_mod.ForceCable))
                and float(fp["L"]) == 0.0]
        if not auto:
            return
        kin0 = model.forward_kinematics(topo, params, state0.q[None], state0.qdot[None],
                                        _lanes(state0.aux, 1))
        E_wi = kin0.E_wi[0].cpu().numpy()

        def world_pt(b, xl):
            return np.asarray(xl) if b < 0 else E_wi[b, :3, :3] @ np.asarray(xl) + E_wi[b, :3, 3]

        for obj, fp in auto:
            if isinstance(obj, forces_mod.ForceCable):
                pts = [world_pt(b, fp["xls"][i]) for i, b in enumerate(obj.bodies)]
                L = sum(np.linalg.norm(pts[i + 1] - pts[i]) for i in range(len(pts) - 1))
            else:
                L = np.linalg.norm(world_pt(obj.body2, fp["xl2"]) - world_pt(obj.body1, fp["xl1"]))
            params["forces"][obj.key]["L"] = torch.as_tensor(
                L, dtype=dtype, device=params["forces"][obj.key]["k"].device)


def _lanes(aux: Dict, B: int) -> Dict:
    """A scene's unbatched aux ([G] per entry) broadcast to B lanes ([B, G])."""
    return {k: v.expand(B, *v.shape).contiguous() for k, v in aux.items()}


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
    friction_model: Optional[friction.FrictionModel] = None  # a scene that sets fric

    @property
    def nsteps(self) -> int:
        return math.ceil(self.tEnd / self.h)

    def assemble(self, q, qdot, aux=None):
        """(M [B,nr,nr], f [B,nr], parts) at batched (q, qdot) [B, nr]; aux:
        the state's (default: state0's charts on every lane)."""
        aux = _lanes(self.state0.aux, q.shape[0]) if aux is None else aux
        return model.assemble(self.topo, self.params, q, qdot, self.force_fns, aux)

    def energies(self, q, qdot, aux=None):
        """(T [B], V [B]) at batched (q, qdot) [B, nr]; aux as in assemble."""
        aux = _lanes(self.state0.aux, q.shape[0]) if aux is None else aux
        return model.energies(self.topo, self.params, q, qdot, self.force_fns, aux)

    def make_step(self, integrator: str = "bdf1",
                  cfg: Optional["integrators.NewtonConfig"] = None):
        """A batched step function over [B, nr] states: "bdf1", "bdf2" or
        "euler" (the op-level routes; the kernel routes are
        integrators.make_bdf2_step_batched / make_euler_step_batched), or
        "euler_fric" for a scene that sets fric (friction.make_euler_fric_step,
        its sweeps on the K3 kernel)."""
        if integrator == "bdf1":
            return integrators.make_bdf1_step(self.topo, self.force_fns,
                                              cfg or integrators.NewtonConfig())
        if integrator == "bdf2":
            return integrators.make_bdf2_step(self.topo, self.force_fns,
                                              cfg or integrators.NewtonConfig())
        if integrator == "euler":
            return integrators.make_euler_step(self.topo, self.force_fns, self.constraint_fns)
        if integrator == "euler_fric":
            if self.friction_model is None:
                raise ValueError("the euler_fric step needs a scene compiled with fric = True")
            return friction.make_euler_fric_step(self.topo, self.force_fns, self.friction_model)
        raise ValueError(integrator)

    def initial_state(self, integrator: str = "bdf1", B: int = 1):
        """state0 broadcast to B lanes (its aux too), as the integrator's
        state type."""
        s = State(q=self.state0.q.expand(B, -1).contiguous(),
                  qdot=self.state0.qdot.expand(B, -1).contiguous(),
                  aux=_lanes(self.state0.aux, B))
        return integrators.bdf2_init(s) if integrator == "bdf2" else s
