"""Carry a scene's weights and topology across from the JAX package.

The JAX package's SceneParams is a nested dict of arrays; handed over as
numpy (``jax.tree_util.tree_map(np.asarray, sc.params)``) it becomes this
package's SceneParams with the same layout, params["constraints"]
and params["forces"] included (a friction scene's mu, baumgarte and loop
closures' xA, axisA too; the friction step reads them as they come). A state's aux (the Euler-chart joints'
charts, int32 there) becomes int64 tensors. The Topology's tuple fields carry over as
they are, and the constraint and force objects are rebuilt from their class
names and attributes. No
function here imports the JAX package.
"""

from typing import Any, Dict, Iterable, Tuple

import numpy as np
import torch

from redmax_tpu_torch import constraints, forces, friction
from redmax_tpu_torch.types import Topology


def params_from_numpy(params_np: Dict[str, Any], device="cuda", dtype=torch.float64):
    """Nested dict of numpy arrays -> nested dict of tensors on device."""
    if isinstance(params_np, dict):
        return {k: params_from_numpy(v, device, dtype) for k, v in params_np.items()}
    return torch.tensor(np.array(params_np, dtype=np.float64), dtype=dtype, device=device)


def aux_from_numpy(aux_np: Dict[str, Any], device="cuda") -> Dict[str, torch.Tensor]:
    """A state's aux (``{"euler_chart": [G] or [B, G]}``, as numpy) -> int64
    tensors on device, the shape kept."""
    return {k: torch.tensor(np.asarray(v), dtype=torch.int64, device=device)
            for k, v in aux_np.items()}


def topology_from_fields(njoints, nr, parent, jtype, qstart, ndof) -> Topology:
    """A Topology from the fields of the JAX package's Topology."""
    return Topology(
        njoints=int(njoints),
        nr=int(nr),
        parent=tuple(int(p) for p in parent),
        jtype=tuple(int(t) for t in jtype),
        qstart=tuple(int(s) for s in qstart),
        ndof=tuple(int(d) for d in ndof),
    )


def _loop_args(a):
    meta = a.get("static_params", {})
    return (int(a["bodyA"]), int(a["bodyB"]), float(meta.get("radius", 1.0)),
            float(meta.get("height", 1.0)))


_CONSTRAINT_ARGS = {
    "ConstraintLoop": _loop_args,
    "ConstraintJointLimit": lambda a: (int(a["dof"]),),
    "ConstraintFloor": lambda a: (int(a["body"]),),
    "ConstraintMultQ": lambda a: (int(a["dofA"]), int(a["dofB"])),
    "ConstraintPrescJoint": lambda a: (tuple(int(d) for d in a["dofs"]),),
    "ConstraintPrescBody": lambda a: (int(a["body"]), tuple(int(c) for c in a["comps"])),
    "ConstraintPrescJointM": lambda a: (int(a["joint"]), int(a["parent"]), int(a["axis_idx"])),
    "ConstraintPrescBodyW": lambda a: (int(a["body"]), tuple(int(c) for c in a["comps"])),
    "ConstraintAttachPoint": lambda a: (int(a["body"]), int(a["node"])),
}


def constraints_from_fields(fields: Iterable[Tuple[str, Dict[str, Any]]]) -> Tuple:
    """constraint_fns from (class name, attribute dict) pairs, as
    ``[(type(c).__name__, vars(c)) for c in sc.constraint_fns]`` gives them
    for a JAX CompiledScene; the keys into params["constraints"] carry over
    (a loop's ring radius and height from its static_params)."""
    return tuple(getattr(constraints, name)(attrs["key"], *_CONSTRAINT_ARGS[name](attrs))
                 for name, attrs in fields)


_FORCE_ARGS = {
    "ForceGroundCuboid": lambda a: (int(a["body"]),),
    "ForcePointPoint": lambda a: (int(a["body1"]), int(a["body2"])),
    "ForceSpringDamper": lambda a: (int(a["body1"]), int(a["body2"]),
                                    bool(a.get("tension_only", False))),
    "ForceCable": lambda a: (tuple(int(b) for b in a["bodies"]),),
    "SpringDamperM": lambda a: (int(a["body1"]), int(a["body2"])),
    "ForcePointDirection": lambda a: (int(a["body"]),),
    "ForceDeformableSegments": lambda a: (tuple(int(b) for b in a["nodes"]),),
}


def forces_from_fields(fields: Iterable[Tuple[str, Dict[str, Any]]]) -> Tuple:
    """force_fns from (class name, attribute dict) pairs, as
    ``[(type(f).__name__, vars(f)) for f in sc.force_fns]`` gives them for a
    JAX CompiledScene; the keys into params["forces"] carry over."""
    return tuple(getattr(forces, name)(attrs["key"], *_FORCE_ARGS[name](attrs))
                 for name, attrs in fields)


def friction_model_from_fields(rings: Iterable[Dict[str, Any]],
                               loop_rings: Iterable[Dict[str, Any]],
                               constraint_fns: Tuple) -> "friction.FrictionModel":
    """A friction scene's FrictionModel from the JAX package's, its rings'
    fields as ``[r._asdict() for r in fm.rings]`` and ``[lr._asdict() for lr
    in fm.loop_rings]`` give them; the floor and maximal-equality constraints
    are those of constraint_fns (constraints_from_fields), in their order."""
    def arrays(d):
        return {k: np.asarray(v, dtype=np.float64) if isinstance(v, np.ndarray) else v
                for k, v in d.items()}

    return friction.FrictionModel(
        rings=tuple(friction.Ring(**arrays(r)) for r in rings),
        loop_rings=tuple(friction.LoopRing(**arrays(r)) for r in loop_rings),
        floor_cons=tuple(c for c in constraint_fns if isinstance(c, constraints.ConstraintFloor)),
        eq_cons=tuple(c for c in constraint_fns if c.n_eq_m))
