"""Carry a scene's weights and topology across from the JAX package.

The JAX package's SceneParams is a nested dict of arrays; handed over as
numpy (``jax.tree_util.tree_map(np.asarray, sc.params)``) it becomes this
package's SceneParams with the same layout, params["constraints"]
and params["forces"] included. A state's aux (the Euler-chart joints'
charts, int32 there) becomes int64 tensors. The Topology's tuple fields carry over as
they are, and the constraint and force objects are rebuilt from their class
names and attributes. No
function here imports the JAX package.
"""

from typing import Any, Dict, Iterable, Tuple

import numpy as np
import torch

from redmax_tpu_torch import constraints, forces
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


_CONSTRAINT_FIELDS = {
    "ConstraintLoop": ("bodyA", "bodyB"),
    "ConstraintJointLimit": ("dof",),
    "ConstraintFloor": ("body",),
    "ConstraintMultQ": ("dofA", "dofB"),
}


def constraints_from_fields(fields: Iterable[Tuple[str, Dict[str, Any]]]) -> Tuple:
    """constraint_fns from (class name, attribute dict) pairs, as
    ``[(type(c).__name__, vars(c)) for c in sc.constraint_fns]`` gives them
    for a JAX CompiledScene; the keys into params["constraints"] carry over."""
    out = []
    for name, attrs in fields:
        if name not in _CONSTRAINT_FIELDS:
            raise NotImplementedError(f"{name} is not ported yet ({constraints.PORTED})")
        cls = getattr(constraints, name)
        out.append(cls(attrs["key"], *(int(attrs[k]) for k in _CONSTRAINT_FIELDS[name])))
    return tuple(out)


_FORCE_ARGS = {
    "ForceGroundCuboid": lambda a: (int(a["body"]),),
    "ForcePointPoint": lambda a: (int(a["body1"]), int(a["body2"])),
    "ForceSpringDamper": lambda a: (int(a["body1"]), int(a["body2"]),
                                    bool(a.get("tension_only", False))),
    "ForceCable": lambda a: (tuple(int(b) for b in a["bodies"]),),
}


def forces_from_fields(fields: Iterable[Tuple[str, Dict[str, Any]]]) -> Tuple:
    """force_fns from (class name, attribute dict) pairs, as
    ``[(type(f).__name__, vars(f)) for f in sc.force_fns]`` gives them for a
    JAX CompiledScene; the keys into params["forces"] carry over."""
    out = []
    for name, attrs in fields:
        if name not in _FORCE_ARGS:
            raise NotImplementedError(f"{name} is not ported yet ({forces.PORTED})")
        out.append(getattr(forces, name)(attrs["key"], *_FORCE_ARGS[name](attrs)))
    return tuple(out)
