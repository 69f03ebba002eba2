"""Carry a scene's weights and topology across from the JAX package.

The JAX package's SceneParams is a nested dict of arrays; handed over as
numpy (``jax.tree_util.tree_map(np.asarray, sc.params)``) it becomes this
package's SceneParams with the same layout. The Topology's tuple fields
carry over as they are. Neither function imports the JAX package.
"""

from typing import Any, Dict

import numpy as np
import torch

from redmax_tpu_torch.types import Topology


def params_from_numpy(params_np: Dict[str, Any], device="cuda", dtype=torch.float64):
    """Nested dict of numpy arrays -> nested dict of tensors on device."""
    if isinstance(params_np, dict):
        return {k: params_from_numpy(v, device, dtype) for k, v in params_np.items()}
    return torch.tensor(np.array(params_np, dtype=np.float64), dtype=dtype, device=device)


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
