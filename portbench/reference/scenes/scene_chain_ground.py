"""scene_chain with penalty ground contact (reference/forces/ground_cuboid.py)
on every link: the floor the z = floor_z plane, z up (matlab-diff scene 11,
scenesRedMax.m:290-311, on the chain)."""

import torch

from portbench.reference.forces.ground_cuboid import GroundCuboids
from portbench.reference.scenes import scene_chain


def build(args, dtype, device):
    sc = scene_chain.build({k: v for k, v in args.items() if k != "floor_z"}, dtype, device)
    n, L = sc.n, float(args.get("link_len", 1.0))
    floor_z = float(args.get("floor_z", -1.5 * L))
    E = torch.eye(4, dtype=dtype, device=device)
    E[2, 3] = floor_z
    coef = lambda k: torch.full((n,), float(args[k]), dtype=dtype, device=device)
    sides = torch.tensor([L, 0.1 * L, 0.1 * L], dtype=dtype, device=device)
    sc.closures.append(GroundCuboids(list(range(n)), E.expand(n, 4, 4).clone(),
                                     sides.expand(n, 3).clone(), coef("kn"), coef("kt"),
                                     coef("kd"), coef("mu")))
    return sc
