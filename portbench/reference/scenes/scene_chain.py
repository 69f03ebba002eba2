"""A serial chain of revolute links (sueda/redmax's loadChain in
RigidBodyCreator): link i a solid cuboid (link_len, link_len/10,
link_len/10) of the given density, its centre link_len/2 along x from its
joint; joint 0 at the world origin, joint i link_len along x from joint
i - 1; axes alternating y, z; joint stiffness and damping on every joint;
gravity grav, time step h. The chain rests straight at q = 0."""

import torch

from portbench.reference.articulated import Scene, cuboid_inertia, transl


def build(args, dtype, device):
    n = int(args["nlinks"])
    L = float(args.get("link_len", 1.0))
    density = float(args.get("density", 1.0))
    t = lambda x: torch.as_tensor(x, dtype=dtype, device=device)
    axis = t([[0.0, 1.0, 0.0] if i % 2 == 0 else [0.0, 0.0, 1.0] for i in range(n)])
    E0_pj = torch.stack([torch.eye(4, dtype=dtype, device=device) if i == 0
                         else transl([L, 0, 0], dtype, device) for i in range(n)])
    E0_ji = transl([L / 2, 0, 0], dtype, device).expand(n, 4, 4).clone()
    I = t([cuboid_inertia((L, 0.1 * L, 0.1 * L), density)] * n)
    full = lambda v: torch.full((n,), float(v), dtype=dtype, device=device)
    return Scene(parent=[i - 1 for i in range(n)], axis=axis, E0_pj=E0_pj, E0_ji=E0_ji, I=I,
                 body_damping=full(0.0), stiffness=full(args.get("stiffness", 0.0)),
                 damping=full(args.get("damping", 1.0)), qrest=full(0.0),
                 g=t(args.get("grav", (0.0, 0.0, -980.0))), h=float(args.get("h", 1e-2)))
