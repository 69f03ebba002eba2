"""scene_chain with three two-point springs (reference/forces/point_springs.py),
the spring-MPC scene of benchmarks/bench_spring_ab.py with the laws of
ForceSpringDamper.m and ForcePointPoint.m (matlab-diff), on the chain of
loadChain:

  - a spring-damper from the world point (0, 0, 6) to the tip link's point
    (0.5, 0, 0), k 2e3, d 20;
  - a spring-damper bracing link 2's point (0.5, 0, 0.05) and link 8's
    (0.5, 0, -0.05), k 1e3, d 10;
  - a zero-rest point-point spring coupling link 5's point (0.5, 0, 0.05)
    and link 11's (0.5, 0, -0.05), k 50, d 2.

The spring-dampers' rest lengths are their lengths at q = 0, from this
module's own forward kinematics (ForceSpringDamper.init_ sets an unset rest
length so). Their blocks couple two bodies, which articulated.Scene's
per-body structured_hessian cannot hold, so SpringScene adds
sum_pairs J_b^T K_bc J_c and the same with D. Needs nlinks >= 12 (the
springs name links 8 and 11). Departure from the sources: the anchors and
coefficients are the repo's scene_spring_chain's; the matlab-diff scenes
place no springs on this chain.
"""

import dataclasses

import torch

from portbench.reference import articulated
from portbench.reference.forces.point_springs import POINT_POINT, SPRING_DAMPER, PointSprings
from portbench.reference.scenes import scene_chain

# (kind, b1, b2, xl1, xl2, k, d); body -1 is the world, its xl in world coordinates
SPRINGS = ((SPRING_DAMPER, -1, 11, (0.0, 0.0, 6.0), (0.5, 0.0, 0.0), 2e3, 20.0),
           (SPRING_DAMPER, 2, 8, (0.5, 0.0, 0.05), (0.5, 0.0, -0.05), 1e3, 10.0),
           (POINT_POINT, 5, 11, (0.5, 0.0, 0.05), (0.5, 0.0, -0.05), 50.0, 2.0))


@dataclasses.dataclass
class SpringScene(articulated.Scene):
    """A revolute tree whose closures may couple two bodies (any closure
    with pair_blocks): H adds their blocks between pairs of bodies."""

    def structured_hessian(self, q, qdot, cK, cD):
        H = articulated.structured_hessian(self, q, qdot, cK, cD)
        E_wi, J, _, phi = articulated.kinematics(self, q, qdot)
        Jt = J.transpose(-1, -2)
        for c in self.closures:
            for bj, bi, K, D in getattr(c, "pair_blocks", lambda *a: ())(E_wi, phi):
                H = H + Jt[:, bj] @ (cK * K + cD * D) @ J[:, bi]
        return H


def build(args, dtype, device):
    n = int(args["nlinks"])
    if n < 12:
        raise ValueError("scene_spring_chain needs nlinks >= 12")
    chain = scene_chain.build({"nlinks": n, "h": args.get("h", 1e-2)}, dtype, device)
    sc = SpringScene(**{f.name: getattr(chain, f.name) for f in dataclasses.fields(chain)})
    t = lambda x: torch.as_tensor(x, dtype=dtype, device=device)
    zero = torch.zeros(1, n, dtype=dtype, device=device)
    E0 = articulated.kinematics(sc, zero, zero)[0]
    springs = []
    for kind, b1, b2, xl1, xl2, k, d in SPRINGS:
        x = [t(xl) if b < 0 else (E0[0, b, :3, :3] @ t(xl)) + E0[0, b, :3, 3]
             for b, xl in ((b1, xl1), (b2, xl2))]
        springs.append({"kind": kind, "b1": b1, "b2": b2, "xl1": t(xl1), "xl2": t(xl2),
                        "k": k, "d": d, "L": float(torch.linalg.vector_norm(x[1] - x[0])),
                        "tension": False})
    sc.closures.append(PointSprings(springs))
    return sc
