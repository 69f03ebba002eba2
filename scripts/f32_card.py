"""Float32 against float64 on the card, for the departures that the CPU
runs of scripts/f32_departures.py do not show. Imports nothing of the JAX
package; runs on the CPU too (the kernel route's plain version there).

  python scripts/f32_card.py mppi S
      chain-12 MPC (bench.py's task: horizon 50, the main path's
      NewtonConfig, p0 and the target from numpy seed 0), S candidates
      p0 + 3e-3 N(0, 1) from numpy seed 1 (scripts/f32_departures.py mppi
      draws the same): their costs through make_objective_batched on the
      kernel route (K1a) and on the op-level route in float32, and on the
      op-level route in float64. Prints the share of candidates whose two
      float32 costs differ by rel > 1e-3 and, for each such candidate, its
      index, its rank by float64 cost and its three costs.
  python scripts/f32_card.py ode45 B
      mscene 0 through dense ode45 (explicit.simulate_ode45) in float32 and
      float64 from mzoo_state0's B lanes (numpy seed 0): the share of lanes
      whose final y = (q, qdot), and q alone, lie within 1e-3 of scale of
      float64, at B lanes and on the first 32 of them alone.
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from redmax_tpu_torch import integrators, mpc  # noqa: E402
from redmax_tpu_torch.scenes import scene_chain  # noqa: E402
from redmax_tpu_torch.types import State  # noqa: E402

CFG = dict(fixed_iters=3, predictor="quadratic", chord=True, hessian="structured",
           linsolve="gj")


def costs(S, dtype, use_kernel, device):
    rng = np.random.default_rng(0)
    p0 = 3.0 / 1e3 * rng.normal(size=(1, 12))[0]
    tgt = rng.uniform(-2.0, 2.0, size=(1, 3))[0]
    cand = p0[None] + 3e-3 * np.random.default_rng(1).normal(size=(S, 12))
    sc = scene_chain(12).compile(dtype=dtype, device=device)
    task = mpc.PointPosTask(body=11, wp=1.0, wreg=1e-6, pscale=1e3)
    obj = mpc.make_objective_batched(sc.topo, sc.force_fns, task, (0.5, 0.0, 0.0), 50,
                                     integrators.NewtonConfig(**CFG), use_kernel=use_kernel)
    s0 = State(q=sc.state0.q.expand(S, -1), qdot=sc.state0.qdot.expand(S, -1))
    t = lambda a: torch.tensor(np.ascontiguousarray(a), dtype=dtype, device=device)
    with torch.no_grad():
        return obj(sc.params, t(cand), s0, t(np.broadcast_to(tgt, (S, 3)))).double().cpu().numpy()


def mppi(S, device):
    k32 = costs(S, torch.float32, None, device)
    o32 = costs(S, torch.float32, False, device)
    o64 = costs(S, torch.float64, False, device)
    rel = np.abs(k32 - o32) / np.abs(o32)
    off = np.flatnonzero(~(rel <= 1e-3))
    rank = np.argsort(np.argsort(np.where(np.isfinite(o64), o64, np.inf)))
    print(f"mppi chain-12 on {device}, {S} candidates (numpy seed 1): kernel route vs op level "
          f"in float32: {len(off) / S:.4f} of candidates off by rel > 1e-3")
    for i in off:
        print(f"candidate {i} (rank {rank[i]} by float64 cost): kernel f32 {k32[i]!r}, op level "
              f"f32 {o32[i]!r}, op level f64 {o64[i]!r}; rel to f64: kernel "
              f"{abs(k32[i] - o64[i]) / abs(o64[i]):.3e}, op level "
              f"{abs(o32[i] - o64[i]) / abs(o64[i]):.3e}")
    for name, c in (("kernel f32", k32), ("op level f32", o32)):
        r = np.abs(c - o64) / np.abs(o64)
        print(f"{name} vs op level f64: {float((~(r <= 1e-3)).mean()):.4f} of candidates off "
              f"by rel > 1e-3 (max {np.nanmax(r):.3e})")


def ode45(B, device):
    from redmax_tpu_torch import explicit
    from redmax_tpu_torch.scenes_matlab import build_mscene
    rng = np.random.default_rng(0)
    sc64 = build_mscene(0, device=device)
    qd = sc64.state0.qdot.double().cpu().numpy()[None] + 1e-3 * rng.normal(size=(B, sc64.topo.nr))
    qd[0] = sc64.state0.qdot.double().cpu().numpy()
    q = np.broadcast_to(sc64.state0.q.double().cpu().numpy(), qd.shape).copy()
    fin = {}
    for dtype in (torch.float64, torch.float32):
        sc = build_mscene(0, device=device, dtype=dtype)
        for n in (B, 32):
            s0 = State(q=torch.tensor(q[:n], dtype=dtype, device=device),
                       qdot=torch.tensor(qd[:n], dtype=dtype, device=device))
            out = explicit.simulate_ode45(sc, "dense", state0=s0)
            fin[(dtype, n)] = torch.cat([out.q, out.qdot], -1).double().cpu()
    nr = q.shape[1]
    for n in (B, 32):
        for part, sl in (("y", slice(None)), ("q", slice(0, nr))):
            ref = fin[(torch.float64, n)][:, sl]
            err = (fin[(torch.float32, n)][:, sl] - ref).abs().amax(-1) / max(
                1.0, float(ref.abs().max()))
            print(f"mscene 0 dense ode45 on {device}, {n} lanes: f32 vs f64, final {part}: "
                  f"{float((err <= 1e-3).double().mean()):.4f} of lanes within 1e-3 (median "
                  f"{float(err.median()):.3e})")


if __name__ == "__main__":
    torch.backends.cuda.matmul.allow_tf32 = False
    {"mppi": mppi, "ode45": ode45}[sys.argv[1]](int(sys.argv[2]),
                                               "cuda" if torch.cuda.is_available() else "cpu")
