"""Performance and correctness counters (the JAX package's metrics.py; the
reference's ChronoTimer.h:28-40, SolverDataTracker and batchTest
aggregation, Scene.cpp:248-287):

  * Timer: tic/toc slots on the host's wall clock;
  * bench_throughput: seconds per call and calls/s, the warm-up excluded,
    the device of the outputs synchronized before each clock read;
  * energy_drift: the certificate quantity H_end = T_end + V_end - V_0.
"""

import time
from typing import Callable, Dict

import torch

from redmax_tpu_torch.checkpoint import tree_flatten


class Timer:
    """tic/toc multi-slot wall-clock timer (ChronoTimer.h:28-40). It reads
    the host clock only: time device work with bench_throughput, or
    synchronize before toc."""

    def __init__(self):
        self.t0: Dict[str, float] = {}
        self.total: Dict[str, float] = {}
        self.count: Dict[str, int] = {}

    def tic(self, slot: str = "") -> None:
        self.t0[slot] = time.perf_counter()

    def toc(self, slot: str = "") -> float:
        dt = time.perf_counter() - self.t0[slot]
        self.total[slot] = self.total.get(slot, 0.0) + dt
        self.count[slot] = self.count.get(slot, 0) + 1
        return dt

    def report(self) -> Dict[str, Dict[str, float]]:
        return {k: {"total_s": v, "count": self.count[k], "avg_s": v / self.count[k]}
                for k, v in self.total.items()}


def _synchronize(out) -> None:
    """Wait for the device work behind every CUDA tensor of out."""
    for dev in {x.device for x in tree_flatten(out)
                if isinstance(x, torch.Tensor) and x.device.type == "cuda"}:
        torch.cuda.synchronize(dev)


def bench_throughput(fn: Callable, args, n_warmup: int = 1, n_reps: int = 3):
    """(seconds per call, calls/s) of fn(*args) over n_reps calls after
    n_warmup (the kernels' builds and the allocator's first growth fall
    there; 0 where nothing is left to build); the host clock starts once the
    device of the arguments and of the warm-up's outputs is idle and is read
    once the outputs' device has finished."""
    out = None
    for _ in range(n_warmup):
        out = fn(*args)
    _synchronize((args, out))
    t0 = time.perf_counter()
    for _ in range(n_reps):
        out = fn(*args)
    _synchronize(out)
    dt = (time.perf_counter() - t0) / n_reps
    return dt, 1.0 / dt


def energy_drift(scene, state_final):
    """H_end = T_end + (V_end - V_0), the certificate quantity
    (Scene.plotEnergies, matlab-diff/+redmax/Scene.m:164-191), against the
    scene's initial state: a float for an unbatched state (q [nr]), a
    tensor [B] for a batched one (q [B, nr])."""
    s0 = scene.state0
    _, V0 = scene.energies(s0.q[None], s0.qdot[None])
    if state_final.q.dim() == 1:
        aux = {k: v[None] for k, v in state_final.aux.items()}
        T, V = scene.energies(state_final.q[None], state_final.qdot[None], aux)
        return float(T[0]) + float(V[0]) - float(V0[0])
    T, V = scene.energies(state_final.q, state_final.qdot, state_final.aux)
    return T + V - V0[0]
