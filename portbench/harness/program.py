"""The system under test as a configuration file names it: the port's scene,
Newton settings and task. The only module of the harness, with modes/, that
imports the port."""

import torch

from redmax_tpu_torch import integrators, mpc, scenes
from redmax_tpu_torch.types import State


class Program:
    """The compiled scene of a configuration on a device, in its dtype."""

    def __init__(self, config, device):
        self.dtype = getattr(torch, config["dtype"])
        self.sc = getattr(scenes, config["scene"])(**config["args"]).compile(
            dtype=self.dtype, device=device)
        self.topo, self.params, self.force_fns = self.sc.topo, self.sc.params, self.sc.force_fns
        self.cfg = integrators.NewtonConfig(**config["newton"])
        self.nr = self.topo.nr
        t = config.get("task")
        self.task = None if t is None else mpc.PointPosTask(
            body=t["body"], wp=t["wp"], wreg=t["wreg"], pscale=t["pscale"])

    def rest(self, B):
        """The scene's rest state on B lanes."""
        return State(q=self.sc.state0.q.expand(B, -1).contiguous(),
                     qdot=self.sc.state0.qdot.expand(B, -1).contiguous())

    def step(self, differentiable):
        """The batched BDF2 step the cell's path takes (the kernel route)."""
        return integrators.make_bdf2_step_batched(self.topo, self.force_fns, self.cfg,
                                                  differentiable=differentiable)

    def split(self, params, s0, nsteps, around_inner, backward_of=None):
        """One pass of the path by phase: the bootstrap, the nsteps - 1 inner
        steps (inside around_inner(), which a profiler may take) and, with
        backward_of (the torques that require grad), the adjoint backward of
        the final q's sum; milliseconds of each by CUDA events."""
        step = self.step(backward_of is not None)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        torch.cuda.synchronize()
        ev[0].record()
        s = step.bootstrap(params, integrators.bdf2_init(s0))
        ev[1].record()
        torch.cuda.synchronize()
        with around_inner():
            for _ in range(nsteps - 1):
                s = step.inner(params, s)
            ev[2].record()
            torch.cuda.synchronize()
        if backward_of is not None:
            torch.autograd.grad(s.q.sum(), backward_of)
        ev[3].record()
        torch.cuda.synchronize()
        ms = [ev[i].elapsed_time(ev[i + 1]) for i in range(3)]
        out = {"bootstrap_ms": ms[0], "inner_ms": ms[1]}
        if backward_of is not None:
            out["backward_ms"] = ms[2]
        return out
