"""Rollout: one batched call of integrators.make_simulate over
make_bdf2_step_batched(differentiable=False) under torch.no_grad(): the
SDIRK2 bootstrap and steps - 1 BDF2 steps on the chord kernel route, from
the rest state, constant per-lane torques."""

import contextlib

import torch

from redmax_tpu_torch import integrators

from portbench.harness.program import Program


class Runner:
    def __init__(self, config, traffic, device):
        self.prog = Program(config, device)
        self.B, self.steps = int(traffic["B"]), int(traffic["steps"])
        self.nr = self.prog.nr
        self.sim = integrators.make_simulate(self.prog.step(False), self.steps)
        self.s0 = self.prog.rest(self.B)
        self.inner_steps = self.steps - 1
        self.units_per_call = self.B * self.steps

    def call(self, inputs):
        with torch.no_grad():
            s = self.sim({**self.prog.params, "tau": inputs["tau"]},
                         integrators.bdf2_init(self.s0))
        return {"q": s.q, "qdot": s.qdot}

    def finite(self, out):
        ok = torch.isfinite(out["q"]).all(-1) & torch.isfinite(out["qdot"]).all(-1)
        return float(ok.float().mean())

    def split(self, inputs, around_inner=contextlib.nullcontext):
        with torch.no_grad():
            return self.prog.split({**self.prog.params, "tau": inputs["tau"]}, self.s0,
                                   self.steps, around_inner)
