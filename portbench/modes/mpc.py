"""MPC: one batched call of mpc.make_mpc_solver_batched over
mpc.make_objective_batched (the forward rollout on the chord kernel route,
the adjoint backward, `iters` Adam updates) from the rest state."""

import contextlib

import torch

from redmax_tpu_torch import mpc

from portbench.harness.program import Program


class Runner:
    def __init__(self, config, traffic, device):
        self.prog = Program(config, device)
        self.B, self.horizon = int(traffic["B"]), int(traffic["horizon"])
        self.nr = self.prog.nr
        obj = mpc.make_objective_batched(self.prog.topo, self.prog.force_fns, self.prog.task,
                                         tuple(config["task"]["xlocal"]), self.horizon,
                                         self.prog.cfg)
        self.solve = mpc.make_mpc_solver_batched(obj, iters=int(traffic["iters"]),
                                                 lr=float(traffic["lr"]))
        self.s0 = self.prog.rest(self.B)
        self.inner_steps = self.horizon - 1
        self.units_per_call = self.B

    def call(self, inputs):
        r = self.solve(self.prog.params, inputs["P0"], self.s0, inputs["targets"])
        return {"objective": r.objective, "grad_norm": r.grad_norm, "p": r.p}

    def finite(self, out):
        return float(torch.isfinite(out["objective"]).float().mean())

    def split(self, inputs, around_inner=contextlib.nullcontext):
        tau = (self.prog.task.pscale * inputs["P0"]).requires_grad_(True)
        return self.prog.split({**self.prog.params, "tau": tau}, self.s0, self.horizon,
                               around_inner, backward_of=tau)
