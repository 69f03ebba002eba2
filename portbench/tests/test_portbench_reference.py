"""The reference is the port's mechanics written again: in float64 on the CPU
it equals the port's op-level route (integrators.make_bdf2_step,
mpc.make_mpc_solver_batched with use_kernel=False) to roundoff, on both
configurations, for both modes."""

import os

import pytest
import torch

from portbench.harness import spec
from portbench.harness.cell import reference_outputs
from portbench.harness.program import Program
from portbench.harness.traffic import make_inputs
from portbench.tests import TINY
from redmax_tpu_torch import integrators, mpc


@pytest.mark.parametrize("cfg_name", ["chain12", "chain_ground12"])
@pytest.mark.parametrize("mix", ["mpc_b32768_h50", "rollout_b32768_n500"])
def test_reference_equals_port_op_level_f64(cfg_name, mix):
    config = spec.load_json(os.path.join(spec.BENCH, "configs", cfg_name + ".json"))
    config = {**config, "dtype": "float64"}
    traffic = {**spec.load_json(os.path.join(spec.BENCH, "traffic", mix + ".json")), **TINY,
               "B": 6, "horizon": 8, "steps": 8}
    prog = Program(config, "cpu")
    inputs = make_inputs(traffic, {"B": 6, "nr": prog.nr}, 11, "cpu", torch.float64)[0]
    ref = reference_outputs(config, traffic, inputs, "cpu")
    s0 = prog.rest(6)
    if traffic["mode"] == "mpc":
        t = config["task"]
        obj = mpc.make_objective_batched(prog.topo, prog.force_fns, prog.task,
                                         tuple(t["xlocal"]), traffic["horizon"], prog.cfg,
                                         use_kernel=False)
        r = mpc.make_mpc_solver_batched(obj, iters=1, lr=traffic["lr"])(
            prog.params, inputs["P0"], s0, inputs["targets"])
        got = {"objective": r.objective, "grad_norm": r.grad_norm, "p": r.p}
    else:
        step = integrators.make_bdf2_step_batched(prog.topo, prog.force_fns, prog.cfg,
                                                  use_kernel=False)
        with torch.no_grad():
            s = integrators.make_simulate(step, traffic["steps"])(
                {**prog.params, "tau": inputs["tau"]}, integrators.bdf2_init(s0))
        got = {"q": s.q, "qdot": s.qdot}
    for k, v in got.items():
        torch.testing.assert_close(v, ref[k], rtol=1e-10, atol=1e-12, equal_nan=True)
