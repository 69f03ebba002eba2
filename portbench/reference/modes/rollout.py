"""A batched rollout: from the rest state, constant joint torques tau held
over the SDIRK2 bootstrap and steps - 1 BDF2 steps; outputs the final q and
qdot."""

import torch


def run(solver, config, traffic, inputs):
    tau = inputs["tau"]
    q0 = torch.zeros_like(tau)
    with torch.no_grad():
        s = solver.bootstrap(tau, q0, q0)
        for _ in range(int(traffic["steps"]) - 1):
            s = solver.inner(tau, s)
    return {"q": s[0], "qdot": s[1]}
