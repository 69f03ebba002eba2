"""One batched MPC solve (TaskBDF2PointPos.m with driverRedMaxAdjointBDF2.m
of sueda/redmax's matlab-diff): from the rest state, torques pscale * P
held over a horizon of BDF2 steps; the cost at the last step

    0.5 wp |x_tip - target|^2 + 0.5 wreg |P|^2,

its gradient in P by the adjoint, and `iters` Adam steps (lr, b1 0.9,
b2 0.999, eps 1e-8). Outputs: the cost and the gradient's norm at the last
iterate before its update, and the updated P."""

import torch


def run(solver, config, traffic, inputs):
    task = config["task"]
    P, targets = inputs["P0"], inputs["targets"]
    q0 = torch.zeros_like(P)
    mu, nu = torch.zeros_like(P), torch.zeros_like(P)
    lr, b1, b2, eps = float(traffic["lr"]), 0.9, 0.999, 1e-8
    for k in range(1, int(traffic["iters"]) + 1):
        Pg = P.detach().requires_grad_(True)
        with torch.enable_grad():
            q = solver.rollout(task["pscale"] * Pg, q0, q0, int(traffic["horizon"]))[0]
            dx = solver.sc.point_world(q, task["body"], task["xlocal"]) - targets
            v = 0.5 * task["wp"] * (dx * dx).sum(-1) + 0.5 * task["wreg"] * (Pg * Pg).sum(-1)
            (g,) = torch.autograd.grad(v.sum(), Pg)
        mu = (1 - b1) * g + b1 * mu
        nu = (1 - b2) * g * g + b2 * nu
        P = P - lr * (mu / (1 - b1 ** k)) / (torch.sqrt(nu / (1 - b2 ** k)) + eps)
    return {"objective": v.detach(), "grad_norm": torch.linalg.vector_norm(g, dim=-1), "p": P}
