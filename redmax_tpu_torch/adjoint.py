"""Differentiability layer: adjoint gradients through implicit integration.

For a solve g(x*, theta) = 0 the implicit function theorem gives, for an
incoming cotangent xbar,

    thetabar = -(dg/dtheta)^T H^{-T} xbar,   H = dg/dx

i.e. one transposed linear solve per step plus one VJP of the residual in
theta. ``implicit_solve_factored`` runs the forward solve with gradients off
and reuses the factor the forward solve built (chord: H^-1 at the predictor)
for the transposed solve, the reference's LU reuse (TaskBDF1.m:66). The
Newton iteration itself is never differentiated.
"""

from typing import Any, Callable

import torch


class _ImplicitSolveFactored(torch.autograd.Function):
    @staticmethod
    def forward(ctx, res_fn, newton_factored_fn, solve_T_fn, params, keys, x0, *tensors):
        theta = _theta(params, keys, tensors)
        x, F = newton_factored_fn(theta, x0)
        ctx.res_fn, ctx.solve_T_fn, ctx.params, ctx.keys = res_fn, solve_T_fn, params, keys
        ctx.save_for_backward(x, F, *tensors)
        return x

    @staticmethod
    def backward(ctx, xbar):
        x, F, *tensors = ctx.saved_tensors
        z = ctx.solve_T_fn(F, xbar)
        need = ctx.needs_input_grad[6:]
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(n) for t, n in zip(tensors, need)]
            g = ctx.res_fn(_theta(ctx.params, ctx.keys, leaves), x.detach())
            wanted = [t for t, n in zip(leaves, need) if n]
            grads = iter(torch.autograd.grad(g, wanted, grad_outputs=-z, allow_unused=True))
        # x0 (the predictor) gets no gradient: the solution does not depend on it.
        return (None,) * 6 + tuple(next(grads) if n else None for n in need)


def _theta(params, keys, tensors):
    """Rebuild theta = (params, *states) from the flat differentiable tensors."""
    k = len(keys)
    return ({**params, **dict(zip(keys, tensors[:k]))}, *tensors[k:])


def implicit_solve_factored(
    res_fn: Callable,
    newton_factored_fn: Callable,
    solve_T_factor_fn: Callable,
    theta: Any,
    x0,
):
    """Solve res_fn(theta, x) = 0 with the implicit-function VJP, reusing the
    forward factorization in the backward pass.

    theta = (params, *state tensors): params is a SceneParams dict whose
    top-level tensors that require grad are differentiated (tau on the MPC
    path); every state tensor is differentiated.
    newton_factored_fn: (theta, x0) -> (x*, F), F the live factorization.
    solve_T_factor_fn: (F, xbar) -> H^-T xbar.
    """
    params, *states = theta
    keys = tuple(k for k, v in params.items() if torch.is_tensor(v) and v.requires_grad)
    return _ImplicitSolveFactored.apply(
        res_fn, newton_factored_fn, solve_T_factor_fn, params, keys, x0,
        *(params[k] for k in keys), *states,
    )
