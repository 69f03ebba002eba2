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
    def forward(ctx, res_fn, newton_factored_fn, solve_T_fn, params, paths, x0, *tensors):
        theta = _theta(params, paths, tensors)
        x, F = newton_factored_fn(theta, x0)
        ctx.res_fn, ctx.solve_T_fn, ctx.params, ctx.paths = res_fn, solve_T_fn, params, paths
        ctx.save_for_backward(x, F, *tensors)
        return x

    @staticmethod
    def backward(ctx, xbar):
        x, F, *tensors = ctx.saved_tensors
        z = ctx.solve_T_fn(F, xbar)
        need = ctx.needs_input_grad[6:]
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(n) for t, n in zip(tensors, need)]
            g = ctx.res_fn(_theta(ctx.params, ctx.paths, leaves), x.detach())
            wanted = [t for t, n in zip(leaves, need) if n]
            grads = iter(torch.autograd.grad(g, wanted, grad_outputs=-z, allow_unused=True))
        # x0 (the predictor) gets no gradient: the solution does not depend on it.
        return (None,) * 6 + tuple(next(grads) if n else None for n in need)


def _grad_leaves(params, prefix=()):
    """(path, tensor) of every tensor leaf of the nested params dict that
    requires grad, at any depth, in the dict's order; a path is a key tuple."""
    out = []
    for k, v in params.items():
        if isinstance(v, dict):
            out += _grad_leaves(v, prefix + (k,))
        elif torch.is_tensor(v) and v.requires_grad:
            out.append((prefix + (k,), v))
    return out


def _with_leaf(params, path, value):
    """params with the leaf at path replaced; only the dicts on the path are
    copied."""
    head, *rest = path
    return {**params, head: _with_leaf(params[head], rest, value) if rest else value}


def _theta(params, paths, tensors):
    """Rebuild theta = (params, *states) from the flat differentiable tensors:
    the first len(paths) are params leaves, the rest the states."""
    k = len(paths)
    for path, t in zip(paths, tensors[:k]):
        params = _with_leaf(params, path, t)
    return (params, *tensors[k:])


def implicit_solve_factored(
    res_fn: Callable,
    newton_factored_fn: Callable,
    solve_T_factor_fn: Callable,
    theta: Any,
    x0,
):
    """Solve res_fn(theta, x) = 0 with the implicit-function VJP, reusing the
    forward factorization in the backward pass.

    theta = (params, *state tensors): params is a nested SceneParams dict
    whose tensor leaves that require grad, at any depth, are differentiated
    (tau on the MPC path; inertia, gravity, timestep and the force and joint
    coefficients for system identification); every state tensor is
    differentiated.
    newton_factored_fn: (theta, x0) -> (x*, F), F the live factorization.
    solve_T_factor_fn: (F, xbar) -> H^-T xbar.
    """
    params, *states = theta
    found = _grad_leaves(params)
    paths, leaves = tuple(p for p, _ in found), [v for _, v in found]
    return _ImplicitSolveFactored.apply(
        res_fn, newton_factored_fn, solve_T_factor_fn, params, paths, x0, *leaves, *states,
    )
