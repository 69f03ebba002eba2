"""Differentiability layer: adjoint gradients through implicit integration.

For a solve g(x*, theta) = 0 the implicit function theorem gives, for an
incoming cotangent xbar,

    thetabar = -(dg/dtheta)^T H^{-T} xbar,   H = dg/dx

i.e. one transposed linear solve per step plus one VJP of the residual in
theta (through autograd, or by a caller's ResidualVJP: the chord route's
residual VJP kernel, residual_vjp.py). The forward solve runs with gradients off and
the Newton iteration itself is never differentiated. Two forms, as in the
JAX package:

  * ``implicit_solve_factored`` reuses the factor the forward solve built
    (chord: H^-1 at the predictor) for the transposed solve, the reference's
    LU reuse (TaskBDF1.m:66);
  * ``implicit_solve`` builds H at the solution x* in the backward pass (a
    structured matrix, or the exact Jacobian of the residual) and solves
    against it.
"""

from typing import Any, Callable, NamedTuple, Optional

import torch

from redmax_tpu_torch import metrics


def batched_jacobian(res_fn: Callable, x):
    """The exact per-lane Jacobian dg/dx [B, m, n] of a lane-separable
    batched function g = res_fn(x) [B, m] at x [B, n] (a residual: m = n):
    one reverse pass, batched over the m unit cotangents e_i on every lane
    (lanes do not mix, so row i of each lane is the gradient of
    g[:, i].sum()). Enables grad locally on a detached x; returns a
    detached Jacobian."""
    with torch.enable_grad():
        xg = x.detach().requires_grad_(True)
        g = res_fn(xg)
        m = g.shape[-1]
        eye = torch.eye(m, dtype=g.dtype, device=g.device)[:, None, :].expand(m, *g.shape)
        (rows,) = torch.autograd.grad(g, xg, grad_outputs=eye, is_grads_batched=True)
    return rows.transpose(0, 1).detach()


class ResidualVJP(NamedTuple):
    """A VJP of the residual that stands in for autograd's, chosen in the
    backward of each solve:
    fn: (theta, x*, F, xbar, z) -> the cotangents of (tau, *states) of the
        residual's VJP at the cotangent -z, with theta's tensors detached;
    serves: params -> whether fn takes these params (autograd's VJP where
        not); asked in each backward;
    solves_z: fn solves z = H^-T xbar itself from the factor F (z is None
        then, and no backsolve runs)."""
    fn: Callable
    serves: Callable
    solves_z: bool


class _ImplicitSolve(torch.autograd.Function):
    @staticmethod
    def forward(ctx, res_fn, solve_fn, backsolve_fn, vjp, why, grad_other, params, paths, x0,
                *tensors):
        x, F = solve_fn(_theta(params, paths, tensors), x0)
        # a factor may be one tensor, a tuple (LU, pivots) or None
        factor = () if F is None else tuple(F) if isinstance(F, tuple) else (F,)
        ctx.res_fn, ctx.backsolve_fn, ctx.vjp = res_fn, backsolve_fn, vjp
        ctx.why, ctx.grad_other = why, grad_other
        ctx.params, ctx.paths = params, paths
        ctx.nfactor, ctx.factor_is_tuple = len(factor), isinstance(F, tuple)
        ctx.save_for_backward(x, *factor, *tensors)
        return x

    @staticmethod
    def backward(ctx, xbar):
        with metrics.span("adjoint.backward"):
            x, *rest = ctx.saved_tensors
            factor, tensors = rest[:ctx.nfactor], rest[ctx.nfactor:]
            F = tuple(factor) if ctx.factor_is_tuple else (factor[0] if factor else None)
            theta = _theta(ctx.params, ctx.paths, [t.detach() for t in tensors])
            vjp, why = ctx.vjp, ctx.why
            if vjp is not None:
                why = ("params" if not vjp.serves(theta[0])
                       else "grad" if ctx.grad_other else None)
                vjp = vjp if why is None else None
            z = None
            if vjp is None or not vjp.solves_z:
                with metrics.span("adjoint.backsolve"):
                    z = ctx.backsolve_fn(theta, x.detach(), F, xbar)
            need = ctx.needs_input_grad[9:]
            if vjp is not None:
                metrics.count("adjoint.vjp.kernel")
                with metrics.span("adjoint.vjp"):
                    tau_bar, *state_bars = vjp.fn(theta, x.detach(), F, xbar, z)
                # the ResidualVJP serves only where tau is the one params
                # leaf that may require grad
                grads = [tau_bar] * len(ctx.paths) + state_bars
            else:
                metrics.count("adjoint.vjp.oplevel")
                metrics.count("adjoint.vjp.oplevel." + why)
                with metrics.span("adjoint.vjp"), torch.enable_grad():
                    leaves = [t.detach().requires_grad_(n) for t, n in zip(tensors, need)]
                    g = ctx.res_fn(_theta(ctx.params, ctx.paths, leaves), x.detach())
                    wanted = [t for t, n in zip(leaves, need) if n]
                    found = iter(torch.autograd.grad(g, wanted, grad_outputs=-z,
                                                     allow_unused=True))
                    grads = [next(found) if n else None for n in need]
            # x0 (the predictor) gets no gradient: the solution does not depend on it.
            return (None,) * 9 + tuple(g if n else None for g, n in zip(grads, need))


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


def implicit_solve_custom(res_fn: Callable, solve_fn: Callable, backsolve_fn: Callable,
                          theta: Any, x0, vjp: Optional[ResidualVJP] = None,
                          why: str = "route"):
    """Solve res_fn(theta, x) = 0 with the implicit-function VJP.

    theta = (params, *state tensors): params is a nested SceneParams dict
    whose tensor leaves that require grad, at any depth, are differentiated
    (tau on the MPC path; inertia, gravity, timestep and the force and joint
    coefficients for system identification); every state tensor is
    differentiated.
    solve_fn: (theta, x0) -> (x*, F), F a factor the backward may reuse (a
    tensor, a tuple of tensors, or None).
    backsolve_fn: (theta, x*, F, xbar) -> z = H^-T xbar, with theta's
    tensors detached.
    vjp: None for the VJP of res_fn through autograd, else a ResidualVJP,
    which serves the backward of a solve where no params leaf but tau
    requires grad and vjp.serves(params) holds, and autograd's VJP serves
    the others. The backward counts its route: adjoint.vjp.kernel where vjp
    serves (whatever the device: on CPU tensors its plain version runs),
    adjoint.vjp.oplevel where autograd does, and beside it
    adjoint.vjp.oplevel.<reason>: with no vjp, why (the caller's reason:
    "bootstrap" for an SDIRK2 solve, the scene's residual_vjp.refusal on the
    chord route, "route" by default, a step with no residual VJP kernel on
    its route); else "params" where vjp.serves refuses the params, then
    "grad" where a params leaf other than tau requires grad.
    """
    params, *states = theta
    found = _grad_leaves(params)
    paths, leaves = tuple(p for p, _ in found), [v for _, v in found]
    grad_other = any(p != ("tau",) for p in paths)
    return _ImplicitSolve.apply(res_fn, solve_fn, backsolve_fn, vjp, why, grad_other, params,
                                paths, x0, *leaves, *states)


def implicit_solve_factored(res_fn: Callable, newton_factored_fn: Callable,
                            solve_T_factor_fn: Callable, theta: Any, x0, why: str = "route"):
    """implicit_solve_custom that reuses the forward factorization:
    newton_factored_fn: (theta, x0) -> (x*, F), F the live factorization;
    solve_T_factor_fn: (F, xbar) -> H^-T xbar."""
    return implicit_solve_custom(
        res_fn, newton_factored_fn, lambda theta, x, F, xbar: solve_T_factor_fn(F, xbar),
        theta, x0, why=why)


def implicit_solve(res_fn: Callable, newton_fn: Callable, hess_fn: Optional[Callable],
                   solve_T_fn: Optional[Callable], theta: Any, x0, why: str = "route"):
    """implicit_solve_custom that builds H at the solution in the backward.

    newton_fn: (fn: x -> g, jac_or_None, x0) -> x*, the inner solver.
    hess_fn: optional (theta, x) -> H used for the backward transposed
        solve; None -> the exact Jacobian of res_fn (batched_jacobian).
    solve_T_fn: optional (H, xbar) -> H^-T xbar; None ->
        torch.linalg.solve(H^T, xbar).
    """

    def solve(theta, x0):
        jac = (lambda x: hess_fn(theta, x)) if hess_fn is not None else None
        return newton_fn(lambda x: res_fn(theta, x), jac, x0), None

    def backsolve(theta, x, _F, xbar):
        if hess_fn is None:
            H = batched_jacobian(lambda xx: res_fn(theta, xx), x)
        else:
            H = hess_fn(theta, x)
        xbar = xbar.to(H.dtype)
        if solve_T_fn is not None:
            return solve_T_fn(H, xbar)
        return torch.linalg.solve_ex(H.transpose(-1, -2), xbar[..., None])[0][..., 0]

    return implicit_solve_custom(res_fn, solve, backsolve, theta, x0, why=why)
