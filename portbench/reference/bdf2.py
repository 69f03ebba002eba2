"""BDF2 with the SDIRK2 bootstrap, fixed-iteration chord Newton and the
implicit-function adjoint, for the reference (driverRedMaxBDF2.m:64-293 of
sueda/redmax's matlab-diff):

  SDIRK2, alpha = (2 - sqrt 2)/2:  two implicit substeps of alpha h,
  BDF2:  M(q2) (q2 - 4/3 q1 + 1/3 q0 - 8/9 h qd1 + 2/9 h qd0) - 4/9 h^2 f(q2, qd2) = 0,
         qd2 = 3/(2h) (q2 - 4/3 q1 + 1/3 q0).

Each solve starts at the predictor, builds the structured Newton matrix
there once, inverts it and takes `fixed_iters` full steps; a lane whose
residual at the last iteration is non-finite or grew by more than
`growth_reject` over the first is set to NaN. The adjoint of a solve
x*(theta) is thetabar = -(dg/dtheta)^T H^-T xbar with the same H^-1.
"""

import math

import torch


ALPHA = (2.0 - math.sqrt(2.0)) / 2.0


def _mv(M, v):
    return (M @ v[..., None])[..., 0]


class Solver:
    """A scene (reference/articulated.Scene or one with its methods) with the
    Newton settings of a configuration file."""

    def __init__(self, sc, newton: dict):
        if not (newton.get("chord") and newton.get("hessian") == "structured"
                and newton.get("fixed_iters", 0) > 0):
            raise ValueError(f"the reference solves fixed-iteration chord Newton with the "
                             f"structured matrix only, not {newton}")
        self.sc = sc
        self.iters = int(newton["fixed_iters"])
        self.growth = float(newton.get("growth_reject", 10.0))
        self.quadratic = newton.get("predictor", "linear") == "quadratic"

    def chord(self, res, hess, x0):
        """(x, H^-1): fixed-iteration chord Newton on res from x0."""
        Hinv = torch.linalg.inv_ex(hess(x0)).inverse
        x, g0n = x0, None
        for _ in range(self.iters):
            g = res(x)
            gn = torch.linalg.vector_norm(g, dim=-1)
            g0n = gn if g0n is None else g0n
            x = x - _mv(Hinv, g)
        bad = ~torch.isfinite(x).all(-1) | ~torch.isfinite(gn) | (gn > self.growth * g0n)
        return torch.where(bad[:, None], torch.full_like(x, float("nan")), x), Hinv

    def implicit(self, res, hess, x0, theta):
        """x* of res(theta, x) = 0, differentiable in theta by the adjoint."""
        if not torch.is_grad_enabled():
            return self.chord(lambda x: res(theta, x), lambda x: hess(theta, x), x0)[0]
        return _Implicit.apply(self, res, hess, x0, *theta)

    # residuals, with theta = (tau, history...)
    def res_a(self, th, qa):
        tau, q0, qd0 = th
        ah = ALPHA * self.sc.h
        M, f = self.sc.mass_and_force(qa, (qa - q0) / ah, tau)
        return _mv(M, qa - q0 - ah * qd0) - ah * ah * f

    def hess_a(self, th, qa):
        _, q0, _ = th
        ah = ALPHA * self.sc.h
        return self.sc.structured_hessian(qa, (qa - q0) / ah, -ah * ah, -ah)

    def _qd_b(self, th, q1):
        _, q0, _, qda = th
        h = self.sc.h
        return (q1 - q0 - (1 - ALPHA) * h * qda) / (ALPHA * h)

    def res_b(self, th, q1):
        tau, q0, qd0, qda = th
        h = self.sc.h
        ah = ALPHA * h
        M, f = self.sc.mass_and_force(q1, self._qd_b(th, q1), tau)
        dq = q1 - q0 - (2 * ALPHA - 1) * h * qd0 - 2 * (1 - ALPHA) * h * qda
        return _mv(M, dq) - ah * ah * f

    def hess_b(self, th, q1):
        ah = ALPHA * self.sc.h
        return self.sc.structured_hessian(q1, self._qd_b(th, q1), -ah * ah, -ah)

    def _qd_2(self, th, q2):
        _, q0, _, q1, _ = th
        return (3 / (2 * self.sc.h)) * (q2 - (4 / 3) * q1 + (1 / 3) * q0)

    def res_2(self, th, q2):
        tau, q0, qd0, q1, qd1 = th
        h = self.sc.h
        M, f = self.sc.mass_and_force(q2, self._qd_2(th, q2), tau)
        dq = q2 - (4 / 3) * q1 + (1 / 3) * q0 - (8 / 9) * h * qd1 + (2 / 9) * h * qd0
        return _mv(M, dq) - (4 / 9) * h * h * f

    def hess_2(self, th, q2):
        h = self.sc.h
        return self.sc.structured_hessian(q2, self._qd_2(th, q2), -(4 / 9) * h * h,
                                      -(2 / 3) * h)

    # steps: a state is (q, qd, q_prev, qd_prev)
    def bootstrap(self, tau, q0, qd0):
        h = self.sc.h
        ah = ALPHA * h
        qa = self.implicit(self.res_a, self.hess_a, q0 + ah * qd0, (tau, q0, qd0))
        qda = (qa - q0) / ah
        q1 = self.implicit(self.res_b, self.hess_b, qa + (1 - ALPHA) * h * qda,
                           (tau, q0, qd0, qda))
        return q1, self._qd_b((tau, q0, qd0, qda), q1), q0, qd0

    def inner(self, tau, s):
        q1, qd1, q0, qd0 = s
        h = self.sc.h
        guess = q1 + h * qd1 + (0.5 * h * (qd1 - qd0) if self.quadratic else 0.0)
        th = (tau, q0, qd0, q1, qd1)
        q2 = self.implicit(self.res_2, self.hess_2, guess, th)
        return q2, self._qd_2(th, q2), q1, qd1

    def rollout(self, tau, q0, qd0, nsteps):
        """The state (q, qd, q_prev, qd_prev) after the bootstrap and nsteps - 1
        BDF2 steps."""
        s = self.bootstrap(tau, q0, qd0)
        for _ in range(nsteps - 1):
            s = self.inner(tau, s)
        return s


class _Implicit(torch.autograd.Function):
    @staticmethod
    def forward(ctx, solver, res, hess, x0, *theta):
        with torch.no_grad():
            x, Hinv = solver.chord(lambda x: res(theta, x), lambda x: hess(theta, x), x0)
        ctx.res = res
        ctx.save_for_backward(x, Hinv, *theta)
        return x

    @staticmethod
    def backward(ctx, xbar):
        x, Hinv, *theta = ctx.saved_tensors
        need = ctx.needs_input_grad[4:]
        z = (Hinv.transpose(-1, -2) @ xbar[..., None])[..., 0]
        with torch.enable_grad():
            th = [t.detach().requires_grad_(n) for t, n in zip(theta, need)]
            g = ctx.res(th, x.detach())
            wanted = [t for t, n in zip(th, need) if n]
            grads = iter(torch.autograd.grad(g, wanted, grad_outputs=-z, allow_unused=True))
        return (None,) * 4 + tuple(next(grads) if n else None for n in need)
