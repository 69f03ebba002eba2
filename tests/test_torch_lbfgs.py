"""The port's L-BFGS MPC solver (mpc.make_mpc_solver(method="lbfgs"): optax's
lbfgs(memory_size=8) with its zoom line search, written out lane by lane)
against redmax_tpu.mpc.make_mpc_solver(method="lbfgs") in float64 on the CPU:
the optimizer alone on a 4-D Rosenbrock function at 1, 3 and 8 iterations
and on a convex quadratic whose first trial step is accepted (p, objective
and grad_norm to 1e-10 relative); scene 100's BDF1 adjoint task
(tests/test_adjoint.py:103-110, 4 iterations) to 1e-8; and lanes: a lane
vector objective of three starts and a NaN lane against the JAX solver under
jax.vmap. Each JAX oracle is jitted once.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from redmax_tpu import mpc as jmpc
from redmax_tpu.scenes import build_scene as jbuild
from redmax_tpu_torch import mpc as tmpc
from redmax_tpu_torch.scenes import build_scene as tbuild
from test_torch_certificates import single_thread  # noqa: F401

ROSEN_P0 = (-1.2, 1.0, -0.5, 0.8)


def rosen_jax(params, p, s0, tgt):
    return jnp.sum(100.0 * (p[1:] - p[:-1] ** 2) ** 2 + (1.0 - p[:-1]) ** 2)


def rosen_torch(params, p, s0, tgt):
    """A scalar of p [n], or a lane vector [B] of P [B, n]."""
    return (100.0 * (p[..., 1:] - p[..., :-1] ** 2) ** 2 + (1.0 - p[..., :-1]) ** 2).sum(-1)


class Counted:
    """An objective that counts its calls."""

    def __init__(self, fn):
        self.fn, self.calls = fn, 0

    def __call__(self, *args):
        self.calls += 1
        return self.fn(*args)


def _rel_close(got, want, rtol, name):
    got, want = np.asarray(got.detach()), np.asarray(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    scale = max(np.abs(want).max(), 1e-300)
    err = np.abs(got - want).max() / scale
    assert err <= rtol, f"{name}: {err:.3e} of scale"


def _hold(res, ref, rtol):
    for name in ("p", "objective", "grad_norm"):
        _rel_close(getattr(res, name), getattr(ref, name), rtol, name)


@pytest.mark.parametrize("iters", [1, 3, 8])
def test_rosenbrock_matches_jax(iters):
    ref = jax.jit(jmpc.make_mpc_solver(rosen_jax, iters=iters, method="lbfgs"))(
        None, jnp.asarray(ROSEN_P0), None, None)
    res = tmpc.make_mpc_solver(rosen_torch, iters=iters, method="lbfgs")(
        None, torch.tensor(ROSEN_P0, dtype=torch.float64), None, None)
    _hold(res, ref, 1e-10)
    if iters == 8:
        assert abs(float(res.objective) - 3.4937502220178063) <= 1e-10 * 3.5


def test_quadratic_first_trial_accepted():
    """A convex quadratic whose Hessian's eigenvalues lie in (0, 2): from a
    start with |g| < 1 the first direction is -g, and stepsize 1 meets both
    line-search conditions, so each iteration evaluates the objective twice
    (its start and the accepted trial)."""
    Q = np.diag([0.5, 1.0, 1.5])
    p0 = (0.3, 0.2, 0.1)
    ref = jax.jit(jmpc.make_mpc_solver(lambda _, p, s, t: 0.5 * p @ jnp.asarray(Q) @ p,
                                       iters=1, method="lbfgs"))(None, jnp.asarray(p0), None, None)
    Qt = torch.tensor(Q)
    obj = Counted(lambda _, p, s, t: 0.5 * ((p @ Qt) * p).sum(-1))
    res = tmpc.make_mpc_solver(obj, iters=1, method="lbfgs")(
        None, torch.tensor(p0, dtype=torch.float64), None, None)
    _hold(res, ref, 1e-10)
    assert obj.calls == 2
    np.testing.assert_allclose(res.p.numpy(), np.asarray(p0) - Q @ np.asarray(p0), rtol=1e-14)


def test_bdf1_adjoint_task_matches_jax():
    """tests/test_adjoint.py:103-110 on the port: scene 100's BDF1 task, 8
    steps, 4 L-BFGS iterations from the same draw; the objective falls and
    p equals JAX's."""
    rng = np.random.default_rng(7)
    task = dict(body=1, wp=1.0, wreg=1e-5, pscale=1e4)
    jsc = jbuild(100)
    jobj = jmpc.make_objective(jsc.topo, jsc.force_fns, jmpc.PointPosTask(**task),
                               jnp.array([5.0, 0.0, 0.0]), 8, "bdf1")
    p = rng.normal(size=jsc.topo.nr)
    target = (8.0, 0.0, 4.0)
    ref = jax.jit(jmpc.make_mpc_solver(jobj, iters=4, method="lbfgs"))(
        jsc.params, jnp.asarray(p), jsc.state0, jnp.asarray(target))
    tsc = tbuild(100, device="cpu")
    tobj = tmpc.make_objective(tsc.topo, tsc.force_fns, tmpc.PointPosTask(**task),
                               (5.0, 0.0, 0.0), 8, "bdf1")
    tgt = torch.tensor(target, dtype=torch.float64)
    res = tmpc.make_mpc_solver(tobj, iters=4, method="lbfgs")(
        tsc.params, torch.tensor(p), tsc.state0, tgt)
    _rel_close(res.p, ref.p, 1e-8, "p")
    _rel_close(res.objective, ref.objective, 1e-8, "objective")
    with torch.no_grad():
        f0 = tobj(tsc.params, torch.tensor(p), tsc.state0, tgt)
        f1 = tobj(tsc.params, res.p, tsc.state0, tgt)
    assert float(f1) < float(f0)


def test_lanes_match_vmapped_jax():
    """A lane vector objective: three finite starts and a NaN lane, every lane
    with its own memory and line search. Each finite lane equals the JAX
    solver vmapped over the lanes (and so its own unbatched solve); the NaN
    lane stays NaN and touches no other lane."""
    P0 = np.array([ROSEN_P0, [0.5, 0.5, 0.5, 0.5], [2.0, -1.0, 0.0, 1.0],
                   [np.nan, 1.0, 1.0, 1.0]])
    ref = jax.jit(jax.vmap(jmpc.make_mpc_solver(rosen_jax, iters=8, method="lbfgs"),
                           in_axes=(None, 0, None, None)))(None, jnp.asarray(P0), None, None)
    res = tmpc.make_mpc_solver(rosen_torch, iters=8, method="lbfgs")(
        None, torch.tensor(P0), None, None)
    assert res.p.shape == (4, 4) and res.objective.shape == (4,) and res.grad_norm.shape == (4,)
    for lane in range(3):
        for name in ("p", "objective", "grad_norm"):
            _rel_close(getattr(res, name)[lane], np.asarray(getattr(ref, name))[lane], 1e-10,
                       f"{name} lane {lane}")
        one = tmpc.make_mpc_solver(rosen_torch, iters=8, method="lbfgs")(
            None, torch.tensor(P0[lane]), None, None)
        assert torch.equal(one.p, res.p[lane])
    assert torch.isnan(res.p[3]).all() and torch.isnan(res.objective[3])
