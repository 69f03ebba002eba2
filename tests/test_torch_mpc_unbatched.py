"""The unbatched adjoint MPC of redmax_tpu_torch against redmax_tpu, in
float64 on the CPU: scene 100's mpc.make_objective (the reference's adjoint
task, PointPosTask(body=1, wp=1, wreg=1e-5, pscale=1e4), 10 steps) and its
gradient in p for BDF1 and BDF2 on both adjoint routes (the factor-reusing
one of a fixed-iteration config, and implicit_solve with the exact H of the
default config) against jax.grad at 1e-8 of scale; one Adam step of
mpc.make_mpc_solver against the JAX package's (the L-BFGS solver is held in
test_torch_lbfgs.py). The JAX oracles are jitted once each.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from redmax_tpu import integrators as jint
from redmax_tpu import mpc as jmpc
from redmax_tpu import scenes as jscenes
from redmax_tpu_torch import integrators as tint
from redmax_tpu_torch import mpc as tmpc
from redmax_tpu_torch import scenes as tscenes
from test_torch_bdf1 import CFG_KW, _close
from test_torch_certificates import single_thread  # noqa: F401

TASK = dict(body=1, wp=1.0, wreg=1e-5, pscale=1e4)
XLOCAL, TARGET, NSTEPS = (5.0, 0.0, 0.0), (8.0, 0.0, 4.0), 10


_JAX_OBJECTIVES = {}


def _objectives(integrator, cfg):
    """(JAX objective, jitted jax.value_and_grad, port objective, port scene,
    JAX scene) of scene 100's adjoint task."""
    key = (integrator, cfg)
    if key not in _JAX_OBJECTIVES:
        jsc = jscenes.build_scene(100)
        kw = CFG_KW if cfg == "fixed" else {}
        obj = jmpc.make_objective(jsc.topo, jsc.force_fns, jmpc.PointPosTask(**TASK),
                                  jnp.asarray(XLOCAL), NSTEPS, integrator,
                                  jint.NewtonConfig(**kw))
        tsc = tscenes.build_scene(100, device="cpu")
        tobj = tmpc.make_objective(tsc.topo, tsc.force_fns, tmpc.PointPosTask(**TASK), XLOCAL,
                                   NSTEPS, integrator, tint.NewtonConfig(**kw))
        _JAX_OBJECTIVES[key] = (obj, jax.jit(jax.value_and_grad(obj, argnums=1)), tobj, tsc,
                                jsc)
    return _JAX_OBJECTIVES[key]


def _p0():
    return np.random.default_rng(7).normal(size=2) * 0.3


@pytest.mark.parametrize("cfg", ["fixed", "reference"])
@pytest.mark.parametrize("integrator", ["bdf1", "bdf2"])
def test_objective_gradient_matches_jax_grad(integrator, cfg):
    """The factor-reusing adjoint (fixed) and implicit_solve with the exact
    H at the solution (reference), each against jax.grad of the same
    objective."""
    _, vg, tobj, tsc, jsc = _objectives(integrator, cfg)
    p = _p0()
    v, g = vg(jsc.params, jnp.asarray(p), jsc.state0, jnp.asarray(TARGET))
    pt = torch.tensor(p, requires_grad=True)
    vt = tobj(tsc.params, pt, tsc.state0, torch.tensor(TARGET, dtype=torch.float64))
    (gt,) = torch.autograd.grad(vt, pt)
    assert vt.shape == () and gt.shape == (2,)
    _close(vt.detach(), v, 1e-8, "objective")
    _close(gt, g, 1e-8, "gradient")
    assert float(np.abs(np.asarray(g)).max()) > 0


def test_adam_step_matches_jax():
    obj, _, tobj, tsc, jsc = _objectives("bdf2", "fixed")
    p = _p0()
    ref = jax.jit(jmpc.make_mpc_solver(obj, iters=1, lr=0.05))(
        jsc.params, jnp.asarray(p), jsc.state0, jnp.asarray(TARGET))
    res = tmpc.make_mpc_solver(tobj, iters=1, lr=0.05)(
        tsc.params, torch.tensor(p), tsc.state0, torch.tensor(TARGET, dtype=torch.float64))
    for name in ("p", "objective", "grad_norm"):
        _close(getattr(res, name), getattr(ref, name), 1e-8, name)
    assert callable(tmpc.make_mpc_solver(tobj, method="lbfgs"))   # test_torch_lbfgs.py
    with pytest.raises(ValueError):
        tmpc.make_mpc_solver(tobj, method="sgd")
    for fn in (tmpc.make_mppi_solver, tmpc.make_mppi_solver_batched):
        assert callable(fn(tobj))          # ported (test_torch_mppi.py)
