"""The sampling MPC (MPPI) solvers of redmax_tpu_torch against redmax_tpu, in
float64 on the CPU: _mppi_combine with NaN and inf candidates and with every
candidate diverged; the batched solver (candidates as the lanes of
make_objective_batched, op-level route) against the unbatched one
(candidates as lanes of the lane-of-one make_objective) for one generator
(1e-8, as tests/test_adjoint.py::test_mppi_batched_matches_vmapped);
candidates drawn from a JAX key given to both packages' objectives and
combine (1e-8); and the cost falls (test_mppi_solver_reduces_objective).
Scene 100's adjoint task, PointPosTask(body=1, wp=1, wreg=1e-5, pscale=1e4),
5 BDF2 steps with the default NewtonConfig. The JAX oracles are jitted once
each.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from redmax_tpu import mpc as jmpc
from redmax_tpu import scenes as jscenes
from redmax_tpu_torch import mpc as tmpc
from redmax_tpu_torch import scenes as tscenes
from redmax_tpu_torch.types import State
from test_torch_certificates import single_thread  # noqa: F401

TASK = dict(body=1, wp=1.0, wreg=1e-5, pscale=1e4)
XLOCAL, TARGET, NSTEPS = (5.0, 0.0, 0.0), (8.0, 0.0, 4.0), 5


def _close(a, b, tol, name):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    scale = max(1.0, float(np.abs(b[np.isfinite(b)]).max())) if np.isfinite(b).any() else 1.0
    np.testing.assert_allclose(a, b, rtol=0, atol=tol * scale, err_msg=name)


@pytest.fixture(scope="module")
def port():
    sc = tscenes.build_scene(100, device="cpu")
    task = tmpc.PointPosTask(**TASK)
    obj = tmpc.make_objective(sc.topo, sc.force_fns, task, XLOCAL, NSTEPS, "bdf2")
    obj_b = tmpc.make_objective_batched(sc.topo, sc.force_fns, task, XLOCAL, NSTEPS,
                                        use_kernel=False)
    p = torch.tensor(np.random.default_rng(1).normal(size=sc.topo.nr))
    return sc, obj, obj_b, p, torch.tensor(TARGET, dtype=torch.float64)


@pytest.mark.parametrize("case", ["mixed", "all_diverged", "all_finite"])
def test_mppi_combine_matches_jax(case):
    rng = np.random.default_rng(3)
    costs = rng.uniform(0.5, 3.0, size=8)
    cand = rng.normal(size=(8, 4))
    p0 = rng.normal(size=4)
    if case == "mixed":
        costs[[1, 5]] = np.nan
        costs[6] = np.inf
    elif case == "all_diverged":
        costs[:] = [np.nan, np.inf, -np.inf, np.nan, np.inf, np.nan, np.nan, np.inf]
        cand[2] = np.inf
    p_ref, c_ref = jmpc._mppi_combine(jnp.asarray(costs), jnp.asarray(cand), jnp.asarray(p0), 0.7)
    p, c = tmpc._mppi_combine(torch.tensor(costs), torch.tensor(cand), torch.tensor(p0), 0.7)
    assert not torch.isnan(p).any() and not torch.isnan(c)
    _close(p, p_ref, 1e-14, "p_new")
    if case == "all_diverged":
        assert float(c) == float(c_ref) == float("inf")
        np.testing.assert_allclose(p.numpy(), p0, rtol=0, atol=1e-15)
    else:
        _close(c, c_ref, 1e-14, "mean cost")


def test_mppi_batched_matches_vmapped(port):
    """The batched solver and the unbatched one from one generator state
    draw the same candidates and agree at 1e-8."""
    sc, obj, obj_b, p, target = port
    s_v = tmpc.make_mppi_solver(obj, n_samples=16, sigma=0.3)
    s_b = tmpc.make_mppi_solver_batched(obj_b, n_samples=16, sigma=0.3)
    p_v, c_v = s_v(torch.Generator().manual_seed(1), sc.params, p, sc.state0, target)
    p_b, c_b = s_b(torch.Generator().manual_seed(1), sc.params, p, sc.state0, target)
    assert torch.isfinite(c_v)
    _close(p_b, p_v, 1e-8, "p_new")
    _close(c_b, c_v, 1e-8, "mean cost")


def test_mppi_candidates_from_jax_key(port):
    """Candidates drawn from a JAX key (as the JAX solver draws them) go
    through both packages' batched objectives and _mppi_combine: costs,
    p_new and the mean cost agree at 1e-8."""
    sc, _, obj_b, p, target = port
    jsc = jscenes.build_scene(100)
    jobj = jmpc.make_objective_batched(jsc.topo, jsc.force_fns, jmpc.PointPosTask(**TASK),
                                       jnp.asarray(XLOCAL), NSTEPS, use_pallas=False)
    S = 16
    pj = jnp.asarray(p.numpy())
    cand = pj[None] + 0.3 * jax.random.normal(jax.random.PRNGKey(1), (S,) + pj.shape, pj.dtype)
    s0 = jax.tree_util.tree_map(lambda x: jnp.broadcast_to(x, (S,) + jnp.shape(x)), jsc.state0)
    tg = jnp.broadcast_to(jnp.asarray(TARGET), (S, 3))

    @jax.jit
    def ref(cand):
        costs = jobj(jsc.params, cand, s0, tg)
        return (costs,) + jmpc._mppi_combine(costs, cand, pj, 1.0)

    costs_ref, p_ref, c_ref = ref(cand)
    tc = torch.tensor(np.asarray(cand))
    lanes = lambda v: v.expand(S, *v.shape).contiguous()
    with torch.no_grad():
        costs = obj_b(sc.params, tc, State(q=lanes(sc.state0.q), qdot=lanes(sc.state0.qdot)),
                      lanes(target))
    p_new, c = tmpc._mppi_combine(costs, tc, p, 1.0)
    _close(costs, costs_ref, 1e-8, "costs")
    _close(p_new, p_ref, 1e-8, "p_new")
    _close(c, c_ref, 1e-8, "mean cost")


def test_mppi_solver_reduces_objective(port):
    """Softmax-averaged candidates lower the cost (32 candidates)."""
    sc, obj, _, p, target = port
    solve = tmpc.make_mppi_solver(obj, n_samples=32, sigma=0.3)
    p1, c1 = solve(torch.Generator().manual_seed(0), sc.params, p, sc.state0, target)
    with torch.no_grad():
        c0 = obj(sc.params, p, sc.state0, target)
    assert float(c1) <= float(c0) + 1e-9
    with torch.no_grad():
        assert torch.isfinite(obj(sc.params, p1, sc.state0, target))
