"""A robust-mode MPC solve of the port against redmax_tpu's: the guard_last
config of benchmarks/robust_mode.py (fixed_iters=3, quadratic predictor,
chord, structured, GJ, one guarded final iteration) on chain-ground-3 at the
contact-MPC coefficients, B = 4, horizon 5, p0 = 6e-3 N(0, 1) (robust_mode.py's
sigma = 6), one Adam step, in float64: the port's kernel route (the plain
version on the CPU) against make_mpc_solver_batched with the vmapped
op-level path (use_pallas=False). The finite masks are equal (one lane is
rejected at this torque scale); on the finite lanes objective, gradient norm
and the updated P agree to 1e-8 of each quantity's largest magnitude. The
JAX oracle's trace and compile (25-45 s) is most of this file's time, so it
has a file of its own.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from redmax_tpu import integrators as jint
from redmax_tpu import mpc as jmpc
from redmax_tpu.scenes import scene_chain_ground as jground
from redmax_tpu.types import State as JState
from redmax_tpu_torch import chord_kernel, convert
from redmax_tpu_torch import integrators as tint
from redmax_tpu_torch import mpc as tmpc
from redmax_tpu_torch.types import State


@pytest.fixture(scope="module", autouse=True)
def single_thread():
    """torch's intra-op threads set to 1 for the module, then restored."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CFG_KW = dict(fixed_iters=3, predictor="quadratic", chord=True, guard_last=True,
              hessian="structured", linsolve="gj")
NLINKS, HORIZON, B, LR, SIGMA = 3, 5, 4, 0.05, 6.0
XLOCAL = (0.5, 0.0, 0.0)


def test_guard_last_mpc_solve_matches_jax():
    sc = jground(nlinks=NLINKS, kn=100.0, kt=0.1, kd=10.0, mu=0.5, h=1e-2,
                 floor_z=-0.06).compile()
    nr, tip = sc.topo.nr, sc.topo.njoints - 1
    rng = np.random.default_rng(0)
    p0 = SIGMA / 1e3 * rng.normal(size=(B, nr))
    targets = rng.uniform(-2.0, 2.0, size=(B, 3))
    task_j = jmpc.PointPosTask(body=tip, wp=1.0, wreg=1e-6, pscale=1e3)
    obj_j = jmpc.make_objective_batched(
        sc.topo, sc.force_fns, task_j, jnp.asarray(XLOCAL), HORIZON,
        jint.NewtonConfig(**CFG_KW), use_pallas=False)
    s0 = JState(q=jnp.tile(sc.state0.q, (B, 1)), qdot=jnp.tile(sc.state0.qdot, (B, 1)), aux={})
    ref = jax.jit(jmpc.make_mpc_solver_batched(obj_j, iters=1, lr=LR))(
        sc.params, jnp.asarray(p0), s0, jnp.asarray(targets))

    topo = convert.topology_from_fields(**dataclasses.asdict(sc.topo))
    params = convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, sc.params), "cpu")
    fns = convert.forces_from_fields([(type(f).__name__, vars(f)) for f in sc.force_fns])
    cfg = tint.NewtonConfig(**CFG_KW)
    assert chord_kernel.supports(topo, fns, cfg)
    task = tmpc.PointPosTask(body=tip, wp=1.0, wreg=1e-6, pscale=1e3)
    obj = tmpc.make_objective_batched(topo, fns, task, XLOCAL, HORIZON, cfg, use_kernel=True)
    st = State(q=torch.tensor(np.tile(np.asarray(sc.state0.q), (B, 1))),
               qdot=torch.tensor(np.tile(np.asarray(sc.state0.qdot), (B, 1))))
    res = tmpc.make_mpc_solver_batched(obj, iters=1, lr=LR)(
        params, torch.tensor(p0), st, torch.tensor(targets))

    for name, got, want in [("objective", res.objective, ref.objective),
                            ("grad_norm", res.grad_norm, ref.grad_norm),
                            ("P", res.p, ref.p)]:
        want, got = np.asarray(want), got.numpy()
        fin = np.isfinite(want)
        np.testing.assert_array_equal(np.isfinite(got), fin, err_msg=name)
        scale = float(np.abs(want[fin]).max())
        np.testing.assert_allclose(got[fin], want[fin], rtol=0, atol=1e-8 * scale, err_msg=name)
    # at this torque scale the guard rejects a lane (NaN in both), not all of them
    assert 0 < int(np.isfinite(np.asarray(ref.objective)).sum()) < B
