"""The slice as a whole: one batched MPC solve (BDF2 rollout with the SDIRK2
bootstrap, the kernel route's factor-reusing adjoint, one Adam step) of the
port against redmax_tpu's make_mpc_solver_batched with the vmapped op-level
path (use_pallas=False), in float64 on scene_chain(4), B = 8, horizon 5; the
contact-MPC solve of benchmarks/bench_contact.py on chain-ground-4 (a
penalty ground contact on every link, the workload's coefficients) and the
spring-MPC solve on the 3-link spring scene (a body-body point-point spring
and a world spring-damper; tests/test_torch_springs.py) at the same size.
Objective, gradient norm and the updated P agree to 1e-8 of each quantity's
largest magnitude. The JAX oracle's time is its trace and compile of the
op-level solve (about 25-45 s a scene on this sandbox); the port's solve
takes about a second.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from redmax_tpu import integrators as jint
from redmax_tpu import mpc as jmpc
from redmax_tpu import scene as jscene
from redmax_tpu.scenes import scene_chain as jchain
from redmax_tpu.scenes import scene_chain_ground as jground
from redmax_tpu.types import JointType as JJT
from redmax_tpu.types import State as JState
from redmax_tpu_torch import chord_kernel, convert
from redmax_tpu_torch import integrators as tint
from redmax_tpu_torch import mpc as tmpc
from redmax_tpu_torch.types import State
from test_torch_springs import spring3


@pytest.fixture(scope="module", autouse=True)
def single_thread():
    """torch's intra-op threads set to 1 for the module, then restored."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CFG_KW = dict(fixed_iters=3, predictor="quadratic", chord=True,
              hessian="structured", linsolve="gj")
NLINKS, HORIZON, B, LR = 4, 5, 8, 0.05
XLOCAL = (0.5, 0.0, 0.0)


def _inputs(nr):
    rng = np.random.default_rng(0)
    p0 = 0.003 * rng.normal(size=(B, nr))
    targets = rng.uniform(-2.0, 2.0, size=(B, 3))
    return p0, targets


SCENES = {
    "chain": lambda: jchain(nlinks=NLINKS),
    "chain_ground": lambda: jground(nlinks=NLINKS, kn=100.0, kt=0.1, kd=10.0, mu=0.5,
                                    h=1e-2, floor_z=-0.06),
    "springs": lambda: spring3(jscene, JJT),
}
NCLOSURES = {"chain": 0, "chain_ground": NLINKS, "springs": 2}


@pytest.mark.parametrize("scene", ["chain", "chain_ground", "springs"])
def test_mpc_solve_matches_jax(scene):
    sc = SCENES[scene]().compile()
    assert len(sc.force_fns) == NCLOSURES[scene]
    nr = sc.topo.nr
    tip = sc.topo.njoints - 1
    p0, targets = _inputs(nr)
    task_j = jmpc.PointPosTask(body=tip, wp=1.0, wreg=1e-6, pscale=1e3)
    obj_j = jmpc.make_objective_batched(
        sc.topo, sc.force_fns, task_j, jnp.asarray(XLOCAL), HORIZON, jint.NewtonConfig(**CFG_KW),
        use_pallas=False,
    )
    s0 = JState(q=jnp.tile(sc.state0.q, (B, 1)), qdot=jnp.tile(sc.state0.qdot, (B, 1)), aux={})
    ref = jax.jit(jmpc.make_mpc_solver_batched(obj_j, iters=1, lr=LR))(
        sc.params, jnp.asarray(p0), s0, jnp.asarray(targets))

    topo = convert.topology_from_fields(**dataclasses.asdict(sc.topo))
    params = convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, sc.params), "cpu")
    task = tmpc.PointPosTask(body=tip, wp=1.0, wreg=1e-6, pscale=1e3)
    fns = convert.forces_from_fields([(type(f).__name__, vars(f)) for f in sc.force_fns])
    obj = tmpc.make_objective_batched(topo, fns, task, XLOCAL, HORIZON,
                                      tint.NewtonConfig(**CFG_KW), use_kernel=True)
    st = State(q=torch.tensor(np.tile(np.asarray(sc.state0.q), (B, 1))),
               qdot=torch.tensor(np.tile(np.asarray(sc.state0.qdot), (B, 1))))
    before = chord_kernel.chord_bdf2_launches
    res = tmpc.make_mpc_solver_batched(obj, iters=1, lr=LR)(
        params, torch.tensor(p0), st, torch.tensor(targets))
    assert chord_kernel.chord_bdf2_launches == before  # CPU: the plain version

    for name, got, want in [("objective", res.objective, ref.objective),
                            ("grad_norm", res.grad_norm, ref.grad_norm),
                            ("P", res.p, ref.p)]:
        want = np.asarray(want)
        assert np.isfinite(want).all(), name
        scale = float(np.abs(want).max())
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-8 * scale, err_msg=name)
