"""The q-dependent-joint slice as a whole on the CPU: one batched MPC solve
(SDIRK2 bootstrap, BDF2 on the kernel route with the post-step exp-map
rescale, the factor-reusing adjoint, one Adam step) on a chain of a FREE3D
root, a SPHERICAL and a UNIVERSAL joint, B = 8, horizon 5, float64, against
redmax_tpu.mpc.make_mpc_solver_batched(use_pallas=False) under one jax.jit:
objective, grad_norm and P at 1e-8 of scale. Its own file because the JAX
oracle's trace takes 30-55 s on this sandbox.
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
from redmax_tpu.types import JointType as JJT
from redmax_tpu.types import State as JState
from redmax_tpu_torch import convert
from redmax_tpu_torch import integrators as tint
from redmax_tpu_torch import mpc as tmpc
from redmax_tpu_torch.types import State
from test_torch_joints import qdep_mixed
from test_torch_lane_body import CFG_KW


@pytest.fixture(scope="module", autouse=True)
def single_thread():
    """torch's intra-op threads set to 1 for the module, then restored."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_mpc_solve_through_the_reparam_matches_jax():
    """One MPC solve on the FREE3D/SPHERICAL/UNIVERSAL chain (the mixed chain
    without its revolute joint), B = 8, horizon 5, float64. The spherical
    joint (DOFs 6:9) starts 0.9 inside |w| = 1.5 pi with a torque of 20 along
    w: the joint damping makes its rate about torque / damping, and in lanes
    1 and 7 |w| crosses 1.5 pi in the last step, so their final state and
    their gradient pass through the exp-map rescale. (A lane that crossed
    earlier would diverge in both packages: the rescale changes q and qdot
    but leaves the BDF2 history q_prev in the old coordinates, as the JAX
    package does, ROADMAP queue 3.) Finite masks must agree; objective,
    grad_norm and P at 1e-8 of scale."""
    HORIZON, B, LR, XLOCAL = 5, 8, 0.05, (0.5, 0.0, 0.0)
    sc = qdep_mixed(jscene, JJT, revolute=False).compile()
    nr = sc.topo.nr
    rng = np.random.default_rng(0)
    p0 = 0.003 * rng.normal(size=(B, nr))
    u = rng.normal(size=(B, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    q0, qd0 = np.zeros((B, nr)), 0.3 * rng.normal(size=(B, nr))
    q0[:, 6:9], p0[:, 6:9] = (1.5 * np.pi - 0.9) * u, 0.02 * u
    targets = rng.uniform(-2.0, 2.0, size=(B, 3))

    task_j = jmpc.PointPosTask(body=2, wp=1.0, wreg=1e-6, pscale=1e3)
    obj_j = jmpc.make_objective_batched(sc.topo, (), task_j, jnp.asarray(XLOCAL), HORIZON,
                                        jint.NewtonConfig(**CFG_KW), use_pallas=False)
    s0 = JState(q=jnp.asarray(q0), qdot=jnp.asarray(qd0), aux={})
    ref = jax.jit(jmpc.make_mpc_solver_batched(obj_j, iters=1, lr=LR))(
        sc.params, jnp.asarray(p0), s0, jnp.asarray(targets))

    topo = convert.topology_from_fields(**dataclasses.asdict(sc.topo))
    params = convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, sc.params), "cpu")
    cfg = tint.NewtonConfig(**CFG_KW)
    task = tmpc.PointPosTask(body=2, wp=1.0, wreg=1e-6, pscale=1e3)
    obj = tmpc.make_objective_batched(topo, (), task, XLOCAL, HORIZON, cfg, use_kernel=True)
    st = State(q=torch.tensor(q0), qdot=torch.tensor(qd0))
    res = tmpc.make_mpc_solver_batched(obj, iters=1, lr=LR)(params, torch.tensor(p0), st,
                                                            torch.tensor(targets))
    # the lanes whose rescale fired (in the last step: |w| ends near pi/2)
    final = tmpc.make_rollout_batched(topo, (), HORIZON, cfg)(params, 1e3 * torch.tensor(p0), st)
    w_end = torch.linalg.vector_norm(final.q[:, 6:9], dim=-1)
    assert torch.isfinite(res.objective).all()
    assert (w_end < 0.6 * np.pi).nonzero().flatten().tolist() == [1, 7], w_end

    for name, got, want in [("objective", res.objective, ref.objective),
                            ("grad_norm", res.grad_norm, ref.grad_norm), ("P", res.p, ref.p)]:
        want = np.asarray(want)
        np.testing.assert_array_equal(np.isfinite(got.numpy()), np.isfinite(want), err_msg=name)
        fin = np.isfinite(want)
        np.testing.assert_allclose(got.numpy()[fin], want[fin], rtol=0,
                                   atol=1e-8 * float(np.abs(want[fin]).max()), err_msg=name)
