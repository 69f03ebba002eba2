"""The per-lane slice as a whole on the CPU: one domain-randomized contact-MPC
solve (SDIRK2 bootstrap, BDF2 on the kernel route, the factor-reusing
adjoint, one Adam step) on chain-ground-3 at benchmarks/bench_contact.py's
coefficients, B = 4, horizon 5, float64, with per-lane I_i, body damping, g,
h and each contact's kn and mu (test_torch_perlane.perlane_params), against
redmax_tpu.mpc.make_mpc_solver_batched(use_pallas=False) under one jax.jit:
objective, grad_norm and P at 1e-8 of scale. B differs from the 3 contacts,
so that a per-lane coefficient laid out along the contacts raises. Its own
file because the JAX oracle's trace takes 25-45 s on a CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from redmax_tpu import integrators as jint
from redmax_tpu import mpc as jmpc
from redmax_tpu.scenes import scene_chain_ground as jground
from redmax_tpu.types import State as JState
from redmax_tpu_torch import chord_kernel
from redmax_tpu_torch import integrators as tint
from redmax_tpu_torch import mpc as tmpc
from redmax_tpu_torch.types import State
from test_torch_chord import BENCH_GROUND
from test_torch_perlane import CFG_KW, perlane_params, port_scene


@pytest.fixture(scope="module", autouse=True)
def single_thread():
    """torch's intra-op threads set to 1 for the module, then restored."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_randomized_contact_mpc_solve_matches_jax():
    HORIZON, B, LR, XLOCAL = 5, 4, 0.05, (0.5, 0.0, 0.0)
    sc = jground(nlinks=3, **BENCH_GROUND).compile()
    nr, tip = sc.topo.nr, sc.topo.njoints - 1
    pn = perlane_params(sc.params, sc.force_fns, B)
    rng = np.random.default_rng(0)
    p0 = 0.003 * rng.normal(size=(B, nr))
    targets = rng.uniform(-2.0, 2.0, size=(B, 3))
    q0, qd0 = np.tile(np.asarray(sc.state0.q), (B, 1)), np.tile(np.asarray(sc.state0.qdot), (B, 1))

    task_j = jmpc.PointPosTask(body=tip, wp=1.0, wreg=1e-6, pscale=1e3)
    obj_j = jmpc.make_objective_batched(sc.topo, sc.force_fns, task_j, jnp.asarray(XLOCAL),
                                        HORIZON, jint.NewtonConfig(**CFG_KW), use_pallas=False)
    s0 = JState(q=jnp.asarray(q0), qdot=jnp.asarray(qd0), aux={})
    ref = jax.jit(jmpc.make_mpc_solver_batched(obj_j, iters=1, lr=LR))(
        jax.tree_util.tree_map(jnp.asarray, pn), jnp.asarray(p0), s0, jnp.asarray(targets))

    topo, params, fns = port_scene(sc, pn)
    assert len(fns) == 3 and params["forces"]["f0"]["kn"].shape == (B,)
    task = tmpc.PointPosTask(body=tip, wp=1.0, wreg=1e-6, pscale=1e3)
    obj = tmpc.make_objective_batched(topo, fns, task, XLOCAL, HORIZON,
                                      tint.NewtonConfig(**CFG_KW), use_kernel=True)
    before = chord_kernel.chord_bdf2_launches
    res = tmpc.make_mpc_solver_batched(obj, iters=1, lr=LR)(
        params, torch.tensor(p0), State(q=torch.tensor(q0), qdot=torch.tensor(qd0)),
        torch.tensor(targets))
    assert chord_kernel.chord_bdf2_launches == before  # CPU: the plain version

    for name, got, want in [("objective", res.objective, ref.objective),
                            ("grad_norm", res.grad_norm, ref.grad_norm), ("P", res.p, ref.p)]:
        want = np.asarray(want)
        assert np.isfinite(want).all(), name
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-8 * float(np.abs(want).max()), err_msg=name)
    # the lanes' params act: lane 0's params on every lane give other objectives
    lane0 = {**params, **{k: params[k][0] for k in ("I_i", "g", "h", "body_damping")}}
    other = tmpc.make_mpc_solver_batched(obj, iters=1, lr=LR)(
        lane0, torch.tensor(p0), State(q=torch.tensor(q0), qdot=torch.tensor(qd0)),
        torch.tensor(targets))
    assert float((other.objective - res.objective)[1:].abs().min()) > 0
