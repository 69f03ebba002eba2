"""The matrix-free PCG tier of redmax_tpu_torch, in float64 on the CPU: the
unsharded gates of tests/test_pcg.py at its tolerances (the O(n) J and J^T
products against the dense J; chain-30's PCG solve against the dense Euler
step in at most 3 iterations; mscene 15's Schur complement against the KKT
step; a 20-step trajectory against the dense Euler step), the port's pcg and
Euler PCG solve against the JAX package's (1e-10, the same iteration
counts), lanes that converge at different iterations against runs of one
lane, and the mesh= and inequality refusals. One intra-op thread
(single_thread).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from redmax_tpu import pcg as jpcg
from redmax_tpu import scenes as jscenes
from redmax_tpu import scenes_matlab as jms
from redmax_tpu_torch import integrators as tint
from redmax_tpu_torch import model as tmodel
from redmax_tpu_torch import pcg as tpcg
from redmax_tpu_torch import scenes as tscenes
from redmax_tpu_torch import scenes_matlab as tms
from redmax_tpu_torch.types import State
from test_torch_certificates import single_thread  # noqa: F401
from test_torch_recursive import close

RNG = np.random.default_rng(1)


@pytest.mark.parametrize("sid", [0, 2, 8])
def test_J_products_match_dense(sid):
    sc = tscenes.build_scene(sid, device="cpu")
    nr, N = sc.topo.nr, sc.topo.njoints
    q = sc.state0.q[None] + 0.1 * torch.tensor(RNG.normal(size=(2, nr)))
    qd = torch.tensor(RNG.normal(size=(2, nr)))
    kin = tmodel.forward_kinematics(sc.topo, sc.params, q, qd)
    J, _, _ = tmodel.jacobians(sc.topo, sc.params, kin, qd)
    J_x, JT_y = tpcg.make_J_products(sc.topo, sc.params, kin)
    x, y = torch.tensor(RNG.normal(size=(2, 3, nr))), torch.tensor(RNG.normal(size=(2, 3, 6 * N)))
    assert float((J_x(x) - (J[:, None] @ x[..., None])[..., 0]).abs().max()) < 1e-12
    assert float((JT_y(y) - (J.transpose(-1, -2)[:, None] @ y[..., None])[..., 0]).abs().max()) \
        < 1e-12
    assert float((J_x(x[:, 0]) - (J @ x[:, 0, :, None])[..., 0]).abs().max()) < 1e-12
    assert float((JT_y(y[:, 0]) - (J.transpose(-1, -2) @ y[:, 0, :, None])[..., 0]).abs().max()) \
        < 1e-12


def test_pcg_euler_matches_dense():
    sc = tscenes.scene_chain(nlinks=30, damping=0.0).compile(device="cpu")
    s0 = sc.initial_state("euler", B=2)
    s0.qdot[1] += torch.tensor(RNG.normal(size=sc.topo.nr))
    qdot1, res = tpcg.make_euler_pcg_solver(sc.topo, sc.force_fns)(sc.params, s0.q, s0.qdot)
    s1 = tint.make_euler_step(sc.topo, sc.force_fns)(sc.params, s0)
    assert float((qdot1 - s1.qdot).abs().max()) < 1e-8
    # The RHD preconditioner is the exact inverse of the pure-inertia LHS.
    assert int(res.iters.max()) <= 3


def test_pcg_schur_loop_constraint_matches_dense_kkt():
    """The Schur complement (Solver.cpp:654-746) against the dense KKT Euler
    step: the me + 1 right-hand sides of each lane are lanes of one CG."""
    sc = tms.build_mscene(15, device="cpu")
    solve = tpcg.make_euler_pcg_constrained_solver(sc.topo, sc.force_fns, sc.constraint_fns,
                                                   tol=1e-12)
    s0 = sc.initial_state("euler", B=2)
    s0.qdot[1] += 0.1
    qdot1, lam, res = solve(sc.params, s0.q, s0.qdot)
    s1 = tint.make_euler_step(sc.topo, sc.force_fns, sc.constraint_fns)(sc.params, s0)
    assert float((qdot1 * sc.params["h"] + s0.q - s1.q).abs().max()) < 1e-8
    assert lam.shape == (2, 2) and res.iters.shape == (2, 3)


def test_pcg_step_trajectory_matches_dense():
    sc = tms.build_mscene(15, device="cpu")
    dense = tint.make_euler_step(sc.topo, sc.force_fns, sc.constraint_fns)
    tier = tpcg.make_euler_pcg_step(sc.topo, sc.force_fns, sc.constraint_fns, tol=1e-12)
    s0 = sc.initial_state("euler")
    fd = tint.make_simulate(dense, 20)(sc.params, s0)
    ft = tint.make_simulate(tier, 20)(sc.params, s0)
    assert float((fd.q - ft.q).abs().max()) < 1e-6
    assert float((fd.qdot - ft.qdot).abs().max()) < 1e-5


def spd_systems(B, n, seed):
    """B SPD matrices, lane b with 3 + 2 b distinct eigenvalues (so CG ends
    in that many iterations, far from the tolerance at the one before),
    right-hand sides, and a preconditioner scale for each lane."""
    rng = np.random.default_rng(seed)
    A = []
    for b in range(B):
        Q, _ = np.linalg.qr(rng.normal(size=(n, n)))
        ev = np.resize(np.logspace(0, 2, 3 + 2 * b), n)
        A.append(Q @ np.diag(ev) @ Q.T)
    return np.stack(A), rng.normal(size=(B, n)), rng.uniform(0.5, 2.0, size=(B, 1))


def test_pcg_matches_jax():
    """pcg on three SPD systems with a scaling preconditioner against the
    JAX package's pcg, lane by lane (x at 1e-10, equal iteration counts)."""
    A, b, c = spd_systems(3, 12, 2)
    res = tpcg.pcg(lambda x: (torch.tensor(A) @ x[..., None])[..., 0], torch.tensor(b),
                   lambda r: torch.tensor(c) * r, tol=1e-9, maxit=200)
    ref = jax.jit(jax.vmap(lambda A, b, c: jpcg.pcg(lambda x: A @ x, b, lambda r: c * r,
                                                    tol=1e-9, maxit=200)))(
        jnp.asarray(A), jnp.asarray(b), jnp.asarray(c))
    close(res.x, ref.x, 1e-10, "x")
    np.testing.assert_array_equal(res.iters.numpy(), np.asarray(ref.iters))
    np.testing.assert_array_equal(res.iters.numpy(), [3, 5, 7])
    assert float(res.resnorm.max()) < 1e-9


@pytest.mark.parametrize("case", [("s", 8), ("m", 23)], ids=str)
def test_euler_pcg_solver_matches_jax(case):
    """The Euler PCG velocity solve at a seeded state against the JAX
    package's (qdot1 at 1e-10, equal iteration counts): scene 8 (joint
    damping) and mscene 23 (point-to-point springs: the closures' blocks in
    the matvec)."""
    kind, sid = case
    js = jscenes.build_scene(sid) if kind == "s" else jms.build_mscene(sid)
    ts = tscenes.build_scene(sid, device="cpu") if kind == "s" else tms.build_mscene(
        sid, device="cpu")
    rng = np.random.default_rng(4)
    q = np.asarray(js.state0.q) + 0.1 * rng.normal(size=js.topo.nr)
    qd = np.asarray(js.state0.qdot) + rng.normal(size=js.topo.nr)
    ref = jax.jit(jpcg.make_euler_pcg_solver(js.topo, js.force_fns, tol=1e-10))(
        js.params, jnp.asarray(q), jnp.asarray(qd))
    qdot1, res = tpcg.make_euler_pcg_solver(ts.topo, ts.force_fns, tol=1e-10)(
        ts.params, torch.tensor(q)[None], torch.tensor(qd)[None])
    close(qdot1[0], ref[0], 1e-10, "qdot1")
    assert int(res.iters[0]) == int(ref[1].iters)
    dense = tint.make_euler_step(ts.topo, ts.force_fns)(
        ts.params, State(q=torch.tensor(q)[None], qdot=torch.tensor(qd)[None]))
    close(qdot1, dense.qdot, 1e-9, "qdot1 vs the dense step")


def test_lanes_converge_at_different_iterations():
    """Lanes of one pcg call that stop at different iterations against runs
    of one lane each: the same x, residual and count, bit for bit."""
    A, b, c = spd_systems(3, 10, 7)
    T = [torch.tensor(v) for v in (A, b, c)]
    res = tpcg.pcg(lambda x: (T[0] @ x[..., None])[..., 0], T[1], lambda r: T[2] * r, tol=1e-10)
    for i in range(3):
        one = tpcg.pcg(lambda x: (T[0][i:i + 1] @ x[..., None])[..., 0], T[1][i:i + 1],
                       lambda r: T[2][i:i + 1] * r, tol=1e-10)
        assert torch.equal(res.x[i], one.x[0]) and int(res.iters[i]) == int(one.iters[0])
        assert torch.equal(res.resnorm[i], one.resnorm[0])
    assert len(set(res.iters.tolist())) == 3


def test_mesh_and_inequality_rows_raise():
    sc = tms.build_mscene(15, device="cpu")
    # mesh= takes a DeviceMesh (the sharded solve: test_torch_parallel.py)
    with pytest.raises(TypeError, match="DeviceMesh"):
        tpcg.make_euler_pcg_constrained_solver(sc.topo, (), sc.constraint_fns, mesh=object())
    with pytest.raises(TypeError, match="DeviceMesh"):
        tpcg.make_euler_pcg_step(sc.topo, (), sc.constraint_fns, mesh=object())
    sc6 = tms.build_mscene(6, device="cpu")
    with pytest.raises(NotImplementedError, match="equality"):
        tpcg.make_euler_pcg_step(sc6.topo, sc6.force_fns, sc6.constraint_fns)
