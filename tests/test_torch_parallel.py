"""The port's parallel.py (torch.distributed) and pcg's mesh= on a 2-process
gloo world on the CPU (spawned, a FileStore in a temp dir), in float64:

  * sharded_batch at model 1 and model 2 on tests/test_parallel.py's problem
    (B = 16, a 4-link chain, 3 BDF2 steps, 2 Adam iterations), with the main
    path's chord NewtonConfig, bench.py's torque scale (p0 = 0.003 N(0, 1),
    pscale 1e3) and lr 0.005, and one NaN lane: equal bit for bit to the
    port's unsharded lane-by-lane solve, and to JAX's vmapped solve to 1e-10;
    the mean is the finite-lane mean;
  * sharded_mpc_batched over the batched Adam solve likewise (each rank's
    block of 8 lanes whole);
  * every lane NaN gives a mean of inf; reduce_metrics=False keeps the rank's
    own mean; shard_batch_arrays gives the rank's block;
  * pcg's mesh= with model 2 on mscene 15 (tests/test_pcg.py:79-111),
    through the solver and the step, bit-identical to the unsharded solve;
  * make_mesh without an initialized world raises.

The world runs once for the module, in the background, while this process
computes the references.
"""

import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

from redmax_tpu_torch import integrators, mpc, parallel
from redmax_tpu_torch import pcg as tpcg
from redmax_tpu_torch.scenes import scene_chain
from redmax_tpu_torch.scenes_matlab import build_mscene
from redmax_tpu_torch.types import State
from test_torch_certificates import single_thread  # noqa: F401

WORLD = 2
B, NSTEPS, NLINKS, NAN_LANE = 16, 3, 4, 5
CFG = dict(fixed_iters=3, predictor="quadratic", chord=True, hessian="structured",
           linsolve="gj")
TASK = dict(body=NLINKS - 1, wp=1.0, wreg=1e-6, pscale=1e3)
ITERS, LR = 2, 0.005


def problem_arrays():
    """test_parallel.py's draws (seed 3) at bench.py's torque scale, lane
    NAN_LANE's p0 NaN."""
    rng = np.random.default_rng(3)
    sc = scene_chain(nlinks=NLINKS, tEnd=NSTEPS * 1e-2).compile(device="cpu")
    p0 = 0.003 * rng.normal(size=(B, sc.topo.nr))
    p0[NAN_LANE] = np.nan
    q0 = sc.state0.q.numpy()[None] + 0.01 * rng.normal(size=(B, sc.topo.nr))
    targets = rng.normal(size=(B, 3))
    return p0, q0, targets


def port_problem():
    """(params, per-task solve, batched solve, p0, state0, targets) on the
    port."""
    sc = scene_chain(nlinks=NLINKS, tEnd=NSTEPS * 1e-2).compile(device="cpu")
    cfg = integrators.NewtonConfig(**CFG)
    task = mpc.PointPosTask(**TASK)
    obj = mpc.make_objective(sc.topo, sc.force_fns, task, (0.5, 0.0, 0.0), NSTEPS, "bdf2", cfg)
    objb = mpc.make_objective_batched(sc.topo, sc.force_fns, task, (0.5, 0.0, 0.0), NSTEPS, cfg)
    p0, q0, targets = (torch.tensor(a) for a in problem_arrays())
    s0 = State(q=q0, qdot=sc.state0.qdot.expand(B, -1).contiguous())
    return (sc.params, mpc.make_mpc_solver(obj, iters=ITERS, lr=LR),
            mpc.make_mpc_solver_batched(objb, iters=ITERS, lr=LR), p0, s0, targets)


def _nan_solve(params, p, s0, tgt):
    return mpc.MpcResult(p=p, objective=torch.full(p.shape[:-1], float("nan"), dtype=p.dtype),
                         grad_norm=torch.zeros(p.shape[:-1], dtype=p.dtype))


def _pcg_runs(mesh):
    """mscene 15 (2 loop-closure rows: 3 CG right-hand sides over 2 model
    ranks, one pad row), 2 lanes: the constrained solve and the step, with
    and without the mesh."""
    sc = build_mscene(15, device="cpu")
    q = sc.state0.q.expand(2, -1).contiguous()
    q = q + 1e-3 * torch.arange(2, dtype=q.dtype)[:, None]
    qdot = sc.state0.qdot.expand(2, -1).contiguous()
    out = {}
    for tag, m in (("ref", None), ("mesh", mesh)):
        solve = tpcg.make_euler_pcg_constrained_solver(sc.topo, sc.force_fns, sc.constraint_fns,
                                                       tol=1e-12, mesh=m)
        qdot1, lam, res = solve(sc.params, q, qdot)
        step = tpcg.make_euler_pcg_step(sc.topo, sc.force_fns, sc.constraint_fns, tol=1e-12,
                                        mesh=m)
        s = step(sc.params, State(q=q, qdot=qdot))
        out[tag] = (qdot1, lam, res.x, res.iters, res.resnorm, s.q, s.qdot)
    return out


def world_main(rank: int, store: str, out_dir: str) -> None:
    """One rank of the 2-process gloo world: every sharded run, saved to
    out_dir/rank<rank>.pt."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, WORLD), rank=rank,
                            world_size=WORLD)
    try:
        params, solve, solve_b, p0, s0, targets = port_problem()
        out = {}
        for model in (1, 2):
            mesh = parallel.make_mesh(model=model)
            assert mesh.device_type == "cpu" and mesh.mesh_dim_names == ("rollout", "model")
            assert tuple(mesh.shape) == (WORLD // model, model)
            out[f"batch{model}"] = parallel.sharded_batch(solve, mesh)(params, p0, s0, targets)
        mesh = parallel.make_mesh(model=1)
        out["mpc_batched"] = parallel.sharded_mpc_batched(solve_b, mesh)(params, p0, s0, targets)
        out["nan_batch"] = parallel.sharded_batch(_nan_solve, mesh)(params, p0, s0, targets)[1]
        out["nan_mpc"] = parallel.sharded_mpc_batched(_nan_solve, mesh)(params, p0, s0,
                                                                      targets)[1]
        out["own_mean"] = parallel.sharded_batch(solve, mesh, reduce_metrics=False)(
            params, p0, s0, targets)[1]
        out["block"] = parallel.shard_batch_arrays(mesh, {"p0": p0, "s0": s0})
        out["pcg"] = _pcg_runs(parallel.make_mesh(model=2))
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


class World:
    """The spawned world, started once; results() waits for it."""

    def __init__(self, out_dir):
        self.out_dir = str(out_dir)
        self.ctx = torch.multiprocessing.spawn(
            world_main, args=(os.path.join(self.out_dir, "store"), self.out_dir),
            nprocs=WORLD, join=False)
        self._results = None

    def results(self):
        if self._results is None:
            for _ in range(30):
                if self.ctx.join(timeout=10):
                    break
            else:
                raise AssertionError("the gloo world did not finish in 300 s")
            self._results = [torch.load(os.path.join(self.out_dir, f"rank{r}.pt"),
                                        weights_only=False) for r in range(WORLD)]
        return self._results


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = World(tmp_path_factory.mktemp("world"))
    yield w
    w.results()


@pytest.fixture(scope="module")
def port_refs():
    """The port's unsharded solves: lane by lane (the per-task solve), and
    the batched solve of all 16 lanes."""
    params, solve, solve_b, p0, s0, targets = port_problem()
    lanes = [solve(params, p0[i], State(q=s0.q[i], qdot=s0.qdot[i]), targets[i])
             for i in range(B)]
    per_task = mpc.MpcResult(*(torch.stack(f) for f in zip(*lanes)))
    return per_task, solve_b(params, p0, s0, targets)


@pytest.fixture(scope="module")
def jax_ref():
    """JAX's vmapped per-task solve of the same problem, jitted once."""
    import jax
    import jax.numpy as jnp

    from redmax_tpu import integrators as jint
    from redmax_tpu import mpc as jmpc
    from redmax_tpu.scenes import scene_chain as jchain
    from redmax_tpu.types import State as JState

    sc = jchain(nlinks=NLINKS, tEnd=NSTEPS * 1e-2).compile()
    obj = jmpc.make_objective(sc.topo, sc.force_fns, jmpc.PointPosTask(**TASK),
                              jnp.array([0.5, 0.0, 0.0]), NSTEPS, "bdf2", jint.NewtonConfig(**CFG))
    p0, q0, targets = problem_arrays()
    s0 = JState(q=jnp.asarray(q0), qdot=jnp.tile(sc.state0.qdot, (B, 1)))
    res = jax.jit(jax.vmap(jmpc.make_mpc_solver(obj, iters=ITERS, lr=LR),
                           in_axes=(None, 0, 0, 0)))(sc.params, jnp.asarray(p0), s0,
                                                     jnp.asarray(targets))
    return mpc.MpcResult(*(torch.tensor(np.asarray(x)) for x in res))


def _finite_mean(objective):
    return float(objective[torch.isfinite(objective)].mean())


def _bitwise(a, b, name):
    torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True, msg=name)


def _vs_jax(res, ref):
    for name in ("p", "objective", "grad_norm"):
        a, b = getattr(res, name), getattr(ref, name)
        scale = float(b[torch.isfinite(b)].abs().max())
        torch.testing.assert_close(a, b, rtol=0, atol=1e-10 * scale, equal_nan=True, msg=name)


@pytest.mark.parametrize("model", [1, 2])
def test_sharded_batch_equals_unsharded(world, port_refs, jax_ref, model):
    per_task, _ = port_refs
    want = _finite_mean(per_task.objective)
    assert torch.isnan(per_task.objective[NAN_LANE])
    assert int(torch.isfinite(per_task.objective).sum()) == B - 1
    for rank, out in enumerate(world.results()):
        res, mean = out[f"batch{model}"]
        for name in ("p", "objective", "grad_norm"):
            _bitwise(getattr(res, name), getattr(per_task, name), f"{name} rank {rank}")
        assert abs(float(mean) - want) <= 1e-12 * abs(want)
    _vs_jax(per_task, jax_ref)


def test_sharded_mpc_batched_equals_unsharded(world, port_refs, jax_ref):
    """Each rank's block of 8 lanes through the batched solve gives the
    16-lane solve's lanes bit for bit."""
    _, batched = port_refs
    want = _finite_mean(batched.objective)
    for rank, out in enumerate(world.results()):
        res, mean = out["mpc_batched"]
        for name in ("p", "objective", "grad_norm"):
            _bitwise(getattr(res, name), getattr(batched, name), f"{name} rank {rank}")
        assert abs(float(mean) - want) <= 1e-12 * abs(want)
    _vs_jax(batched, jax_ref)


def test_all_nan_mean_is_inf_and_own_mean(world, port_refs):
    per_task, _ = port_refs
    for rank, out in enumerate(world.results()):
        assert float(out["nan_batch"]) == float("inf")
        assert float(out["nan_mpc"]) == float("inf")
        own = per_task.objective[rank * B // WORLD:(rank + 1) * B // WORLD]
        assert abs(float(out["own_mean"]) - _finite_mean(own)) <= 1e-12 * abs(_finite_mean(own))
        p0 = torch.tensor(problem_arrays()[0])
        blk = out["block"]
        _bitwise(blk["p0"], p0[rank * B // WORLD:(rank + 1) * B // WORLD], "p0 block")
        assert blk["s0"].q.shape == (B // WORLD, per_task.p.shape[1])


def test_pcg_mesh_bit_identical(world):
    """The constrained PCG solve and step with its CG rows split over the 2
    model ranks equal the unsharded ones bit for bit, on both ranks."""
    for out in world.results():
        ref, got = out["pcg"]["ref"], out["pcg"]["mesh"]
        for name, a, b in zip(("qdot1", "lam", "x", "iters", "resnorm", "q", "qdot"), got, ref):
            assert torch.equal(a, b), name
        assert ref[2].shape[1] == 3


def test_make_mesh_needs_a_world():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="initialized"):
        parallel.make_mesh()
    sc = build_mscene(15, device="cpu")
    with pytest.raises(TypeError, match="DeviceMesh"):
        tpcg.make_euler_pcg_step(sc.topo, (), sc.constraint_fns, mesh=object())
