"""Per-step gate of the port's f32 BDF2 inner step against the committed f64
reference trajectory of scene 0 (tests/data/ref_traj_00.npz), with the
bounds tests/test_ref_traj.py holds the JAX package's production tier to:
each dumped step becomes one lane, re-stepped in f32 from the f64 history.
"""

import os

import numpy as np
import pytest
import torch

from redmax_tpu_torch import integrators as tint
from redmax_tpu_torch.scenes import scene_00_serial_chain
from redmax_tpu_torch.types import State


@pytest.fixture(scope="module", autouse=True)
def single_thread():
    """torch's intra-op threads set to 1 for the module, then restored."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


DATA = os.path.join(os.path.dirname(__file__), "data")
CFG = tint.NewtonConfig(fixed_iters=3, predictor="quadratic", chord=True,
                        hessian="structured", linsolve="gj")
P99_BOUND, MAX_BOUND = 6e-6, 2e-5  # tests/test_ref_traj.py BOUNDS[0] (bdf2)


@pytest.mark.parametrize("use_kernel", [True, False], ids=["kernel_route", "op_level"])
def test_bdf2_per_step_vs_ref_scene0(use_kernel):
    d = np.load(os.path.join(DATA, "ref_traj_00.npz"))
    sc = scene_00_serial_chain().compile(dtype=torch.float32, device="cpu")
    q, qd = d["q_bdf2"], d["qdot_bdf2"]
    f32 = lambda a: torch.tensor(a, dtype=torch.float32)
    s = tint.Bdf2State(q=f32(q[1:-1]), qdot=f32(qd[1:-1]),
                       q_prev=f32(q[:-2]), qdot_prev=f32(qd[:-2]), k=1)
    step = tint.make_bdf2_step_batched(sc.topo, (), CFG, use_kernel=use_kernel)
    out = step.inner(sc.params, s)
    scale = max(1.0, float(np.abs(q).max()))
    err = np.abs(out.q.numpy().astype(np.float64) - q[2:]).max(axis=-1) / scale
    p99, mx = float(np.quantile(err, 0.99)), float(err.max())
    assert p99 <= P99_BOUND and mx <= MAX_BOUND, (p99, mx)


def test_step_dispatch_and_unported_modes():
    """step() bootstraps at k = 0 and runs the inner step after; the solver
    modes that once raised (guarded, guard_last, chord=False, the line
    search, LU) now run and give a finite step, and guard_last outside
    unguarded chord raises."""
    sc = scene_00_serial_chain().compile(device="cpu")
    s0 = tint.bdf2_init(State(q=sc.state0.q[None], qdot=sc.state0.qdot[None]))
    step = tint.make_bdf2_step_batched(sc.topo, (), CFG)
    s1 = step(sc.params, s0)
    s2 = step(sc.params, s1)
    assert (s1.k, s2.k) == (1, 2)
    torch.testing.assert_close(s1.q, step.bootstrap(sc.params, s0).q, rtol=0, atol=0)
    torch.testing.assert_close(s2.q_prev, s1.q, rtol=0, atol=0)
    assert torch.isfinite(s2.q).all()
    for mode in (dict(guarded=True), dict(guard_last=True), dict(chord=False),
                 dict(fixed_iters=0), dict(linsolve="lu")):
        cfg = tint.NewtonConfig(**{**CFG.__dict__, **mode})
        s = tint.make_bdf2_step(sc.topo, (), cfg).bootstrap(sc.params, s0)
        torch.testing.assert_close(s.q, s1.q, rtol=0, atol=1e-8)
    with pytest.raises(ValueError):
        cfg = tint.NewtonConfig(**{**CFG.__dict__, "guard_last": True, "chord": False})
        tint.make_bdf2_step(sc.topo, (), cfg).bootstrap(sc.params, s0)
