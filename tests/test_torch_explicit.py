"""The explicit tier of redmax_tpu_torch (explicit.py) against redmax_tpu, in
float64 on the CPU: make_ode45's controller against the JAX package's on a
damped, driven oscillator (closed form, cheap to compile) at 1e-12, with
rejected steps; batched lanes against runs of one lane, bit for bit (the
oscillator, and mscene 25 through the dense and recursive derivatives); the
dense derivative's inequality branch (mscene 6 with its joint limit active)
against the JAX package's; scene 5's time-varying torques through ode45
(|H - 160.8208| <= 1e-2, tests/test_ode45.py::test_scene5_time_varying_torques).
The derivatives of every certificate scene: test_torch_explicit_derivs*.py;
the certificates: test_torch_ode45_certificates*.py. One intra-op thread
(single_thread).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from redmax_tpu import explicit as jex
from redmax_tpu import scenes_matlab as jms
from redmax_tpu_torch import explicit as tex
from redmax_tpu_torch import scenes_matlab as tms
from redmax_tpu_torch.types import State
from test_torch_certificates import single_thread  # noqa: F401
from test_torch_recursive import close

# y = [x, v]: x'' = -k x - c x' + a sin(w t), per lane (k, c, a, w).
OSC = np.array([[40.0, 0.3, 5.0, 17.0], [4.0, 0.1, 0.0, 1.0], [400.0, 2.0, 50.0, 60.0]])


def osc_jax(params, t, y, aux=None):
    k, c, a, w = (params[..., i] for i in range(4))
    return jnp.stack([y[..., 1], -k * y[..., 0] - c * y[..., 1] + a * jnp.sin(w * t)], axis=-1)


def osc_torch(params, t, y, aux=None):
    k, c, a, w = (params[..., i] for i in range(4))
    return torch.stack([y[..., 1], -k * y[..., 0] - c * y[..., 1] + a * torch.sin(w * t)], dim=-1)


def test_ode45_matches_jax_with_rejected_steps():
    """Three oscillator lanes over [0, 3] at RelTol 1e-6 against the JAX
    package's make_ode45 run on each lane (vmapped), at 1e-12; the port's
    counts show rejected steps."""
    y0 = np.array([[1.0, 0.0], [0.0, 2.0], [0.3, -1.0]])
    integ = jex.make_ode45(osc_jax, rtol=1e-6, atol=1e-8)
    ref = jax.jit(jax.vmap(lambda p, y: integ(p, y, 0.0, 3.0)))(jnp.asarray(OSC), jnp.asarray(y0))
    got = tex.make_ode45(osc_torch, rtol=1e-6, atol=1e-8)(
        torch.tensor(OSC), torch.tensor(y0), 0.0, 3.0)
    close(got, ref, 1e-12, "y1")
    st = tex.ode45_stats
    rejected = st["steps"] - st["accepted"]
    assert int(rejected.sum()) > 0 and int(st["accepted"].min()) > 10
    assert st["iterations"] >= int(st["steps"].max())


def test_ode45_lanes_bit_for_bit():
    """A lane of a batched run takes the steps of a run of it alone."""
    y0 = torch.tensor([[1.0, 0.0], [0.0, 2.0], [0.3, -1.0]])
    integ = tex.make_ode45(osc_torch, rtol=1e-5, atol=1e-7)
    batch = integ(torch.tensor(OSC), y0, 0.0, 2.0)
    steps = tex.ode45_stats["steps"].clone()
    assert len(set(steps.tolist())) == 3
    for i in range(3):
        one = integ(torch.tensor(OSC[i:i + 1]), y0[i:i + 1], 0.0, 2.0)
        assert torch.equal(one, batch[i:i + 1]) and int(tex.ode45_stats["steps"][0]) == steps[i]


@pytest.mark.parametrize("method", ["dense", "recursive"])
def test_scene_lanes_bit_for_bit(method):
    """Mscene 25 (composite body): three lanes with their own qdot0 through
    simulate_ode45 against each lane alone, bit for bit."""
    sc = tms.build_mscene(25, device="cpu")
    rng = np.random.default_rng(3)
    s0 = sc.initial_state("euler", B=3)
    s0.qdot[1:] += 1e-2 * torch.tensor(rng.normal(size=(2, sc.topo.nr)))
    fin = tex.simulate_ode45(sc, method, state0=s0)
    for i in range(3):
        one = tex.simulate_ode45(sc, method, state0=State(q=s0.q[i:i + 1], qdot=s0.qdot[i:i + 1]))
        assert torch.equal(one.q, fin.q[i:i + 1]) and torch.equal(one.qdot, fin.qdot[i:i + 1])


def test_inequality_branch_matches_jax():
    """Mscene 6 with joint 2 past its upper limit: the dense derivative's
    PGS branch (200 sweeps) against the JAX package's at 1e-10 of scale,
    and with the limit inactive (its row masked)."""
    js, ts = jms.build_mscene(6), tms.build_mscene(6, device="cpu")
    dj = jax.jit(lambda y: jex.make_deriv_dense(js.topo, js.force_fns, js.constraint_fns)(
        js.params, 0.0, y))
    dt = tex.make_deriv_dense(ts.topo, ts.force_fns, ts.constraint_fns)
    for q1, v in ((1.0, (0.3, 2.0)), (0.2, (0.3, -0.4))):
        y = np.array([0.1, q1, *v])
        got = dt(ts.params, torch.zeros(1, dtype=torch.float64), torch.tensor(y)[None])
        close(got[0], dj(jnp.asarray(y)), 1e-10, f"q1 = {q1}")
        rows = tex.constraint_rates(ts.topo, ts.params, ts.constraint_fns,
                                    torch.tensor(y[None, :2]), torch.tensor(y[None, 2:]))[0]
        assert bool(rows["act"].all()) == (q1 == 1.0)


def test_scene5_time_varying_torques():
    """sceneFcn05's torque schedule, per lane t, through ode45 (dense)."""
    sc = tms.build_mscene(5, device="cpu")
    s0 = sc.initial_state("euler")
    _, V0 = sc.energies(s0.q, s0.qdot)
    fin = tex.simulate_ode45(sc, "dense", scene_fn=tms.scene_fn_05)
    T, V = sc.energies(fin.q, fin.qdot)
    H = float(T[0] + V[0] - V0[0])
    assert abs(H - 160.820781710469) <= 1e-2, H
