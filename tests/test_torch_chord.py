"""Parity of the chord kernel's plain version (chord_kernel.chord_bdf2_reference,
which the wrapper runs for CPU tensors) and of the kernel route's custom
backward with redmax_tpu.

  * f32: against pallas_step.chord_bdf2_dense(xp=np), the JAX package's numpy
    evaluation of the Pallas kernel body, at the tolerances of
    tests/test_pallas_step.py (x 5e-6 abs, Hinv 2e-5 of scale);
  * f64: against the vmapped JAX newton chord solve, to 1e-9;
  * a diverging lane (qdot = 1e6) is poisoned in both rollouts;
  * the "reuse" backward's cotangents of tau, q0, qd0, q1, qd1 match JAX's
    _pbwd computation to 2e-4 of scale in f32;
  * the same with penalty ground contact (chain-ground scenes, states with
    corners out of contact, in static and in dynamic friction): the plain
    version against chord_bdf2_dense(force_fns=...) and JAX newton, an 8-step
    rollout through impact against the vmapped JAX fallback, and the kernel
    route's backward on the ground scene;
  * the same with springs (a point-point spring and a world spring-damper)
    and with a cable: the plain version against chord_bdf2_dense and JAX
    newton;
  * the wrapper's packing: a buffer whose closure counts do not match its
    contents is refused before any launch.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from redmax_tpu import integrators as jint
from redmax_tpu import pallas_step
from redmax_tpu import scene as jscene
from redmax_tpu.scenes import scene_chain as jchain
from redmax_tpu.scenes import scene_chain_ground as jground
from redmax_tpu.types import JointType as JJT
from redmax_tpu.types import State as JState
from redmax_tpu_torch import chord_kernel, convert, forces, metrics
from redmax_tpu_torch import integrators as tint
from redmax_tpu_torch import model as tmodel
from redmax_tpu_torch.types import State
from test_torch_model import mixed_builder
from test_torch_springs import jax_scene


@pytest.fixture(scope="module", autouse=True)
def single_thread():
    """torch's intra-op threads set to 1 for the module, then restored."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CFG_KW = dict(fixed_iters=3, predictor="quadratic", chord=True,
              hessian="structured", linsolve="gj")
JCFG = jint.NewtonConfig(**CFG_KW)
TCFG = tint.NewtonConfig(**CFG_KW)
# the contact-MPC workload's coefficients (benchmarks/bench_contact.py)
BENCH_GROUND = dict(kn=100.0, kt=0.1, kd=10.0, mu=0.5, h=1e-2, floor_z=-0.06)


def chord_launches():
    """(thread-per-lane, cooperative) chord kernel launches so far."""
    c = metrics.counters()
    return c.get("chord_kernel.launch.thread", 0), c.get("chord_kernel.launch.coop", 0)


def _port(sc, dtype):
    topo = convert.topology_from_fields(**dataclasses.asdict(sc.topo))
    params = convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, sc.params), "cpu", dtype)
    return topo, params


def _port_forces(sc):
    return convert.forces_from_fields([(type(f).__name__, vars(f)) for f in sc.force_fns])

def contact_states(nr, B, seed=1):
    """Chord-solve inputs of a chain lying near its floor: small joint angles
    (corners a few hundredths above and below the floor), joint speeds that
    slide some corners (dynamic friction) and leave others sticking."""
    rng = np.random.default_rng(seed)
    q1 = (0.01 * rng.normal(size=(B, nr))).astype(np.float32)
    qd1 = (rng.normal(size=(B, nr)) * rng.choice([0.002, 0.3], size=(B, 1))).astype(np.float32)
    q0 = q1 - np.float32(0.01) * qd1
    qd0 = qd1 + (0.01 * rng.normal(size=(B, nr))).astype(np.float32)
    x0 = q1 + np.float32(0.01) * qd1
    tau = (0.3 * rng.normal(size=(B, nr))).astype(np.float32)
    return (x0, q0, qd0, q1, qd1), tau


def corner_regimes(topo, params, fns, q, qdot):
    """(out of contact, static, dynamic) corner counts at (q, qdot)."""
    q, qdot = torch.as_tensor(q).double(), torch.as_tensor(qdot).double()
    p64 = jax.tree_util.tree_map(lambda a: a.double(), params)
    kin = tmodel.forward_kinematics(topo, p64, q, qdot)
    _, _, phi = tmodel.jacobians(topo, p64, kin, qdot)
    idx = forces.body_index(tuple(fn.body for fn in fns), q.device)
    s = forces.corner_state(kin.E_wi[:, idx], phi[:, idx],
                             forces.stack_contact_params(fns, p64))
    return (int((s["active"] == 0).sum()), int((s["sta"] > 0).sum()), int((s["dyn"] > 0).sum()))


def _rand_states(nr, B, seed=1):
    """The states of tests/test_pallas_step.py::_rand_states, in numpy f32."""
    rng = np.random.default_rng(seed)
    q1 = (0.3 * rng.normal(size=(B, nr))).astype(np.float32)
    qd1 = rng.normal(size=(B, nr)).astype(np.float32)
    q0 = q1 - np.float32(0.01) * qd1
    qd0 = qd1 + (0.05 * rng.normal(size=(B, nr))).astype(np.float32)
    x0 = q1 + np.float32(0.01) * qd1
    return x0, q0, qd0, q1, qd1


@pytest.mark.parametrize("scene", ["chain4", "mixed"])
def test_reference_matches_kernel_body_f32(scene):
    """scene_chain(4), and a scene with every constant-S joint type, a
    penalty limit and body damping."""
    build = {"chain4": lambda: jchain(nlinks=4), "mixed": lambda: mixed_builder(jscene, JJT)}
    sc = build[scene]().compile(dtype=jnp.float32)
    topo, params = _port(sc, torch.float32)
    states = _rand_states(sc.topo.nr, 8)
    x_np, hinv_np = pallas_step.chord_bdf2_dense(sc.topo, JCFG, sc.params, *states, xp=np)
    x, hinv = chord_kernel.chord_bdf2(topo, TCFG, params, *(torch.tensor(a) for a in states))
    assert np.isfinite(x_np).all()
    np.testing.assert_allclose(x.numpy(), x_np, rtol=0, atol=5e-6)
    scale = float(np.abs(hinv_np).max())
    np.testing.assert_allclose(hinv.numpy(), hinv_np, rtol=0, atol=2e-5 * scale)


def test_reference_matches_newton_f64():
    sc = jchain(nlinks=4).compile()
    topo, params = _port(sc, torch.float64)
    states = [a.astype(np.float64) for a in _rand_states(sc.topo.nr, 8)]
    hess = jint._hess_bdf2(sc.topo, ())

    def one(x0, q0, qd0, q1, qd1):
        theta = (sc.params, q0, qd0, q1, qd1, {})
        res = lambda x: jint.residual_bdf2(sc.topo, (), sc.params, x, q0, qd0, q1, qd1, {})
        x, info = jint.newton(res, x0, JCFG, jac_fn=lambda x: hess(theta, x))
        return x, info["factor"]

    x_ref, hinv_ref = jax.jit(jax.vmap(one))(*(jnp.asarray(a) for a in states))
    x, hinv = chord_kernel.chord_bdf2_reference(topo, TCFG, params, *(torch.tensor(a) for a in states))
    np.testing.assert_allclose(x.numpy(), np.asarray(x_ref), rtol=0, atol=1e-9)
    scale = float(np.abs(np.asarray(hinv_ref)).max())
    np.testing.assert_allclose(hinv.numpy(), np.asarray(hinv_ref), rtol=0, atol=1e-9 * scale)


def test_wrapper_on_cpu_runs_the_plain_version():
    """A CPU tensor runs the plain version and never counts a launch; a
    tensor on another device raises instead of falling back."""
    sc = jchain(nlinks=4).compile(dtype=jnp.float32)
    topo, params = _port(sc, torch.float32)
    states = [torch.tensor(a) for a in _rand_states(sc.topo.nr, 4)]
    before = chord_launches()
    x, _ = chord_kernel.chord_bdf2(topo, TCFG, params, *states)
    assert chord_launches() == before
    x_ref, _ = chord_kernel.chord_bdf2_reference(topo, TCFG, params, *states)
    assert torch.equal(x, x_ref)
    with pytest.raises(ValueError):
        chord_kernel.chord_bdf2(topo, TCFG, params, *(s.to("meta") for s in states))


def test_divergence_poisoning_matches():
    """A lane driven to divergence (absurd initial velocity) is NaN-poisoned
    by the port's kernel route (plain version on the CPU) exactly as by the
    JAX vmap fallback (tests/test_pallas_step.py::test_divergence_poisoning_matches)."""
    sc = jchain(nlinks=3).compile(dtype=jnp.float32)
    topo, params = _port(sc, torch.float32)
    B, nsteps = 4, 6
    rng = np.random.default_rng(2)
    qd = rng.normal(size=(B, sc.topo.nr))
    qd[0] = 1e6
    q = 0.3 * rng.normal(size=(B, sc.topo.nr))
    step = jint.make_bdf2_step_batched(sc.topo, (), JCFG, use_pallas=False)
    s0 = JState(q=jnp.asarray(q, jnp.float32), qdot=jnp.asarray(qd, jnp.float32), aux={})
    ref = jax.jit(jint.make_simulate(step, nsteps))(sc.params, jint.bdf2_init(s0))
    mask_ref = np.all(np.isfinite(np.asarray(ref.q)), axis=-1)
    assert not mask_ref[0] and mask_ref[1:].all(), mask_ref

    tstep = tint.make_bdf2_step_batched(topo, (), TCFG)
    t0 = State(q=torch.tensor(q, dtype=torch.float32), qdot=torch.tensor(qd, dtype=torch.float32))
    out = tint.make_simulate(tstep, nsteps)(params, tint.bdf2_init(t0))
    np.testing.assert_array_equal(torch.isfinite(out.q).all(-1).numpy(), mask_ref)
    np.testing.assert_allclose(out.q[1:].numpy(), np.asarray(ref.q)[1:], rtol=0, atol=5e-5)


def test_kernel_route_backward_matches_jax():
    """The kernel route's autograd.Function (forward: chord solve; backward:
    z = Hinv^T xbar, then the VJP of the op-level residual at the detached
    x*) gives JAX's _pbwd cotangents (tests/test_pallas_step.py
    ::test_custom_vjp_backward_matches_fallback)."""
    sc = jchain(nlinks=3).compile(dtype=jnp.float32)
    topo, params = _port(sc, torch.float32)
    B, nr = 4, sc.topo.nr
    states = _rand_states(nr, B, seed=5)
    rng = np.random.default_rng(9)
    tau = (0.1 * rng.normal(size=(B, nr))).astype(np.float32)
    xbar = rng.normal(size=(B, nr)).astype(np.float32)
    _, q0, qd0, q1, qd1 = states

    # JAX: numpy-oracle forward, z = H^-T xbar, one VJP of the batched residual.
    h = float(np.asarray(sc.params["h"]))
    guess = q1 + h * qd1 + 0.5 * h * (qd1 - qd0)
    xstar, hinv = pallas_step.chord_bdf2_dense(
        sc.topo, JCFG, {**sc.params, "tau": jnp.asarray(tau)}, guess, q0, qd0, q1, qd1, xp=np)
    z = jnp.einsum("bsr,bs->br", jnp.asarray(hinv), jnp.asarray(xbar))

    def res_b(tau_b, a, b, c, d):
        def one(ti, a, b, c, d, xi):
            return jint.residual_bdf2(sc.topo, (), {**sc.params, "tau": ti}, xi, a, b, c, d, {})
        return jax.vmap(one)(tau_b, a, b, c, d, jnp.asarray(xstar))

    cots_ref = jax.jit(lambda z, *a: jax.vjp(res_b, *a)[1](-z))(
        z, *(jnp.asarray(a) for a in (tau, q0, qd0, q1, qd1)))

    # Port: the kernel route's inner step, differentiated by autograd.
    step = tint.make_bdf2_step_batched(topo, (), TCFG, differentiable=True, use_kernel=True)
    leaves = [torch.tensor(a, requires_grad=True) for a in (tau, q0, qd0, q1, qd1)]
    s = tint.Bdf2State(q=leaves[3], qdot=leaves[4], q_prev=leaves[1], qdot_prev=leaves[2], k=1)
    out = step.inner({**params, "tau": leaves[0]}, s)
    np.testing.assert_allclose(out.q.detach().numpy(), xstar, rtol=0, atol=5e-6)
    grads = torch.autograd.grad(out.q, leaves, grad_outputs=torch.tensor(xbar))
    for name, g, r in zip(["tau", "q0", "qd0", "q1", "qd1"], grads, cots_ref):
        r = np.asarray(r, np.float64)
        scale = max(np.abs(r).max(), 1e-9)
        np.testing.assert_allclose(g.numpy().astype(np.float64), r, rtol=0, atol=2e-4 * scale,
                                   err_msg=name)


@pytest.mark.parametrize("nlinks,mu", [(4, 0.5), (4, 0.0)])
def test_reference_with_contacts_matches_kernel_body_f32(nlinks, mu):
    sc = jground(nlinks=nlinks, **{**BENCH_GROUND, "mu": mu}).compile(dtype=jnp.float32)
    topo, params = _port(sc, torch.float32)
    fns = _port_forces(sc)
    states, tau = contact_states(sc.topo.nr, 16)
    qd_pred = 150.0 * (states[0] - (4 / 3) * states[3] + (1 / 3) * states[1])
    out, sta, dyn = corner_regimes(topo, params, fns, states[0], qd_pred)
    assert out > 0 and (sta > 0 and dyn > 0 if mu else sta == dyn == 0), (out, sta, dyn)
    x_np, hinv_np = pallas_step.chord_bdf2_dense(
        sc.topo, JCFG, {**sc.params, "tau": jnp.asarray(tau)}, *states, xp=np,
        force_fns=sc.force_fns)
    x, hinv = chord_kernel.chord_bdf2(topo, TCFG, {**params, "tau": torch.tensor(tau)},
                                      *(torch.tensor(a) for a in states), fns)
    finite = np.isfinite(x_np).all(-1)
    assert finite.mean() >= 0.75, finite
    np.testing.assert_array_equal(torch.isfinite(x).all(-1).numpy(), finite)
    np.testing.assert_allclose(x.numpy()[finite], x_np[finite], rtol=0, atol=5e-6)
    scale = float(np.abs(hinv_np[finite]).max())
    np.testing.assert_allclose(hinv.numpy()[finite], hinv_np[finite], rtol=0, atol=2e-5 * scale)


def test_reference_with_contacts_matches_newton_f64():
    sc = jground(nlinks=4, **BENCH_GROUND).compile()
    topo, params = _port(sc, torch.float64)
    fns = _port_forces(sc)
    states, tau = contact_states(sc.topo.nr, 8)
    states = [a.astype(np.float64) for a in states]
    hess = jint._hess_bdf2(sc.topo, sc.force_fns)

    def one(ti, x0, q0, qd0, q1, qd1):
        p = {**sc.params, "tau": ti}
        theta = (p, q0, qd0, q1, qd1, {})
        res = lambda x: jint.residual_bdf2(sc.topo, sc.force_fns, p, x, q0, qd0, q1, qd1, {})
        x, info = jint.newton(res, x0, JCFG, jac_fn=lambda x: hess(theta, x))
        return x, info["factor"]

    x_ref, hinv_ref = jax.jit(jax.vmap(one))(jnp.asarray(tau, jnp.float64),
                                             *(jnp.asarray(a) for a in states))
    x, hinv = chord_kernel.chord_bdf2_reference(
        topo, TCFG, {**params, "tau": torch.tensor(tau, dtype=torch.float64)},
        *(torch.tensor(a) for a in states), fns)
    finite = np.isfinite(np.asarray(x_ref)).all(-1)
    assert finite.mean() >= 0.75
    np.testing.assert_array_equal(torch.isfinite(x).all(-1).numpy(), finite)
    np.testing.assert_allclose(x.numpy()[finite], np.asarray(x_ref)[finite], rtol=0, atol=1e-9)
    scale = float(np.abs(np.asarray(hinv_ref)[finite]).max())
    np.testing.assert_allclose(hinv.numpy()[finite], np.asarray(hinv_ref)[finite], rtol=0,
                               atol=1e-9 * scale)


def test_contact_rollout_matches_jax():
    """A chain dropped onto the floor, 8 steps through impact in f32: the
    port's kernel route (plain version on the CPU) against the vmapped JAX
    fallback, on the configuration of
    tests/test_pallas_step.py::test_contact_rollout_matches_vmap_fallback."""
    sc = jground(nlinks=3, floor_z=-0.02, kn=300.0, kt=20.0, kd=5.0, mu=0.5).compile(
        dtype=jnp.float32)
    topo, params = _port(sc, torch.float32)
    fns = _port_forces(sc)
    B, nsteps = 4, 8
    rng = np.random.default_rng(4)
    q = (0.1 * rng.normal(size=(B, sc.topo.nr))).astype(np.float32)
    qd = (0.3 * rng.normal(size=(B, sc.topo.nr))).astype(np.float32)
    step = jint.make_bdf2_step_batched(sc.topo, sc.force_fns, JCFG, use_pallas=False)
    s0 = JState(q=jnp.asarray(q), qdot=jnp.asarray(qd), aux={})
    ref = jax.jit(jint.make_simulate(step, nsteps))(sc.params, jint.bdf2_init(s0))
    assert bool(jnp.all(jnp.isfinite(ref.q)))

    tstep = tint.make_bdf2_step_batched(topo, fns, TCFG, use_kernel=True)
    out = tint.make_simulate(tstep, nsteps)(
        params, tint.bdf2_init(State(q=torch.tensor(q), qdot=torch.tensor(qd))))
    np.testing.assert_allclose(out.q.numpy(), np.asarray(ref.q), rtol=0, atol=1e-4)
    np.testing.assert_allclose(out.qdot.numpy(), np.asarray(ref.qdot), rtol=0, atol=2e-2)
    free = tint.make_simulate(tint.make_bdf2_step_batched(topo, (), TCFG), nsteps)(
        params, tint.bdf2_init(State(q=torch.tensor(q), qdot=torch.tensor(qd))))
    assert float((free.q - out.q).abs().max()) > 1e-2   # the floor was struck


def test_contact_kernel_route_backward_matches_jax():
    """Differentiable contact: the kernel route's backward on the ground scene
    (z = Hinv^T xbar, then autograd's VJP of the op-level residual with the
    contact force) against JAX's cotangents
    (tests/test_pallas_step.py::test_contact_vjp_matches_fallback)."""
    sc = jground(nlinks=3, floor_z=-0.02, kn=1e3, kt=50.0, kd=10.0, mu=0.5).compile(
        dtype=jnp.float32)
    topo, params = _port(sc, torch.float32)
    fns = _port_forces(sc)
    B, nr = 4, sc.topo.nr
    _, q0, qd0, q1, qd1 = _rand_states(nr, B, seed=11)
    rng = np.random.default_rng(13)
    tau = (0.1 * rng.normal(size=(B, nr))).astype(np.float32)
    xbar = rng.normal(size=(B, nr)).astype(np.float32)

    h = float(np.asarray(sc.params["h"]))
    guess = q1 + h * qd1 + 0.5 * h * (qd1 - qd0)
    xstar, hinv = pallas_step.chord_bdf2_dense(
        sc.topo, JCFG, {**sc.params, "tau": jnp.asarray(tau)}, guess, q0, qd0, q1, qd1, xp=np,
        force_fns=sc.force_fns)
    assert np.isfinite(xstar).all()
    z = jnp.einsum("bsr,bs->br", jnp.asarray(hinv), jnp.asarray(xbar))

    def res_b(tau_b, a, b, c, d):
        def one(ti, a, b, c, d, xi):
            return jint.residual_bdf2(sc.topo, sc.force_fns, {**sc.params, "tau": ti},
                                      xi, a, b, c, d, {})
        return jax.vmap(one)(tau_b, a, b, c, d, jnp.asarray(xstar))

    cots_ref = jax.jit(lambda z, *a: jax.vjp(res_b, *a)[1](-z))(
        z, *(jnp.asarray(a) for a in (tau, q0, qd0, q1, qd1)))

    step = tint.make_bdf2_step_batched(topo, fns, TCFG, differentiable=True, use_kernel=True)
    leaves = [torch.tensor(a, requires_grad=True) for a in (tau, q0, qd0, q1, qd1)]
    s = tint.Bdf2State(q=leaves[3], qdot=leaves[4], q_prev=leaves[1], qdot_prev=leaves[2], k=1)
    out = step.inner({**params, "tau": leaves[0]}, s)
    np.testing.assert_allclose(out.q.detach().numpy(), xstar, rtol=0, atol=1e-5)
    grads = torch.autograd.grad(out.q, leaves, grad_outputs=torch.tensor(xbar))
    for name, g, r in zip(["tau", "q0", "qd0", "q1", "qd1"], grads, cots_ref):
        r = np.asarray(r, np.float64)
        scale = max(np.abs(r).max(), 1e-9)
        np.testing.assert_allclose(g.numpy().astype(np.float64), r, rtol=0, atol=5e-4 * scale,
                                   err_msg=name)


def test_kernel_route_refuses_what_the_kernel_does_not_cover():
    """supports() takes ground contacts, springs and cables and nothing else.
    Per-lane contact or spring coefficients (which once raised) are split
    out as per lane and pick the PERLANE build, whose fixed library holds
    the shapes the paths run (another shape gets a build made for it)."""
    tc_free = jchain(nlinks=4).compile(dtype=jnp.float32)
    topo, params = _port(tc_free, torch.float32)
    gnd = forces.ForceGroundCuboid("f0", 1)
    spr = forces.ForceSpringDamper("f1", -1, 3, tension_only=True)
    assert chord_kernel.supports(topo, (), TCFG) and chord_kernel.supports(topo, (gnd,), TCFG)
    assert chord_kernel.supports(topo, (spr, forces.ForceCable("f2", (0, 3))), TCFG)
    assert not chord_kernel.supports(topo, (gnd, object()), TCFG)
    _, lane = tint.split_batched_params({**params, "forces": {"f1": {"k": torch.ones(3)}}})
    assert set(lane["forces"]["f1"]) == {"k"}
    with pytest.raises(ValueError):
        tint.make_bdf2_step_batched(topo, (object(),), TCFG, use_kernel=True)
    sc = jground(nlinks=4, **BENCH_GROUND).compile(dtype=jnp.float32)
    topo, params = _port(sc, torch.float32)
    lane = {**params["forces"]["f0"], "kn": torch.full((3,), 100.0)}
    perlane = {**params, "forces": {**params["forces"], "f0": lane}}
    assert chord_kernel.has_perlane(perlane) and not chord_kernel.has_perlane(params)
    counts = chord_kernel.counts_of(chord_kernel.closure_spec(topo, _port_forces(sc)))
    kinds = chord_kernel.kinds_of(topo, counts, perlane=True)
    assert kinds == chord_kernel.CONTACTS | chord_kernel.PERLANE
    assert chord_kernel.build_of(kinds) is chord_kernel.BUILD_PERLANE
    assert (4, 4, kinds) not in chord_kernel.INSTANTIATED
    assert (12, 12, kinds) in chord_kernel.INSTANTIATED


PAIR_SCENES = {"springs": "spring3", "cable": "cable3"}


@pytest.mark.parametrize("scene", list(PAIR_SCENES))
def test_reference_with_springs_matches_kernel_body_f32(scene):
    sc = jax_scene(PAIR_SCENES[scene], f32=True)
    topo, params = _port(sc, torch.float32)
    fns = _port_forces(sc)
    states = _rand_states(sc.topo.nr, 8)
    x_np, hinv_np = pallas_step.chord_bdf2_dense(sc.topo, JCFG, sc.params, *states, xp=np,
                                                 force_fns=sc.force_fns)
    x, hinv = chord_kernel.chord_bdf2(topo, TCFG, params, *(torch.tensor(a) for a in states), fns)
    assert np.isfinite(x_np).all()
    np.testing.assert_allclose(x.numpy(), x_np, rtol=0, atol=5e-6)
    scale = float(np.abs(hinv_np).max())
    np.testing.assert_allclose(hinv.numpy(), hinv_np, rtol=0, atol=2e-5 * scale)
    x0, _ = chord_kernel.chord_bdf2(topo, TCFG, params, *(torch.tensor(a) for a in states))
    assert float((x0 - x).abs().max()) > 1e-4   # the closures act


@pytest.mark.parametrize("scene", list(PAIR_SCENES))
def test_reference_with_springs_matches_newton_f64(scene):
    sc = jax_scene(PAIR_SCENES[scene])
    topo, params = _port(sc, torch.float64)
    fns = _port_forces(sc)
    states = [a.astype(np.float64) for a in _rand_states(sc.topo.nr, 8)]
    hess = jint._hess_bdf2(sc.topo, sc.force_fns)

    def one(x0, q0, qd0, q1, qd1):
        theta = (sc.params, q0, qd0, q1, qd1, {})
        res = lambda x: jint.residual_bdf2(sc.topo, sc.force_fns, sc.params, x, q0, qd0, q1, qd1,
                                           {})
        x, info = jint.newton(res, x0, JCFG, jac_fn=lambda x: hess(theta, x))
        return x, info["factor"]

    x_ref, hinv_ref = jax.jit(jax.vmap(one))(*(jnp.asarray(a) for a in states))
    x, hinv = chord_kernel.chord_bdf2_reference(topo, TCFG, params,
                                                *(torch.tensor(a) for a in states), fns)
    assert np.isfinite(np.asarray(x_ref)).all()
    np.testing.assert_allclose(x.numpy(), np.asarray(x_ref), rtol=0, atol=1e-9)
    scale = float(np.abs(np.asarray(hinv_ref)).max())
    np.testing.assert_allclose(hinv.numpy(), np.asarray(hinv_ref), rtol=0, atol=1e-9 * scale)


def test_check_buffers_rejects_mismatched_counts():
    """launch checks both packed buffers against the closure counts before it
    builds or launches anything: the counts of another scene, or a buffer one
    entry short, raise on CPU tensors."""
    sc = jground(nlinks=4, **BENCH_GROUND).compile(dtype=jnp.float32)
    topo, params = _port(sc, torch.float32)
    fns = _port_forces(sc)
    states = [torch.tensor(a) for a in _rand_states(sc.topo.nr, 4)]
    *_, topo_i, stat_f, counts, lane_f = chord_kernel.pack(topo, params, *states, fns)
    assert lane_f is None
    assert counts == chord_kernel.Closures(contacts=4, springs=0, cables=0, cable_points=0)
    chord_kernel.check_buffers(topo, topo_i, stat_f, counts)
    for bad in (counts._replace(contacts=3), counts._replace(springs=1),
                counts._replace(cables=1, cable_points=2)):
        with pytest.raises(ValueError, match="do not hold"):
            chord_kernel.check_buffers(topo, topo_i, stat_f, bad)
    with pytest.raises(ValueError, match="do not hold"):
        chord_kernel.check_buffers(topo, topo_i, stat_f[:-1], counts)
    with pytest.raises(ValueError, match="do not hold"):
        chord_kernel.launch(topo, TCFG, *states, states[0], topo_i[:-1], stat_f, counts)
    # the counts travel in topo_i too, where the kernel reads them
    N, nr = topo.njoints, topo.nr
    head = 3 * N + 1 + nr + N * N
    assert topo_i[head:head + 4].tolist() == list(counts)
    # per-lane kn: a [7N + 4 + 13C, B] record buffer, held to the counts too
    fp = params["forces"]["f0"]
    perlane = {**params, "forces": {**params["forces"], "f0": {**fp, "kn": fp["kn"].expand(4)}}}
    *_, lane_f = chord_kernel.pack(topo, perlane, *states, fns)
    assert lane_f.shape == (7 * N + 4 + 13 * 4, 4)
    chord_kernel.check_buffers(topo, topo_i, stat_f, counts, lane_f)
    with pytest.raises(ValueError, match="does not hold"):
        chord_kernel.check_buffers(topo, topo_i, stat_f, counts, lane_f[:-1])


def test_robust_configs_pick_the_robust_build():
    """supports() takes what the JAX package's kernel route takes: any
    fixed-iteration config with the structured matrix and GJ, guarded,
    guard_last and chord=False included. Those modes add the ROBUST bit and
    pick the fourth library, instantiated at (12, 12) with and without
    contacts; unguarded chord never picks it. On the CPU the wrapper runs the
    plain version in the same mode."""
    sc = jground(nlinks=4, **BENCH_GROUND).compile(dtype=jnp.float32)
    topo, params = _port(sc, torch.float32)
    fns = _port_forces(sc)
    counts = chord_kernel.counts_of(chord_kernel.closure_spec(topo, fns))
    for mode in (dict(guarded=True), dict(guard_last=True), dict(chord=False),
                 dict(guarded=True, chord=False)):
        cfg = tint.NewtonConfig(**{**CFG_KW, **mode})
        assert chord_kernel.supports(topo, fns, cfg) and chord_kernel.is_robust(cfg)
        kinds = chord_kernel.kinds_of(topo, counts, robust=chord_kernel.is_robust(cfg))
        assert kinds == chord_kernel.CONTACTS | chord_kernel.ROBUST
        assert chord_kernel.build_of(kinds) is chord_kernel.BUILD_ROBUST
    assert not chord_kernel.is_robust(TCFG)
    assert chord_kernel.build_of(chord_kernel.kinds_of(topo, counts)) is chord_kernel.BUILD
    for bad in (dict(fixed_iters=0), dict(linsolve="lu"), dict(hessian="exact")):
        assert not chord_kernel.supports(topo, fns, tint.NewtonConfig(**{**CFG_KW, **bad}))
    assert {(12, 12, chord_kernel.ROBUST), (12, 12, chord_kernel.CONTACTS | chord_kernel.ROBUST)} \
        <= set(chord_kernel.INSTANTIATED)
    assert (4, 4, chord_kernel.CONTACTS | chord_kernel.ROBUST) not in chord_kernel.INSTANTIATED

    cfg = tint.NewtonConfig(**{**CFG_KW, "guarded": True})
    states, tau = contact_states(topo.nr, 4)
    args = (topo, cfg, {**params, "tau": torch.tensor(tau)}, *(torch.tensor(a) for a in states))
    x, hinv = chord_kernel.chord_bdf2(*args, fns)
    x_ref, hinv_ref = chord_kernel.chord_bdf2_reference(*args, fns)
    assert torch.equal(x, x_ref) and torch.equal(hinv, hinv_ref)
    with pytest.raises(ValueError):
        chord_kernel.chord_bdf2(topo, tint.NewtonConfig(**{**CFG_KW, "guard_last": True,
                                                            "chord": False}),
                                *args[2:], fns)
