"""Gradients into every param leaf, on the CPU:

  * float64: torch.autograd.grad of sum(q^2) after 20 BDF2 steps, through
    the op-level route and through the kernel route (its plain version on
    CPU tensors), into each contact's kn and each spring's k
    (params["forces"]), the revolute axes (params["joint"]) and I_i, against
    jax.grad of the same loss through redmax_tpu's
    make_bdf2_step_batched(use_pallas=False), at 1e-8 of scale. The scene is
    scene_chain_ground(3) at the contact-MPC workload's coefficients with the
    3-link spring scene's two springs (a body-body point-point spring, a
    world spring-damper): one JAX trace (about 15 s on a CPU) covers a contact
    leaf and a spring leaf. (The adjoint once passed only the top-level
    params leaves into its autograd.Function; the nested ones got None.)
  * float32: the kernel route's factor-reusing backward into per-lane I_i
    and h against the VJP of JAX's fallback step at 5e-4 of scale (the port
    of tests/test_pallas_step.py::test_perlane_inertia_vjp_matches_fallback).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from redmax_tpu import integrators as jint
from redmax_tpu.scenes import scene_chain as jchain
from redmax_tpu.scenes import scene_chain_ground as jground
from redmax_tpu.types import JointType as JJT
from redmax_tpu.types import State as JState
from redmax_tpu_torch import integrators as tint
from redmax_tpu_torch.types import State
from test_torch_chord import BENCH_GROUND
from test_torch_perlane import JCFG, TCFG, close, port_scene


@pytest.fixture(scope="module", autouse=True)
def single_thread():
    """torch's intra-op threads set to 1 for the module, then restored."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def contact_and_springs():
    """scene_chain_ground(3) at the contact-MPC workload's coefficients plus
    the springs of tests/test_torch_springs.py::spring3."""
    b = jground(nlinks=3, **BENCH_GROUND)
    b.force_point_point(0, 2, xl1=(0.3, 0, 0.05), xl2=(0.2, 0, -0.05), k=70.0, d=4.0)
    b.force_spring_damper(-1, 2, [1.5, 0.5, 2.0], [0.4, 0, 0.0], k=120.0, d=2.0)
    return b


def _grad_leaves(params, force_fns):
    """(path, value) of the leaves the gradient is taken in: each contact's
    kn, each spring's k, the revolute axes (params["joint"]["1"]["axis"]) and
    I_i."""
    out = [(("forces", fn.key, c), params["forces"][fn.key][c])
           for fn in force_fns for c in ("kn", "k") if c in params["forces"][fn.key]]
    return out + [(("joint", str(int(JJT.REVOLUTE)), "axis"),
                   params["joint"][str(int(JJT.REVOLUTE))]["axis"]), (("I_i",), params["I_i"])]


def _with(params, path, v):
    head, *rest = path
    return {**params, head: _with(params[head], rest, v) if rest else v}


def test_nested_param_gradients_match_jax():
    """Gradients into leaves under params["forces"] and params["joint"]
    equal jax.grad of the same rollout loss, on both routes."""
    sc = contact_and_springs().compile()
    assert len(sc.force_fns) == 5
    nsteps, B = 20, 3
    rng = np.random.default_rng(5)
    q0 = np.tile(np.asarray(sc.state0.q), (B, 1))     # at rest, lanes apart by their speed
    qd0 = 0.1 * rng.normal(size=(B, sc.topo.nr))
    tau = np.zeros((B, sc.topo.nr))
    paths, vals = zip(*_grad_leaves(sc.params, sc.force_fns))
    assert len(paths) == 7

    jstep = jint.make_bdf2_step_batched(sc.topo, sc.force_fns, JCFG, differentiable=True,
                                        use_pallas=False)
    jsim = jint.make_simulate(jstep, nsteps)
    s0 = jint.bdf2_init(JState(q=jnp.asarray(q0), qdot=jnp.asarray(qd0), aux={}))

    def jloss(leaves):
        p = {**sc.params, "tau": jnp.asarray(tau)}
        for path, v in zip(paths, leaves):
            p = _with(p, path, v)
        return jnp.sum(jsim(p, s0).q ** 2)

    ref = jax.jit(jax.grad(jloss))(list(vals))

    topo, params, fns = port_scene(sc, jax.tree_util.tree_map(np.asarray, sc.params))
    for use_kernel in (False, True):
        leaves = [torch.tensor(np.asarray(v), requires_grad=True) for v in vals]
        p = {**params, "tau": torch.tensor(tau)}
        for path, v in zip(paths, leaves):
            p = _with(p, path, v)
        step = tint.make_bdf2_step_batched(topo, fns, TCFG, differentiable=True,
                                           use_kernel=use_kernel)
        s = tint.make_simulate(step, nsteps)(
            p, tint.bdf2_init(State(q=torch.tensor(q0), qdot=torch.tensor(qd0))))
        assert torch.isfinite(s.q).all()
        grads = torch.autograd.grad((s.q ** 2).sum(), leaves)
        for path, g, r in zip(paths, grads, ref):
            assert float(np.abs(np.asarray(r)).max()) > 0, path
            close(g, r, 1e-8, f"{'kernel route' if use_kernel else 'op level'} {path}")


def test_perlane_inertia_and_timestep_cotangents_match_jax():
    """float32, scene_chain(3), B = 4: the kernel route's factor-reusing
    backward into per-lane I_i [B, N, 6] and h [B] (the kernel's plain
    version on CPU tensors) against the VJP of JAX's vmapped fallback step,
    at 5e-4 of scale (tests/test_pallas_step.py:886-945)."""
    sc = jchain(nlinks=3).compile(dtype=jnp.float32)
    B, nr = 4, sc.topo.nr
    q1, q0, qd1, qd0 = _chain_states(nr, B)
    rng = np.random.default_rng(44)
    Ii = (np.asarray(sc.params["I_i"])[None] * (1.0 + 0.3 * rng.uniform(size=(B, 1, 1)))
          ).astype(np.float32)
    hB = (float(sc.params["h"]) * (1 + 0.2 * rng.uniform(size=B))).astype(np.float32)
    tau = (0.1 * rng.normal(size=(B, nr))).astype(np.float32)
    xbar = rng.normal(size=(B, nr)).astype(np.float32)

    jstep = jint.make_bdf2_step_batched(sc.topo, (), JCFG, differentiable=True, use_pallas=False)

    def inner_q(Ii_b, h_b):
        s = jint.Bdf2State(q=jnp.asarray(q1), qdot=jnp.asarray(qd1), q_prev=jnp.asarray(q0),
                           qdot_prev=jnp.asarray(qd0), k=jnp.ones((), jnp.int32), aux={})
        return jstep.inner({**sc.params, "tau": jnp.asarray(tau), "I_i": Ii_b, "h": h_b}, s).q

    out_ref, cots_ref = jax.jit(lambda a, b, xb: (lambda o, f: (o, f(xb)))(
        *jax.vjp(inner_q, a, b)))(jnp.asarray(Ii), jnp.asarray(hB), jnp.asarray(xbar))

    topo, params, _ = port_scene(sc, jax.tree_util.tree_map(np.asarray, sc.params), torch.float32)
    leaves = [torch.tensor(Ii, requires_grad=True), torch.tensor(hB, requires_grad=True)]
    step = tint.make_bdf2_step_batched(topo, (), TCFG, differentiable=True, use_kernel=True)
    s = tint.Bdf2State(q=torch.tensor(q1), qdot=torch.tensor(qd1), q_prev=torch.tensor(q0),
                       qdot_prev=torch.tensor(qd0), k=1)
    out = step.inner({**params, "tau": torch.tensor(tau), "I_i": leaves[0], "h": leaves[1]}, s)
    np.testing.assert_allclose(out.q.detach().numpy(), np.asarray(out_ref), rtol=0, atol=5e-6)
    grads = torch.autograd.grad(out.q, leaves, grad_outputs=torch.tensor(xbar))
    for name, g, r in zip(["I_i", "h"], grads, cots_ref):
        close(g, r, 5e-4, name)


def _chain_states(nr, B):
    rng = np.random.default_rng(43)
    q1 = (0.3 * rng.normal(size=(B, nr))).astype(np.float32)
    qd1 = rng.normal(size=(B, nr)).astype(np.float32)
    return q1, q1 - np.float32(0.01) * qd1, qd1, qd1 + (0.05 * rng.normal(size=(B, nr))).astype(
        np.float32)
