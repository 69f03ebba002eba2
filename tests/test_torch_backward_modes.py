"""The port's adjoint backward modes against redmax_tpu's, in float64 on the
CPU:

  * op-level make_bdf2_step(differentiable=True) through implicit_solve (the
    backward builds H at the solution): adjoint_reuse_factor=False with the
    structured and the exact matrix, the GJ and the LU solver, on chain-3:
    torch.autograd.grad of sum(q^2) after two inner steps in the per-lane
    torques and the velocities, against jax.grad of the same through JAX's
    make_bdf2_step_batched (the vmapped op-level route), at 1e-8 of scale
    (the default NewtonConfig(), the bootstrap and the ground scene are in
    tests/test_torch_reference_adjoint.py);
  * the kernel route (the plain version on the CPU) with backward="refresh"
    and "exact": one inner step's cotangents of tau against the manual IFT
    reference of tests/test_pallas_step.py::test_backward_escape_hatch (x*
    from JAX's newton, H at x*, z = H^-T xbar, -z^T dg/dtau) at 1e-8;
  * the ValueErrors: an unknown backward, and a mode other than "reuse" on
    the op-level route.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from redmax_tpu import integrators as jint
from redmax_tpu.scenes import scene_chain as jchain
from redmax_tpu.scenes import scene_chain_ground as jground
from redmax_tpu.types import State as JState
from redmax_tpu_torch import convert
from redmax_tpu_torch import integrators as tint
from redmax_tpu_torch.types import State


@pytest.fixture(scope="module", autouse=True)
def single_thread():
    """torch's intra-op threads set to 1 for the module, then restored."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CHORD = dict(fixed_iters=3, predictor="quadratic", chord=True, adjoint_reuse_factor=False)
CONFIGS = {
    "structured_gj": dict(CHORD, hessian="structured", linsolve="gj"),
    "structured_lu": dict(CHORD, hessian="structured", linsolve="lu"),
    "exact_gj": dict(CHORD, hessian="exact", linsolve="gj"),
    "exact_lu": dict(CHORD, hessian="exact", linsolve="lu"),
    "default": dict(),
}
B, NINNER = 3, 2


def scene(name):
    sc = (jchain(nlinks=3) if name == "chain3" else
          jground(nlinks=3, kn=100.0, kt=0.1, kd=10.0, mu=0.5, h=1e-2, floor_z=-0.06)).compile()
    topo = convert.topology_from_fields(**dataclasses.asdict(sc.topo))
    params = convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, sc.params), "cpu")
    fns = convert.forces_from_fields([(type(f).__name__, vars(f)) for f in sc.force_fns])
    return sc, topo, params, fns


def _inputs(sc):
    rng = np.random.default_rng(3)
    nr = sc.topo.nr
    tau = 2.0 * rng.normal(size=(B, nr))
    q = np.tile(np.asarray(sc.state0.q), (B, 1)) + 0.05 * rng.normal(size=(B, nr))
    qd = 0.3 * rng.normal(size=(B, nr))
    return tau, q, qd


def check_gradients(name, kw, bootstrap):
    """grad of sum(q^2) in tau and qdot after the SDIRK2 bootstrap and
    NINNER inner steps from rest (bootstrap=True), or after NINNER inner
    steps from the history (q - 0.01 qdot, qdot; q, qdot): the port's
    autograd against jax.grad through JAX's vmapped op-level route, at 1e-8
    of scale. (The JAX trace of a bootstrap costs about 6 s more.)"""
    sc, topo, params, fns = scene(name)
    tau, q, qd = _inputs(sc)

    jstep = jint.make_bdf2_step_batched(sc.topo, sc.force_fns, jint.NewtonConfig(**kw),
                                        differentiable=True, use_pallas=False)

    def loss(t, v):
        p = {**sc.params, "tau": t}
        qq = jnp.asarray(q)
        if bootstrap:
            s = jstep.bootstrap(p, jint.bdf2_init(JState(q=qq, qdot=v, aux={})))
        else:
            s = jint.Bdf2State(q=qq, qdot=v, q_prev=qq - 0.01 * v, qdot_prev=v,
                               k=jnp.ones((), jnp.int32), aux={})
        s, _ = jax.lax.scan(lambda c, _: (jstep.inner(p, c), None), s, None, length=NINNER)
        return jnp.sum(s.q ** 2)

    g_ref = jax.jit(jax.grad(loss, argnums=(0, 1)))(jnp.asarray(tau), jnp.asarray(qd))

    step = tint.make_bdf2_step(topo, fns, tint.NewtonConfig(**kw), differentiable=True)
    t, v = torch.tensor(tau, requires_grad=True), torch.tensor(qd, requires_grad=True)
    p, qq = {**params, "tau": t}, torch.tensor(q)
    if bootstrap:
        s = step.bootstrap(p, tint.bdf2_init(State(q=qq, qdot=v)))
    else:
        s = tint.Bdf2State(q=qq, qdot=v, q_prev=qq - 0.01 * v, qdot_prev=v, k=1)
    for _ in range(NINNER):
        s = step.inner(p, s)
    assert torch.isfinite(s.q).all()
    grads = torch.autograd.grad((s.q ** 2).sum(), (t, v))
    for what, g, r in zip(("tau", "qdot"), grads, g_ref):
        r = np.asarray(r)
        scale = float(np.abs(r).max())
        np.testing.assert_allclose(g.numpy(), r, rtol=0, atol=1e-8 * scale, err_msg=what)


@pytest.mark.parametrize("config", ["structured_gj", "structured_lu", "exact_gj", "exact_lu"])
def test_implicit_solve_gradients_match_jax(config):
    check_gradients("chain3", CONFIGS[config], bootstrap=False)


@pytest.mark.parametrize("backward", ["refresh", "exact"])
def test_kernel_route_backward_modes_match_manual_ift(backward):
    sc, topo, params, fns = scene("chain3")
    nr = sc.topo.nr
    rng = np.random.default_rng(21)
    q1 = 0.3 * rng.normal(size=(B, nr))
    qd1 = rng.normal(size=(B, nr))
    q0, qd0 = q1 - 0.01 * qd1, qd1 + 0.05 * rng.normal(size=(B, nr))
    tau, xbar = 0.1 * rng.normal(size=(B, nr)), rng.normal(size=(B, nr))
    cfg_kw = dict(fixed_iters=3, predictor="quadratic", chord=True, hessian="structured",
                  linsolve="gj")

    # manual IFT reference: x* from JAX's chord solve, H at x*, z = H^-T xbar,
    # cotangent = -z^T d(res)/d(tau)
    h = float(np.asarray(sc.params["h"]))
    guess = q1 + h * qd1 + 0.5 * h * (qd1 - qd0)
    hessb = jint._hess_bdf2(sc.topo, ())
    jcfg = jint.NewtonConfig(**cfg_kw)

    def one(ti, x0, a, b, c, d, xb):
        p = {**sc.params, "tau": ti}
        res = lambda xx: jint.residual_bdf2(sc.topo, (), p, xx, a, b, c, d, {})
        theta = (p, a, b, c, d, {})
        xs = jint.newton(res, x0, jcfg, jac_fn=lambda xx: hessb(theta, xx))[0]
        H = hessb(theta, xs) if backward == "refresh" else jax.jacfwd(res)(xs)
        z = jnp.linalg.solve(H.T, xb)
        _, vjp = jax.vjp(lambda tt: jint.residual_bdf2(
            sc.topo, (), {**sc.params, "tau": tt}, xs, a, b, c, d, {}), ti)
        return xs, vjp(-z)[0]

    xs_ref, cot_ref = jax.jit(jax.vmap(one))(*(jnp.asarray(a) for a in
                                              (tau, guess, q0, qd0, q1, qd1, xbar)))

    step = tint.make_bdf2_step_batched(topo, (), tint.NewtonConfig(**cfg_kw), differentiable=True,
                                       use_kernel=True, backward=backward)
    t = torch.tensor(tau, requires_grad=True)
    T = [torch.tensor(a) for a in (q0, qd0, q1, qd1)]
    out = step.inner({**params, "tau": t},
                     tint.Bdf2State(q=T[2], qdot=T[3], q_prev=T[0], qdot_prev=T[1], k=1))
    np.testing.assert_allclose(out.q.detach().numpy(), np.asarray(xs_ref), rtol=0, atol=1e-10)
    (cot,) = torch.autograd.grad(out.q, t, grad_outputs=torch.tensor(xbar))
    cot_ref = np.asarray(cot_ref)
    scale = float(np.abs(cot_ref).max())
    np.testing.assert_allclose(cot.numpy(), cot_ref, rtol=0, atol=1e-8 * scale)
    # and the mode matters: "reuse" (the factor at the predictor) differs
    reuse = tint.make_bdf2_step_batched(topo, (), tint.NewtonConfig(**cfg_kw),
                                        differentiable=True, use_kernel=True)
    out_r = reuse.inner({**params, "tau": t},
                        tint.Bdf2State(q=T[2], qdot=T[3], q_prev=T[0], qdot_prev=T[1], k=1))
    (cot_r,) = torch.autograd.grad(out_r.q, t, grad_outputs=torch.tensor(xbar))
    assert float((cot_r - cot).abs().max()) > 1e-6 * scale


def test_backward_mode_errors():
    _, topo, _, _ = scene("chain3")
    cfg = tint.NewtonConfig(fixed_iters=3, chord=True, hessian="structured", linsolve="gj")
    with pytest.raises(ValueError):
        tint.make_bdf2_step_batched(topo, (), cfg, backward="adjoint")
    for mode in ("refresh", "exact"):
        with pytest.raises(ValueError):
            tint.make_bdf2_step_batched(topo, (), cfg, differentiable=True, use_kernel=False,
                                        backward=mode)
        # without gradients the backward is never built: no error
        tint.make_bdf2_step_batched(topo, (), cfg, use_kernel=False, backward=mode)
    with pytest.raises(ValueError):   # the line search has no kernel route
        tint.make_bdf2_step_batched(topo, (), tint.NewtonConfig(), differentiable=True,
                                    backward="exact")
