"""Parity of redmax_tpu_torch's guarded Newton modes with redmax_tpu's, in
float64 on the CPU: integrators.newton on the BDF2 residual against JAX's
vmapped newton, guarded with chord and with chord=False, guard_last and a
guarded solve with dx_clamp (chain-4), with the structured Newton
matrix and the GJ inverse: x within 1e-10 of scale, the rejection masks
equal. Scenes: chain-4 and the ground scene of tests/test_pallas_step.py
(chain-ground-3, kn 1e3, kt 50, kd 10, mu 0.5, floor -0.02), on the states
of its _rand_states with torques at 30 N(0, 1) on some lanes and 600 N(0, 1)
on the others, where the guard takes full steps, half steps and stays put (a
census of the port's own branches is asserted). The unguarded chord=False
mode, the damped Newton with line search, the exact Newton matrix and the LU
/ pivoted GJ solvers are held in tests/test_torch_newton_unguarded.py. Each
JAX oracle runs under one jax.jit.
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
from redmax_tpu_torch import convert
from redmax_tpu_torch import integrators as tint


@pytest.fixture(scope="module", autouse=True)
def single_thread():
    """torch's intra-op threads set to 1 for the module, then restored."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TAU = (30.0, 600.0)  # each lane's torque scale, drawn from these
BASE = dict(fixed_iters=3, predictor="quadratic", hessian="structured", linsolve="gj")
MODES = {
    "guarded": dict(BASE, guarded=True, chord=True),
    "guarded_rehess": dict(BASE, guarded=True, chord=False),
    "guard_last": dict(BASE, guard_last=True, chord=True),
    "rehess": dict(BASE, chord=False),
    "guarded_clamp": dict(BASE, guarded=True, chord=True, dx_clamp=0.5),
}
_SCENES = {}


def scene(name):
    """(JAX scene, port topology, f64 params, force closures), compiled once
    per module."""
    if name not in _SCENES:
        sc = (jchain(nlinks=4) if name == "chain4" else
              jground(nlinks=3, floor_z=-0.02, kn=1e3, kt=50.0, kd=10.0, mu=0.5)).compile()
        topo = convert.topology_from_fields(**dataclasses.asdict(sc.topo))
        params = convert.params_from_numpy(
            jax.tree_util.tree_map(np.asarray, sc.params), "cpu", torch.float64)
        fns = convert.forces_from_fields([(type(f).__name__, vars(f)) for f in sc.force_fns])
        _SCENES[name] = (sc, topo, params, fns)
    return _SCENES[name]


def rand_states(nr, B, seed=1, scales=TAU):
    """tests/test_pallas_step.py::_rand_states in float64, with torques at
    scales (each lane's drawn from them) times N(0, 1)."""
    rng = np.random.default_rng(seed)
    q1 = 0.3 * rng.normal(size=(B, nr))
    qd1 = rng.normal(size=(B, nr))
    q0 = q1 - 0.01 * qd1
    qd0 = qd1 + 0.05 * rng.normal(size=(B, nr))
    x0 = q1 + 0.01 * qd1
    return (x0, q0, qd0, q1, qd1), rng.choice(scales, size=(B, 1)) * rng.normal(size=(B, nr))


def jax_newton(sc, jcfg, states, tau):
    """JAX's newton on residual_bdf2, vmapped over lanes: (x, diverged)."""
    hess = jint._hess_bdf2(sc.topo, sc.force_fns)

    def one(x0, q0, qd0, q1, qd1, t):
        p = {**sc.params, "tau": t}
        theta = (p, q0, qd0, q1, qd1, {})
        res = lambda x: jint.residual_bdf2(sc.topo, sc.force_fns, p, x, q0, qd0, q1, qd1, {})
        jac = (lambda x: hess(theta, x)) if jcfg.hessian == "structured" else None
        x, info = jint.newton(res, x0, jcfg, jac_fn=jac)
        return x, info["diverged"]

    x, div = jax.jit(jax.vmap(one))(*(jnp.asarray(a) for a in (*states, tau)))
    return np.asarray(x), np.asarray(div)


def port_newton(name, cfg, states, tau):
    _, topo, params, fns = scene(name)
    T = [torch.tensor(a) for a in states]
    p = {**params, "tau": torch.tensor(tau)}
    theta = (p, *T[1:])
    hess = tint._hess_bdf2(topo, fns)
    jac = (lambda x: hess(theta, x)) if cfg.hessian == "structured" else None
    res = lambda x: tint.residual_bdf2(topo, fns, p, x, *T[1:])
    return tint.newton(res, T[0], cfg, jac_fn=jac)


# the guards (chord=False unguarded is a case of
# tests/test_torch_newton_unguarded.py)
CASES = [("chain4", m) for m in MODES if m != "rehess"] + [
    ("ground3", m) for m in ("guarded", "guarded_rehess", "guard_last")]


@pytest.mark.parametrize("name,mode", CASES, ids=[f"{m}-{n}" for n, m in CASES])
def test_newton_mode_matches_jax(name, mode):
    check_mode(name, MODES[mode], TAU)


def check_mode(name, kw, scales):
    """The port's newton in config kw against JAX's, on 32 lanes with torques
    at scales; returns the port's info."""
    sc, topo, _, _ = scene(name)
    states, tau = rand_states(topo.nr, 32, scales=scales)
    x, info = port_newton(name, tint.NewtonConfig(**kw), states, tau)
    x_ref, div_ref = jax_newton(sc, jint.NewtonConfig(**kw), states, tau)

    x = x.numpy()
    np.testing.assert_array_equal(info["diverged"].numpy(), div_ref)
    fin = np.isfinite(x_ref).all(-1)
    np.testing.assert_array_equal(np.isfinite(x).all(-1), fin)
    assert fin.mean() >= 0.5, fin
    scale = max(1.0, float(np.abs(x_ref[fin]).max()))
    np.testing.assert_allclose(x[fin], x_ref[fin], rtol=0, atol=1e-10 * scale)
    if "steps" in info:
        # the census: each branch of the guard fires at this torque scale
        steps = info["steps"].numpy()
        census = {s: int((steps == s).sum()) for s in (1.0, 0.5, 0.0)}
        assert min(census.values()) > 0, census
    return info


def test_rejection_keeps_lanes_that_halved_their_residual():
    """A guarded lane that stayed put is rejected only when its solve never
    halved |g|: at this torque scale both kinds occur, and the rejected ones
    are exactly the stalled ones (or grown / non-finite)."""
    name = "chain4"
    _, topo, _, _ = scene(name)
    states, tau = rand_states(topo.nr, 32)
    x, info = port_newton(name, tint.NewtonConfig(**MODES["guarded"]), states, tau)
    stayed = (info["steps"] == 0).any(-1)
    assert bool((stayed & ~info["diverged"]).any()) and bool((stayed & info["diverged"]).any())
    assert torch.isnan(x[info["diverged"]]).all() and torch.isfinite(x[~info["diverged"]]).all()
