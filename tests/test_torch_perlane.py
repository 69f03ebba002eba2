"""Per-lane physical parameters and gradients into every param leaf, against
redmax_tpu, on the CPU (float64 unless stated):

  * per-lane I_i, body_damping, g, h and contact, spring and cable
    coefficients (draws of tests/test_pallas_step.py::_perlane_params, plus
    body damping and the springs' and cable's k, d, L) through the batched
    BDF2 step on both routes, against make_bdf2_step_batched(use_pallas=False)
    to 1e-9 of scale, with B different from the closure counts, so that a
    wrong layout raises;
  * float32: the kernel's plain version with per-lane params against
    pallas_step.chord_bdf2_dense(xp=np) at the chord tolerances (x 5e-6,
    1e-5 on the cable, H^-1 2e-5 of scale), and the kernel route's backward into per-lane I_i
    and h against JAX's fallback VJP at 5e-4 of scale (the ports of
    test_perlane_params_match_vmap_fallback and
    test_perlane_inertia_vjp_matches_fallback);
  * the batched Euler step with per-lane h, I_i and g against
    redmax_tpu's make_euler_step_batched.

Every JAX oracle runs under one jax.jit. The gradients into nested and
per-lane param leaves are tests/test_torch_param_grads.py, the small
randomized contact-MPC solve tests/test_torch_perlane_mpc.py.
"""

import dataclasses
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from redmax_tpu import integrators as jint
from redmax_tpu import pallas_step
from redmax_tpu.scenes import scene_chain_ground as jground
from redmax_tpu.types import State as JState
from redmax_tpu_torch import chord_kernel, convert
from redmax_tpu_torch import integrators as tint
from redmax_tpu_torch.types import State
from test_torch_chord import BENCH_GROUND, contact_states
from test_torch_constraints import SCENES as CONSTRAINED, port_of
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


def perlane_params(params, force_fns, B, seed=0, extra=True):
    """numpy params with per-lane leaves, drawn as
    tests/test_pallas_step.py::_perlane_params draws them (U uniform on
    [0, 1)): I_i (1 + 0.3U) [B, 1, 1], h (1 + 0.2U) [B], g (1 + 0.1U) [B, 1],
    each contact's kn (1 + 0.5U) and mu U [B], tau 0.1 N(0, 1) [B, nr]; with
    extra also (body_damping + 0.05) (1 + 0.5U) [B, N] and each spring's and
    cable's k, d, L (1 + 0.3U) [B]."""
    rng = np.random.default_rng(seed)
    p = jax.tree_util.tree_map(np.asarray, dict(params))
    p["I_i"] = p["I_i"][None] * (1.0 + 0.3 * rng.uniform(size=(B, 1, 1)))
    p["h"] = p["h"] * (1 + 0.2 * rng.uniform(size=B))
    p["g"] = p["g"][None] * (1 + 0.1 * rng.uniform(size=(B, 1)))
    forces = {k: dict(v) for k, v in p.get("forces", {}).items()}
    for fn in force_fns:
        fp = forces[fn.key]
        if "kn" in fp:
            fp["kn"] = fp["kn"] * (1 + 0.5 * rng.uniform(size=B))
            fp["mu"] = fp["mu"] * rng.uniform(size=B)
    p["forces"] = forces
    p["tau"] = 0.1 * rng.normal(size=(B, p["tau"].shape[-1]))
    if extra:
        p["body_damping"] = (p["body_damping"] + 0.05)[None] * (
            1 + 0.5 * rng.uniform(size=(B, 1)))
        for fn in force_fns:
            fp = forces[fn.key]
            for c in ("k", "d", "L"):
                if c in fp:
                    fp[c] = fp[c] * (1 + 0.3 * rng.uniform(size=B))
    return p


def port_scene(sc, params_np, dtype=torch.float64):
    """The JAX scene's topology and force closures in the port, with params_np."""
    topo = convert.topology_from_fields(**dataclasses.asdict(sc.topo))
    fns = convert.forces_from_fields([(type(f).__name__, vars(f)) for f in sc.force_fns])
    return topo, convert.params_from_numpy(params_np, "cpu", dtype), fns


def _j(params_np, dtype=jnp.float64):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), params_np)


def close(got, want, tol, name):
    want = np.asarray(want, np.float64)
    got = got.detach().numpy().astype(np.float64) if torch.is_tensor(got) else np.asarray(got)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale, err_msg=name)


# ---------------------------------------------------------------------------
# Per-lane params through the batched BDF2 step
# ---------------------------------------------------------------------------

PERLANE_SCENES = {
    "chain_ground": lambda: jground(nlinks=3, **BENCH_GROUND).compile(),
    "springs": lambda: jax_scene("spring3"),
    "scene13": lambda: jax_scene("scene13"),
}


@pytest.mark.parametrize("scene", sorted(PERLANE_SCENES))
def test_perlane_bdf2_steps_match_jax(scene):
    """Four steps (the bootstrap and three inner steps) with per-lane
    inertia, body damping, gravity, timestep and closure coefficients, B = 5
    (3 contacts, 2 springs, 1 cable): q and qdot to 1e-9 of scale against
    the vmapped JAX step, on the op-level and the kernel route."""
    sc = PERLANE_SCENES[scene]()
    B, nsteps = 5, 4
    assert len(sc.force_fns) not in (0, B)
    pn = perlane_params(sc.params, sc.force_fns, B)
    rng = np.random.default_rng(2)
    q0 = np.asarray(sc.state0.q)[None] + 0.02 * rng.normal(size=(B, sc.topo.nr))
    qd0 = np.asarray(sc.state0.qdot)[None] + 0.1 * rng.normal(size=(B, sc.topo.nr))
    jstep = jint.make_bdf2_step_batched(sc.topo, sc.force_fns, JCFG, use_pallas=False)
    ref = jax.jit(jint.make_simulate(jstep, nsteps))(
        _j(pn), jint.bdf2_init(JState(q=jnp.asarray(q0), qdot=jnp.asarray(qd0), aux={})))
    assert np.isfinite(np.asarray(ref.q)).all()

    topo, params, fns = port_scene(sc, pn)
    shared, lane = tint.split_batched_params(params)
    assert {"I_i", "h", "g", "body_damping", "tau", "forces"} <= set(lane)
    assert tint.merge_batched_params(shared, lane).keys() == params.keys()
    for use_kernel in (False, True):
        step = tint.make_bdf2_step_batched(topo, fns, TCFG, use_kernel=use_kernel)
        s = tint.make_simulate(step, nsteps)(
            params, tint.bdf2_init(State(q=torch.tensor(q0), qdot=torch.tensor(qd0))))
        close(s.q, ref.q, 1e-9, f"q, use_kernel={use_kernel}")
        close(s.qdot, ref.qdot, 1e-9, f"qdot, use_kernel={use_kernel}")


def _chord_states(nr, B):
    rng = np.random.default_rng(1)
    q1 = (0.3 * rng.normal(size=(B, nr))).astype(np.float32)
    qd1 = rng.normal(size=(B, nr)).astype(np.float32)
    return (q1 + np.float32(0.01) * qd1, q1 - np.float32(0.01) * qd1,
            qd1 + (0.05 * rng.normal(size=qd1.shape)).astype(np.float32), q1, qd1)


# (float32 scene, chord-solve inputs): contact states as tests/test_torch_chord.py
# draws them (corners out of contact, static and dynamic)
KERNEL_SCENES = {
    "chain_ground": (lambda: jground(nlinks=4, **BENCH_GROUND).compile(dtype=jnp.float32),
                     lambda nr, B: contact_states(nr, B)[0]),
    "springs": (lambda: jax_scene("spring3", f32=True), _chord_states),
    "cable": (lambda: jax_scene("cable3", f32=True), _chord_states),
}


@pytest.mark.parametrize("scene", sorted(KERNEL_SCENES))
def test_plain_version_with_perlane_params_matches_kernel_body(scene):
    """float32: chord_kernel.chord_bdf2 on CPU tensors (the kernel's plain
    version) with per-lane params against the JAX package's numpy evaluation
    of the Pallas kernel body with its perlane reads: x at 5e-6 (1e-5 on the
    cable case, whose per-lane draws make the solve more sensitive: the two
    float32 evaluations differ by up to 6.6e-6 there, each within 1e-5 of
    the float64 solve), H^-1 at 2e-5 of scale."""
    build, states_of = KERNEL_SCENES[scene]
    sc = build()
    B = 12
    pn = perlane_params(sc.params, sc.force_fns, B)
    pj = _j(pn, jnp.float32)
    states = states_of(sc.topo.nr, B)
    perlane = pallas_step._perlane_keys(pj, sc.force_fns)
    assert {"I_i", "gh", "bd"} <= perlane and perlane & {"cp", "sp", "cb"}
    x_np, hinv_np = pallas_step.chord_bdf2_dense(sc.topo, JCFG, pj, *states, xp=np,
                                                 force_fns=sc.force_fns)
    topo, params, fns = port_scene(sc, pn, torch.float32)
    x, hinv = chord_kernel.chord_bdf2(topo, TCFG, params, *(torch.tensor(a) for a in states), fns)
    fin = np.isfinite(x_np).all(-1)
    assert fin.mean() >= 0.75
    np.testing.assert_array_equal(np.isfinite(x.numpy()).all(-1), fin)
    np.testing.assert_allclose(x.numpy()[fin], x_np[fin], rtol=0,
                               atol=1e-5 if scene == "cable" else 5e-6)
    scale = float(np.abs(hinv_np[fin]).max())
    np.testing.assert_allclose(hinv.numpy()[fin], hinv_np[fin], rtol=0, atol=2e-5 * scale)
    # the per-lane values act: lane 0's params on every lane give another solution
    lane0 = {**params, **{k: params[k][0] for k in ("I_i", "g", "h", "body_damping")}}
    x0, _ = chord_kernel.chord_bdf2(topo, TCFG, lane0, *(torch.tensor(a) for a in states), fns)
    assert float((x0 - x)[torch.tensor(fin)].abs().max()) > 1e-4


# ---------------------------------------------------------------------------
# The Euler tier
# ---------------------------------------------------------------------------


@lru_cache(maxsize=None)
def _euler_case(B=4, nsteps=5):
    """(scene, params, q, qdot, JAX's final state) of the Euler case, once
    per module: the 3-link floor chain bent onto its floor, per-lane h, I_i
    and g, nsteps steps of redmax_tpu's make_euler_step_batched."""
    sc = CONSTRAINED["floor3"][0]().compile()
    pn = perlane_params(sc.params, (), B, seed=6, extra=False)
    pn["tau"] = np.zeros(sc.topo.nr)
    rng = np.random.default_rng(3)
    q = np.asarray(sc.state0.q)[None] + np.array([1.4, 0.3, 0.3]) + 0.05 * rng.normal(
        size=(B, sc.topo.nr))
    qd = np.asarray(sc.state0.qdot)[None] + 0.1 * rng.normal(size=(B, sc.topo.nr))
    jstep = jint.make_euler_step_batched(sc.topo, sc.force_fns, sc.constraint_fns)
    ref = jax.jit(jint.make_simulate(jstep, nsteps))(
        _j(pn), JState(q=jnp.asarray(q), qdot=jnp.asarray(qd), aux={}))
    return sc, pn, q, qd, ref


@pytest.mark.parametrize("use_kernel", [None, False], ids=["kernel_route", "op_level"])
def test_perlane_euler_steps_match_jax(use_kernel):
    """Five linearly implicit Euler steps of the 3-link floor chain with
    per-lane h, I_i and g, B = 4, against redmax_tpu's
    make_euler_step_batched: q at 1e-8, qdot at 1e-6 (the bounds of
    tests/test_torch_euler.py)."""
    sc, pn, q, qd, ref = _euler_case()
    nsteps = 5
    topo, _, cons = port_of(sc)
    params = convert.params_from_numpy(pn, "cpu")
    step = tint.make_euler_step_batched(topo, (), cons, use_kernel=use_kernel)
    final = tint.make_simulate(step, nsteps)(params, State(q=torch.tensor(q), qdot=torch.tensor(qd)))
    np.testing.assert_allclose(final.q.numpy(), np.asarray(ref.q), rtol=0, atol=1e-8)
    np.testing.assert_allclose(final.qdot.numpy(), np.asarray(ref.qdot), rtol=0, atol=1e-6)
    # per lane: lane 1 alone with its own params gives its row
    lone = {**params, "I_i": params["I_i"][1], "g": params["g"][1], "h": params["h"][1]}
    one = tint.make_simulate(step, nsteps)(lone, State(q=torch.tensor(q[1:2]),
                                                       qdot=torch.tensor(qd[1:2])))
    np.testing.assert_allclose(one.q.numpy()[0], final.q.numpy()[1], rtol=0, atol=1e-12)
