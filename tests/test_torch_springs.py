"""Parity of redmax_tpu_torch's spring and cable closures (ForcePointPoint,
ForceSpringDamper with tension_only, ForceCable) with redmax_tpu, in
float64 on the CPU unless stated:

  * each closure's wrench and energy at 1e-12 of the largest magnitude,
    with world and body endpoints, the tension gate taut and slack;
  * the compile of scenes 10, 12, 13 and of the spring chain (rest lengths
    set from the initial configuration);
  * M, f, the structured Newton matrix (JAX: jacfwd over the whole system;
    the port: closed-form pair blocks) and the energies at 1e-10;
  * the f32 BDF2 inner step of scenes 10, 12 and 13 against their f64
    reference dumps, on the kernel route and at op level, with the bounds of
    tests/test_ref_traj.py;
  * the kernel route's backward with springs and with a cable against JAX's
    cotangents (the small spring-MPC solve is a case of
    tests/test_torch_mpc.py).

The JAX side runs on its op-level route, each oracle under one jax.jit.
"""

import dataclasses
import os
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from redmax_tpu import forces as jforces
from redmax_tpu import model as jmodel
from redmax_tpu import scene as jscene
from redmax_tpu import scenes as jscenes
from redmax_tpu.types import JointType as JJT
from redmax_tpu_torch import convert
from redmax_tpu_torch import forces as tforces
from redmax_tpu_torch import integrators as tint
from redmax_tpu_torch import model as tmodel
from redmax_tpu_torch import scenes as tscenes
from test_torch_model import _close, _flat


@pytest.fixture(scope="module", autouse=True)
def single_thread():
    """torch's intra-op threads set to 1 for the module, then restored."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


DATA = os.path.join(os.path.dirname(__file__), "data")
B = 8


def spring3(mod, JT):
    """tests/test_pallas_step.py::_spring_scene with either package's builder:
    a 3-link revolute chain, a body-body point-point spring and a world-body
    spring-damper."""
    b = mod.SceneBuilder(name="spr", h=1e-2, tEnd=0.1, grav=(0.0, 0.0, -980.0))
    for i in range(3):
        bi = b.body_cuboid(1.0, (1.0, 0.1, 0.1), E_ji=mod.transl([0.5, 0, 0]))
        b.joint(JT.REVOLUTE, None if i == 0 else i - 1, bi,
                E_pj=np.eye(4) if i == 0 else mod.transl([1.0, 0, 0]),
                axis=(0, 1, 0) if i % 2 == 0 else (0, 0, 1))
    b.force_point_point(0, 2, xl1=(0.3, 0, 0.05), xl2=(0.2, 0, -0.05), k=70.0, d=4.0)
    b.force_spring_damper(-1, 2, [1.5, 0.5, 2.0], [0.4, 0, 0.0], k=120.0, d=2.0)
    return b


def springs4(mod, JT):
    """spring3 with a second spring of each law (a world-body point-point
    spring, a body-body spring-damper): two springs to a group."""
    b = spring3(mod, JT)
    b.force_point_point(-1, 1, xl1=(0.5, -0.5, 1.0), xl2=(0.3, 0.0, 0.05), k=30.0, d=1.0)
    b.force_spring_damper(0, 1, [0.2, 0, 0.05], [0.6, 0, -0.05], k=80.0, d=3.0)
    return b


def cable3(mod, JT, L=0.5):
    """tests/test_pallas_step.py::_cable_scene: a 4-point cable from a world
    anchor over three links."""
    b = mod.SceneBuilder(name="cab", h=1e-2, tEnd=0.1, grav=(0.0, 0.0, -980.0))
    for i in range(3):
        bi = b.body_cuboid(1.0, (1.0, 0.1, 0.1), E_ji=mod.transl([0.5, 0, 0]))
        b.joint(JT.REVOLUTE, None if i == 0 else i - 1, bi,
                E_pj=np.eye(4) if i == 0 else mod.transl([1.0, 0, 0]),
                axis=(0, 1, 0) if i % 2 == 0 else (0, 0, 1))
    b.force_cable([-1, 0, 1, 2], [[0.0, 0.5, 2.0], [0.3, 0, 0.05], [0.4, 0, 0.0], [0.2, 0, -0.05]],
                  k=200.0, d=5.0, L=L)
    return b


def spring_chain_jax(nlinks=12):
    """benchmarks/bench_spring_ab.py:41-67 built with redmax_tpu's builder
    (the benchmark module itself is not imported)."""
    b = jscene.SceneBuilder(name=f"spring-chain-{nlinks}", h=1e-2, tEnd=0.5,
                            grav=(0.0, 0.0, -980.0))
    for i in range(nlinks):
        body = b.body_cuboid(1.0, (1.0, 0.1, 0.1), E_ji=jscene.transl([0.5, 0, 0]))
        j = b.joint(JJT.REVOLUTE, None if i == 0 else i - 1, body,
                    E_pj=np.eye(4) if i == 0 else jscene.transl([1.0, 0, 0]),
                    axis=(0, 1, 0) if i % 2 == 0 else (0, 0, 1))
        b.set_damping(j, 1.0)
    b.force_spring_damper(-1, nlinks - 1, [0.0, 0.0, 6.0], [0.5, 0, 0], k=2e3, d=20.0)
    b.force_spring_damper(2, 8, [0.5, 0, 0.05], [0.5, 0, -0.05], k=1e3, d=10.0)
    b.force_point_point(5, 11, xl1=(0.5, 0, 0.05), xl2=(0.5, 0, -0.05), k=50.0, d=2.0)
    return b


JAX_BUILDERS = {
    "spring3": lambda: spring3(jscene, JJT),
    "springs4": lambda: springs4(jscene, JJT),
    "cable3": lambda: cable3(jscene, JJT),
    "scene10": jscenes.scene_10_loop,
    "scene12": jscenes.scene_12_spring_damper,
    "scene13": jscenes.scene_13_cables,
    "spring_chain": spring_chain_jax,
}


@lru_cache(maxsize=None)
def _jax_compiled(name):
    return JAX_BUILDERS[name]().compile()


def jax_scene(name, f32=False):
    """redmax_tpu's f64 compile of a scene, once per module (its rest-length
    init runs JAX's forward kinematics op by op: seconds a scene), in fresh
    containers that a test may change; f32 casts its params."""
    sc = _jax_compiled(name)
    cast = (lambda a: a.astype(jnp.float32)) if f32 else (lambda a: a)
    return dataclasses.replace(sc, params=jax.tree_util.tree_map(cast, sc.params))


def _port(sc, dtype=torch.float64):
    topo = convert.topology_from_fields(**dataclasses.asdict(sc.topo))
    params = convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, sc.params), "cpu", dtype)
    fns = convert.forces_from_fields([(type(f).__name__, vars(f)) for f in sc.force_fns])
    return topo, params, fns


def _states(nr, seed=3, scale=0.5):
    rng = np.random.default_rng(seed)
    return scale * rng.normal(size=(B, nr)), rng.normal(size=(B, nr))


def lengths(topo, params, fn, q):
    """Length [B] of the port's spring-damper or cable fn at q, in f64."""
    p64 = jax.tree_util.tree_map(lambda a: a.double(), params)
    q = torch.as_tensor(q, dtype=torch.float64)
    kin = tmodel.forward_kinematics(topo, p64, q, torch.zeros_like(q))
    fp = fn.p(p64)
    if isinstance(fn, tforces.ForceCable):
        x, _, _, _ = tforces.body_points(kin, None, fn.bodies, fp["xls"])
    else:
        x, _, _, _ = tforces.body_points(kin, None, (fn.body1, fn.body2),
                                         torch.stack([fp["xl1"], fp["xl2"]]))
    return torch.linalg.vector_norm(x[:, 1:] - x[:, :-1], dim=-1).sum(-1).numpy()


def tension_only(sc):
    """sc (a JAX CompiledScene) with its spring-dampers made tension-only."""
    fns = tuple(jforces.ForceSpringDamper(f.key, f.body1, f.body2, tension_only=True)
                if isinstance(f, jforces.ForceSpringDamper) else f for f in sc.force_fns)
    return dataclasses.replace(sc, force_fns=fns)


@pytest.mark.parametrize("case", ["springs", "tension_only", "cable"])
def test_closures_and_energies_match(case):
    """Wrench and energy of every closure against the JAX closure's, and the
    grouped evaluation (forces.pair_closure_*) against their sum. The
    tension-only spring-damper and the cable get the median length of the
    lanes as rest length: half the lanes taut, half slack (asserted)."""
    sc = jax_scene("cable3" if case == "cable" else "spring3")
    if case == "tension_only":
        sc = tension_only(sc)
    q, qd = _states(sc.topo.nr)
    topo, params, fns = _port(sc)
    if case != "springs":
        key = fns[-1].key
        l = lengths(topo, params, fns[-1], q)
        L = float(np.median(l))       # B is even: no lane sits on L
        sc.params["forces"][key]["L"] = jnp.asarray(L)
        params["forces"][key]["L"] = torch.tensor(L, dtype=torch.float64)
        taut = l > L
        assert 0 < taut.sum() < B, l
    assert [vars(f) for f in fns] == [vars(f) for f in sc.force_fns]

    def jone(a, b):
        kin = jmodel.forward_kinematics(sc.topo, sc.params, a, b, {})
        _, _, phi = jmodel.jacobians(sc.topo, sc.params, kin, b)
        fm = [fn(sc.params, kin, None, phi, a, b)[1] for fn in sc.force_fns]
        V = [fn.energy(sc.params, kin, a, b) for fn in sc.force_fns]
        return jnp.stack(fm), jnp.stack(V)

    fm_ref, V_ref = (np.asarray(a) for a in jax.jit(jax.vmap(jone))(jnp.asarray(q),
                                                                    jnp.asarray(qd)))
    tq, tqd = torch.tensor(q), torch.tensor(qd)
    kin = tmodel.forward_kinematics(topo, params, tq, tqd)
    _, _, phi = tmodel.jacobians(topo, params, kin, tqd)
    fm_sum = torch.zeros_like(phi)
    for c, fn in enumerate(fns):
        fr, fm = fn(params, kin, None, phi, tq, tqd)
        assert fr.shape == tq.shape and not fr.any()
        np.testing.assert_allclose(fm.numpy(), fm_ref[:, c], rtol=0,
                                   atol=1e-12 * np.abs(fm_ref[:, c]).max(), err_msg=f"fm[{c}]")
        V = fn.energy(params, kin, tq, tqd).numpy()
        np.testing.assert_allclose(V, V_ref[:, c], rtol=0, atol=1e-12 * np.abs(V_ref[:, c]).max(),
                                   err_msg=f"V[{c}]")
        fm_sum = fm_sum + fm
    if case != "springs":  # slack lanes: no force and no energy
        assert not fm_ref[~taut, -1].any() and not V_ref[~taut, -1].any()
        assert np.abs(fm_ref[taut, -1]).max() > 1.0
    _close(tforces.pair_closure_wrenches(fns, params, kin, phi).numpy(), fm_sum.numpy(), "grouped")
    _close(tforces.pair_closure_energy(fns, params, kin).numpy(), V_ref.sum(1), "grouped V")


SCENES = {"scene10": tscenes.scene_10_loop, "scene12": tscenes.scene_12_spring_damper,
          "scene13": tscenes.scene_13_cables, "spring_chain": tscenes.scene_spring_chain}


@pytest.mark.parametrize("scene", list(SCENES))
def test_compile_matches(scene):
    """The port's builder gives redmax_tpu's topology, closures, params and
    state0; the rest lengths set at compile agree to f64 roundoff (each
    package evaluates its own forward kinematics)."""
    sc, tc = jax_scene(scene), SCENES[scene]().compile(device="cpu")
    assert tc.topo == convert.topology_from_fields(**dataclasses.asdict(sc.topo))
    assert [(type(f).__name__, vars(f)) for f in tc.force_fns] == \
        [(type(f).__name__, vars(f)) for f in sc.force_fns]
    jp, tp = _flat(jax.tree_util.tree_map(np.asarray, sc.params)), _flat(tc.params)
    assert sorted(jp) == sorted(tp)
    for k in jp:
        if k.startswith("forces/") and k.endswith("/L"):
            assert float(jp[k]) > 0
            np.testing.assert_allclose(tp[k], jp[k], rtol=1e-14, atol=0, err_msg=k)
        else:
            np.testing.assert_array_equal(tp[k], jp[k], err_msg=k)
    np.testing.assert_array_equal(tc.state0.q.numpy(), np.asarray(sc.state0.q))
    np.testing.assert_array_equal(tc.state0.qdot.numpy(), np.asarray(sc.state0.qdot))


@pytest.mark.parametrize("scene", ["scene12", "scene13", "spring3", "cable3", "springs4"])
def test_assembly_hessian_energies_match(scene):
    """M, f, fm, the structured H (cK = -0.3, cD = -0.05) and (T, V) with the
    closures, against redmax_tpu.model, whose H takes jacfwd of the closures
    over the whole system; springs4 puts two springs in each group."""
    sc = jax_scene(scene)
    topo, params, fns = _port(sc)
    q, qd = _states(sc.topo.nr, seed=5)

    def jone(a, b):
        M, f, aux = jmodel.assemble(sc.topo, sc.params, a, b, sc.force_fns)
        H = jmodel.structured_hessian(sc.topo, sc.params, a, b, -0.3, -0.05, sc.force_fns)
        T, V = jmodel.energies(sc.topo, sc.params, a, b, sc.force_fns)
        return M, f, aux["fm"], H, T, V

    ref = jax.jit(jax.vmap(jone))(jnp.asarray(q), jnp.asarray(qd))
    tq, tqd = torch.tensor(q), torch.tensor(qd)
    M, f, aux = tmodel.assemble(topo, params, tq, tqd, fns)
    H = tmodel.structured_hessian(topo, params, tq, tqd, -0.3, -0.05, fns)
    T, V = tmodel.energies(topo, params, tq, tqd, fns)
    for name, a, b in zip(["M", "f", "fm", "H", "T", "V"], [M, f, aux["fm"], H, T, V], ref):
        _close(a.numpy(), b, name)
    # the closures are in: without them f, H and V differ
    _, f0, _ = tmodel.assemble(topo, params, tq, tqd)
    H0 = tmodel.structured_hessian(topo, params, tq, tqd, -0.3, -0.05)
    assert float((f - f0).abs().max()) > 1.0 and float((H - H0).abs().max()) > 1e-3
    assert float((V - tmodel.energies(topo, params, tq, tqd)[1]).abs().max()) > 1e-3


# tests/test_ref_traj.py BOUNDS (bdf2 p99, max): scene 12's k = 1e6 springs
# get (2.5e-5, 3e-5), scenes 10 and 13 the default (1e-6, 1e-6).
REF_BOUNDS = {10: (1e-6, 1e-6), 12: (2.5e-5, 3e-5), 13: (1e-6, 1e-6)}
REF_SCENES = {10: tscenes.scene_10_loop, 12: tscenes.scene_12_spring_damper,
              13: tscenes.scene_13_cables}
CFG = tint.NewtonConfig(fixed_iters=3, predictor="quadratic", chord=True,
                        hessian="structured", linsolve="gj")


@pytest.mark.parametrize("use_kernel", [True, False], ids=["kernel_route", "op_level"])
@pytest.mark.parametrize("sid", sorted(REF_SCENES))
def test_bdf2_per_step_vs_ref(sid, use_kernel):
    """Every dumped step of tests/data/ref_traj_{sid}.npz is one lane, re-stepped
    in f32 from the f64 history by one batched call (the pattern of
    tests/test_torch_integrators.py)."""
    d = np.load(os.path.join(DATA, f"ref_traj_{sid:02d}.npz"))
    sc = REF_SCENES[sid]().compile(dtype=torch.float32, device="cpu")
    q, qd = d["q_bdf2"], d["qdot_bdf2"]
    f32 = lambda a: torch.tensor(a, dtype=torch.float32)
    s = tint.Bdf2State(q=f32(q[1:-1]), qdot=f32(qd[1:-1]),
                       q_prev=f32(q[:-2]), qdot_prev=f32(qd[:-2]), k=1)
    step = tint.make_bdf2_step_batched(sc.topo, sc.force_fns, CFG, use_kernel=use_kernel)
    out = step.inner(sc.params, s)
    scale = max(1.0, float(np.abs(q).max()))
    err = np.abs(out.q.numpy().astype(np.float64) - q[2:]).max(axis=-1) / scale
    p99, mx = float(np.quantile(err, 0.99)), float(err.max())
    b99, bmax = REF_BOUNDS[sid]
    assert p99 <= b99 and mx <= bmax, (sid, p99, mx)


@pytest.mark.parametrize("case", ["springs", "cable"])
def test_kernel_route_backward_with_closures_matches_jax(case):
    """The kernel route's backward (z = Hinv^T xbar, then autograd's VJP of
    the op-level residual with the springs' or the cable's forces) against
    JAX's cotangents of tau, q0, qd0, q1, qd1 in f32, at 5e-4 of scale
    (tests/test_torch_chord.py's contact case)."""
    from redmax_tpu import integrators as jint
    from redmax_tpu import pallas_step

    sc = jax_scene("cable3" if case == "cable" else "spring3", f32=True)
    topo, params, fns = _port(sc, torch.float32)
    Bn, nr = 4, sc.topo.nr
    rng = np.random.default_rng(11)
    q1 = (0.3 * rng.normal(size=(Bn, nr))).astype(np.float32)
    qd1 = rng.normal(size=(Bn, nr)).astype(np.float32)
    q0 = q1 - np.float32(0.01) * qd1
    qd0 = qd1 + (0.05 * rng.normal(size=(Bn, nr))).astype(np.float32)
    tau = (0.1 * rng.normal(size=(Bn, nr))).astype(np.float32)
    xbar = rng.normal(size=(Bn, nr)).astype(np.float32)
    cfg = dict(fixed_iters=3, predictor="quadratic", chord=True, hessian="structured",
               linsolve="gj")

    h = float(np.asarray(sc.params["h"]))
    guess = q1 + h * qd1 + 0.5 * h * (qd1 - qd0)
    xstar, hinv = pallas_step.chord_bdf2_dense(
        sc.topo, jint.NewtonConfig(**cfg), {**sc.params, "tau": jnp.asarray(tau)}, guess, q0,
        qd0, q1, qd1, xp=np, force_fns=sc.force_fns)
    assert np.isfinite(xstar).all()
    z = jnp.einsum("bsr,bs->br", jnp.asarray(hinv), jnp.asarray(xbar))

    def cots(z, *leaves):
        def res_b(tau_b, a, b, c, d):
            def one(ti, a, b, c, d, xi):
                return jint.residual_bdf2(sc.topo, sc.force_fns, {**sc.params, "tau": ti},
                                          xi, a, b, c, d, {})
            return jax.vmap(one)(tau_b, a, b, c, d, jnp.asarray(xstar))
        return jax.vjp(res_b, *leaves)[1](-z)

    cots_ref = jax.jit(cots)(z, *(jnp.asarray(a) for a in (tau, q0, qd0, q1, qd1)))

    step = tint.make_bdf2_step_batched(topo, fns, tint.NewtonConfig(**cfg), differentiable=True,
                                       use_kernel=True)
    leaves = [torch.tensor(a, requires_grad=True) for a in (tau, q0, qd0, q1, qd1)]
    s = tint.Bdf2State(q=leaves[3], qdot=leaves[4], q_prev=leaves[1], qdot_prev=leaves[2], k=1)
    out = step.inner({**params, "tau": leaves[0]}, s)
    np.testing.assert_allclose(out.q.detach().numpy(), xstar, rtol=0, atol=1e-5)
    grads = torch.autograd.grad(out.q, leaves, grad_outputs=torch.tensor(xbar))
    for name, g, r in zip(["tau", "q0", "qd0", "q1", "qd1"], grads, cots_ref):
        r = np.asarray(r, np.float64)
        np.testing.assert_allclose(g.numpy().astype(np.float64), r, rtol=0,
                                   atol=5e-4 * max(np.abs(r).max(), 1e-9), err_msg=name)
