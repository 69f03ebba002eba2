"""Parity of redmax_tpu_torch's q-dependent joints (UNIVERSAL, exp-map
SPHERICAL, FREE3D, FREE2D) with redmax_tpu, in float64 on the CPU unless
stated:

  * Q, S and Sdot of each type against redmax_tpu.joints.joint_QSSdot (whose
    Sdot is jax.jvp of S) at 1e-12, on seeded (q, qdot) with |w| -> 0,
    s = |w|^2 just below and above the 0.04 Taylor switch and |w| near
    1.5 pi;
  * model.reparam_all against redmax_tpu.model.reparam_all on lanes above
    and below 1.5 pi (float64 at 1e-12, float32 at 1e-6);
  * FK, J, Jdot, M, f and the structured H on a chain with every
    q-dependent type, per lane, against redmax_tpu.model at 1e-10;
  * the compile of scenes 6, 7, 8, 9, 11 and of the universal-6 and
    spherical-4 chains (benchmarks/qdep_ablation.py) against the JAX scenes;
  * the f32 BDF2 inner step of scenes 6, 7, 8, 9 and 11 against their f64
    reference dumps at the bounds of tests/test_ref_traj.py, at op level and,
    for 7, 8 and 9, on the kernel route;
  * a finite gradient of a short rollout from q = 0, where every scene
    starts.

The JAX side runs under one jax.jit per oracle.
"""

import dataclasses
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from redmax_tpu import joints as jjoints
from redmax_tpu import model as jmodel
from redmax_tpu import scene as jscene
from redmax_tpu import scenes as jscenes
from redmax_tpu.types import JointType as JJT
from redmax_tpu_torch import convert, joints
from redmax_tpu_torch import integrators as tint
from redmax_tpu_torch import model as tmodel
from redmax_tpu_torch import scene as tscene
from redmax_tpu_torch import scenes as tscenes
from redmax_tpu_torch.types import JointType as TJT
from test_torch_model import _close, _flat, _port


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


def qdep_mixed(mod, JT, revolute=True):
    """A FREE3D root, then a SPHERICAL, a UNIVERSAL and (revolute) a REVOLUTE
    joint (N = 4, nr = 12; N = 3, nr = 11 without it), joint damping 1;
    built with either package's SceneBuilder."""
    T = mod.transl
    b = mod.SceneBuilder(name="qdep-mixed", h=1e-2, tEnd=0.1, grav=(0.0, 0.0, -980.0))
    types = (JT.FREE3D, JT.SPHERICAL, JT.UNIVERSAL) + ((JT.REVOLUTE,) if revolute else ())
    for i, jt in enumerate(types):
        body = b.body_cuboid(1.0, (1.0, 0.1, 0.1), E_ji=T([0.5, 0, 0]))
        kw = {"axis": (0, 0, 1)} if jt == JT.REVOLUTE else {}
        j = b.joint(jt, None if i == 0 else i - 1, body,
                    E_pj=np.eye(4) if i == 0 else T([1.0, 0, 0]), **kw)
        b.set_damping(j, 1.0)
    return b


def rotation_samples(n, seed):
    """[n, 3] rotation vectors: random, |w| = 0, 1e-9, 1e-5, s just below and
    above 0.04, |w| around 1.5 pi."""
    rng = np.random.default_rng(seed)
    u = rng.normal(size=(n, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    norms = np.concatenate([
        [0.0, 1e-9, 1e-5, 0.2 * (1 - 1e-7), 0.2 * (1 + 1e-7), 0.1999, 0.2001,
         1.5 * np.pi - 1e-3, 1.5 * np.pi + 1e-3, 1.49 * np.pi, 1.6 * np.pi],
        rng.uniform(0.0, 4.0, size=n - 11)])
    return u * norms[:, None]


@pytest.mark.parametrize("jt", ["UNIVERSAL", "SPHERICAL", "FREE3D", "FREE2D"])
def test_joint_QSSdot_matches(jt):
    n, d = 24, {"UNIVERSAL": 2, "SPHERICAL": 3, "FREE3D": 6, "FREE2D": 3}[jt]
    rng = np.random.default_rng(7)
    q = rng.normal(size=(n, d)) * 2.0
    qd = rng.normal(size=(n, d)) * 3.0
    if jt in ("SPHERICAL", "FREE3D"):
        q[:, d - 3:] = rotation_samples(n, 8)
    else:
        q[0] = 0.0
    Q, S, Sd = jax.jit(jax.vmap(lambda a, b: jjoints.joint_QSSdot(JJT[jt], a, b, {})))(
        jnp.asarray(q), jnp.asarray(qd))
    # the port's group layout: [B, G = 1, d]
    tQ, tS, tSd = joints.joint_QSSdot(TJT[jt], torch.tensor(q)[:, None], torch.tensor(qd)[:, None],
                                      {})
    for name, a, b in (("Q", tQ, Q), ("S", tS, S), ("Sdot", tSd, Sd)):
        b = np.asarray(b)
        np.testing.assert_allclose(a[:, 0].numpy(), b, rtol=0,
                                   atol=1e-12 * max(1.0, float(np.abs(b).max())), err_msg=name)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_reparam_matches(dtype):
    """reparam_all on the mixed chain, the FREE3D and SPHERICAL rotations
    above 1.5 pi on half the lanes and below on the others; the JAX
    function's rdot map Jr(r_new)^-1 Jr(r) rdot with its float32 Taylor
    branch of Jr^-1 (s < 1)."""
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    sc = qdep_mixed(jscene, JJT).compile(dtype=jdt)
    B, nr = 16, sc.topo.nr
    rng = np.random.default_rng(4)
    q, qd = rng.normal(size=(B, nr)), 2.0 * rng.normal(size=(B, nr))
    q[:, 3:6] = rotation_samples(B, 5)
    q[:, 6:9] = rotation_samples(B, 6)[::-1]
    big = np.linalg.norm(q[:, 3:6], axis=1) > 1.5 * np.pi
    assert 0 < big.sum() < B
    ref = jax.jit(jax.vmap(lambda a, b: jmodel.reparam_all(sc.topo, sc.params, a, b, {})[:2]))(
        jnp.asarray(q, jdt), jnp.asarray(qd, jdt))
    topo, params = _port(sc)
    out = tmodel.reparam_all(topo, params, torch.tensor(q, dtype=tdt),
                             torch.tensor(qd, dtype=tdt))[:2]
    tol = 1e-12 if dtype == "float64" else 1e-6
    for name, a, b in zip(("q", "qdot"), out, ref):
        b = np.asarray(b, np.float64)
        np.testing.assert_allclose(a.double().numpy(), b, rtol=0,
                                   atol=tol * float(np.abs(b).max()), err_msg=name)
    # the rescale fired where |w| > 1.5 pi and nowhere else
    moved = (out[0].double().numpy() != np.asarray(q, getattr(np, dtype))).any(-1)
    np.testing.assert_array_equal(moved, big | (np.linalg.norm(q[:, 6:9], axis=1) > 1.5 * np.pi))


@pytest.mark.parametrize("scene", ["mixed", "scene6", "scene7"])
def test_kinematics_and_assembly_match(scene):
    """Per-lane S(q) through FK, J, Jdot (with Sdot), M, f and the structured
    H (cK = -0.3, cD = -0.05) at random (q, qdot), lane 0 at q = 0."""
    build = {"mixed": lambda: qdep_mixed(jscene, JJT), "scene6": jscenes.scene_06_free2d,
             "scene7": jscenes.scene_07_spherical}[scene]
    sc = build().compile()
    topo, params = _port(sc)
    B, nr = 8, sc.topo.nr
    rng = np.random.default_rng(2)
    q, qd = 1.5 * rng.normal(size=(B, nr)), 2.0 * rng.normal(size=(B, nr))
    q[0] = 0.0

    def jone(a, b):
        kin = jmodel.forward_kinematics(sc.topo, sc.params, a, b, {})
        J, Jd, phi = jmodel.jacobians(sc.topo, sc.params, kin, b)
        M, f, _ = jmodel.assemble(sc.topo, sc.params, a, b)
        H = jmodel.structured_hessian(sc.topo, sc.params, a, b, -0.3, -0.05)
        return kin.E_wi, kin.S, kin.Sdot, J, Jd, phi, M, f, H

    ref = jax.jit(jax.vmap(jone))(jnp.asarray(q), jnp.asarray(qd))
    tq, tqd = torch.tensor(q), torch.tensor(qd)
    kin = tmodel.forward_kinematics(topo, params, tq, tqd)
    J, Jd, phi = tmodel.jacobians(topo, params, kin, tqd)
    M, f, _ = tmodel.assemble(topo, params, tq, tqd)
    H = tmodel.structured_hessian(topo, params, tq, tqd, -0.3, -0.05)
    for name, a, b in zip(["E_wi", "S", "Sdot", "J", "Jdot", "phi", "M", "f", "H"],
                          [kin.E_wi, kin.S, kin.Sdot, J, Jd, phi, M, f, H], ref):
        _close(a.numpy(), b, name)


SCENES = {
    "scene6": (jscenes.scene_06_free2d, tscenes.scene_06_free2d),
    "scene7": (jscenes.scene_07_spherical, tscenes.scene_07_spherical),
    "scene8": (jscenes.scene_08_universal, tscenes.scene_08_universal),
    "scene9": (jscenes.scene_09_free3d, tscenes.scene_09_free3d),
    "scene11": (jscenes.scene_11_ground, tscenes.scene_11_ground),
    "uni6": (None, lambda: tscenes.scene_qdep_chain("universal", 6)),
    "sph4": (None, lambda: tscenes.scene_qdep_chain("spherical", 4)),
}


def qdep_chain_jax(jtype, njoints):
    """benchmarks/qdep_ablation.py:42-65 with redmax_tpu's builder (the
    benchmark module itself is not imported)."""
    jt = {"spherical": JJT.SPHERICAL, "universal": JJT.UNIVERSAL}[jtype]
    b = jscene.SceneBuilder(name=f"{jtype}-chain-{njoints}", h=1e-2, tEnd=0.5,
                            grav=(0.0, 0.0, -980.0))
    for i in range(njoints):
        body = b.body_cuboid(1.0, (1.0, 0.1, 0.1), E_ji=jscene.transl([0.5, 0, 0]))
        j = b.joint(jt, None if i == 0 else i - 1, body,
                    E_pj=np.eye(4) if i == 0 else jscene.transl([1.0, 0, 0]))
        b.set_damping(j, 1.0)
    return b


@pytest.mark.parametrize("scene", list(SCENES))
def test_compile_matches(scene):
    """Topology, closures, params and state0 of the port's builder against
    redmax_tpu's at 1e-12 (scene 7's exp-map qdot: the port solves with the
    closed-form Jr and the XYZ chart's closed-form S, the JAX package takes
    both from jacfwd)."""
    jb, tb = SCENES[scene]
    if jb is None:
        jb = lambda: qdep_chain_jax({"uni6": "universal", "sph4": "spherical"}[scene],
                                    {"uni6": 6, "sph4": 4}[scene])
    sc, tc = jb().compile(), tb().compile(device="cpu")
    assert tc.topo == convert.topology_from_fields(**dataclasses.asdict(sc.topo))
    assert [(type(f).__name__, vars(f)) for f in tc.force_fns] == \
        [(type(f).__name__, vars(f)) for f in sc.force_fns]
    jp, tp = _flat(jax.tree_util.tree_map(np.asarray, sc.params)), _flat(tc.params)
    assert sorted(jp) == sorted(tp)
    for k in jp:
        np.testing.assert_allclose(tp[k], jp[k], rtol=0, atol=1e-12, err_msg=k)
    np.testing.assert_allclose(tc.state0.q.numpy(), np.asarray(sc.state0.q), rtol=0, atol=1e-12)
    np.testing.assert_allclose(tc.state0.qdot.numpy(), np.asarray(sc.state0.qdot), rtol=0,
                               atol=1e-12)
    assert tc.h == sc.h and tc.tEnd == sc.tEnd and tc.Hexpected == sc.Hexpected


# tests/test_ref_traj.py BOUNDS (bdf2 p99, max) of these scenes.
REF_BOUNDS = {6: (1e-6, 1e-6), 7: (1e-6, 1e-6), 8: (1e-5, 1.2e-5), 9: (1e-6, 1e-6),
              11: (1e-6, 2e-4)}
REF_SCENES = {6: tscenes.scene_06_free2d, 7: tscenes.scene_07_spherical,
              8: tscenes.scene_08_universal, 9: tscenes.scene_09_free3d,
              11: tscenes.scene_11_ground}


@pytest.mark.parametrize("sid,use_kernel", [(6, False), (7, False), (8, False), (9, False),
                                            (11, False), (7, True), (8, True), (9, True)])
def test_bdf2_per_step_vs_ref(sid, use_kernel):
    """Every dumped step of tests/data/ref_traj_{sid}.npz is one lane, re-stepped
    in f32 from the f64 history by one batched call, the post-step reparam
    included."""
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


def test_free2d_stays_off_the_kernel():
    from redmax_tpu_torch import chord_kernel

    sc = tscenes.scene_06_free2d().compile(dtype=torch.float32, device="cpu")
    assert not chord_kernel.supports(sc.topo, (), CFG)
    with pytest.raises(ValueError):
        tint.make_bdf2_step_batched(sc.topo, (), CFG, use_kernel=True)
    assert chord_kernel.supports(qdep_mixed(tscene, TJT).compile(device="cpu").topo, (), CFG)


@pytest.mark.parametrize("use_kernel", [True, False], ids=["kernel_route", "op_level"])
def test_rollout_gradient_finite_at_zero(use_kernel):
    """Three differentiable BDF2 steps from q = qdot = 0 on the mixed chain and
    on scene 6 (FREE2D): the gradient in tau is finite and nonzero (the
    where-guarded Taylor branches keep the unused closed forms out of it)."""
    for build in (lambda: qdep_mixed(tscene, TJT), tscenes.scene_06_free2d):
        sc = build().compile(device="cpu")
        B, nr = 2, sc.topo.nr
        route = use_kernel and sc.topo.jtype[0] != int(TJT.FREE2D)
        step = tint.make_bdf2_step_batched(sc.topo, (), CFG, differentiable=True,
                                           use_kernel=route)
        tau = torch.zeros(B, nr, dtype=torch.float64, requires_grad=True)
        s0 = tint.bdf2_init(tscene.State(q=torch.zeros(B, nr, dtype=torch.float64),
                                         qdot=torch.zeros(B, nr, dtype=torch.float64)))
        out = tint.make_simulate(step, 3)({**sc.params, "tau": tau}, s0)
        (g,) = torch.autograd.grad((out.q * out.q).sum() + out.q.sum(), tau)
        assert torch.isfinite(g).all() and g.abs().max() > 0, g


def test_unported_joint_types_raise():
    """Every joint type is ported; the chord kernel has no branch for
    FREE_ST, COMPOSITE_RP and the splines, so supports() refuses their
    scenes (they run at op level), and FREE_ST carries the exp-map rescale
    of its rotation."""
    from redmax_tpu_torch import chord_kernel
    from redmax_tpu_torch.scenes_matlab import build_mscene
    for jt in (TJT.FREE_ST, TJT.COMPOSITE_RP, TJT.SPLINE_CURVE, TJT.SPLINE_SURFACE):
        b = tscene.SceneBuilder()
        b.body_cuboid(1.0, (1, 1, 1))
        kw = {TJT.COMPOSITE_RP: dict(axis1=(1, 0, 0), axis2=(1, 0, 0)),
              TJT.SPLINE_CURVE: dict(control_frames=[np.eye(4), tscene.transl([1, 0, 0])]),
              TJT.SPLINE_SURFACE: dict(control_values=np.zeros((4, 4, 6)))}.get(jt, {})
        b.joint(jt, None, 0, **kw)
        sc = b.compile(device="cpu")
        assert not chord_kernel.supports(sc.topo, (), CFG), jt
    for sid in (19, 21, 22):
        sc = build_mscene(sid, device="cpu")
        assert not chord_kernel.supports(sc.topo, sc.force_fns, CFG), sid
    q = torch.tensor([[[0.0, 0.0, 5.0, 1.0, 2.0, 3.0]]], dtype=torch.float64)
    q1, _ = joints.joint_reparam(TJT.FREE_ST, q, torch.zeros_like(q))
    assert math.isclose(float(q1[0, 0, 2]), 5.0 - 2 * math.pi)
    assert q1[0, 0, 3:].tolist() == [1.0, 2.0, 3.0]
    w = joints.reparam_exp(torch.tensor([0.0, 0.0, 5.0], dtype=torch.float64))
    assert math.isclose(float(w[2]), 5.0 - 2 * math.pi)
