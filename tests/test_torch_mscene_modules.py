"""Parity of the modules the feature-rich scene zoo needs with redmax_tpu, in
float64 on the CPU: the closures SpringDamperM, ForcePointDirection and
ForceDeformableSegments (wrench and energy to 1e-10), the linearly implicit
Euler system with closures (Mrtilde and frtilde to 1e-10 of scale:
SpringDamperM's matlab_KD and the strip rule, point-point springs,
spring-dampers, ground contacts), the prescribed-motion and attach-point
constraint rows with geqddot (1e-12 of scale), the joints FREE_ST,
COMPOSITE_RP, SPLINE_CURVE, SPLINE_SURFACE and make_composite (Q, S, Sdot to
1e-12 of scale), the joint_composite desugaring against the fused
COMPOSITE_RP joint, and make_simulate with scene_fn and record.

The same inputs, made from a seed with numpy, go through both packages; the
port gets the JAX scene's params, closures and constraints through
redmax_tpu_torch.convert, or builds its own where the builder is under test.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from redmax_tpu import constraints as jcon
from redmax_tpu import integrators as jint
from redmax_tpu import joints as jjoints
from redmax_tpu import model as jmodel
from redmax_tpu import scene as jscene
from redmax_tpu import scenes as jscenes
from redmax_tpu import scenes_matlab as jms
from redmax_tpu.types import NDOF
from redmax_tpu.types import JointType as JJT
from redmax_tpu.types import State as JState
from redmax_tpu_torch import constraints as tcon
from redmax_tpu_torch import convert
from redmax_tpu_torch import integrators as tint
from redmax_tpu_torch import joints as tjoints
from redmax_tpu_torch import model as tmodel
from redmax_tpu_torch import scene as tscene
from redmax_tpu_torch import scenes_matlab as tms
from redmax_tpu_torch.types import JointType as TJT
from redmax_tpu_torch.types import State


@pytest.fixture(scope="module", autouse=True)
def single_thread():
    """torch's intra-op threads set to 1 for the module, then restored."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


B = 6


def close(a, b, name, tol):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (name, a.shape, b.shape)
    scale = max(1.0, float(np.abs(b).max())) if b.size else 1.0
    np.testing.assert_allclose(a, b, rtol=0, atol=tol * scale, err_msg=name)


def port_of(sc):
    """The JAX scene's topology, params, closures and constraints in the
    port."""
    topo = convert.topology_from_fields(**dataclasses.asdict(sc.topo))
    params = convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, sc.params), "cpu")
    fns = convert.forces_from_fields([(type(f).__name__, vars(f)) for f in sc.force_fns])
    cons = convert.constraints_from_fields([(type(c).__name__, vars(c))
                                            for c in sc.constraint_fns])
    return topo, params, fns, cons


def states(sc, seed=3, qs=0.2, qds=1.0):
    rng = np.random.default_rng(seed)
    q = np.asarray(sc.state0.q)[None] + qs * rng.normal(size=(B, sc.topo.nr))
    qd = np.asarray(sc.state0.qdot)[None] + qds * rng.normal(size=(B, sc.topo.nr))
    return q, qd


def force_zoo(scene_mod, JT):
    """Every closure of the feature-rich variant and the implicit ones beside
    them: a 3-link chain with a SpringDamperM (damped) between links 0 and 2,
    a ForcePointDirection on link 1, a damped ForcePointPoint from a world
    point (strip rule), a damped ForceSpringDamper between links 1 and 2, and
    a 3-node deformable spring from a world point to link 2."""
    T = scene_mod.transl
    b = scene_mod.SceneBuilder(name="force zoo", h=1e-2, tEnd=0.1)
    for i in range(3):
        body = b.body_cuboid(1.0, (10, 1, 1), E_ji=T([5, 0, 0]))
        b.joint(JT.REVOLUTE, None if i == 0 else i - 1, body,
                E_pj=np.eye(4) if i == 0 else T([10, 0, 0]), axis=(0, 1, 0),
                q=[0.4 * (i + 1)])
    b.force_spring_damper_m(0, 2, [-2, 0, -0.5], [1, 0.5, -0.5], k=1e4, d=50.0)
    b.force_point_direction(1, [5, 0, 0], [0, 0.6, 0.8], 1e3)
    b.force_point_point(-1, 2, [0.0, 1.0, 5.0], [5, 0, 0], k=2e2, d=3.0)
    b.force_spring_damper(1, 2, [0, 0.5, 0], [3, 0, 0.5], k=1e3, d=4.0)
    b.deformable_spring(3, 1e4, 1.0, -1, [30.0, 0.0, 10.0], 2, [5.0, 0.0, 0.0])
    return b


def test_new_closures_wrench_and_energy():
    sc = force_zoo(jscene, JJT).compile()
    topo, params, fns, _ = port_of(sc)
    q, qd = states(sc)

    def jone(a, b):
        kin = jmodel.forward_kinematics(sc.topo, sc.params, a, b, {})
        _, _, phi = jmodel.jacobians(sc.topo, sc.params, kin, b)
        fm = [fn(sc.params, kin, None, phi, a, b)[1] for fn in sc.force_fns]
        return jnp.stack(fm), jnp.stack([fn.energy(sc.params, kin, a, b) for fn in sc.force_fns])

    fm_ref, V_ref = jax.jit(jax.vmap(jone))(jnp.asarray(q), jnp.asarray(qd))
    tq, tqd = torch.tensor(q), torch.tensor(qd)
    kin = tmodel.forward_kinematics(topo, params, tq, tqd)
    _, _, phi = tmodel.jacobians(topo, params, kin, tqd)
    names = [type(f).__name__ for f in fns]
    assert {"SpringDamperM", "ForcePointDirection", "ForceDeformableSegments"} <= set(names)
    for c, fn in enumerate(fns):
        fr, fm = fn(params, kin, None, phi, tq, tqd)
        assert not fr.any()
        close(fm.numpy(), np.asarray(fm_ref)[:, c], f"fm {names[c]}", 1e-10)
        close(fn.energy(params, kin, tq, tqd).numpy(), np.asarray(V_ref)[:, c],
              f"V {names[c]}", 1e-10)
    assert float(np.abs(np.asarray(V_ref)[:, names.index("SpringDamperM")]).max()) > 1.0
    assert not np.asarray(V_ref)[:, names.index("ForcePointDirection")].any()
    # the closures in the assembly and the energies, and no Newton-matrix block
    _, f, _ = tmodel.assemble(topo, params, tq, tqd, fns)
    _, V = tmodel.energies(topo, params, tq, tqd, fns)
    jf, jV = jax.jit(jax.vmap(lambda a, b: (
        jmodel.assemble(sc.topo, sc.params, a, b, sc.force_fns, {})[1],
        jmodel.energies(sc.topo, sc.params, a, b, sc.force_fns, {})[1])))(
        jnp.asarray(q), jnp.asarray(qd))
    close(f.numpy(), jf, "f", 1e-10)
    close(V.numpy(), jV, "V", 1e-10)
    explicit = tuple(f for f in fns if not getattr(f, "implicit_KD", True))
    H0 = tmodel.structured_hessian(topo, params, tq, tqd, 1.0, 1.0, ())
    H1 = tmodel.structured_hessian(topo, params, tq, tqd, 1.0, 1.0, explicit)
    torch.testing.assert_close(H1, H0, rtol=0, atol=0)


EULER_SCENES = {
    "force zoo": (lambda: force_zoo(jscene, JJT), lambda: force_zoo(tscene, TJT)),
    "mscene 24": (jms.mscene_24, tms.mscene_24),
    "mscene 23": (jms.mscene_23, tms.mscene_23),
    "mscene 10": (jms.mscene_10, tms.mscene_10),
    "mscene 12": (jms.mscene_12, tms.mscene_12),
    "spring-damper": (jscenes.scene_12_spring_damper, None),
    "chain-ground": (lambda: jscenes.scene_chain_ground(3, kn=300.0, kt=20.0, kd=5.0,
                                                        mu=0.5, floor_z=-0.02), None),
}


@pytest.mark.parametrize("scene", sorted(EULER_SCENES))
def test_euler_system_with_closures(scene):
    """Mrtilde and frtilde against JAX's euler_system (its Km, Dm by jacfwd)."""
    sc = EULER_SCENES[scene][0]().compile()
    topo, params, fns, _ = port_of(sc)
    q, qd = states(sc, qs=0.05 if scene == "chain-ground" else 0.2)
    sysj = jax.jit(jax.vmap(lambda a, b: {
        k: v for k, v in jint.euler_system(sc.topo, sc.force_fns, sc.params, a, b, {}).items()
        if k in ("Mrtilde", "frtilde")}))(jnp.asarray(q), jnp.asarray(qd))
    syst = tint.euler_system(topo, fns, params, torch.tensor(q), torch.tensor(qd))
    for k in ("Mrtilde", "frtilde"):
        close(syst[k].numpy(), sysj[k], f"{scene} {k}", 1e-10)
    # the closures moved both sides
    bare = tint.euler_system(topo, (), params, torch.tensor(q), torch.tensor(qd))
    assert not torch.allclose(bare["frtilde"], syst["frtilde"])
    if scene not in ("mscene 10", "mscene 12"):     # implicit K/D or matlab_KD
        assert not torch.allclose(bare["Mrtilde"], syst["Mrtilde"])


def presc_body(scene_mod, JT):
    """mscene 13's chain with a body-frame prescribed twist (ConstraintPrescBody)
    on the last link instead."""
    b = scene_mod.SceneBuilder(name="presc body", h=5e-2, tEnd=1.0)
    T = scene_mod.transl
    for i in range(3):
        body = b.body_cuboid(1.0, (10, 1, 1), E_ji=T([5, 0, 0]))
        b.joint(JT.REVOLUTE, None if i == 0 else i - 1, body,
                E_pj=np.eye(4) if i == 0 else T([10, 0, 0]), axis=(0, 1, 0))
    b.constraint_presc_body(2, [1, 3], [0.5, -0.2])
    return b


ROW_SCENES = {
    "mscene 9": (jms.mscene_09, jms.scene_fn_09, tms.scene_fn_09),
    "mscene 13": (jms.mscene_13, jms.scene_fn_13, tms.scene_fn_13),
    "mscene 20": (jms.mscene_20, jms.scene_fn_20, tms.scene_fn_20),
    "mscene 32": (jms.mscene_32, jms.scene_fn_32, tms.scene_fn_32),
    "mscene 12": (jms.mscene_12, None, None),
    "presc body": (lambda: presc_body(jscene, JJT), None, None),
}


@pytest.mark.parametrize("scene", sorted(ROW_SCENES))
def test_constraint_rows(scene):
    """Geq, geq, geqdot and geqddot of the new constraints against JAX's
    assemble_constraints, with each scene function's targets at t = 5 (mscene
    13's profile in its third window, mscene 20's sigmoid mid-way)."""
    make, jfn, tfn = ROW_SCENES[scene]
    sc = make().compile()
    topo, params, _, cons = port_of(sc)
    q, qd = states(sc)
    jparams = jfn(sc.params, jnp.asarray(5.0)) if jfn else sc.params
    tparams = tfn(params, torch.tensor(5.0, dtype=torch.float64)) if tfn else params

    def jone(a, b):
        kin = jmodel.forward_kinematics(sc.topo, jparams, a, b, {})
        J, _, phi = jmodel.jacobians(sc.topo, jparams, kin, b)
        return jcon.assemble_constraints(sc.constraint_fns, jparams, sc.topo, kin, phi, a, b, J)

    jrows = jax.jit(jax.vmap(jone))(jnp.asarray(q), jnp.asarray(qd))
    tq, tqd = torch.tensor(q), torch.tensor(qd)
    kin = tmodel.forward_kinematics(topo, tparams, tq, tqd)
    J, _, phi = tmodel.jacobians(topo, tparams, kin, tqd)
    trows = tcon.assemble_constraints(cons, tparams, topo, kin, phi, tq, tqd, J)
    for k in ("Geq", "geq", "geqdot", "geqddot"):
        close(trows[k].numpy(), jrows[k], f"{scene} {k}", 1e-12)
    assert float(np.abs(np.asarray(jrows["geqdot"])).max()) > 0 or scene == "mscene 12"
    if scene in ("mscene 13", "mscene 20"):
        assert float(np.abs(np.asarray(jrows["geqddot"])).max()) > 0


def _cf():
    cf = []
    for ang, p in [(math.pi, [-10, 0, 0]), (math.pi / 2, [0, 0, -2]), (0.0, [10, 0, 0]),
                   (-math.pi / 2, [0, 0, 2])]:
        E = jscenes._rot([0, 1, 0], ang)
        E[:3, 3] = p
        cf.append(E)
    return cf


def joint_params(jt):
    """The type params of a joint of type jt as both builders make them
    (checked equal), as (JAX dict, port dict [G = 1])."""
    kw = {JJT.COMPOSITE_RP: dict(axis1=(0.6, 0.8, 0.0), axis2=(0.0, 0.0, 1.0)),
          JJT.SPLINE_CURVE: dict(control_frames=_cf()),
          JJT.SPLINE_SURFACE: dict(control_values=np.random.default_rng(1).normal(
              size=(4, 4, 6)))}.get(jt, {})
    jb, tb = jscene.SceneBuilder(), tscene.SceneBuilder()
    jb.body_cuboid(1.0, (1, 1, 1))
    tb.body_cuboid(1.0, (1, 1, 1))
    jb.joint(jt, None, 0, **kw)
    tb.joint(TJT(int(jt)), None, 0, **kw)
    jp, tp = jb.joints[0].params, tb.joints[0].params
    assert sorted(jp) == sorted(tp)
    for k in jp:
        close(tp[k], jp[k], k, 1e-13)
    return ({k: jnp.asarray(v) for k, v in jp.items()},
            {k: torch.tensor(v)[None] for k, v in jp.items()})


def joint_qs(jt, rng):
    d = NDOF[jt]
    if jt == JJT.SPLINE_CURVE:     # negative, inside, past ncfs = 4, a cell boundary
        return [np.array([v]) for v in (-7.3, -0.2, 0.0, 1.0, 2.5, 3.9, 4.5, 11.2)]
    if jt == JJT.SPLINE_SURFACE:
        return [rng.uniform(-0.5, 1.5, size=d) for _ in range(6)]
    return [1.5 * rng.normal(size=d) for _ in range(6)] + [1e-3 * rng.normal(size=d)]


@pytest.mark.parametrize("jt", [JJT.FREE_ST, JJT.COMPOSITE_RP, JJT.SPLINE_CURVE,
                                JJT.SPLINE_SURFACE], ids=lambda j: j.name)
def test_joint_QSSdot(jt):
    rng = np.random.default_rng(5)
    jp, tp = joint_params(jt)
    qs = joint_qs(jt, rng)
    qds = [rng.normal(size=NDOF[jt]) for _ in qs]
    ref = jax.jit(jax.vmap(lambda q, qd: jjoints.joint_QSSdot(jt, q, qd, jp)))(
        jnp.asarray(np.stack(qs)), jnp.asarray(np.stack(qds)))
    # all lanes at once: [B, G = 1, d]
    out = tjoints.joint_QSSdot(TJT(int(jt)), torch.tensor(np.stack(qs))[:, None],
                               torch.tensor(np.stack(qds))[:, None], tp)
    for i in range(len(qs)):
        for name, a, b in zip(("Q", "S", "Sdot"), out, ref):
            close(a[i, 0].numpy(), b[i], f"{jt.name} lane {i} {name}", 1e-12)


@pytest.mark.parametrize("jt1,jt2,p1,p2", [
    (JJT.REVOLUTE, JJT.SPHERICAL, {"axis": [0.0, 1.0, 0.0]}, {}),
    (JJT.PRISMATIC, JJT.UNIVERSAL, {"axis": [1.0, 0.0, 0.0]}, {}),
], ids=["rev-sph", "prism-univ"])
def test_make_composite(jt1, jt2, p1, p2):
    """Q, S, Sdot of two joints in series against JAX's derive_S and jvp of
    the composed Q, and S against the reference's hand-assembled form
    (composite_S_reference)."""
    rng = np.random.default_rng(9)
    jpar = {"p1": {k: jnp.asarray(v) for k, v in p1.items()},
            "p2": {k: jnp.asarray(v) for k, v in p2.items()}}
    tpar = {"p1": {k: torch.tensor(v, dtype=torch.float64)[None] for k, v in p1.items()},
            "p2": {k: torch.tensor(v, dtype=torch.float64)[None] for k, v in p2.items()}}
    kern = jjoints.make_composite(jt1, jt2)
    S_fn = jjoints.derive_S(kern.Q_fn)
    fn = tjoints.make_composite(TJT(int(jt1)), TJT(int(jt2)))
    d = NDOF[jt1] + NDOF[jt2]
    q, qd = 0.8 * rng.normal(size=(4, d)), rng.normal(size=(4, d))

    def jone(x, xd):
        S, Sd = jax.jvp(lambda y: S_fn(y, jpar), (x,), (xd,))
        return kern.Q_fn(x, jpar), S, Sd, jjoints.composite_S_reference(jt1, jt2, x, jpar)

    jQ, jS, jSd, jSref = jax.jit(jax.vmap(jone))(jnp.asarray(q), jnp.asarray(qd))
    Q, S, Sd = fn(torch.tensor(q)[:, None], torch.tensor(qd)[:, None], tpar)
    close(Q[:, 0].numpy(), jQ, "Q", 1e-12)
    close(S[:, 0].numpy(), jS, "S", 1e-12)
    close(S[:, 0].numpy(), jSref, "S ref", 1e-12)
    close(Sd[:, 0].numpy(), jSd, "Sdot", 1e-12)


def test_joint_composite_desugar_matches_fused_rp():
    """SceneBuilder.joint_composite (a massless link between two joints)
    steps as the fused COMPOSITE_RP joint (tests/test_derivatives.py:274)."""
    def build(fused):
        b = tscene.SceneBuilder(name="comp", h=1e-2, tEnd=0.1, grav=(0, 0, -980.0))
        body = b.body_cuboid(1.0, (1.0, 0.1, 0.1), E_ji=tscene.transl([0.5, 0, 0]))
        if fused:
            b.joint(TJT.COMPOSITE_RP, None, body, axis1=(0, 1, 0), axis2=(1, 0, 0),
                    q=[0.3, 0.2], qdot=[0.5, -0.4])
        else:
            b.joint_composite(TJT.REVOLUTE, TJT.PRISMATIC, None, body, q=[0.3, 0.2],
                              qdot=[0.5, -0.4], p1={"axis": (0, 1, 0)}, p2={"axis": (1, 0, 0)})
        return b.compile(device="cpu")

    outs = []
    for fused in (True, False):
        sc = build(fused)
        final = tint.make_simulate(sc.make_step("bdf1"), 10)(sc.params, sc.initial_state())
        outs.append(final)
    assert outs[1].q.shape[1] == 2 and len(build(False).topo.jtype) == 2
    np.testing.assert_allclose(outs[0].q.numpy(), outs[1].q.numpy(), rtol=0, atol=1e-12)
    np.testing.assert_allclose(outs[0].qdot.numpy(), outs[1].qdot.numpy(), rtol=0, atol=1e-11)


@pytest.mark.parametrize("case", ["euler mscene 20", "bdf2 mscene 5"])
def test_make_simulate_scene_fn_record(case):
    """make_simulate(step, 5, record=True, scene_fn=...) against JAX's: the
    Euler step under scene_fn_20 (targets moving every step), and BDF2 under
    scene_fn_05 (the bootstrap sees the t = h torques)."""
    integ, _, sid = case.split()
    sid = int(sid)
    sc = jms.M_SCENES[sid]().compile()
    tsc = tms.build_mscene(sid, device="cpu")
    jfn, tfn = {20: (jms.scene_fn_20, tms.scene_fn_20), 5: (jms.scene_fn_05, tms.scene_fn_05)}[sid]
    s0 = sc.initial_state(integ)
    jstep = sc.make_step(integ)
    jfinal, (jq, jqd) = jax.jit(jint.make_simulate(jstep, 5, record=True, scene_fn=jfn))(
        sc.params, s0)
    final, (q, qd) = tint.make_simulate(tsc.make_step(integ), 5, record=True, scene_fn=tfn)(
        tsc.params, tsc.initial_state(integ))
    assert q.shape == (5, 1, sc.topo.nr) and qd.shape == q.shape
    close(q[:, 0].numpy(), jq, "q history", 1e-10)
    close(qd[:, 0].numpy(), jqd, "qdot history", 1e-8)
    close(final.q[0].numpy(), jfinal.q, "final q", 1e-10)
    # without record the same final state
    plain = tint.make_simulate(tsc.make_step(integ), 5, scene_fn=tfn)(
        tsc.params, tsc.initial_state(integ))
    torch.testing.assert_close(plain.q, final.q, rtol=0, atol=0)
    # the scene function moved the run
    still = tint.make_simulate(tsc.make_step(integ), 5)(tsc.params, tsc.initial_state(integ))
    assert not torch.allclose(still.q, final.q)
