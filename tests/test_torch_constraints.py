"""Parity of redmax_tpu_torch's constraint rows and linearly implicit Euler
system with redmax_tpu, in float64 on the CPU at 1e-10 of each quantity's
scale.

Scenes: a 3-link floor chain (joint-limit and floor rows), reference cases
4 (loop closure), 6 (joint limit) and 7 (gear couplings), and a scene with
every constant-S joint type, an active penalty limit, body damping and a
joint-limit plus a gear row. The same states, made from a seed with numpy,
go through both packages; the port gets the JAX scene's params and
constraint objects through redmax_tpu_torch.convert, and its own
SceneBuilder must compile the same params.
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
from redmax_tpu import scene as jscene
from redmax_tpu import scenes_matlab as jms
from redmax_tpu.types import JointType as JJT
from redmax_tpu_torch import constraints as tcon
from redmax_tpu_torch import convert
from redmax_tpu_torch import integrators as tint
from redmax_tpu_torch import scene as tscene
from redmax_tpu_torch import scenes as tscenes
from redmax_tpu_torch import scenes_matlab as tms
from redmax_tpu_torch.types import JointType as TJT
from test_torch_model import _flat, mixed_builder


@pytest.fixture(scope="module", autouse=True)
def single_thread():
    """torch's intra-op threads set to 1 for the module, then restored."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ATOL = 1e-10


def floor_chain_scene(scene_mod, JT, nlinks):
    """benchmarks/bench_qp.py's floor_chain with either package's SceneBuilder."""
    T = scene_mod.transl
    b = scene_mod.SceneBuilder(name="floor-chain-%d" % nlinks, h=1e-2, tEnd=0.5,
                               grav=(0.0, 0.0, -980.0))
    for i in range(nlinks):
        body = b.body_cuboid(1.0, (1.0, 0.1, 0.1), E_ji=T([0.5, 0, 0]))
        j = b.joint(JT.REVOLUTE, None if i == 0 else 2 * (i - 1), body,
                    E_pj=np.eye(4) if i == 0 else T([1.0, 0, 0]), axis=(0, 1, 0))
        b.set_damping(j, 1.0)
        b.constraint_joint_limit(j, -0.6 * math.pi, 0.6 * math.pi)
        s = b.body_sphere(0.1, 0.1)
        b.joint(JT.FIXED, j, s, E_pj=T([0.5, 0, 0]))
        b.constraint_floor(s, E=T([0, 0, -2.0]))
    return b


def mixed_constrained(scene_mod, JT):
    b = mixed_builder(scene_mod, JT)
    b.constraint_joint_limit(3, -0.3, 0.3)
    b.constraint_multq(0, 3, 0.5)
    return b


# name -> (the scene in the JAX package, the scene in the port)
SCENES = {
    "floor3": (lambda: floor_chain_scene(jscene, JJT, 3), lambda: tscenes.scene_floor_chain(3)),
    "mscene04": (jms.mscene_04, tms.mscene_04),
    "mscene06": (jms.mscene_06, tms.mscene_06),
    "mscene07": (jms.mscene_07, tms.mscene_07),
    "mixed": (lambda: mixed_constrained(jscene, JJT), lambda: mixed_constrained(tscene, TJT)),
}


def port_of(sc, dtype=torch.float64):
    """The JAX scene's topology, params and constraints carried to the port."""
    topo = convert.topology_from_fields(**dataclasses.asdict(sc.topo))
    params = convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, sc.params),
                                       "cpu", dtype)
    cons = convert.constraints_from_fields(
        [(type(c).__name__, vars(c)) for c in sc.constraint_fns])
    return topo, params, cons


def spread_states(sc, B=6, seed=3):
    """Lanes from near state0 to far from it, so that limits and contacts
    are active on some lanes and inactive on others."""
    rng = np.random.default_rng(seed)
    scale = np.array([0.05, 0.05, 0.5, 1.0, 1.5, 2.0])[:B, None]
    q = np.asarray(sc.state0.q)[None] + scale * rng.normal(size=(B, sc.topo.nr))
    qd = np.asarray(sc.state0.qdot)[None] + rng.normal(size=(B, sc.topo.nr))
    return q, qd


def _close(a, b, name):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (name, a.shape, b.shape)
    scale = max(1.0, float(np.abs(b).max())) if b.size else 1.0
    np.testing.assert_allclose(a, b, rtol=0, atol=ATOL * scale, err_msg=name)


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_compile_matches(scene):
    """The port's SceneBuilder gives JAX's params (constraints included) and the
    same constraint objects as convert rebuilds from JAX's."""
    sc = SCENES[scene][0]().compile()
    tc = SCENES[scene][1]().compile(device="cpu")
    jp, tp = _flat(jax.tree_util.tree_map(np.asarray, sc.params)), _flat(tc.params)
    assert sorted(jp) == sorted(tp)
    assert any(k.startswith("constraints/") for k in tp)
    for k in jp:
        np.testing.assert_array_equal(tp[k], jp[k], err_msg=k)
    _, _, cons = port_of(sc)
    assert [(type(c).__name__, vars(c)) for c in tc.constraint_fns] == \
        [(type(c).__name__, vars(c)) for c in cons]
    np.testing.assert_array_equal(tc.state0.qdot.numpy(), np.asarray(sc.state0.qdot))


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_rows_and_euler_system_match(scene):
    sc = SCENES[scene][0]().compile()
    topo, params, cons = port_of(sc)
    q, qd = spread_states(sc)
    if scene == "mixed":
        q[:3, 1], q[3:, 1] = 0.5, -0.4   # the prismatic joint beyond its penalty limit

    def jone(a, b):
        sys = jint.euler_system(sc.topo, sc.force_fns, sc.params, a, b, {})
        rows = jcon.assemble_constraints(sc.constraint_fns, sc.params, sc.topo, sys["kin"],
                                         sys["phi"], a, b, sys["J"])
        return {k: sys[k] for k in ("Mr", "Mrtilde", "frtilde")}, rows

    jsys, jrows = jax.jit(jax.vmap(jone))(jnp.asarray(q), jnp.asarray(qd))
    tq, tqd = torch.tensor(q), torch.tensor(qd)
    tsys = tint.euler_system(topo, (), params, tq, tqd)
    trows = tcon.assemble_constraints(cons, params, topo, tsys["kin"], tsys["phi"],
                                      tq, tqd, tsys["J"])
    for k, v in jsys.items():
        _close(tsys[k].numpy(), v, k)
    for k in ("Geq", "geq", "geqdot", "Cin", "cin"):
        _close(trows[k].numpy(), jrows[k], k)
    act = np.asarray(jrows["act"])
    np.testing.assert_array_equal(trows["act"].numpy(), act)
    if act.size:
        assert act.any() and not act.all(), "the states exercise no activity switch"
    if scene == "mixed":
        hit = (q < np.asarray(sc.params["qlimL"])) | (q > np.asarray(sc.params["qlimU"]))
        assert hit[:, 1].all() and float(sc.params["body_damping"].max()) > 0


def test_constraints_waiting_for_later_items_raise():
    """The constraint subsystem's rows are all ported (every constraint class
    of the JAX package has its counterpart), and so is friction, which used
    to raise here: a scene with frictional floor contact (31) and the driven
    walker (33) compile, their floor and maximal equality constraints in
    their friction model, and give an euler_fric step; a scene compiled
    without fric has no friction model, and its euler_fric step raises."""
    for name in ("ConstraintPrescJoint", "ConstraintPrescBody", "ConstraintPrescJointM",
                 "ConstraintPrescBodyW", "ConstraintAttachPoint"):
        assert getattr(jcon, name).__name__ == getattr(tcon, name).__name__
    for sid in (31, 33):        # frictional floor contact; the driven walker
        b = tms.M_SCENES[sid]()
        assert any(type(c).__name__ in ("ConstraintFloor", "ConstraintPrescJointM")
                   for c, _ in b.constraints)
        sc = b.compile(device="cpu")
        fm = sc.friction_model
        assert fm.floor_cons == tuple(c for c in sc.constraint_fns
                                      if isinstance(c, tcon.ConstraintFloor))
        assert fm.eq_cons == tuple(c for c in sc.constraint_fns if c.n_eq_m)
        assert callable(sc.make_step("euler_fric"))
    sc6 = tms.build_mscene(6, device="cpu")
    assert sc6.friction_model is None
    with pytest.raises(ValueError, match="euler_fric"):
        sc6.make_step("euler_fric")
