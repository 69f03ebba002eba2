"""Parity of redmax_tpu_torch's scene compile, SE(3) helpers, kinematics and
assembly with redmax_tpu, in float64 on the CPU.

The same inputs, made from a seed with numpy, go through both packages; the
port gets the JAX scene's own params through redmax_tpu_torch.convert.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from redmax_tpu import model as jmodel
from redmax_tpu import scene as jscene
from redmax_tpu import se3 as jse3
from redmax_tpu import scenes as jscenes
from redmax_tpu.types import JointType as JJT
from redmax_tpu_torch import convert
from redmax_tpu_torch import model as tmodel
from redmax_tpu_torch import scene as tscene
from redmax_tpu_torch import scenes as tscenes
from redmax_tpu_torch import se3 as tse3
from redmax_tpu_torch.types import JointType as TJT


@pytest.fixture(scope="module", autouse=True)
def single_thread():
    """torch's intra-op threads set to 1 for the module, then restored."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ATOL = 1e-10  # relative to each quantity's largest magnitude (f64 roundoff)


def mixed_builder(scene_mod, JT):
    """Every constant-S joint type (revolute, prismatic, fixed, planar,
    translational), with joint stiffness and damping, a penalty joint limit
    and body damping; built with either package's SceneBuilder (N = 6,
    nr = 8)."""
    T = scene_mod.transl
    b = scene_mod.SceneBuilder(name="mix", h=1e-2, tEnd=0.1, grav=(0.0, 0.0, -980.0))
    b.body_cuboid(1.0, (1.0, 0.1, 0.1), E_ji=T([0.5, 0, 0]))
    b.joint(JT.REVOLUTE, None, 0, axis=(0, 1, 0))
    b.body_cuboid(1.0, (1.0, 0.1, 0.1), E_ji=T([0.5, 0, 0]))
    b.joint(JT.PRISMATIC, 0, 1, E_pj=T([1.0, 0, 0]), axis=(1, 0, 0))
    b.set_limits(1, lower=-0.2, upper=0.2, k=1e3, d=5.0)
    b.body_cuboid(1.0, (0.5, 0.1, 0.1), E_ji=T([0.25, 0, 0]))
    b.joint(JT.FIXED, 1, 2, E_pj=T([1.0, 0, 0]))
    b.body_cuboid(1.0, (1.0, 0.1, 0.1), E_ji=T([0.5, 0, 0]))
    b.joint(JT.REVOLUTE, 2, 3, E_pj=T([0.5, 0, 0]), axis=(0, 0, 1))
    b.set_damping(3, 0.5)
    b.set_stiffness(3, 10.0)
    b.set_body_damping(3, 0.2)
    b.body_cuboid(1.0, (0.6, 0.1, 0.1), E_ji=T([0.3, 0, 0]))
    b.joint(JT.PLANAR, 3, 4, E_pj=T([1.0, 0, 0]), plane=np.array([[1.0, 0, 0], [0, 0, 1.0]]).T)
    b.set_stiffness(4, 25.0)
    b.set_damping(4, 0.3)
    b.body_cuboid(1.0, (0.4, 0.1, 0.1), E_ji=T([0.2, 0, 0]))
    b.joint(JT.TRANSLATIONAL, 4, 5, E_pj=T([0.6, 0, 0]))
    b.set_stiffness(5, 40.0)
    b.set_damping(5, 0.5)
    return b


SCENES = {
    "chain4": (lambda: jscenes.scene_chain(nlinks=4), lambda: tscenes.scene_chain(nlinks=4)),
    "scene0": (jscenes.scene_00_serial_chain, tscenes.scene_00_serial_chain),
    "chain12": (lambda: jscenes.scene_chain(nlinks=12), lambda: tscenes.scene_chain(nlinks=12)),
    "mixed": (lambda: mixed_builder(jscene, JJT), lambda: mixed_builder(tscene, TJT)),
}


def _port(sc):
    """The JAX scene's topology and params carried across to the port."""
    topo = convert.topology_from_fields(**dataclasses.asdict(sc.topo))
    params = convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, sc.params), "cpu")
    return topo, params


def _close(a, b, name):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (name, a.shape, b.shape)
    scale = max(1.0, float(np.abs(b).max()))
    np.testing.assert_allclose(a, b, rtol=0, atol=ATOL * scale, err_msg=name)


def _flat(d, prefix=""):
    out = {}
    for k, v in d.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


@pytest.mark.parametrize("scene", ["chain12", "scene0", "mixed"])
def test_compile_matches(scene):
    """The port's own SceneBuilder.compile gives JAX's topology, params and
    state0, and convert carries JAX's params across unchanged."""
    jb, tb = SCENES[scene]
    sc = jb().compile()
    tc = tb().compile(device="cpu")
    assert tc.topo == convert.topology_from_fields(**dataclasses.asdict(sc.topo))
    jp, tp = _flat(jax.tree_util.tree_map(np.asarray, sc.params)), _flat(tc.params)
    assert sorted(jp) == sorted(tp)
    for k in jp:
        np.testing.assert_array_equal(tp[k], jp[k], err_msg=k)
    _, cparams = _port(sc)
    for k, v in _flat(cparams).items():
        np.testing.assert_array_equal(v, jp[k], err_msg=k)
    np.testing.assert_array_equal(tc.state0.q.numpy(), np.asarray(sc.state0.q))
    np.testing.assert_array_equal(tc.state0.qdot.numpy(), np.asarray(sc.state0.qdot))
    assert tc.topo.doubling_rounds()[0].tolist() == sc.topo.doubling_rounds()[0].tolist()


def test_se3_matches():
    rng = np.random.default_rng(0)
    E = np.asarray(jse3.exp(jnp.asarray(rng.normal(size=(5, 6)))))
    phi = rng.normal(size=(5, 6))
    # exp_so3 across its Taylor switch-over and at 0
    w = rng.normal(size=(6, 3)) * np.array([[1.0], [1e-3], [1e-5], [1e-9], [0.0], [3.0]])
    tE, tphi, tw = (torch.tensor(a) for a in (E, phi, w))
    _close(tse3.inv(tE), jse3.inv(E), "inv")
    _close(tse3.Ad(tE), jse3.Ad(E), "Ad")
    _close(tse3.ad(tphi), jse3.ad(phi), "ad")
    _close(tse3.hat3(tphi[:, :3]), jse3.hat3(phi[:, :3]), "hat3")
    _close(tse3.make_E(tE[:, :3, :3], tE[:, :3, 3]), jse3.make_E(E[:, :3, :3], E[:, :3, 3]), "make_E")
    _close(tse3.exp_so3(tw), jse3.exp_so3(jnp.asarray(w)), "exp_so3")


@pytest.mark.parametrize("scene", ["chain4", "scene0", "mixed"])
def test_kinematics_and_assembly_match(scene):
    """FK E_wi, J, Jdot, phi, M, f and the structured H at random (q, qdot),
    B = 8 lanes (q = 0 included, where every scene starts)."""
    sc = SCENES[scene][0]().compile()
    topo, params = _port(sc)
    B, nr = 8, sc.topo.nr
    rng = np.random.default_rng(1)
    q = rng.normal(size=(B, nr))
    q[0] = 0.0
    qd = rng.normal(size=(B, nr))
    tq, tqd = torch.tensor(q), torch.tensor(qd)

    def jone(a, b):
        kin = jmodel.forward_kinematics(sc.topo, sc.params, a, b, {})
        J, Jd, phi = jmodel.jacobians(sc.topo, sc.params, kin, b)
        M, f, _ = jmodel.assemble(sc.topo, sc.params, a, b)
        H = jmodel.structured_hessian(sc.topo, sc.params, a, b, -0.3, -0.05)
        return kin.E_wi, J, Jd, phi, M, f, H

    ref = jax.jit(jax.vmap(jone))(jnp.asarray(q), jnp.asarray(qd))
    kin = tmodel.forward_kinematics(topo, params, tq, tqd)
    J, Jd, phi = tmodel.jacobians(topo, params, kin, tqd)
    M, f, _ = tmodel.assemble(topo, params, tq, tqd)
    H = tmodel.structured_hessian(topo, params, tq, tqd, -0.3, -0.05)
    for name, a, b in zip(["E_wi", "J", "Jdot", "phi", "M", "f", "H"],
                          [kin.E_wi, J, Jd, phi, M, f, H], ref):
        _close(a.numpy(), b, name)


def test_index_tensors_are_cached_per_topology_and_device():
    """The kinematics build their index tensors once per (topology, device):
    a second call makes none anew (on a GPU each would be a blocking
    host-to-device copy)."""
    tc = tscenes.scene_chain(nlinks=4).compile(device="cpu")
    q = torch.zeros(2, 4, dtype=torch.float64)
    tmodel.assemble(tc.topo, tc.params, q, q)
    misses = tmodel._index_tensors.cache_info().misses
    index = tmodel._index_tensors(tc.topo, q.device)
    tmodel.assemble(tc.topo, tc.params, q + 0.1, q)
    tmodel.structured_hessian(tc.topo, tc.params, q, q, -0.3, -0.05)
    assert tmodel._index_tensors.cache_info().misses == misses
    assert tmodel._index_tensors(tc.topo, q.device) is index
    assert index.anc.dtype == torch.bool and index.anc.shape == (4, 4)
