"""Parity of redmax_tpu_torch's Euler-chart ball joints with redmax_tpu, in
float64 on the CPU:

  * euler.euler_R, euler_T (with its closed-form time derivative against
    jax.jvp of the JAX euler_T), euler_inv_all and reparam_spherical at
    every one of the 12 charts, lanes that switch charts and lanes that do
    not, at 1e-12;
  * Q, S and Sdot of SPHERICAL_EULER and FREE3D_EULER against
    redmax_tpu.joints.joint_QSSdot (Sdot: jax.jvp of S) at 1e-12, each lane
    on its own chart;
  * model.reparam_all with the BDF2 history (q_prev, qdot_prev) and the
    charts in aux on a chain of both Euler-chart types and an exp-map joint,
    against redmax_tpu.model.reparam_all, on lanes that switch and lanes
    that do not, and the assembly (M, f) at those charts;
  * the gradient of euler_inv_all at a clipped argument, as jnp.clip gives it.

The JAX side runs under one jax.jit per oracle.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from redmax_tpu import euler as jeuler
from redmax_tpu import joints as jjoints
from redmax_tpu import model as jmodel
from redmax_tpu import scene as jscene
from redmax_tpu.types import JointType as JJT
from redmax_tpu_torch import convert, euler
from redmax_tpu_torch import joints as tjoints
from redmax_tpu_torch import model as tmodel
from redmax_tpu_torch import scene as tscene
from redmax_tpu_torch.types import JointType as TJT
from test_torch_certificates import single_thread  # noqa: F401

TOL = 1e-12


def _close(a, b, tol=TOL, name=""):
    b = np.asarray(b, np.float64)
    np.testing.assert_allclose(np.asarray(a, np.float64), b, rtol=0,
                               atol=tol * max(1.0, float(np.abs(b).max())), err_msg=name)


def _middle(charts, rng, switch):
    """Middle angles for charts [...]: |det T| (|cos q2| on a Tait-Bryan
    chart, |sin q2| on a proper one) above 0.62, so that the chart stays,
    and 0.29 where switch (a mask) holds, so that the lane leaves it."""
    proper = jeuler._PROPER[charts]
    sign = rng.choice([-1.0, 1.0], size=charts.shape)
    keep = np.where(proper, rng.uniform(0.7, np.pi - 0.7, size=charts.shape),
                    sign * rng.uniform(0.0, 0.9, size=charts.shape))
    near = np.where(proper, 0.295, sign * (np.pi / 2 - 0.295))
    return np.where(switch, near, keep)


def _samples(B, seed, switch):
    """Charts cycling through all 12, angles N(0, 1) and rates N(0, 2), the
    middle angle of _middle; with switch, every other lane leaves its chart."""
    rng = np.random.default_rng(seed)
    charts = np.arange(B) % 12
    q, qd = rng.normal(size=(B, 3)), 2.0 * rng.normal(size=(B, 3))
    q[:, 1] = _middle(charts, rng, switch & (np.arange(B) % 2 == 0))
    q1, qd1 = q - 0.01 * qd, qd + 0.1 * rng.normal(size=(B, 3))
    return charts, q, qd, q1, qd1


def _hold_switch(out, ref):
    """Hold reparam_spherical's (chart, q, qdot, q1, qdot1) [..., 3] against
    JAX's: equal charts and the angles at 1e-12 where the two chose the same
    chart. Where they did not, the two charts tie (mathematically equal
    scores: XYX and XZX both score |sin acos R[x, x]|, and so on), and each
    package's roundoff broke the tie its own way; there the two must tie to
    1e-12 and give the same rotations and body angular velocities, current
    and previous. Such lanes stay under a tenth."""
    ref = [torch.tensor(np.asarray(a)) for a in ref]
    same = out[0] == ref[0]
    assert float(same.double().mean()) >= 0.9, same
    for name, a, b in zip(("q", "qdot", "q1", "qdot1"), out[1:], ref[1:]):
        _close(a[same], b[same], name=name)
    if same.all():
        return
    d = ~same
    w = lambda c, x, v: (euler.euler_T(c, x) @ v[..., None])[..., 0]
    for qi, vi in ((1, 2), (3, 4)):
        _close(euler.euler_R(out[0][d], out[qi][d]), euler.euler_R(ref[0][d], ref[qi][d]),
               name="tie: R")
        _close(w(out[0][d], out[qi][d], out[vi][d]), w(ref[0][d], ref[qi][d], ref[vi][d]),
               tol=1e-11, name="tie: w")
    for qi in (1, 3):
        _close(euler.euler_detT(out[0][d], out[qi][d]).abs(),
               euler.euler_detT(ref[0][d], ref[qi][d]).abs(), name="tie: |det T|")


@jax.jit
def _jax_chart_fns(charts, q, qd):
    R = jax.vmap(jeuler.euler_R)(charts, q)
    T = jax.vmap(jeuler.euler_T)(charts, q)
    Td = jax.vmap(lambda c, x, v: jax.jvp(lambda y: jeuler.euler_T(c, y), (x,), (v,))[1])(
        charts, q, qd)
    return R, T, Td, jax.vmap(jeuler.euler_inv_all)(R)


_jax_reparam = jax.jit(jax.vmap(jeuler.reparam_spherical))


def test_euler_R_T_inv_every_chart():
    charts, q, qd, _, _ = _samples(48, 0, switch=False)
    R, T, Td, inv = _jax_chart_fns(jnp.asarray(charts, jnp.int32), jnp.asarray(q),
                                   jnp.asarray(qd))
    tc, tq, tqd = torch.tensor(charts), torch.tensor(q), torch.tensor(qd)
    T2, Td2 = euler.euler_T_and_dot(tc, tq, tqd)
    _close(euler.euler_R(tc, tq), R, name="R")
    _close(T2, T, name="T")
    _close(Td2, Td, name="Tdot")
    _close(euler.euler_detT(tc, tq), np.linalg.det(np.asarray(T)), name="detT")
    inv2 = euler.euler_inv_all(torch.tensor(np.asarray(R)))
    _close(inv2, inv, name="euler_inv_all")
    # each chart's own angles come back where q lies inside its principal range
    _close(euler.euler_R(torch.arange(12).expand(48, 12), inv2),
           np.broadcast_to(np.asarray(R)[:, None], (48, 12, 3, 3)), tol=1e-10, name="R(inv)")
    np.testing.assert_array_equal(euler.AXES, jeuler.AXES)
    np.testing.assert_array_equal(euler.EPS_SIGN, jeuler.EPS_SIGN)


@pytest.mark.parametrize("switch", [False, True])
def test_reparam_spherical_every_chart(switch):
    charts, q, qd, q1, qd1 = _samples(48, 1, switch)
    ref = _jax_reparam(jnp.asarray(charts, jnp.int32), *(jnp.asarray(a) for a in (q, qd, q1, qd1)))
    out = euler.reparam_spherical(torch.tensor(charts),
                                  *(torch.tensor(a) for a in (q, qd, q1, qd1)))
    _hold_switch(out, ref)
    moved = out[0].numpy() != charts
    if switch:
        assert moved[::2].all() and not moved[1::2].any()
        # the remapped state is the same rotation and body angular velocity
        _close(euler.euler_R(out[0], out[1]), euler.euler_R(torch.tensor(charts),
                                                            torch.tensor(q)), name="same R")
        w = lambda c, x, v: (euler.euler_T(c, x) @ v[..., None])[..., 0]
        _close(w(out[0], out[1], out[2]), w(torch.tensor(charts), torch.tensor(q),
                                            torch.tensor(qd)), tol=1e-11, name="same w")
    else:
        assert not moved.any()


@pytest.mark.parametrize("jt", ["SPHERICAL_EULER", "FREE3D_EULER"])
def test_joint_QSSdot_matches_jvp(jt):
    d = 3 if jt == "SPHERICAL_EULER" else 6
    rng = np.random.default_rng(2)
    B = 36
    charts = np.arange(B) % 12
    q, qd = rng.normal(size=(B, d)), 2.0 * rng.normal(size=(B, d))
    ref = jax.jit(jax.vmap(lambda c, x, v: jjoints.joint_QSSdot(getattr(JJT, jt), x, v,
                                                                {"chart": c})))(
        jnp.asarray(charts, jnp.int32), jnp.asarray(q), jnp.asarray(qd))
    # the port's groups are [B, G, d]: one joint a lane here
    out = tjoints.joint_QSSdot(getattr(TJT, jt), torch.tensor(q)[:, None],
                               torch.tensor(qd)[:, None], {"chart": torch.tensor(charts)[:, None]})
    for name, a, b in zip(("Q", "S", "Sdot"), out, ref):
        _close(a[:, 0], b, name=name)


def euler_chain(mod, JT):
    """A FREE3D_EULER root, a SPHERICAL_EULER joint and an exp-map SPHERICAL
    joint (N = 3, nr = 12), built with either package's SceneBuilder."""
    T = mod.transl
    b = mod.SceneBuilder(name="euler-chain", h=1e-2, tEnd=0.1, grav=(0.0, 0.0, -980.0))
    for i, jt in enumerate((JT.FREE3D_EULER, JT.SPHERICAL_EULER, JT.SPHERICAL)):
        body = b.body_cuboid(1.0, (1.0, 0.1, 0.1), E_ji=T([0.5, 0, 0]))
        b.joint(jt, None if i == 0 else i - 1, body, E_pj=np.eye(4) if i == 0 else T([1.0, 0, 0]))
        b.set_damping(i, 1.0)
    return b


def test_reparam_all_with_history_matches_jax():
    """Both Euler-chart joints of every lane start on a random chart; on
    half the lanes the middle angle of each sits where |det T| = 0.29, so
    those switch charts and remap q_prev and qdot_prev; the exp-map joint
    rescales where |w| > 1.5 pi. Then M and f at the new charts."""
    sc = euler_chain(jscene, JJT).compile()
    topo = convert.topology_from_fields(**dataclasses.asdict(sc.topo))
    params = convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, sc.params), "cpu")
    B, nr = 24, sc.topo.nr
    rng = np.random.default_rng(3)
    charts = rng.integers(0, 12, size=(B, 2))
    q, qd = rng.normal(size=(B, nr)), 2.0 * rng.normal(size=(B, nr))
    q[:, [4, 7]] = _middle(charts, rng, (np.arange(B) % 2 == 0)[:, None])
    q[:4, 9:12] *= 6.0   # |w| past 1.5 pi on a few lanes
    qp, qdp = q - 0.01 * qd, qd + 0.1 * rng.normal(size=(B, nr))
    aux = {"euler_chart": jnp.asarray(charts, jnp.int32)}
    ref = jax.jit(jax.vmap(lambda a, b, c, d, e: jmodel.reparam_all(
        sc.topo, sc.params, a, b, c, d, e)))(
        jnp.asarray(q), jnp.asarray(qd), aux, jnp.asarray(qp), jnp.asarray(qdp))
    t = torch.tensor
    out = tmodel.reparam_all(topo, params, t(q), t(qd), {"euler_chart": t(charts)}, t(qp), t(qdp))
    # each Euler-chart joint's rotation (q[3:6] of the FREE3D_EULER root,
    # q[6:9] of the SPHERICAL_EULER joint) by _hold_switch; the rest as it is
    for k, rot in enumerate((slice(3, 6), slice(6, 9))):
        _hold_switch([out[2]["euler_chart"][:, k]] + [a[:, rot] for a in out[:2] + out[3:]],
                     [ref[2]["euler_chart"][:, k]] + [a[:, rot] for a in ref[:2] + ref[3:]])
    rest = np.r_[0:3, 9:12]
    for name, a, b in zip(("q", "qdot", "q_prev", "qdot_prev"), out[:2] + out[3:],
                          ref[:2] + ref[3:]):
        _close(a[:, rest], np.asarray(b)[:, rest], name=name)
    switched = (out[2]["euler_chart"].numpy() != charts).any(-1)
    assert switched[::2].all() and not switched[1::2].any()
    # the history of the lanes that did not switch is untouched
    np.testing.assert_array_equal(out[3][1::2].numpy(), qp[1::2])
    M, f, _ = jax.jit(jax.vmap(lambda a, b, c: jmodel.assemble(sc.topo, sc.params, a, b, (), c)))(
        ref[0], ref[1], ref[2])
    M2, f2, _ = tmodel.assemble(topo, params, t(np.asarray(ref[0])), t(np.asarray(ref[1])), (),
                                {"euler_chart": t(np.asarray(ref[2]["euler_chart"]))})
    _close(M2, M, tol=1e-10, name="M")
    _close(f2, f, tol=1e-10, name="f")
    with pytest.raises(ValueError, match="Euler-chart joints"):
        tmodel.assemble(topo, params, out[0], out[1])


def test_compile_state0_aux():
    """SceneBuilder.compile starts every Euler-chart joint on the default
    chart (XYZ), as the JAX package does; initial_state gives each lane its
    copy; convert carries a JAX state's charts across as int64."""
    jsc = euler_chain(jscene, JJT).compile()
    tsc = euler_chain(tscene, TJT).compile(device="cpu")
    charts = convert.aux_from_numpy({k: np.asarray(v) for k, v in jsc.state0.aux.items()}, "cpu")
    assert charts["euler_chart"].dtype == torch.int64
    np.testing.assert_array_equal(tsc.state0.aux["euler_chart"].numpy(),
                                  charts["euler_chart"].numpy())
    assert tsc.initial_state("bdf2", B=3).aux["euler_chart"].shape == (3, 2)


def test_clip_gradient_matches_jnp_clip():
    """d asin(clip(x)) / dx inside, at the bound and past it (jnp.clip's
    gradient: 1 at the bound, 0 past it; past it 0 * inf = NaN)."""
    xs = np.array([0.3, 1.0, 1.0 + 1e-12, -1.0, -1.0 - 1e-12])
    ref = jax.vmap(jax.grad(lambda x: jnp.arcsin(jnp.clip(x, -1.0, 1.0))))(jnp.asarray(xs))
    xt = torch.tensor(xs, requires_grad=True)
    (g,) = torch.autograd.grad(torch.asin(euler._clip_unit(xt)).sum(), xt)
    np.testing.assert_array_equal(np.isnan(g.numpy()), np.isnan(np.asarray(ref)))
    np.testing.assert_array_equal(np.isinf(g.numpy()), np.isinf(np.asarray(ref)))
    fin = np.isfinite(np.asarray(ref))
    _close(g.numpy()[fin], np.asarray(ref)[fin], name="grad")
