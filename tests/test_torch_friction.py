"""redmax_tpu_torch.friction against redmax_tpu.friction in float64 on the
CPU: the ring builders and FrictionModel of the six friction cases of
scenes_matlab.py (27-31, 33) bit for bit, also through
convert.friction_model_from_fields; the per-step functions (tangent_matrix,
scatter_contact_force, contact_multipliers, loop_multipliers,
friction_bounds and friction_bounds_full) at B = 3 perturbed states a case,
each lane against JAX on that lane (one jit a case), within 1e-12 of scale;
the multipliers, and the bounds made of them, within 1e-12 or 10 eps
cond(H) of scale where that is larger (H = N Minv N^T + 1e-6 I, whose
condition numbers reach 5.7e8 in these rings: a rounding-level difference in
H moves a by as much), and JAX's multipliers solve the port's systems to
1e-12 of scale; and mscene 27 with a damped point-to-point spring added in
both packages:
Km, Dm against JAX's model.maximal_force_KD, and 5 steps against JAX's
make_euler_fric_step. Inputs from a numpy seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from redmax_tpu import friction as jfr
from redmax_tpu import model as jmodel
from redmax_tpu import scenes_matlab as jms
from redmax_tpu_torch import convert, friction, model
from redmax_tpu_torch import scenes_matlab as tms
from redmax_tpu_torch.types import State

CASES = (27, 28, 29, 30, 31, 33)
B = 3


@pytest.fixture(scope="module", autouse=True)
def single_thread():
    """torch's intra-op threads set to 1 for the module, then restored."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def close(got, want, what, tol):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    err = float(np.abs(np.asarray(got) - want).max()) if want.size else 0.0
    assert err <= tol * scale, f"{what}: {err} of scale {scale}"


def assert_models_equal(tfm, jfm):
    assert len(tfm.rings) == len(jfm.rings) and len(tfm.loop_rings) == len(jfm.loop_rings)
    for tr, jr in zip(tfm.rings + tfm.loop_rings, jfm.rings + jfm.loop_rings):
        assert type(tr).__name__ == type(jr).__name__
        for k, v in jr._asdict().items():
            if isinstance(v, np.ndarray):
                np.testing.assert_array_equal(getattr(tr, k), v, err_msg=k)
                assert getattr(tr, k).dtype == v.dtype
            else:
                assert getattr(tr, k) == v, k
    for tc, jc in ((tfm.floor_cons, jfm.floor_cons), (tfm.eq_cons, jfm.eq_cons)):
        assert [(type(c).__name__, c.key) for c in tc] == [(type(c).__name__, c.key) for c in jc]


@pytest.mark.parametrize("sid", CASES)
def test_rings_and_model_bit_for_bit(sid):
    """The port's compiled friction model equals JAX's array for array, and
    so does the one convert makes from JAX's rings; the builders alone at a
    tilted axis, sides and a radius equal JAX's too."""
    sc = jms.build_mscene(sid)
    tc = tms.build_mscene(sid, device="cpu")
    assert_models_equal(tc.friction_model, sc.friction_model)
    cons = convert.constraints_from_fields([(type(c).__name__, vars(c))
                                            for c in sc.constraint_fns])
    conv = convert.friction_model_from_fields([r._asdict() for r in sc.friction_model.rings],
                                              [r._asdict() for r in sc.friction_model.loop_rings],
                                              cons)
    assert_models_equal(conv, sc.friction_model)
    rng = np.random.default_rng(sid)
    axis = rng.normal(size=3)
    E = np.eye(4)
    E[:3, :3] = np.linalg.qr(rng.normal(size=(3, 3)))[0]
    E[:3, 3] = rng.normal(size=3)
    for tr, jr in ((friction.revolute_ring(axis, E, 0.7, 1.3),
                    jfr.revolute_ring(axis, E, 0.7, 1.3)),
                   (friction.prismatic_ring_obj(2, axis, E, (5, 0.5, 5)),
                    jfr.prismatic_ring_obj(2, axis, E, (5, 0.5, 5))),
                   (friction.spherical_ring_obj(1, E, 0.4), jfr.spherical_ring_obj(1, E, 0.4)),
                   (friction.loop_ring_obj(3, 0, E[:3, 3], axis, 2, 0.5, 0.5),
                    jfr.loop_ring_obj(3, 0, E[:3, 3], axis, 2, 0.5, 0.5))):
        for a, b in zip(tr, jr):
            if isinstance(b, np.ndarray):
                np.testing.assert_array_equal(a, b)
            else:
                assert a == b


def lane_inputs(sc, fm, seed):
    """B perturbed states of a case and random pass inputs: fam [B, 6N]
    (wrenches ~100), lam_eq [B, nem], a_floor [B, nfloor] >= 0."""
    rng = np.random.default_rng(seed)
    nr, N = sc.topo.nr, sc.topo.njoints
    nem = sum(c.n_eq_m for c in fm.eq_cons)
    q = np.asarray(sc.state0.q)[None] + 0.2 * rng.normal(size=(B, nr))
    qd = np.asarray(sc.state0.qdot)[None] + 1.0 * rng.normal(size=(B, nr))
    fam = 100.0 * rng.normal(size=(B, 6 * N))
    lam = 10.0 * rng.normal(size=(B, nem))
    afl = 50.0 * rng.uniform(size=(B, len(fm.floor_cons)))
    return q, qd, fam, lam, afl


def jax_pass_fn(sc):
    """One jit a case of JAX's per-step functions over the lanes (vmap)."""
    fm, topo = sc.friction_model, sc.topo
    h = sc.params["h"]

    def one(params, q, qd, fam, lam, afl):
        kin = jmodel.forward_kinematics(topo, params, q, qd, sc.state0.aux)
        _, _, phi = jmodel.jacobians(topo, params, kin, qd)
        T = jfr.tangent_matrix(fm, topo, kin, params, q, qd)
        fc = jfr.scatter_contact_force(fm, topo, kin, fam)
        a_r = jfr.contact_multipliers(fm, topo, params, kin, fc, h, 1e-6)
        Gs = [c.eq_m(params, topo, kin, phi, q, qd)[0] for c in fm.eq_cons]
        Gm = jnp.concatenate(Gs) if Gs else jnp.zeros((0, 6 * topo.njoints))
        a_l = jfr.loop_multipliers(fm, topo, params, kin, Gm, lam, h, 1e-6) \
            if fm.loop_rings else []
        mu_i, mu_e = params["mu"][0], params["mu"][1]
        full = jfr.friction_bounds_full(fm, a_r, a_l, afl, mu_i, mu_e, q.dtype)
        part = jfr.friction_bounds(fm, a_r, afl, mu_i, mu_e, q.dtype)
        return T, fc, a_r, a_l, full, part

    return jax.jit(jax.vmap(one, in_axes=(None, 0, 0, 0, 0, 0)))


@pytest.mark.parametrize("sid", CASES)
def test_per_step_functions_match_jax(sid):
    sc = jms.build_mscene(sid)
    tc = tms.build_mscene(sid, device="cpu")
    fm, topo = tc.friction_model, tc.topo
    q, qd, fam, lam, afl = lane_inputs(sc, fm, seed=sid)
    want = jax_pass_fn(sc)(sc.params, *(jnp.asarray(a) for a in (q, qd, fam, lam, afl)))
    params = convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, sc.params), "cpu")
    t = lambda a: torch.tensor(a, dtype=torch.float64)
    q_, qd_ = t(q), t(qd)
    kin = model.forward_kinematics(topo, params, q_, qd_, {})
    _, _, phi = model.jacobians(topo, params, kin, qd_)
    h = params["h"]
    T = friction.tangent_matrix(fm, topo, kin, params, q_, qd_)
    fc = friction.scatter_contact_force(fm, topo, kin, t(fam))
    a_r = friction.contact_multipliers(fm, topo, params, kin, fc, h, 1e-6)
    Gs = [c.eq_m(params, topo, kin, phi, q_, qd_)[0] for c in fm.eq_cons]
    Gm = torch.cat(Gs, dim=1) if Gs else q_.new_zeros(B, 0, 6 * topo.njoints)
    a_l = friction.loop_multipliers(fm, topo, params, kin, Gm, t(lam), h, 1e-6)
    mu_i, mu_e = params["mu"][0], params["mu"][1]
    full = friction.friction_bounds_full(fm, a_r, a_l, t(afl), mu_i, mu_e)
    part = friction.friction_bounds(fm, a_r, t(afl), mu_i, mu_e)
    counts = friction.row_counts(fm)
    assert T.shape == (B, counts["friction_rows"], 6 * topo.njoints)
    close(T, want[0], "tangent_matrix", 1e-12)
    close(fc, want[1], "scatter_contact_force", 1e-12)
    assert len(a_r) == len(want[2]) and len(a_l) == len(want[3])
    systems = (friction._joint_ring_systems(fm, topo, params, kin, 1e-6)
               + friction._loop_ring_systems(fm, params, kin, 1e-6))
    adT = friction._parent_adjoints(topo, kin)
    fvecs = [torch.cat([fc[:, r.joint], -friction._mv(adT[r.joint], fc[:, r.joint])], -1)
             if topo.parent[r.joint] >= 0 else fc[:, r.joint] for r in fm.rings]
    for lr in fm.loop_rings:
        rows = Gm[:, lr.eq_offset: lr.eq_offset + lr.n_rows]
        fcon = friction._mv(rows.transpose(-1, -2), t(lam)[:, lr.eq_offset:][:, :lr.n_rows]) / h
        fvecs.append(torch.cat([fcon[:, 6 * lr.bodyA:][:, :6], fcon[:, 6 * lr.bodyB:][:, :6]], -1))
    tols = []
    for k, (got, ref, sys, fvec) in enumerate(zip(a_r + a_l, list(want[2]) + list(want[3]),
                                                  systems, fvecs)):
        H = (sys.N * sys.Minv[..., None, :]) @ sys.N.transpose(-1, -2) + 1e-6 * torch.eye(
            sys.N.shape[1], dtype=torch.float64)
        fq = friction._mv(sys.N, sys.Minv * fvec) * h
        resid = friction._mv(H, t(np.asarray(ref))) - fq
        assert float(resid.abs().max()) <= 1e-12 * max(
            1.0, float(H.abs().max() * t(np.asarray(ref)).abs().max()), float(fq.abs().max())), k
        tols.append(max(1e-12, 10 * np.finfo(np.float64).eps * float(torch.linalg.cond(H).max())))
        close(got, ref, f"multipliers ring {k}", tols[-1])
    for got, ref, name in ((full, want[4], "friction_bounds_full"),
                           (part, want[5], "friction_bounds")):
        close(got[0], ref[0], name + " bl", max(tols))
        close(got[1], ref[1], name + " bu", max(tols))


def spring_27(mod):
    """mscene 27 with a damped point-to-point spring from link 0's middle to
    link 1's tip (an implicit closure: Km, Dm blocks)."""
    b = mod.mscene_27()
    b.force_point_point(0, 1, [5.0, 0.5, 0.0], [10.0, 0.0, 0.5], 2e3, 30.0)
    return b


def test_spring_closure_KD_and_steps_match_jax():
    """Km, Dm of the spring (maximal_KD, scattered closed-form blocks)
    against JAX's maximal_force_KD (jacfwd) at B perturbed states within
    1e-12 of scale; then 5 friction steps from lanes around the initial
    state against JAX's make_euler_fric_step, lane by lane, within 1e-8 of
    scale."""
    sc = spring_27(jms).compile()
    tc = spring_27(tms).compile(device="cpu")
    params = convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, sc.params), "cpu")
    fns = convert.forces_from_fields([(type(f).__name__, vars(f)) for f in sc.force_fns])
    q, qd, _, _, _ = lane_inputs(sc, tc.friction_model, seed=5)

    def jkd(q1, qd1):
        kin = jmodel.forward_kinematics(sc.topo, sc.params, q1, qd1, sc.state0.aux)
        _, _, phi = jmodel.jacobians(sc.topo, sc.params, kin, qd1)
        return jmodel.maximal_force_KD(sc.topo, sc.params, kin, phi, q1, qd1, sc.force_fns)

    Kw, Dw = jax.jit(jax.vmap(jkd))(jnp.asarray(q), jnp.asarray(qd))
    q_, qd_ = torch.tensor(q), torch.tensor(qd)
    kin = model.forward_kinematics(tc.topo, params, q_, qd_, {})
    _, _, phi = model.jacobians(tc.topo, params, kin, qd_)
    Km, Dm = friction.maximal_KD(fns, params, kin, phi)
    assert float(np.abs(np.asarray(Kw)).max()) > 1.0 and float(np.abs(np.asarray(Dw)).max()) > 1.0
    close(Km, Kw, "Km", 1e-12)
    close(Dm, Dw, "Dm", 1e-12)

    jstep = jax.jit(sc.make_step("euler_fric"))
    step = friction.make_euler_fric_step(tc.topo, fns, tc.friction_model)
    rng = np.random.default_rng(7)
    q0 = np.asarray(sc.state0.q)[None] + 0.05 * rng.normal(size=(B, sc.topo.nr))
    qd0 = np.asarray(sc.state0.qdot)[None] + 0.5 * rng.normal(size=(B, sc.topo.nr))
    s = State(q=torch.tensor(q0), qdot=torch.tensor(qd0), aux={})
    js = [type(sc.state0)(q=jnp.asarray(q0[b]), qdot=jnp.asarray(qd0[b]), aux=sc.state0.aux)
          for b in range(B)]
    for k in range(5):
        s = step(params, s)
        js = [jstep(sc.params, x) for x in js]
        for b in range(B):
            close(s.q[b], js[b].q, f"q step {k} lane {b}", 1e-8)
            close(s.qdot[b], js[b].qdot, f"qdot step {k} lane {b}", 1e-8)
            close(s.aux["fbm"][b], js[b].aux["fbm"], f"fbm step {k} lane {b}", 1e-8)
