"""The O(n) recursive tier of redmax_tpu_torch against redmax_tpu, in float64
on the CPU: recursive.rhd_qddot and make_minv_product against the JAX
package's (1e-10 of scale) and against torch.linalg.solve(M, .) with M from
model.assemble, on seeded numpy states (this file: scenes 0, 2, 8 of
build_scene and mscenes 10, 14, 16, 17; test_torch_recursive_zoo.py: the
other joint kinds of the ode45 certificate scenes); the prescribed (hybrid)
branch with tau read back; dynamics.compute_values against the JAX
package's jacfwd; three lanes batched against three runs of one lane. Each
JAX oracle is one jax.jit. One intra-op thread (single_thread).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from redmax_tpu import dynamics as jdyn
from redmax_tpu import model as jmodel
from redmax_tpu import recursive as jrec
from redmax_tpu import scenes as jscenes
from redmax_tpu import scenes_matlab as jms
from redmax_tpu_torch import dynamics as tdyn
from redmax_tpu_torch import model as tmodel
from redmax_tpu_torch import recursive as trec
from redmax_tpu_torch import scenes as tscenes
from redmax_tpu_torch import scenes_matlab as tms
from test_torch_certificates import single_thread  # noqa: F401


def close(a, b, tol, name):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (name, a.shape, b.shape)
    scale = max(1.0, float(np.abs(b).max())) if b.size else 1.0
    np.testing.assert_allclose(a, b, rtol=0, atol=tol * scale, err_msg=name)


def scenes_of(case):
    """(JAX scene, port scene) of ("s", sid) (build_scene) or ("m", sid)."""
    kind, sid = case
    if kind == "s":
        return jscenes.build_scene(sid), tscenes.build_scene(sid, device="cpu")
    return jms.build_mscene(sid), tms.build_mscene(sid, device="cpu")


def lanes_aux(sc, B):
    return {k: v.expand(B, *v.shape).contiguous() for k, v in sc.state0.aux.items()}


def seeded_state(js, seed=0):
    rng = np.random.default_rng(seed)
    nr = js.topo.nr
    q = np.asarray(js.state0.q) + 0.1 * rng.normal(size=nr)
    return q, rng.normal(size=nr), rng.normal(size=(3, nr))


def check_rhd_minv(case):
    """rhd_qddot and minv (3 right-hand sides) against the JAX package's and
    against the dense solve."""
    js, ts = scenes_of(case)
    q, qd, x = seeded_state(js)

    @jax.jit
    def ref(q, qd, x):
        qdd = jrec.rhd_qddot(js.topo, js.params, q, qd, js.force_fns, js.state0.aux)[0]
        kin = jmodel.forward_kinematics(js.topo, js.params, q, qd, js.state0.aux)
        return qdd, jax.vmap(jrec.make_minv_product(js.topo, js.params, kin))(x)

    qdd_ref, y_ref = ref(jnp.asarray(q), jnp.asarray(qd), jnp.asarray(x))
    tq, tqd, tx = (torch.tensor(v)[None] for v in (q, qd, x))
    aux = lanes_aux(ts, 1)
    qdd, tau = trec.rhd_qddot(ts.topo, ts.params, tq, tqd, ts.force_fns, aux)
    kin = tmodel.forward_kinematics(ts.topo, ts.params, tq, tqd, aux)
    y = trec.make_minv_product(ts.topo, ts.params, kin)(tx)
    M, f, _ = tmodel.assemble(ts.topo, ts.params, tq, tqd, ts.force_fns, aux)
    close(qdd[0], qdd_ref, 1e-10, f"{case} qddot vs JAX")
    close(qdd, torch.linalg.solve(M, f), 1e-10, f"{case} qddot vs M^-1 f")
    close(y[0], y_ref, 1e-10, f"{case} minv vs JAX")
    close(y, torch.linalg.solve(M[:, None], tx[..., None])[..., 0], 1e-10, f"{case} minv vs solve")
    assert not tau.any()
    close(trec.make_minv_product(ts.topo, ts.params, kin)(tx[:, 1]), y[:, 1], 1e-15,
          f"{case} one right-hand side")


@pytest.mark.parametrize("case", [("s", 0), ("s", 2), ("s", 8), ("m", 10), ("m", 14), ("m", 16),
                                  ("m", 17)], ids=str)
def test_rhd_and_minv_match_jax_and_dense(case):
    check_rhd_minv(case)


def test_prescribed_joint_tau_read_back():
    """A 4-link chain with joint 2 prescribed: qddot and tau against the JAX
    package's, and against the dense equations: (M qddot - f) is zero on the
    free DOFs and, on the prescribed one, tau less the joint-space force
    that f already holds there (tau read back is the joint's whole
    torque)."""
    js, ts = jscenes.scene_chain(nlinks=4).compile(), tscenes.scene_chain(nlinks=4).compile(
        device="cpu")
    q, qd, _ = seeded_state(js, 4)
    presc_qdd = np.random.default_rng(5).normal(size=js.topo.nr)
    ref = jax.jit(lambda q, qd, a: jrec.rhd_qddot(js.topo, js.params, q, qd, js.force_fns,
                                                  presc=(2,), presc_qddot=a))
    qdd_ref, tau_ref = ref(jnp.asarray(q), jnp.asarray(qd), jnp.asarray(presc_qdd))
    tq, tqd = torch.tensor(q)[None], torch.tensor(qd)[None]
    qdd, tau = trec.rhd_qddot(ts.topo, ts.params, tq, tqd, ts.force_fns, presc=(2,),
                              presc_qddot=torch.tensor(presc_qdd))
    close(qdd[0], qdd_ref, 1e-10, "qddot")
    close(tau[0], tau_ref, 1e-10, "tau")
    d = ts.topo.qstart[2]
    assert float(qdd[0, d]) == presc_qdd[d]
    M, f, _ = tmodel.assemble(ts.topo, ts.params, tq, tqd, ts.force_fns)
    resid = (M @ qdd[..., None])[..., 0] - f
    want = torch.zeros_like(resid)
    want[0, d] = tau[0, d] - tmodel.joint_space_force(ts.topo, ts.params, tq, tqd)[0, d]
    close(resid, want, 1e-10, "M qddot - f")
    assert abs(float(tau[0, d])) > 1e-3 and not tau[0, torch.arange(4) != d].any()


def test_compute_values_matches_jax():
    """(M, f, dM/dq, K, D) of the spring scene 23 (mscene) and of the
    branching tree, scene 2, against the JAX package's jacfwd."""
    for sid in (23, 2):
        js, ts = scenes_of(("m", sid))
        q, qd, _ = seeded_state(js, 2)
        ref = jax.jit(lambda q, qd: jdyn.compute_values(js.topo, js.params, q, qd, js.force_fns))
        want = ref(jnp.asarray(q), jnp.asarray(qd))
        got = tdyn.compute_values(ts.topo, ts.params, torch.tensor(q)[None],
                                  torch.tensor(qd)[None], ts.force_fns)
        for name, a, b in zip(("M", "f", "dMdq", "K", "D"), got, want):
            close(a[0], b, 1e-10, f"mscene {sid} {name}")
        M, f = tdyn.compute_Mf(ts.topo, ts.params, torch.tensor(q)[None], torch.tensor(qd)[None],
                               ts.force_fns)
        assert torch.equal(M, got[0]) and torch.equal(f, got[1])


def test_lanes_against_runs_of_one_lane():
    """Three lanes of mscene 16 (planar joint) and scene 8 batched against
    three runs of one lane: rhd_qddot and minv."""
    for case in (("m", 16), ("s", 8)):
        js, ts = scenes_of(case)
        rng = np.random.default_rng(9)
        nr = js.topo.nr
        q = torch.tensor(np.asarray(js.state0.q) + 0.2 * rng.normal(size=(3, nr)))
        qd, x = torch.tensor(rng.normal(size=(3, nr))), torch.tensor(rng.normal(size=(3, 2, nr)))
        qdd = trec.rhd_qddot(ts.topo, ts.params, q, qd, ts.force_fns)[0]
        kin = tmodel.forward_kinematics(ts.topo, ts.params, q, qd)
        y = trec.make_minv_product(ts.topo, ts.params, kin)(x)
        for b in range(3):
            one = trec.rhd_qddot(ts.topo, ts.params, q[b:b + 1], qd[b:b + 1], ts.force_fns)[0]
            kin1 = tmodel.forward_kinematics(ts.topo, ts.params, q[b:b + 1], qd[b:b + 1])
            y1 = trec.make_minv_product(ts.topo, ts.params, kin1)(x[b:b + 1])
            close(qdd[b], one[0], 1e-14, f"{case} lane {b} qddot")
            close(y[b], y1[0], 1e-14, f"{case} lane {b} minv")
