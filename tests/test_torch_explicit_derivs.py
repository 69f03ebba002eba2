"""The two ode45 derivatives of redmax_tpu_torch (explicit.make_deriv_dense
and make_deriv_recursive) against redmax_tpu's, in float64 on the CPU, at a
seeded state of each ode45 certificate scene (1e-10 of scale; mscene 12 has
no recursive derivative, as in the reference), and the constraint rates
Gdot qdot (explicit.constraint_rates, forward-mode AD) against jax.jvp on
the scenes with constraint rows: mscenes 4 and 15 (ConstraintLoop) and 12
(ConstraintAttachPoint), at 1e-10. This file: the first half of the
scenes; test_torch_explicit_derivs_b.py: the rest. Each scene's JAX oracle
is one jax.jit. One intra-op thread (single_thread).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from redmax_tpu import explicit as jex
from redmax_tpu import model as jmodel
from redmax_tpu import scenes_matlab as jms
from redmax_tpu.constraints import assemble_constraints as jassemble_constraints
from redmax_tpu_torch import explicit as tex
from redmax_tpu_torch import scenes_matlab as tms
from test_torch_certificates import single_thread  # noqa: F401
from test_torch_recursive import close

# mscene 12: the reference skips the recursive oracle (deformables)
DENSE_ONLY = (12,)


def check_derivs(sid):
    js, ts = jms.build_mscene(sid), tms.build_mscene(sid, device="cpu")
    nr = js.topo.nr
    rng = np.random.default_rng(sid + 10)
    y = np.concatenate([np.asarray(js.state0.q) + 0.05 * rng.normal(size=nr),
                        np.asarray(js.state0.qdot) + 0.5 * rng.normal(size=nr)])
    aux = js.state0.aux
    dd = jex.make_deriv_dense(js.topo, js.force_fns, js.constraint_fns)
    dr = jex.make_deriv_recursive(js.topo, js.force_fns, js.constraint_fns)

    def rate(y):
        q, qdot = y[:nr], y[nr:]

        def Gq(qq):
            kin = jmodel.forward_kinematics(js.topo, js.params, qq, qdot, aux)
            J, _, phi = jmodel.jacobians(js.topo, js.params, kin, qdot)
            return jassemble_constraints(js.constraint_fns, js.params, js.topo, kin, phi, qq,
                                         qdot, J)["Geq"] @ qdot

        return jax.jvp(Gq, (q,), (qdot,))[1]

    @jax.jit
    def ref(y):
        out = {"dense": dd(js.params, 0.0, y, aux)}
        if sid not in DENSE_ONLY:
            out["recursive"] = dr(js.params, 0.0, y, aux)
        if js.constraint_fns:
            out["rate"] = rate(y)
        return out

    want = ref(jnp.asarray(y))
    ty = torch.tensor(y)[None]
    t = torch.zeros(1, dtype=torch.float64)
    taux = {k: v[None] for k, v in ts.state0.aux.items()}
    got = {"dense": tex.make_deriv_dense(ts.topo, ts.force_fns, ts.constraint_fns)(
        ts.params, t, ty, taux)}
    if sid not in DENSE_ONLY:
        got["recursive"] = tex.make_deriv_recursive(ts.topo, ts.force_fns, ts.constraint_fns)(
            ts.params, t, ty, taux)
    if ts.constraint_fns:
        got["rate"] = tex.constraint_rates(ts.topo, ts.params, ts.constraint_fns, ty[:, :nr],
                                           ty[:, nr:], taux)[1]
        assert float(got["rate"].abs().max()) > 0
    assert set(got) == set(want)
    for name in got:
        close(got[name][0], want[name], 1e-10, f"mscene {sid} {name}")


@pytest.mark.parametrize("sid", [-1, 0, 1, 2, 4, 10, 11, 12, 14, 15])
def test_derivs_match_jax(sid):
    check_derivs(sid)
