"""BDF1 of redmax_tpu_torch against redmax_tpu, in float64 on the CPU:
residual_bdf1 and its structured Newton matrix per lane, and one BDF1 step
(the fixed-iteration chord config and the default reference solver)
against redmax_tpu.integrators, on scene 14 (lanes past its joint limits)
and on scene 9 with its Euler-chart FREE3D joint (lanes on several charts,
some of which switch after the step), at 1e-10. The JAX oracles are jitted
once each. (The unbatched adjoint MPC that runs BDF1: test_torch_mpc_unbatched.py.)
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from redmax_tpu import integrators as jint
from redmax_tpu import scenes as jscenes
from redmax_tpu.types import State as JState
from redmax_tpu_torch import convert
from redmax_tpu_torch import integrators as tint
from redmax_tpu_torch import scenes as tscenes
from redmax_tpu_torch.types import State
from test_torch_certificates import single_thread  # noqa: F401

CFG_KW = dict(fixed_iters=3, predictor="quadratic", chord=True,
              hessian="structured", linsolve="gj")


def _close(a, b, tol, name=""):
    b = np.asarray(b, np.float64)
    np.testing.assert_allclose(np.asarray(a, np.float64), b, rtol=0,
                               atol=tol * max(1.0, float(np.abs(b).max())), err_msg=name)


def _lanes(sid, B, seed):
    """Scene sid (9 with its Euler-chart joint) in both packages and B lanes
    about its initial state: q + 0.3 N(0, 1), qdot + N(0, 1); on scene 9 the
    lanes cycle through the 12 charts with the middle rotation angle spread
    over [-1.6, 1.6], so that some lanes leave their chart; on scene 14 half
    the lanes start past a limit."""
    kw = {"exp_coords": False} if sid == 9 else {}
    jsc = jscenes.build_scene(sid, **kw)
    tsc = tscenes.build_scene(sid, device="cpu", **kw)
    rng = np.random.default_rng(seed)
    nr = tsc.topo.nr
    q = np.asarray(jsc.state0.q) + 0.3 * rng.normal(size=(B, nr))
    qd = np.asarray(jsc.state0.qdot) + rng.normal(size=(B, nr))
    aux = {}
    if sid == 9:
        q[:, 4] = np.linspace(-1.6, 1.6, B)
        aux = {"euler_chart": np.arange(B)[:, None] % 12}
    if sid == 14:
        q[::2] += rng.choice([-1.0, 1.0], size=(B // 2, 1)) * 0.4
    return jsc, tsc, q, qd, aux


@pytest.mark.parametrize("sid", [14, 9])
def test_residual_and_structured_matrix(sid):
    jsc, tsc, q, qd, aux = _lanes(sid, 12, 0)
    q1 = q + 0.01 * qd + 0.001
    jaux = {k: jnp.asarray(v, jnp.int32) for k, v in aux.items()}
    taux = convert.aux_from_numpy(aux, "cpu")

    def jfns(a, b, c, x):
        g = jint.residual_bdf1(jsc.topo, jsc.force_fns, jsc.params, a, b, c, x)
        H = jint._hess_bdf1(jsc.topo, jsc.force_fns)((jsc.params, b, c, x), a)
        return g, H

    g, H = jax.jit(jax.vmap(jfns))(jnp.asarray(q1), jnp.asarray(q), jnp.asarray(qd), jaux)
    t = torch.tensor
    g2 = tint.residual_bdf1(tsc.topo, tsc.force_fns, tsc.params, t(q1), t(q), t(qd), taux)
    H2 = tint._hess_bdf1(tsc.topo, tsc.force_fns)((tsc.params, t(q), t(qd)), t(q1), aux=taux)
    _close(g2, g, 1e-10, "g")
    _close(H2, H, 1e-10, "H")
    if sid == 14:   # the limit terms act
        hit = (q1 < float(jsc.params["qlimL"][0])) | (q1 > float(jsc.params["qlimU"][0]))
        assert 0 < hit.sum() < hit.size


@pytest.mark.parametrize("cfg", ["chord", "reference"])
@pytest.mark.parametrize("sid", [14, 9])
def test_bdf1_step(sid, cfg):
    jsc, tsc, q, qd, aux = _lanes(sid, 12, 1)
    kw = CFG_KW if cfg == "chord" else {}
    jstep = jint.make_bdf1_step(jsc.topo, jsc.force_fns, jint.NewtonConfig(**kw))
    jaux = {k: jnp.asarray(v, jnp.int32) for k, v in aux.items()}
    ref = jax.jit(jax.vmap(lambda a, b, c: jstep(jsc.params, JState(q=a, qdot=b, aux=c))))(
        jnp.asarray(q), jnp.asarray(qd), jaux)
    step = tint.make_bdf1_step(tsc.topo, tsc.force_fns, tint.NewtonConfig(**kw))
    out = step(tsc.params, State(q=torch.tensor(q), qdot=torch.tensor(qd),
                                 aux=convert.aux_from_numpy(aux, "cpu")))
    assert np.isfinite(out.q.numpy()).all()
    if sid == 9:
        charts = out.aux["euler_chart"].numpy()
        np.testing.assert_array_equal(charts, np.asarray(ref.aux["euler_chart"]))
        assert (charts != aux["euler_chart"]).sum() >= 2   # some lanes switched
    _close(out.q, ref.q, 1e-10, "q")
    _close(out.qdot, ref.qdot, 1e-10, "qdot")
    # make_step("bdf1") is this step
    s = tsc.initial_state("bdf1", B=2)
    assert isinstance(s, State) and s.q.shape == (2, tsc.topo.nr)
