"""Five linearly implicit Euler steps at B = 4 of the feature-rich zoo's
cases that carry the newly ported features (scene functions, prescribed
motion, deformable springs, the spline and composite joints, SpringDamperM,
composite bodies, FREE2D) through make_euler_step_batched, against
jax.vmap(make_euler_step) from the same perturbed states, in float64 on the
CPU, at the tolerances of tests/test_euler_constraints.py: q at 1e-10,
qdot at 1e-8. The scene function, where the case has one, sets the params
of each step at its end time (k + 1) h in both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from redmax_tpu import integrators as jint
from redmax_tpu import scenes_matlab as jms
from redmax_tpu.types import State as JState
from redmax_tpu_torch import integrators as tint
from redmax_tpu_torch import scenes_matlab as tms
from redmax_tpu_torch.types import State
from test_torch_mscene_modules import port_of


@pytest.fixture(scope="module", autouse=True)
def single_thread():
    """torch's intra-op threads set to 1 for the module, then restored."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("sid", [5, 9, 12, 13, 19, 21, 22, 24, 25, 32, 35])
def test_euler_steps_match_vmap(sid):
    sc = jms.M_SCENES[sid]().compile()
    topo, params, fns, cons = port_of(sc)
    B, nsteps = 4, 5
    rng = np.random.default_rng(3)
    q = np.asarray(sc.state0.q)[None] + 0.05 * rng.normal(size=(B, sc.topo.nr))
    qd = np.asarray(sc.state0.qdot)[None] + 0.1 * rng.normal(size=(B, sc.topo.nr))
    jfn = getattr(jms, f"scene_fn_{sid:02d}", None)
    tfn = tms.SCENE_FNS.get(sid)

    jstep = jint.make_euler_step(sc.topo, sc.force_fns, sc.constraint_fns)
    vstep = jax.jit(jax.vmap(lambda p, s: jstep(p, s), in_axes=(None, 0)))
    sv = JState(q=jnp.asarray(q), qdot=jnp.asarray(qd), aux={})
    for k in range(nsteps):
        sv = vstep(jfn(sc.params, (k + 1) * sc.params["h"]) if jfn else sc.params, sv)

    step = tint.make_euler_step_batched(topo, fns, cons)
    final = tint.make_simulate(step, nsteps, scene_fn=tfn)(
        params, State(q=torch.tensor(q), qdot=torch.tensor(qd)))
    assert np.isfinite(np.asarray(sv.q)).all()
    np.testing.assert_allclose(final.q.numpy(), np.asarray(sv.q), rtol=0, atol=1e-10)
    np.testing.assert_allclose(final.qdot.numpy(), np.asarray(sv.qdot), rtol=0, atol=1e-8)
