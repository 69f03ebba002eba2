"""The friction step (redmax_tpu_torch.friction.make_euler_fric_step, through
CompiledScene.make_step("euler_fric")) against redmax_tpu's
make_euler_fric_step in float64 on the CPU: the first 10 steps of mscenes
27, 28 and 29 (test_torch_friction_steps_b.py: 30, 31, 33) at B = 3 lanes
around the initial state, each lane against JAX's step on that lane (jitted
once a case): q, qdot and aux["fbm"] within 1e-8 of scale; and each lane of
the batch against the one-lane run of its state within 1e-12 of scale (the
per-lane done flags freeze a converged lane's carry; the sweeps skip it).
The port takes the JAX scene's params as they come (convert). Inputs from a
numpy seed."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from redmax_tpu import scenes_matlab as jms
from redmax_tpu_torch import convert, pgs_kernel
from redmax_tpu_torch import scenes_matlab as tms
from redmax_tpu_torch.types import State

B = 3
STEPS = 10
# aux["fbm"]'s tolerance where 1e-8 of scale is below the case's own
# conditioning: in JAX's own step 6, a 1e-15 relative change of q moves fbm
# by 8.9e-9 of scale on mscene 30 and 7.6e-10 on mscene 33 (8.7e-10 at
# 1e-16; scripts/f32_departures.py conditioning SID 6), and 10 steps carry
# such differences on; q and qdot are held at 1e-8 there too.
FBM_TOL = {30: 1e-7, 33: 1e-7}


@pytest.fixture(scope="module", autouse=True)
def single_thread():
    """torch's intra-op threads set to 1 for the module, then restored."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def scale_err(got, want):
    want = np.asarray(want, dtype=np.float64)
    return float(np.abs(np.asarray(got, dtype=np.float64) - want).max()) / max(
        1.0, float(np.abs(want).max()))


def lanes0(sc, seed):
    rng = np.random.default_rng(seed)
    nr = sc.topo.nr
    q = np.asarray(sc.state0.q)[None] + 1e-2 * rng.normal(size=(B, nr))
    qd = np.asarray(sc.state0.qdot)[None] + 0.1 * rng.normal(size=(B, nr))
    return q, qd


def run_port(tc, params, q, qd, fn):
    step = tc.make_step("euler_fric")
    s = State(q=torch.tensor(q), qdot=torch.tensor(qd), aux={})
    out = []
    for k in range(STEPS):
        p = fn(params, (k + 1) * params["h"]) if fn else params
        s = step(p, s)
        out.append(s)
    return out


def check_case(sid):
    sc = jms.build_mscene(sid)
    tc = tms.build_mscene(sid, device="cpu")
    params = convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, sc.params), "cpu")
    jfn = getattr(jms, f"scene_fn_{sid}", None)
    tfn = tms.SCENE_FNS.get(sid)
    q, qd = lanes0(sc, seed=sid)
    runs = pgs_kernel.pgs_sweeps_host_runs
    batch = run_port(tc, params, q, qd, tfn)
    assert pgs_kernel.pgs_sweeps_host_runs > runs      # the sweeps ran on K3's g++ build
    jstep = jax.jit(sc.make_step("euler_fric"))
    fbm_tol = FBM_TOL.get(sid, 1e-8)
    for b in range(B):
        s = sc.state0
        s = type(s)(q=jnp.asarray(q[b]), qdot=jnp.asarray(qd[b]), aux=s.aux)
        for k in range(STEPS):
            s = jstep(jfn(sc.params, (k + 1) * sc.params["h"]) if jfn else sc.params, s)
            got = batch[k]
            for name, g, w, tol in (("q", got.q[b], s.q, 1e-8), ("qdot", got.qdot[b], s.qdot, 1e-8),
                                    ("fbm", got.aux["fbm"][b], s.aux["fbm"], fbm_tol)):
                err = scale_err(g, w)
                assert err <= tol, f"mscene {sid} lane {b} step {k} {name}: {err}"
        one = run_port(tc, params, q[b:b + 1], qd[b:b + 1], tfn)
        for k in range(STEPS):
            for name in ("q", "qdot"):
                err = scale_err(getattr(one[k], name)[0], getattr(batch[k], name)[b])
                assert err <= 1e-12, f"mscene {sid} lane {b} step {k} {name} alone: {err}"
            err = scale_err(one[k].aux["fbm"][0], batch[k].aux["fbm"][b])
            assert err <= 1e-12, f"mscene {sid} lane {b} step {k} fbm alone: {err}"


@pytest.mark.parametrize("sid", [27, 28, 29])
def test_first_steps_match_jax(sid):
    check_case(sid)
