"""The scene zoo of redmax_tpu_torch against redmax_tpu, in float64 on the CPU:

  * every scene of scenes.SCENES (7 and 9 both ways) and the procedural
    tree, bridge and umbrella compile to the JAX scene's topology, closures,
    constraints, params, state0 (its charts too) and certificates, at 1e-12;
  * the default NewtonConfig() (the reference solver) per step against the
    committed f64 dumps tests/data/ref_traj_*.npz, over the files' full
    lengths: the BDF2 columns of scenes 1-5 and 14 (the SDIRK2 bootstrap
    from q[0], then every inner step from the dumps' history, one lane a
    step) and the BDF1 columns of scenes 0-6, 8, 10, 12, 13 and 14 (every
    step from the dumped state, one lane a step), within 1e-9 of scale, the
    bound of test_torch_ref_semantics.py (the BDF2 columns of 0 and 6-13 are
    held there);
  * scene_tree, scene_bridge and scene_umbrella: 10 steps of the batched
    BDF2 step on the default route (on a CPU tensor the chord kernel's plain
    version) and of the BDF1 step, in the fixed-iteration chord config,
    from perturbed initial states, against the JAX package's steps at 1e-9.
"""

import dataclasses
import os

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
from test_torch_model import _flat

DATA = os.path.join(os.path.dirname(__file__), "data")
TOL = 1e-9
CFG_KW = dict(fixed_iters=3, predictor="quadratic", chord=True,
              hessian="structured", linsolve="gj")
BUILDERS = {str(sid): (lambda s=sid: jscenes.SCENES[s](), lambda s=sid: tscenes.SCENES[s]())
            for sid in sorted(tscenes.SCENES) if sid != 101}
BUILDERS.update({
    "7-euler": (lambda: jscenes.scene_07_spherical(exp_coords=False),
                lambda: tscenes.scene_07_spherical(exp_coords=False)),
    "9-euler": (lambda: jscenes.scene_09_free3d(exp_coords=False),
                lambda: tscenes.scene_09_free3d(exp_coords=False)),
    "tree": (jscenes.scene_tree, tscenes.scene_tree),
    "bridge": (jscenes.scene_bridge, tscenes.scene_bridge),
    "umbrella": (jscenes.scene_umbrella, tscenes.scene_umbrella),
})


@pytest.mark.parametrize("scene", sorted(BUILDERS))
def test_compile_matches(scene):
    jb, tb = BUILDERS[scene]
    sc, tc = jb().compile(), tb().compile(device="cpu")
    assert tc.topo == convert.topology_from_fields(**dataclasses.asdict(sc.topo))
    for mine, theirs in ((tc.force_fns, sc.force_fns), (tc.constraint_fns, sc.constraint_fns)):
        assert [type(f).__name__ for f in mine] == [type(f).__name__ for f in theirs]
    jp, tp = _flat(jax.tree_util.tree_map(np.asarray, sc.params)), _flat(tc.params)
    assert sorted(jp) == sorted(tp)
    for k in jp:
        np.testing.assert_allclose(tp[k], jp[k], rtol=0, atol=1e-12, err_msg=k)
    for name in ("q", "qdot"):
        np.testing.assert_allclose(getattr(tc.state0, name).numpy(),
                                   np.asarray(getattr(sc.state0, name)), rtol=0, atol=1e-12)
    assert sorted(tc.state0.aux) == sorted(sc.state0.aux)
    for k, v in sc.state0.aux.items():
        np.testing.assert_array_equal(tc.state0.aux[k].numpy(), np.asarray(v))
    assert (tc.h, tc.tEnd, tc.Hexpected, tc.nsteps) == (sc.h, sc.tEnd, sc.Hexpected, sc.nsteps)


def _dump(sid):
    d = np.load(os.path.join(DATA, f"ref_traj_{sid:02d}.npz"))
    sc = tscenes.build_scene(sid, device="cpu")
    return d, sc


def _t(a):
    return torch.tensor(a, dtype=torch.float64)


@pytest.mark.parametrize("sid", [1, 2, 3, 4, 5, 14])
def test_bdf2_reproduces_ref_traj(sid):
    d, sc = _dump(sid)
    q, qd = d["q_bdf2"], d["qdot_bdf2"]
    assert q.shape[0] == sc.nsteps + 1   # the file's full length
    step = sc.make_step("bdf2")
    scale = max(1.0, float(np.abs(q).max()))
    s1 = step.bootstrap(sc.params, tint.bdf2_init(State(q=_t(q[:1]), qdot=_t(qd[:1]))))
    err_boot = float(np.abs(s1.q.numpy() - q[1:2]).max()) / scale
    s = tint.Bdf2State(q=_t(q[1:-1]), qdot=_t(qd[1:-1]), q_prev=_t(q[:-2]),
                       qdot_prev=_t(qd[:-2]), k=1)
    err = np.abs(step.inner(sc.params, s).q.numpy() - q[2:]).max(axis=-1) / scale
    assert err_boot <= TOL and err.max() <= TOL, (sid, err_boot, float(err.max()),
                                                  int(err.argmax()))


@pytest.mark.parametrize("sid", [0, 1, 2, 3, 4, 5, 6, 8, 10, 12, 13, 14])
def test_bdf1_reproduces_ref_traj(sid):
    d, sc = _dump(sid)
    q, qd = d["q_bdf1"], d["qdot_bdf1"]
    assert q.shape[0] == sc.nsteps + 1
    out = sc.make_step("bdf1")(sc.params, State(q=_t(q[:-1]), qdot=_t(qd[:-1])))
    scale = max(1.0, float(np.abs(q).max()))
    err = np.abs(out.q.numpy() - q[1:]).max(axis=-1) / scale
    assert err.max() <= TOL, (sid, float(err.max()), int(err.argmax()))


@pytest.mark.parametrize("integrator", ["bdf2", "bdf1"])
@pytest.mark.parametrize("scene", ["tree", "bridge", "umbrella"])
def test_procedural_steps_match_jax(scene, integrator):
    jb, tb = BUILDERS[scene]
    sc, tc = jb().compile(), tb().compile(device="cpu")
    B, nsteps = 4, 10
    rng = np.random.default_rng(3)
    q0 = np.asarray(sc.state0.q) + 0.05 * rng.normal(size=(B, sc.topo.nr))
    qd0 = 0.3 * rng.normal(size=(B, sc.topo.nr))
    tau = 0.03 * rng.normal(size=(B, sc.topo.nr))
    jcfg, tcfg = jint.NewtonConfig(**CFG_KW), tint.NewtonConfig(**CFG_KW)
    if integrator == "bdf2":
        jstep = jint.make_bdf2_step_batched(sc.topo, sc.force_fns, jcfg, use_pallas=False)
        tstep = tint.make_bdf2_step_batched(tc.topo, tc.force_fns, tcfg)
        init_j, init_t = jint.bdf2_init, tint.bdf2_init
    else:
        jstep = jax.vmap(jint.make_bdf1_step(sc.topo, sc.force_fns, jcfg), in_axes=(
            {**{k: None for k in sc.params}, "tau": 0}, 0))
        tstep = tint.make_bdf1_step(tc.topo, tc.force_fns, tcfg)
        init_j = init_t = lambda s: s
    sim = jax.jit(jint.make_simulate(jstep, nsteps))
    ref = sim({**sc.params, "tau": jnp.asarray(tau)},
              init_j(JState(q=jnp.asarray(q0), qdot=jnp.asarray(qd0), aux={})))
    out = tint.make_simulate(tstep, nsteps)({**tc.params, "tau": _t(tau)},
                                             init_t(State(q=_t(q0), qdot=_t(qd0))))
    fin = np.isfinite(np.asarray(ref.q)).all(-1)
    np.testing.assert_array_equal(np.isfinite(out.q.numpy()).all(-1), fin)
    assert fin.sum() >= B // 2, fin
    for name in ("q", "qdot"):
        b = np.asarray(getattr(ref, name))[fin]
        np.testing.assert_allclose(getattr(out, name).numpy()[fin], b, rtol=0,
                                   atol=TOL * max(1.0, float(np.abs(b).max())), err_msg=name)
