"""The feature-rich scene zoo (scenes_matlab.py) on redmax_tpu_torch against
redmax_tpu, in float64 on the CPU: every case that compiles here (all but
the OBJ cases 26, 34, which test_torch_mesh.py builds on an OBJ it writes)
compiles to JAX's topology, params (through convert), closures, constraints
and initial state; its linearly implicit Euler system and constraint rows at
seeded states match JAX's at 1e-10 of scale. The friction cases (27-31, 33)
compile with their friction model (the row counts of each case) and an
euler_fric step (test_torch_friction*.py hold them against JAX).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from redmax_tpu import constraints as jcon
from redmax_tpu import integrators as jint
from redmax_tpu import scenes_matlab as jms
from redmax_tpu_torch import chord_kernel, friction
from redmax_tpu_torch import constraints as tcon
from redmax_tpu_torch import integrators as tint
from redmax_tpu_torch import scenes_matlab as tms
from test_torch_model import _flat
from test_torch_mscene_modules import close, port_of


@pytest.fixture(scope="module", autouse=True)
def single_thread():
    """torch's intra-op threads set to 1 for the module, then restored."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


COMPILED = sorted(set(jms.M_SCENES) - set(tms.OBJ_CASES))
# (joint rings, loop rings, floors, maximal equality rows, friction rows) of
# each friction case
FRICTION_ROWS = {27: (2, 0, 0, 0, 32), 28: (2, 0, 0, 0, 24), 29: (2, 0, 0, 0, 32),
                 30: (4, 1, 0, 2, 80), 31: (2, 0, 1, 0, 34), 33: (3, 1, 4, 3, 72)}


def test_registry_matches():
    """The same ids, names, h, tEnd, gravity, Baumgarte factors and
    certificates as the JAX package's zoo, and a scene function where it has
    one."""
    assert sorted(tms.M_SCENES) == sorted(jms.M_SCENES)
    for sid in sorted(jms.M_SCENES):
        if sid in tms.OBJ_CASES:
            continue
        jb, tb = jms.M_SCENES[sid](), tms.M_SCENES[sid]()
        assert (tb.name, tb.h, tb.tEnd, tb.fric) == (jb.name, jb.h, jb.tEnd, jb.fric)
        np.testing.assert_array_equal(tb.grav, jb.grav)
        np.testing.assert_array_equal(tb.baumgarte, jb.baumgarte)
        np.testing.assert_array_equal(tb.mu, jb.mu)
        assert tb.Hexpected == jb.Hexpected, sid
    assert sorted(tms.SCENE_FNS) == [5, 9, 13, 20, 32, 33]
    for sid in tms.OBJ_CASES:
        with pytest.raises(FileNotFoundError, match="obj="):
            tms.build_mscene(sid, device="cpu")


@pytest.mark.parametrize("sid", tms.FRICTION)
def test_friction_cases_raise_at_compile(sid):
    """Each friction case compiles (it raised before friction.py was
    ported): its friction model has the case's rows, aux["fbm"] starts at
    zeros [6N], and make_step("euler_fric") returns a step."""
    b = tms.M_SCENES[sid]()
    assert b.fric
    sc = b.compile(device="cpu")
    counts = friction.row_counts(sc.friction_model)
    assert tuple(counts[k] for k in ("rings", "loop_rings", "floors", "eq_rows",
                                     "friction_rows")) == FRICTION_ROWS[sid]
    torch.testing.assert_close(sc.state0.aux["fbm"],
                               torch.zeros(6 * sc.topo.njoints, dtype=torch.float64))
    assert sc.initial_state("euler", B=3).aux["fbm"].shape == (3, 6 * sc.topo.njoints)
    assert callable(sc.make_step("euler_fric"))


@pytest.mark.parametrize("sid", COMPILED)
def test_compile_matches(sid):
    sc = jms.M_SCENES[sid]().compile()
    tc = tms.build_mscene(sid, device="cpu")
    assert tc.topo == port_of(sc)[0]
    jp, tp = _flat(jax.tree_util.tree_map(np.asarray, sc.params)), _flat(tc.params)
    assert sorted(jp) == sorted(tp)
    for k in jp:
        close(tp[k], jp[k], k, 1e-13)
    _, _, fns, cons = port_of(sc)
    assert [(type(f).__name__, vars(f)) for f in tc.force_fns] == \
        [(type(f).__name__, vars(f)) for f in fns]
    assert [(type(c).__name__, vars(c)) for c in tc.constraint_fns] == \
        [(type(c).__name__, vars(c)) for c in cons]
    close(tc.state0.q.numpy(), sc.state0.q, "q0", 1e-13)
    np.testing.assert_array_equal(tc.state0.qdot.numpy(), np.asarray(sc.state0.qdot))
    assert (tc.nsteps, tc.Hexpected) == (sc.nsteps, sc.Hexpected)
    # the chord kernel takes none of the new joints and closures
    new = {"SpringDamperM", "ForcePointDirection", "ForceDeformableSegments"}
    if set(tc.topo.jtype) & {10, 12, 13, 14} or {type(f).__name__ for f in tc.force_fns} & new:
        cfg = tint.NewtonConfig(fixed_iters=3, chord=True, hessian="structured", linsolve="gj")
        assert not chord_kernel.supports(tc.topo, tc.force_fns, cfg)


@pytest.mark.parametrize("sid", COMPILED)
def test_euler_system_and_rows_match(sid):
    """Mrtilde, frtilde and the constraint rows (with geqddot) at seeded
    states, the scene function's targets at t = 5 where there is one."""
    sc = jms.M_SCENES[sid]().compile()
    topo, params, fns, cons = port_of(sc)
    rng = np.random.default_rng(sid + 10)
    B = 4
    q = np.asarray(sc.state0.q)[None] + 0.1 * rng.normal(size=(B, sc.topo.nr))
    qd = np.asarray(sc.state0.qdot)[None] + 0.5 * rng.normal(size=(B, sc.topo.nr))
    jfn = getattr(jms, f"scene_fn_{sid:02d}", None)
    jparams = jfn(sc.params, jnp.asarray(5.0)) if jfn else sc.params
    tfn = tms.SCENE_FNS.get(sid)
    tparams = tfn(params, torch.tensor(5.0, dtype=torch.float64)) if tfn else params

    def jone(a, b):
        sys = jint.euler_system(sc.topo, sc.force_fns, jparams, a, b, {})
        rows = jcon.assemble_constraints(sc.constraint_fns, jparams, sc.topo, sys["kin"],
                                         sys["phi"], a, b, sys["J"])
        return sys["Mrtilde"], sys["frtilde"], rows

    jM, jf, jrows = jax.jit(jax.vmap(jone))(jnp.asarray(q), jnp.asarray(qd))
    tq, tqd = torch.tensor(q), torch.tensor(qd)
    sys = tint.euler_system(topo, fns, tparams, tq, tqd)
    close(sys["Mrtilde"].numpy(), jM, "Mrtilde", 1e-10)
    close(sys["frtilde"].numpy(), jf, "frtilde", 1e-10)
    rows = tcon.assemble_constraints(cons, tparams, topo, sys["kin"], sys["phi"], tq, tqd,
                                     sys["J"])
    for k in ("Geq", "geq", "geqdot", "geqddot", "Cin", "cin"):
        close(rows[k].numpy(), jrows[k], k, 1e-10)
