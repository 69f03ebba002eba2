"""The feature-rich zoo's linearly implicit Euler energy certificates on
redmax_tpu_torch, in float64 on the CPU (the gate of
tests/test_euler_constraints.py, matlab/testRedMax.m:170-177): each case
runs its nsteps through the scene's Euler step (with its scene function
where it has one), one lane, and H = T_end + V_end - V_init must lie within
1e-2 of Hexpected["euler"]. Every case but the friction ones (27-31, 33)
and the OBJ ones (26, 34). Each module runs with one intra-op thread
(single_thread).
"""

import pytest

from redmax_tpu_torch import integrators as tint
from redmax_tpu_torch import scenes_matlab as tms
from test_torch_certificates import single_thread  # noqa: F401

CERTIFIED = sorted(set(tms.M_SCENES) - set(tms.FRICTION) - set(tms.OBJ_CASES))


def euler_H(sc, scene_fn=None):
    """H = T + V - V0 of one lane after the scene's nsteps Euler steps."""
    s0 = sc.initial_state("euler")
    _, V0 = sc.energies(s0.q, s0.qdot, s0.aux)
    final = tint.make_simulate(sc.make_step("euler"), sc.nsteps, scene_fn=scene_fn)(sc.params, s0)
    T, V = sc.energies(final.q, final.qdot, final.aux)
    return float(T[0] + V[0] - V0[0])


@pytest.mark.parametrize("sid", CERTIFIED)
def test_euler_certificate(sid):
    sc = tms.build_mscene(sid, device="cpu")
    H, expected = euler_H(sc, tms.SCENE_FNS.get(sid)), sc.Hexpected["euler"]
    assert abs(H - expected) <= 1e-2, f"mscene {sid}: H={H!r} vs {expected!r}"
