"""The port's batched linearly implicit Euler step against redmax_tpu, in
float64 on the CPU.

Five steps at B = 4 of make_euler_step_batched, on its kernel route
(use_kernel=None, which on CPU tensors runs the dual-PGS kernel's plain
version) and on its op-level route (use_kernel=False), against
jax.vmap(make_euler_step) from the perturbed states of
tests/test_euler_constraints.py: q at 1e-8, qdot at 1e-6. Scenes: reference
case 4 (loop closure, dense KKT), case 6 (joint limit, PGS) and a 3-link
floor chain hanging onto its floor (floor and limit rows, PGS). Then the
Euler energy certificates of cases 4, 6 and 7 to 1e-2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from redmax_tpu import integrators as jint
from redmax_tpu.types import State as JState
from redmax_tpu_torch import integrators as tint
from redmax_tpu_torch import qp_kernel
from redmax_tpu_torch.scenes_matlab import build_mscene
from redmax_tpu_torch.types import State
from test_torch_constraints import SCENES, port_of


@pytest.fixture(scope="module", autouse=True)
def single_thread():
    """torch's intra-op threads set to 1 for the module, then restored."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# base q added to state0 (the floor chain bent down so its last link touches)
BASE = {"mscene04": 0.0, "mscene06": 0.0, "floor3": np.array([1.4, 0.3, 0.3])}


@pytest.mark.parametrize("use_kernel", [None, False], ids=["kernel_route", "op_level"])
@pytest.mark.parametrize("scene", sorted(BASE))
def test_euler_batched_matches_jax(scene, use_kernel):
    sc = SCENES[scene][0]().compile()
    topo, params, cons = port_of(sc)
    B, nsteps = 4, 5
    rng = np.random.default_rng(3)
    q = np.asarray(sc.state0.q)[None] + BASE[scene] + 0.05 * rng.normal(size=(B, sc.topo.nr))
    qd = np.asarray(sc.state0.qdot)[None] + 0.1 * rng.normal(size=(B, sc.topo.nr))

    jstep = jint.make_euler_step(sc.topo, sc.force_fns, sc.constraint_fns)
    vstep = jax.jit(jax.vmap(lambda ss: jstep(sc.params, ss)))
    sv = JState(q=jnp.asarray(q), qdot=jnp.asarray(qd), aux={})
    for _ in range(nsteps):
        sv = vstep(sv)

    step = tint.make_euler_step_batched(topo, (), cons, use_kernel=use_kernel)
    qp_kernel.dual_pgs_launches = 0
    final = tint.make_simulate(step, nsteps)(
        params, State(q=torch.tensor(q), qdot=torch.tensor(qd)))
    assert qp_kernel.dual_pgs_launches == 0  # CPU tensors never launch
    np.testing.assert_allclose(final.q.numpy(), np.asarray(sv.q), rtol=0, atol=1e-8)
    np.testing.assert_allclose(final.qdot.numpy(), np.asarray(sv.qdot), rtol=0, atol=1e-6)
    if scene == "floor3":  # the rollout went through contact, not around it
        sys = tint.euler_qp_system(topo, (), cons, params, final.q, final.qdot)
        hi = sys[2][3]
        assert torch.isinf(hi).any() and (hi == 0).any()


def test_kernel_route_selection():
    """use_kernel=True needs inequality rows; None picks the kernel route
    only for scenes that have them. A per-lane h is taken (it once raised)."""
    loop = build_mscene(4, device="cpu")
    with pytest.raises(ValueError, match="inequality"):
        tint.make_euler_step_batched(loop.topo, (), loop.constraint_fns, use_kernel=True)
    s0 = loop.initial_state("euler", B=2)
    a = tint.make_euler_step_batched(loop.topo, (), loop.constraint_fns)(loop.params, s0)
    b = loop.make_step("euler")(loop.params, s0)
    torch.testing.assert_close(a.q, b.q, rtol=0, atol=0)
    # an unconstrained scene solves Mrtilde qdot1 = frtilde directly
    free = tint.make_euler_step(loop.topo)(loop.params, s0)
    assert torch.isfinite(free.q).all() and not torch.allclose(free.q, a.q)
    # a per-lane h [B] (each lane's the shared one here) steps as the shared h
    c = loop.make_step("euler")({**loop.params, "h": loop.params["h"].expand(2)}, s0)
    torch.testing.assert_close(c.q, b.q, rtol=0, atol=0)


@pytest.mark.parametrize("sid", [4, 6, 7])
def test_euler_certificate(sid):
    """T + V - V0 after the full rollout equals the reference's Euler energy
    certificate to 1e-2."""
    sc = build_mscene(sid, device="cpu")
    s0 = sc.initial_state("euler")
    _, V0 = sc.energies(s0.q, s0.qdot)
    final = tint.make_simulate(sc.make_step("euler"), sc.nsteps)(sc.params, s0)
    T, V = sc.energies(final.q, final.qdot)
    H = float(T[0] + V[0] - V0[0])
    expected = sc.Hexpected["euler"]
    assert abs(H - expected) <= 1e-2, f"mscene {sid}: H={H!r} vs {expected!r}"
