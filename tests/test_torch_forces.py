"""Parity of redmax_tpu_torch's penalty ground contact with redmax_tpu, in
float64 on the CPU at 1e-10 of each quantity's largest magnitude.

The same states, made from a seed with numpy, go through both packages on
chain-ground-3 (a contact on every link); the port gets the JAX scene's own
params and closures through redmax_tpu_torch.convert. The states put corners
out of contact, in static friction and in dynamic friction (asserted).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from redmax_tpu import forces as jforces
from redmax_tpu import model as jmodel
from redmax_tpu import scenes as jscenes
from redmax_tpu_torch import convert
from redmax_tpu_torch import forces as tforces
from redmax_tpu_torch import model as tmodel
from redmax_tpu_torch import scene as tscene
from redmax_tpu_torch import scenes as tscenes
from redmax_tpu_torch import se3 as tse3
from test_torch_model import _close, _flat


@pytest.fixture(scope="module", autouse=True)
def single_thread():
    """torch's intra-op threads set to 1 for the module, then restored."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


GROUND = dict(nlinks=3, floor_z=-0.02, kn=300.0, kt=20.0, kd=5.0)
B = 8


def _scene(mu=0.5):
    sc = jscenes.scene_chain_ground(mu=mu, **GROUND).compile()
    topo = convert.topology_from_fields(**dataclasses.asdict(sc.topo))
    params = convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, sc.params), "cpu")
    fns = convert.forces_from_fields([(type(f).__name__, vars(f)) for f in sc.force_fns])
    return sc, topo, params, fns


def _states(nr, seed=3):
    rng = np.random.default_rng(seed)
    return 0.1 * rng.normal(size=(B, nr)), 0.3 * rng.normal(size=(B, nr))


def _kin(topo, params, q, qd):
    kin = tmodel.forward_kinematics(topo, params, q, qd)
    _, _, phi = tmodel.jacobians(topo, params, kin, qd)
    return kin, phi


def _jkin(sc, a, b):
    kin = jmodel.forward_kinematics(sc.topo, sc.params, a, b, {})
    _, _, phi = jmodel.jacobians(sc.topo, sc.params, kin, b)
    return kin, phi


@pytest.mark.parametrize("mu", [0.5, 0.0])
def test_force_and_energy_match(mu):
    """Each closure's wrench and energy against the JAX closure's, and the
    one-pass evaluation of all contacts against the sum of the closures."""
    sc, topo, params, fns = _scene(mu)
    q, qd = _states(sc.topo.nr)
    tq, tqd = torch.tensor(q), torch.tensor(qd)
    kin, phi = _kin(topo, params, tq, tqd)

    idx = tforces.body_index(tuple(f.body for f in fns), tq.device)
    s = tforces.corner_state(kin.E_wi[:, idx], phi[:, idx],
                              tforces.stack_contact_params(fns, params))
    n_out, n_sta, n_dyn = (int((s[k] == v).sum()) for k, v in
                           (("active", 0), ("sta", 1), ("dyn", 1)))
    assert n_out > 0 and int(s["active"].sum()) > 0
    assert (n_sta > 0 and n_dyn > 0) if mu else (n_sta == 0 and n_dyn == 0)

    def jone(a, b):
        kin_j, phi_j = _jkin(sc, a, b)
        fm = [fn(sc.params, kin_j, None, phi_j, a, b)[1] for fn in sc.force_fns]
        V = [fn.energy(sc.params, kin_j, a, b) for fn in sc.force_fns]
        return jnp.stack(fm), jnp.stack(V)

    fm_ref, V_ref = jax.jit(jax.vmap(jone))(jnp.asarray(q), jnp.asarray(qd))
    fm_sum = torch.zeros_like(phi)
    for c, fn in enumerate(fns):
        fr, fm = fn(params, kin, None, phi, tq, tqd)
        assert fr.shape == tq.shape and not fr.any()
        _close(fm.numpy(), np.asarray(fm_ref)[:, c], f"fm[{c}]")
        _close(fn.energy(params, kin, tq, tqd).numpy(), np.asarray(V_ref)[:, c], f"V[{c}]")
        fm_sum = fm_sum + fm
    assert float(np.abs(np.asarray(fm_ref)).max()) > 1.0
    _close(tforces.ground_contact_wrenches(fns, params, kin, phi).numpy(), fm_sum.numpy(),
           "grouped")
    _close(tforces.ground_contact_energy(fns, params, kin).numpy(),
           np.asarray(V_ref).sum(1), "grouped energy")


@pytest.mark.parametrize("margin", [False, True])
def test_blocks_match(margin):
    """ground_contact_blocks against the JAX package's, without and with the
    proximity-margin activation, a closure at a time and stacked [B, C]."""
    sc, topo, params, fns = _scene()
    q, qd = _states(sc.topo.nr)
    kin, phi = _kin(topo, params, torch.tensor(q), torch.tensor(qd))
    hg = (0.01, float(np.linalg.norm(np.asarray(sc.params["g"])))) if margin else ()

    def jone(a, b):
        kin_j, phi_j = _jkin(sc, a, b)
        out = [jforces.ground_contact_blocks(kin_j.E_wi[f.body], phi_j[f.body],
                                             sc.params["forces"][f.key],
                                             *(jnp.asarray(v) for v in hg))
               for f in sc.force_fns]
        return jnp.stack([o[0] for o in out]), jnp.stack([o[1] for o in out])

    K_ref, D_ref = jax.jit(jax.vmap(jone))(jnp.asarray(q), jnp.asarray(qd))
    thg = tuple(torch.tensor(v, dtype=torch.float64) for v in hg)
    for c, fn in enumerate(fns):
        K, D = tforces.ground_contact_blocks(kin.E_wi[:, fn.body], phi[:, fn.body],
                                             fn.p(params), *thg)
        _close(K.numpy(), np.asarray(K_ref)[:, c], f"K[{c}]")
        _close(D.numpy(), np.asarray(D_ref)[:, c], f"D[{c}]")
    idx = tforces.body_index(tuple(f.body for f in fns), phi.device)
    K, D = tforces.ground_contact_blocks(kin.E_wi[:, idx], phi[:, idx],
                                         tforces.stack_contact_params(fns, params), *thg)
    _close(K.numpy(), np.asarray(K_ref), "K stacked")
    _close(D.numpy(), np.asarray(D_ref), "D stacked")
    if margin:  # the margin reaches corners the plain activation leaves out
        K0, _ = tforces.ground_contact_blocks(kin.E_wi[:, idx], phi[:, idx],
                                              tforces.stack_contact_params(fns, params))
        assert float((K - K0).abs().max()) > 1.0


def test_blocks_match_autograd_of_the_closure():
    """The margin-free blocks are the derivatives of the port's own closure
    under E <- E exp(xi^), phi <- phi + dphi (masks frozen), the convention
    of tests/test_pallas_step.py::test_contact_blocks_match_jacfwd."""
    sc, topo, params, fns = _scene()
    q, qd = _states(sc.topo.nr)
    tq, tqd = torch.tensor(q), torch.tensor(qd)
    kin, phi = _kin(topo, params, tq, tqd)
    for fn in fns:
        b = fn.body

        def wrench(xi, dphi):
            # exp(xi^) = I + xi^ + O(xi^2): the same derivative at xi = 0
            X = torch.zeros(B, 4, 4, dtype=torch.float64)
            X[:, :3, :3] = tse3.hat3(xi[:, :3])
            X[:, :3, 3] = xi[:, 3:]
            E2 = kin.E_wi.clone()
            E2[:, b] = kin.E_wi[:, b] @ (torch.eye(4, dtype=torch.float64) + X)
            ph2 = phi.clone()
            ph2[:, b] = phi[:, b] + dphi
            return fn(params, kin._replace(E_wi=E2), None, ph2, tq, tqd)[1][:, b].sum(0)

        z = torch.zeros(B, 6, dtype=torch.float64)
        Kj, Dj = torch.autograd.functional.jacobian(wrench, (z, z))   # [6, B, 6] each
        K, D = tforces.ground_contact_blocks(kin.E_wi[:, b], phi[:, b], fn.p(params))
        assert float(K.abs().max()) > 1.0 and float(D.abs().max()) > 0.1
        np.testing.assert_allclose(K.numpy(), Kj.permute(1, 0, 2).numpy(), rtol=0, atol=1e-9)
        np.testing.assert_allclose(D.numpy(), Dj.permute(1, 0, 2).numpy(), rtol=0, atol=1e-9)


@pytest.mark.parametrize("mu", [0.5, 0.0])
def test_assembly_hessian_energies_match(mu):
    sc, topo, params, fns = _scene(mu)
    q, qd = _states(sc.topo.nr, seed=5)

    def jone(a, b):
        M, f, aux = jmodel.assemble(sc.topo, sc.params, a, b, sc.force_fns)
        H = jmodel.structured_hessian(sc.topo, sc.params, a, b, -0.3, -0.05, sc.force_fns)
        T, V = jmodel.energies(sc.topo, sc.params, a, b, sc.force_fns)
        return M, f, aux["fm"], H, T, V

    ref = jax.jit(jax.vmap(jone))(jnp.asarray(q), jnp.asarray(qd))
    tq, tqd = torch.tensor(q), torch.tensor(qd)
    M, f, aux = tmodel.assemble(topo, params, tq, tqd, fns)
    H = tmodel.structured_hessian(topo, params, tq, tqd, -0.3, -0.05, fns)
    T, V = tmodel.energies(topo, params, tq, tqd, fns)
    for name, a, b in zip(["M", "f", "fm", "H", "T", "V"], [M, f, aux["fm"], H, T, V], ref):
        _close(a.numpy(), b, name)
    # the contact terms are in: without closures f, H and V differ
    _, f0, _ = tmodel.assemble(topo, params, tq, tqd)
    H0 = tmodel.structured_hessian(topo, params, tq, tqd, -0.3, -0.05)
    assert float((f - f0).abs().max()) > 1.0 and float((H - H0).abs().max()) > 1e-3
    assert float((V - tmodel.energies(topo, params, tq, tqd)[1]).abs().max()) > 1e-3


def test_gradients_finite_at_rest():
    """A chain lying in contact at rest (qdot = 0: zero tangential velocity
    on every corner) has finite force gradients in q, qdot and tau."""
    tc = tscenes.scene_chain_ground(nlinks=3, kn=100.0, kt=0.1, kd=10.0, mu=0.5,
                                    floor_z=-0.04).compile(device="cpu")
    q = tc.state0.q.expand(2, -1).clone().requires_grad_(True)
    qd = tc.state0.qdot.expand(2, -1).clone().requires_grad_(True)
    _, f, aux = tmodel.assemble(tc.topo, tc.params, q, qd, tc.force_fns)
    assert float(aux["fm"].abs().max()) > 0          # the bottom corners penetrate
    gq, gqd = torch.autograd.grad(f.sum(), (q, qd))
    assert torch.isfinite(gq).all() and torch.isfinite(gqd).all()
    assert float(gq.abs().max()) > 0 and float(gqd.abs().max()) > 0


def test_scene_chain_ground_compile_matches():
    """The port's scene_chain_ground (all arguments, contact_links too) gives
    JAX's topology, params, closures and state0."""
    kw = dict(nlinks=5, link_len=0.8, density=1.5, damping=0.7, h=5e-3, tEnd=0.2,
              floor_z=-0.3, kn=250.0, kt=2.0, kd=7.0, mu=0.4, contact_links=(1, 3, 4))
    sc = jscenes.scene_chain_ground(**kw).compile()
    tc = tscenes.scene_chain_ground(**kw).compile(device="cpu")
    assert tc.name == sc.name and tc.h == sc.h and tc.nsteps == sc.nsteps
    assert tc.topo == convert.topology_from_fields(**dataclasses.asdict(sc.topo))
    jp, tp = _flat(jax.tree_util.tree_map(np.asarray, sc.params)), _flat(tc.params)
    assert sorted(jp) == sorted(tp) and "forces/f2/kn" in tp
    for k in jp:
        np.testing.assert_array_equal(tp[k], jp[k], err_msg=k)
    assert [(type(f).__name__, vars(f)) for f in tc.force_fns] == \
        [(type(f).__name__, vars(f)) for f in sc.force_fns]
    np.testing.assert_array_equal(tc.state0.q.numpy(), np.asarray(sc.state0.q))
    np.testing.assert_array_equal(tc.state0.qdot.numpy(), np.asarray(sc.state0.qdot))
    default = tscenes.scene_chain_ground(nlinks=2).compile(device="cpu")   # floor_z = None
    assert float(default.params["forces"]["f1"]["E"][2, 3]) == -1.5


def test_closures_waiting_for_later_items_raise():
    """Every closure of the JAX package is ported; a closure whose K/D
    blocks would need autodiff (no closed form, implicit_KD left True)
    raises in the assembly; the chord kernel refuses the closures it has no
    branch for (SpringDamperM, ForcePointDirection, ForceDeformableSegments);
    the MPPI and L-BFGS solvers are ported."""
    for name in ("SpringDamperM", "ForcePointDirection", "ForceDeformableSegments"):
        assert getattr(tforces, name).implicit_KD is False
    with pytest.raises(NotImplementedError, match="implicit_KD"):
        tmodel.assemble(None, {}, None, None, (object(),))
    from redmax_tpu_torch import chord_kernel, integrators, mpc
    from redmax_tpu_torch.scenes_matlab import build_mscene
    cfg = integrators.NewtonConfig(fixed_iters=3, chord=True, hessian="structured",
                                   linsolve="gj")
    for sid in (24, 10, 12):
        sc = build_mscene(sid, device="cpu")
        assert not chord_kernel.supports(sc.topo, sc.force_fns, cfg), sid
    assert callable(mpc.make_mpc_solver(None, method="lbfgs"))   # test_torch_lbfgs.py
    assert callable(mpc.make_mppi_solver_batched(None))     # ported (test_torch_mppi.py)
    b = tscene.SceneBuilder()
    b.body_sphere(1.0, 0.1)
    with pytest.raises(ValueError, match="cuboid"):
        b.force_ground_cuboid(0)
