"""The benchmark's plain reference of the spring chain
(portbench/reference/forces/point_springs.py and
reference/scenes/scene_spring_chain.py) against the port, in float64 on the
CPU, and the port's counters and span for what the scene adds:

  * the reference's spring wrenches and K/D blocks, the cross-body ones
    included, equal forces.pair_closure_wrenches and pair_closure_blocks at
    seeded random states, with the scene's springs and with both
    spring-dampers tension-only (some slack);
  * the reference equals the port's op-level route (use_kernel=False) on the
    spring_chain12 configuration for both mixes at B = 6, horizon and steps
    8, to rtol 1e-10 and atol 1e-12; with the sign of one cross-body block
    flipped in the reference, that comparison fails;
  * the reference's chord_work equals chord_kernel.closure_spec, and the
    harness's frozen operation count equals chip_smoke.lane_flops on the
    port's spec;
  * adjoint.vjp.oplevel.<reason>: one reason an op-level VJP, the first that
    applies (bootstrap, the scene's refusal: joints, closures, width; route,
    params, grad), on CPU horizon-5 Adam solves and small gradients;
  * one forces.pair_closures span a pair-closure evaluation inside
    metrics.tracing(), and none on a scene without springs or cables.

Every case runs with one intra-op thread.
"""

import os
from collections import Counter
from functools import lru_cache

import pytest
import torch

from portbench.harness import spec
from portbench.harness.cell import chord_flops_per_lane, reference_outputs
from portbench.harness.program import Program
from portbench.harness.traffic import make_inputs
from portbench.reference import articulated
from portbench.reference.forces.point_springs import PointSprings
from portbench.reference.scenes import scene_spring_chain as ref_scene
from redmax_tpu_torch import chord_kernel, forces, integrators, metrics, model, mpc
from redmax_tpu_torch.scenes import scene_chain, scene_qdep_chain, scene_spring_chain
from redmax_tpu_torch.types import State

CFG = integrators.NewtonConfig(fixed_iters=3, predictor="quadratic", chord=True,
                               hessian="structured", linsolve="gj")
F64 = torch.float64


@pytest.fixture(scope="module", autouse=True)
def single_thread():
    """torch's intra-op threads set to 1 for the module, then restored."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def config(dtype="float64"):
    cfg = spec.load_json(os.path.join(spec.BENCH, "configs", "spring_chain12.json"))
    return {**cfg, "dtype": dtype}


@lru_cache(maxsize=None)
def port_scene():
    return scene_spring_chain(12).compile(dtype=F64, device="cpu")


def random_state(B=5, seed=3):
    gen = torch.Generator().manual_seed(seed)
    return (0.4 * torch.randn(B, 12, generator=gen, dtype=F64),
            2.0 * torch.randn(B, 12, generator=gen, dtype=F64))


def tension_only(fns, springs):
    """The port's closures and the reference's springs with both
    spring-dampers tension-only."""
    fns = tuple(forces.ForceSpringDamper(f.key, f.body1, f.body2, tension_only=True)
                if isinstance(f, forces.ForceSpringDamper) else f for f in fns)
    return fns, PointSprings([{**s, "tension": s["kind"] == 1} for s in springs.springs])


def dense(pairs, B, N):
    """Blocks [B, N, N, 6, 6] summed by (body j, body i)."""
    out = torch.zeros(B, N, N, 6, 6, dtype=F64)
    for bj, bi, K in pairs:
        out[:, bj, bi] += K
    return out


@pytest.mark.parametrize("tension", [False, True], ids=["scene", "tension_only"])
def test_wrenches_and_blocks_equal_the_port(tension):
    sc = port_scene()
    ref = ref_scene.build(config()["args"], F64, "cpu")
    springs = ref.closures[0]
    fns = sc.force_fns
    if tension:
        fns, springs = tension_only(fns, springs)
    q, qdot = random_state()
    q[0] = 0.0
    q[0, 0] = 0.3          # lane 0 swung down about y: the world-to-tip spring stretched
    kin = model.forward_kinematics(sc.topo, sc.params, q, qdot)
    _, _, phi = model.jacobians(sc.topo, sc.params, kin, qdot)
    E_wi, _, _, rphi = articulated.kinematics(ref, q, qdot)
    torch.testing.assert_close(E_wi, kin.E_wi, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(rphi, phi, rtol=1e-12, atol=1e-12)
    want = forces.pair_closure_wrenches(fns, sc.params, kin, phi)
    got = springs.wrenches(E_wi, rphi)
    assert want.abs().max() > 1.0
    torch.testing.assert_close(got, want, rtol=1e-11, atol=1e-9)
    Kp, Dp, bj, bi = forces.pair_closure_blocks(fns, sc.params, kin, phi)
    mine = springs.pair_blocks(E_wi, rphi)
    assert any(a != b for a, b, _, _ in mine)               # cross-body pairs are there
    B, N = q.shape
    for k, port in ((2, Kp), (3, Dp)):
        want = dense(zip(bj, bi, port.unbind(1)), B, N)
        got = dense(((p[0], p[1], p[k]) for p in mine), B, N)
        torch.testing.assert_close(got, want, rtol=1e-11, atol=1e-8)
    if tension:   # the spring-dampers are slack on some lanes and stretched on others
        L = torch.tensor([s["L"] for s in springs.springs if s["kind"] == 1], dtype=F64)
        ends = (("b1", "xl1"), ("b2", "xl2"))
        x = [[springs._point(E_wi, rphi, s[b], s[xl])[0] for b, xl in ends]
             for s in springs.springs if s["kind"] == 1]
        lengths = torch.stack([torch.linalg.vector_norm(b - a, dim=-1) for a, b in x], -1)
        assert (lengths < L).any() and (lengths > L).any()


def port_op_level(cfg, traffic, inputs):
    """The port's op-level float64 route on the configuration's outputs."""
    prog = Program(cfg, "cpu")
    B = next(iter(inputs.values())).shape[0]
    s0 = prog.rest(B)
    if traffic["mode"] == "mpc":
        obj = mpc.make_objective_batched(prog.topo, prog.force_fns, prog.task,
                                         tuple(cfg["task"]["xlocal"]), traffic["horizon"],
                                         prog.cfg, use_kernel=False)
        r = mpc.make_mpc_solver_batched(obj, iters=1, lr=traffic["lr"])(
            prog.params, inputs["P0"], s0, inputs["targets"])
        return {"objective": r.objective, "grad_norm": r.grad_norm, "p": r.p}
    step = integrators.make_bdf2_step_batched(prog.topo, prog.force_fns, prog.cfg,
                                              use_kernel=False)
    with torch.no_grad():
        s = integrators.make_simulate(step, traffic["steps"])(
            {**prog.params, "tau": inputs["tau"]}, integrators.bdf2_init(s0))
    return {"q": s.q, "qdot": s.qdot}


def mix(name):
    traffic = spec.load_json(os.path.join(spec.BENCH, "traffic", name + ".json"))
    return {**traffic, "B": 6, "horizon": 8, "steps": 8, "ref_lanes": 6}


def compare(mix_name):
    cfg, traffic = config(), mix(mix_name)
    inputs = make_inputs(traffic, {"B": 6, "nr": 12}, 11, "cpu", F64)[0]
    ref = reference_outputs(cfg, traffic, inputs, "cpu")
    for k, v in port_op_level(cfg, traffic, inputs).items():
        torch.testing.assert_close(v, ref[k], rtol=1e-10, atol=1e-12, equal_nan=True)


@pytest.mark.parametrize("mix_name", ["mpc_b32768_h50", "rollout_b32768_n500"])
def test_reference_equals_port_op_level_f64(mix_name):
    compare(mix_name)


def test_a_sign_error_in_a_cross_block_fails(monkeypatch):
    """The comparison sees the cross-body blocks: with the stiffness block of
    one pair of distinct bodies negated, the MPC outputs depart."""
    real = PointSprings.pair_blocks

    def planted(self, E_wi, phi):
        out = real(self, E_wi, phi)
        k = next(n for n, (bj, bi, _, _) in enumerate(out) if bj != bi)
        bj, bi, K, D = out[k]
        out[k] = (bj, bi, -K, D)
        return out

    monkeypatch.setattr(PointSprings, "pair_blocks", planted)
    with pytest.raises(AssertionError):
        compare("mpc_b32768_h50")


def test_chord_work_and_the_frozen_count():
    import chip_smoke
    sc = port_scene()
    ref = ref_scene.build(config()["args"], F64, "cpu")
    contacts, springs, cables = chord_kernel.closure_spec(sc.topo, sc.force_fns)
    work = ref.chord_work()
    assert (work["contacts"], work["springs"], work["cables"]) == (len(contacts), springs, cables)
    assert work["springs"] == ((1, -1, 11, 0), (1, 2, 8, 0), (0, 5, 11, 0))
    prog = Program(config("float32"), "cpu")
    want = chip_smoke.lane_flops(prog.topo, prog.cfg.fixed_iters, len(contacts), springs,
                                 cables, chip_smoke.mode_of(prog.cfg))
    assert chord_flops_per_lane(config("float32")) == want == 159183


def moved(before):
    after = metrics.counters()
    return {k: after[k] - before.get(k, 0) for k in after
            if k.startswith("adjoint.vjp") and after[k] != before.get(k, 0)}


def adam_counts(sc, horizon=5, B=4):
    obj = mpc.make_objective_batched(sc.topo, sc.force_fns, mpc.PointPosTask(body=11, pscale=1e3),
                                     (0.5, 0.0, 0.0), horizon, CFG)
    gen = torch.Generator().manual_seed(0)
    P0 = 3e-3 * torch.randn(B, sc.topo.nr, generator=gen, dtype=F64)
    targets = torch.rand(B, 3, generator=gen, dtype=F64)
    before = metrics.counters()
    solve = mpc.make_mpc_solver_batched(obj, iters=1, lr=0.05)
    solve(sc.params, P0, sc.initial_state("euler", B=B), targets)
    return moved(before)


def test_reasons_of_an_adam_solve():
    assert adam_counts(port_scene()) == {"adjoint.vjp.oplevel": 6,
                                         "adjoint.vjp.oplevel.closures": 4,
                                         "adjoint.vjp.oplevel.bootstrap": 2}
    assert adam_counts(scene_chain(12).compile(dtype=F64, device="cpu")) == {
        "adjoint.vjp.kernel": 4, "adjoint.vjp.oplevel": 2, "adjoint.vjp.oplevel.bootstrap": 2}


@lru_cache(maxsize=None)
def chain(n):
    return scene_chain(n).compile(dtype=F64, device="cpu")


REASONS = {   # (scene, params, use_kernel) -> the reason of the 3 inner steps' VJPs
    "joints": (lambda: (scene_qdep_chain("universal", 2).compile(dtype=F64, device="cpu"), None,
                        None), "joints"),
    "width": (lambda: (chain(33), None, None), "width"),
    "route": (lambda: (chain(4), None, False), "route"),
    "params": (lambda: (chain(4), {**chain(4).params,
                                   "I_i": chain(4).params["I_i"].expand(2, -1, -1).contiguous()},
                        None), "params"),
    "grad": (lambda: (chain(4), {**chain(4).params,
                                 "g": chain(4).params["g"].clone().requires_grad_()},
                      None), "grad"),
    "params_then_grad": (lambda: (chain(4), {**chain(4).params,
                                             "I_i": chain(4).params["I_i"].expand(2, -1, -1)
                                             .contiguous().requires_grad_()}, None), "params"),
}


@pytest.mark.parametrize("case", list(REASONS))
def test_the_first_reason_that_applies(case):
    """A horizon-4 objective gradient: the bootstrap's 2 VJPs and the 3 inner
    steps' under their reason, each op-level VJP under one reason."""
    make, reason = REASONS[case]
    sc, params, use_kernel = make()
    params = sc.params if params is None else params
    B, horizon = 2, 4
    obj = mpc.make_objective_batched(sc.topo, sc.force_fns,
                                     mpc.PointPosTask(body=sc.topo.njoints - 1, pscale=1e3),
                                     (0.5, 0.0, 0.0), horizon, CFG, use_kernel=use_kernel)
    P = torch.full((B, sc.topo.nr), 1e-3, dtype=F64, requires_grad=True)
    s0 = State(q=sc.state0.q.expand(B, -1).contiguous(),
               qdot=sc.state0.qdot.expand(B, -1).contiguous(),
               aux={k: v.expand(B, *v.shape).contiguous() for k, v in sc.state0.aux.items()})
    leaves = [P] + [v for v in params.values() if torch.is_tensor(v) and v.requires_grad]
    before = metrics.counters()
    torch.autograd.grad(obj(params, P, s0, torch.zeros(B, 3, dtype=F64)).sum(), leaves)
    assert moved(before) == {"adjoint.vjp.oplevel": horizon + 1,
                             "adjoint.vjp.oplevel.bootstrap": 2,
                             "adjoint.vjp.oplevel." + reason: horizon - 1}


def pair_spans(sc, B=3):
    """Names of the spans of one model.assemble, one model.structured_hessian
    and one integrators.closure_blocks on the scene, inside tracing()."""
    q, qdot = random_state(B)
    metrics.clear_spans()
    with metrics.tracing():
        model.assemble(sc.topo, sc.params, q, qdot, sc.force_fns)
        model.structured_hessian(sc.topo, sc.params, q, qdot, -1e-4, -1e-2, sc.force_fns)
        kin = model.forward_kinematics(sc.topo, sc.params, q, qdot)
        _, _, phi = model.jacobians(sc.topo, sc.params, kin, qdot)
        integrators.closure_blocks(sc.force_fns, sc.params, kin, phi)
    names = [s.name for s in metrics.spans()]
    metrics.clear_spans()
    return names


def test_one_span_a_pair_closure_evaluation():
    assert Counter(pair_spans(port_scene())) == Counter({"forces.pair_closures": 3})
    assert pair_spans(chain(12)) == []
