"""The residual VJP of the chord route's adjoint backward
(redmax_tpu_torch.residual_vjp), in float64 on the CPU:

  * its plain version's five cotangents (tau, q0, qd0, q1, qd1) equal
    torch.autograd.grad of integrators.residual_bdf2 to 1e-12 of their norm
    on chain-12, chain-ground-12 at the contact-MPC cells' coefficients
    (kn 100, kt 0.1, kd 10, mu 0.5, floor -0.06; states with corners out of
    contact, sticking and sliding) and a chain-12 copy with joint limits
    (joints past them), with z = H^-T xbar by each backward= choice (the
    forward's H^-1 solved in the call on "reuse"); a lane-shared tau gets
    the lanes' sum;
  * the Newton matrix's D~ in place of df/dv would fail that check
    (structured_hessian's D~ is not the derivative);
  * a horizon-10 make_objective_batched gradient on the kernel route equals
    the same route's gradient through autograd's VJP to 1e-10, on both
    scenes and every backward= choice ("reuse" also against the op-level
    route), with 9 steps on the kernel's VJP and 2 through autograd;
  * the routing by counters: a spring scene, a q-dependent chain, per-lane
    params and a params leaf other than tau that requires grad keep
    autograd's VJP; the params are asked about in the backward alone; the
    static buffer the launch reads is built once per params.

The kernel's lane arithmetic (csrc/residual_vjp.cuh) is compiled with g++
behind a loop that runs each phase for every tid of the warp in turn,
forward and reversed (bit for bit the same), and held against the plain
version in float64 on chains of 4 and 12 links with and without contacts,
a branched tree and the limited chain, one case with the inputs in
[nr, B] layout; its record at (32, 32), the widest shape takes admits,
fits a block, and 8 lanes of it at (12, 12).

The card cases (pytest.mark.card; on the card with
    python -m pytest tests/test_torch_residual_vjp.py --noconftest -o addopts="" -p no:cacheprovider -q):
the kernel against the plain version at B = 32768 on both scenes, f32; the
counters of one horizon-50 MPC solve on each scene (49 steps on the kernel,
2 through autograd) and of the scenes that keep autograd's VJP; a launch
that fails raises.
"""

import ctypes
import os
import shutil
import subprocess
from functools import lru_cache

import numpy as np
import pytest
import torch

from redmax_tpu_torch import adjoint, chord_kernel, forces, integrators, metrics, model, mpc
from redmax_tpu_torch import residual_vjp
from redmax_tpu_torch.linalg import gj_inverse, make_solver
from redmax_tpu_torch.scenes import (scene_chain, scene_chain_ground, scene_qdep_chain,
                                     scene_spring_chain, scene_tree)
from redmax_tpu_torch.types import State

GROUND = dict(kn=100.0, kt=0.1, kd=10.0, mu=0.5, floor_z=-0.06)
CFG = integrators.NewtonConfig(fixed_iters=3, predictor="quadratic", chord=True,
                               hessian="structured", linsolve="gj")
BACKWARDS = ("reuse", "refresh", "exact")
CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "redmax_tpu_torch", "csrc")
solve_T = make_solver("gj")[2]


def limited_chain():
    """scene_chain(12) with a penalty limit on every joint at +-0.03
    (k 1e3, d 5)."""
    b = scene_chain(12)
    for j in range(12):
        b.set_limits(j, -0.03, 0.03, 1e3, 5.0)
    return b


SCENES = {
    "chain4": lambda: scene_chain(4),
    "chain12": lambda: scene_chain(12),
    "chain_ground4": lambda: scene_chain_ground(4, **GROUND),
    "chain_ground12": lambda: scene_chain_ground(12, **GROUND),
    "chain12_limits": limited_chain,
    "tree3": lambda: scene_tree(depth=3),
}


@lru_cache(maxsize=None)
def compiled(name, dtype=torch.float64, device="cpu"):
    return SCENES[name]().compile(dtype=dtype, device=device)


def step_inputs(sc, B, seed=0):
    """One inner step of a chain near its floor, numpy float32: q0, qd0, q1,
    qd1 (small joint angles, a fifth of the lanes bent 0.3 and so out of
    contact; joint speeds that slide some corners and leave others
    sticking), tau, and xbar."""
    nr = sc.topo.nr
    rng = np.random.default_rng(seed)
    angle = np.where(rng.uniform(size=(B, 1)) < 0.2, 0.3, 0.02)
    q1 = angle * rng.normal(size=(B, nr))
    qd1 = rng.normal(size=(B, nr)) * rng.choice([0.002, 0.3], size=(B, 1))
    q0 = q1 - 0.01 * qd1
    qd0 = qd1 + 0.01 * rng.normal(size=(B, nr))
    tau = 0.3 * rng.normal(size=(B, nr))
    xbar = rng.normal(size=(B, nr))
    return tuple(a.astype(np.float32) for a in (q0, qd0, q1, qd1, tau, xbar))


def solved(sc, inputs, dtype=torch.float64, device="cpu"):
    """(params with tau, q0, qd0, q1, qd1, q2, H^-1, xbar) as tensors: q2 and
    H^-1 from the chord solve at the quadratic predictor (the kernel
    route's forward, its plain version)."""
    q0, qd0, q1, qd1, tau, xbar = (torch.as_tensor(a, dtype=dtype, device=device)
                                   for a in inputs)
    params = {**sc.params, "tau": tau}
    h = params["h"]
    guess = q1 + h * qd1 + 0.5 * h * (qd1 - qd0)
    q2, hinv = chord_kernel.chord_bdf2_reference(sc.topo, CFG, params, guess, q0, qd0, q1, qd1,
                                                 sc.force_fns)
    return params, q0, qd0, q1, qd1, q2, hinv, xbar


def autograd_vjp(sc, params, q0, qd0, q1, qd1, q2, w):
    """The cotangents of (tau, q0, qd0, q1, qd1) by torch.autograd.grad of
    residual_bdf2 at q2 with the cotangent w."""
    leaves = [t.detach().clone().requires_grad_(True) for t in (params["tau"], q0, qd0, q1, qd1)]
    with torch.enable_grad():
        g = integrators.residual_bdf2(sc.topo, sc.force_fns, {**params, "tau": leaves[0]}, q2,
                                      *leaves[1:])
        return torch.autograd.grad(g, leaves, grad_outputs=w)


def z_of(sc, backward, params, q0, qd0, q1, qd1, q2, hinv, xbar):
    """z = H^-T xbar with H as the backward choice builds it."""
    if backward == "reuse":
        return solve_T(hinv, xbar)
    theta = (params, q0, qd0, q1, qd1)
    if backward == "refresh":
        H = integrators._hess_bdf2(sc.topo, sc.force_fns)(theta, q2)
    else:
        H = adjoint.batched_jacobian(
            lambda x: integrators.residual_bdf2(sc.topo, sc.force_fns, params, x, q0, qd0, q1, qd1),
            q2)
    return solve_T(gj_inverse(H), xbar)


def rel(got, want):
    return float((got - want).norm() / want.norm())


def corner_regimes(sc, q, qdot):
    """(out of contact, sticking, sliding) corner counts at (q, qdot)."""
    kin = model.forward_kinematics(sc.topo, sc.params, q, qdot)
    _, _, phi = model.jacobians(sc.topo, sc.params, kin, qdot)
    idx = forces.body_index(tuple(fn.body for fn in sc.force_fns), q.device)
    s = forces.corner_state(kin.E_wi[:, idx], phi[:, idx],
                            forces.stack_contact_params(sc.force_fns, sc.params))
    return int((s["active"] == 0).sum()), int((s["sta"] > 0).sum()), int((s["dyn"] > 0).sum())


@pytest.mark.parametrize("backward", BACKWARDS)
@pytest.mark.parametrize("name", ["chain12", "chain_ground12", "chain12_limits"])
def test_plain_vjp_is_autograds(name, backward):
    sc = compiled(name)
    params, q0, qd0, q1, qd1, q2, hinv, xbar = solved(sc, step_inputs(sc, 24))
    v = (1.5 / params["h"]) * (q2 - (4 / 3) * q1 + (1 / 3) * q0)
    if name == "chain_ground12":
        assert all(n > 0 for n in corner_regimes(sc, q2, v))
    if name == "chain12_limits":
        assert ((q2 < params["qlimL"]) | (q2 > params["qlimU"])).any()
        assert ((q2 >= params["qlimL"]) & (q2 <= params["qlimU"])).any()
    z = z_of(sc, backward, params, q0, qd0, q1, qd1, q2, hinv, xbar)
    want = autograd_vjp(sc, params, q0, qd0, q1, qd1, q2, -z)
    if backward == "reuse":
        got = residual_vjp.residual_vjp(sc.topo, sc.force_fns, params, q0, qd0, q1, qd1, q2, xbar,
                                        hinv)
    else:
        got = residual_vjp.residual_vjp(sc.topo, sc.force_fns, params, q0, qd0, q1, qd1, q2, z)
    for k, (g, w) in enumerate(zip(got, want)):
        assert rel(g, w) <= 1e-12, (k, rel(g, w))


def test_a_shared_tau_gets_the_lanes_sum():
    sc = compiled("chain_ground12")
    params, q0, qd0, q1, qd1, q2, hinv, xbar = solved(sc, step_inputs(sc, 6, seed=1))
    shared = {**params, "tau": params["tau"][0]}
    got = residual_vjp.residual_vjp(sc.topo, sc.force_fns, shared, q0, qd0, q1, qd1, q2, xbar,
                                    hinv)
    lanes = residual_vjp.residual_vjp(sc.topo, sc.force_fns, params, q0, qd0, q1, qd1, q2, xbar,
                                      hinv)
    assert got[0].shape == (12,)
    torch.testing.assert_close(got[0], lanes[0].sum(0), rtol=1e-14, atol=0)


@pytest.mark.parametrize("name", ["chain12", "chain_ground12"])
def test_the_newton_matrix_D_is_not_the_derivative(name):
    """b = (D~)^T w with the Newton matrix's D~ (structured_hessian, the
    chord kernel's) in place of the exact df/dv: D~ is far from df/dv and
    the cotangents miss autograd's by far more than the 1e-12 above."""
    sc = compiled(name)
    params, q0, qd0, q1, qd1, q2, hinv, xbar = solved(sc, step_inputs(sc, 24))
    h = params["h"]
    v = (1.5 / h) * (q2 - (4 / 3) * q1 + (1 / 3) * q0)
    M, _, _ = model.assemble(sc.topo, params, q2, v, sc.force_fns)
    Dt = model.structured_hessian(sc.topo, params, q2, v, 0.0, 1.0, sc.force_fns) - M
    dfdv = adjoint.batched_jacobian(
        lambda vv: model.assemble(sc.topo, params, q2, vv, sc.force_fns)[1], v)
    assert rel(Dt, dfdv) > 0.05
    w = -solve_T(hinv, xbar)
    a = (M @ w[..., None])[..., 0]
    b = (Dt.transpose(-1, -2) @ w[..., None])[..., 0]
    q0_bar = a / 3 - (2 / 9) * h * b
    want = autograd_vjp(sc, params, q0, qd0, q1, qd1, q2, w)[1]
    assert rel(q0_bar, want) > 1e-4


def objective_grad(name, backward, use_kernel=True, B=4, horizon=10):
    """(gradient [B, nr] of a horizon-10 batched objective in P, the
    counters it moved)."""
    sc = compiled(name)
    obj = mpc.make_objective_batched(sc.topo, sc.force_fns, mpc.PointPosTask(body=11, pscale=1e3),
                                     (0.5, 0.0, 0.0), horizon, CFG, use_kernel=use_kernel,
                                     backward=backward)
    gen = torch.Generator().manual_seed(3)
    P = (3e-3 * torch.randn(B, sc.topo.nr, generator=gen, dtype=torch.float64)).requires_grad_()
    targets = 4 * torch.rand(B, 3, generator=gen, dtype=torch.float64) - 2
    s0 = State(q=sc.state0.q.expand(B, -1).contiguous(),
               qdot=sc.state0.qdot.expand(B, -1).contiguous())
    before = metrics.counters()
    (g,) = torch.autograd.grad(obj(sc.params, P, s0, targets).sum(), P)
    after = metrics.counters()
    moved = {k: after.get(k, 0) - before.get(k, 0) for k in ("adjoint.vjp.kernel",
                                                             "adjoint.vjp.oplevel")}
    return g, moved


@pytest.mark.parametrize("backward", BACKWARDS)
@pytest.mark.parametrize("name", ["chain12", "chain_ground12"])
def test_objective_gradient_on_the_kernel_route(name, backward, monkeypatch):
    got, moved = objective_grad(name, backward)
    assert moved == {"adjoint.vjp.kernel": 9, "adjoint.vjp.oplevel": 2}
    if backward == "reuse":
        oplevel, moved = objective_grad(name, backward, use_kernel=False)
        assert moved == {"adjoint.vjp.kernel": 0, "adjoint.vjp.oplevel": 11}
        assert rel(got, oplevel) <= 1e-10
    monkeypatch.setattr(residual_vjp, "takes", lambda topo, force_fns: False)
    want, moved = objective_grad(name, backward)
    assert moved == {"adjoint.vjp.kernel": 0, "adjoint.vjp.oplevel": 11}
    assert rel(got, want) <= 1e-10


@lru_cache(maxsize=None)
def spring_chain():
    return scene_spring_chain(12).compile(dtype=torch.float64, device="cpu")


@lru_cache(maxsize=None)
def qdep_chain():
    return scene_qdep_chain("universal", 2).compile(dtype=torch.float64, device="cpu")


def routed(sc, params, B=2, horizon=4):
    """The adjoint.vjp.* counters that one batched objective gradient moves."""
    obj = mpc.make_objective_batched(sc.topo, sc.force_fns,
                                     mpc.PointPosTask(body=sc.topo.njoints - 1, pscale=1e3),
                                     (0.5, 0.0, 0.0), horizon, CFG)
    P = torch.full((B, sc.topo.nr), 1e-3, dtype=torch.float64, requires_grad=True)
    s0 = State(q=sc.state0.q.expand(B, -1).contiguous(),
               qdot=sc.state0.qdot.expand(B, -1).contiguous(),
               aux={k: v.expand(B, *v.shape).contiguous() for k, v in sc.state0.aux.items()})
    before = metrics.counters()
    leaves = [P] + [v for v in params.values() if torch.is_tensor(v) and v.requires_grad]
    grads = torch.autograd.grad(obj(params, P, s0, torch.zeros(B, 3, dtype=torch.float64)).sum(),
                                leaves)
    assert all(torch.isfinite(g).all() for g in grads)
    after = metrics.counters()
    return tuple(after.get(k, 0) - before.get(k, 0) for k in ("adjoint.vjp.kernel",
                                                              "adjoint.vjp.oplevel"))


ROUTES = {
    "chain4": (lambda: (compiled("chain4"), compiled("chain4").params), (3, 2)),
    "chain_ground4": (lambda: (compiled("chain_ground4"), compiled("chain_ground4").params),
                      (3, 2)),
    "springs": (lambda: (spring_chain(), spring_chain().params), (0, 5)),
    "qdep": (lambda: (qdep_chain(), qdep_chain().params), (0, 5)),
    "perlane_I": (lambda: (compiled("chain4"), {**compiled("chain4").params,
                                                "I_i": compiled("chain4").params["I_i"].expand(
                                                    2, -1, -1).contiguous()}), (0, 5)),
    "grad_g": (lambda: (compiled("chain4"), {**compiled("chain4").params,
                                             "g": compiled("chain4").params["g"].clone()
                                             .requires_grad_()}), (0, 5)),
}


@pytest.mark.parametrize("case", list(ROUTES))
def test_routing_by_counters(case):
    make, want = ROUTES[case]
    sc, params = make()
    assert routed(sc, params) == want


def test_the_route_is_decided_in_the_backward(monkeypatch):
    """The forward asks nothing of the params: takes_params runs once an inner
    step in the backward and never in the forward. On CPU tensors the plain
    version serves the route, so adjoint.vjp.kernel moves and
    residual_vjp.launch does not."""
    asked = []
    takes_params = residual_vjp.takes_params
    monkeypatch.setattr(residual_vjp, "takes_params",
                        lambda params: asked.append(1) or takes_params(params))
    sc, B, horizon = compiled("chain_ground4"), 2, 4
    obj = mpc.make_objective_batched(sc.topo, sc.force_fns,
                                     mpc.PointPosTask(body=sc.topo.njoints - 1, pscale=1e3),
                                     (0.5, 0.0, 0.0), horizon, CFG)
    P = torch.full((B, sc.topo.nr), 1e-3, dtype=torch.float64, requires_grad=True)
    s0 = State(q=sc.state0.q.expand(B, -1).contiguous(),
               qdot=sc.state0.qdot.expand(B, -1).contiguous())
    before = metrics.counters()
    value = obj(sc.params, P, s0, torch.zeros(B, 3, dtype=torch.float64)).sum()
    assert asked == []
    torch.autograd.grad(value, P)
    assert len(asked) == horizon - 1
    after = metrics.counters()
    moved = {k: after.get(k, 0) - before.get(k, 0)
             for k in ("adjoint.vjp.kernel", "adjoint.vjp.oplevel", "residual_vjp.launch")}
    assert moved == {"adjoint.vjp.kernel": horizon - 1, "adjoint.vjp.oplevel": 2,
                     "residual_vjp.launch": 0}


def test_the_static_buffer_is_built_once_per_params():
    """chord_kernel.static_buffer, which the kernel's launch reads: the same
    buffer for the same leaves whatever tau is, a new one for other leaves
    or a leaf changed in place, each equal to _static_buffer's."""
    sc = compiled("chain_ground4")
    tau = torch.zeros(3, sc.topo.nr, dtype=torch.float64)
    params = {**sc.params, "tau": tau}
    first = chord_kernel.static_buffer(sc.topo, params, sc.force_fns)
    assert torch.equal(first, chord_kernel._static_buffer(sc.topo, params, sc.force_fns))
    assert chord_kernel.static_buffer(sc.topo, {**params, "tau": tau + 1}, sc.force_fns) is first
    mine = {**params, "I_i": params["I_i"].clone()}
    other = chord_kernel.static_buffer(sc.topo, mine, sc.force_fns)
    assert other is not first and torch.equal(other, first)
    mine["I_i"].mul_(2.0)
    changed = chord_kernel.static_buffer(sc.topo, mine, sc.force_fns)
    assert changed is not other
    assert torch.equal(changed, chord_kernel._static_buffer(sc.topo, mine, sc.force_fns))
    assert not torch.equal(changed, first)


# ---------------------------------------------------------------------------
# The lane arithmetic under g++
# ---------------------------------------------------------------------------

LOOP = r"""
#include <cstring>
#include "residual_vjp.cuh"
// One phase on every tid of the lane's warp in turn, forward or in reverse.
struct SerialRun {
  int reverse;
  template <class F>
  void operator()(int, F&& f) const {
    for (int i = 0; i < chord::coop::kWarp; ++i) f(reverse ? chord::coop::kWarp - 1 - i : i);
  }
};
#define VJP(n, nr, f)                                                                  \
  if (N == n && NR == nr && feat == f) {                                               \
    static chord::vjp::VjpLane<n, nr, f> L;                                            \
    for (int lane = 0; lane < B; ++lane) {                                             \
      std::memset(&L, 0xff, sizeof L); /* NaN floats, -1 ints */                       \
      chord::vjp::residual_vjp<n, nr, f>(run, L, lane, B, x, topo_i, stat_f, out);     \
    }                                                                                  \
    return 0;                                                                          \
  }
// inputs: q2, q0, qd0, q1, qd1, xbar; strides: their (lane, column) pairs,
// then H^-1's (lane, row, column); hinv null: xbar holds z
extern "C" int residual_vjp_cpu(int N, int NR, int feat, int reverse, int B,
                                const float* const* inputs, const float* hinv,
                                const long long* strides, const int* topo_i,
                                const float* stat_f, float* out) {
  chord::vjp::Inputs x{};
  for (int k = 0; k < 6; ++k) {
    x.p[k] = inputs[k];
    x.sl[k] = strides[2 * k];
    x.sc[k] = strides[2 * k + 1];
  }
  x.hinv = hinv;
  x.hl = strides[12];
  x.hs = strides[13];
  x.hc = strides[14];
  const SerialRun run{reverse};
  VJP(4, 4, 0)
  VJP(4, 4, 1)
  VJP(12, 12, 0)
  VJP(12, 12, 1)
  VJP(7, 7, 0)
  return -1;
}
extern "C" long residual_vjp_record_bytes(int N, int NR, int feat) {
#define SIZE(n, nr, f) \
  if (N == n && NR == nr && feat == f) return sizeof(chord::vjp::VjpLane<n, nr, f>);
  SIZE(12, 12, 0)
  SIZE(12, 12, 1)
  SIZE(32, 32, 0)
  SIZE(32, 32, 1)
  return -1;
}
"""


@pytest.fixture(scope="module")
def vjp_lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    d = tmp_path_factory.mktemp("residual_vjp")
    src, so = d / "loop.cpp", d / "libvjp.so"
    src.write_text(LOOP)
    subprocess.run(["g++", "-O2", "-std=c++17", "-shared", "-fPIC", "-I", CSRC,
                    "-o", str(so), str(src)], check=True)
    lib = ctypes.CDLL(str(so))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.residual_vjp_cpu.argtypes = [i] * 5 + [p] * 6
    lib.residual_vjp_cpu.restype = i
    lib.residual_vjp_record_bytes.argtypes = [i, i, i]
    lib.residual_vjp_record_bytes.restype = ctypes.c_long
    return lib


def run_lane_body(lib, sc, params32, ins, hinv, reverse, transposed=False):
    """The g++ body's cotangents [5, B, nr] on float32 numpy inputs (q2,
    q0, qd0, q1, qd1, xbar), each [B, nr], or laid out [nr, B] where
    transposed, with the wrapper's packing of topology and params."""
    B, nr = ins[0].shape
    keep = [np.ascontiguousarray(a.T if transposed else a) for a in ins]
    strides = []
    for _ in keep:
        strides += [1, B] if transposed else [nr, 1]
    strides += [nr * nr, nr, 1]
    hinv = None if hinv is None else np.ascontiguousarray(hinv)
    spec = chord_kernel.closure_spec(sc.topo, sc.force_fns)
    topo_i = np.ascontiguousarray(chord_kernel._topology_buffer(sc.topo, spec, "cpu").numpy())
    stat_f = np.ascontiguousarray(chord_kernel._static_buffer(sc.topo, params32,
                                                              sc.force_fns).numpy())
    ptrs = (ctypes.c_void_p * 6)(*(a.ctypes.data for a in keep))
    strides = np.asarray(strides, np.int64)
    out = np.empty((5, B, nr), np.float32)
    ptr = lambda a: None if a is None else a.ctypes.data_as(ctypes.c_void_p)
    rc = lib.residual_vjp_cpu(sc.topo.njoints, nr, residual_vjp.kinds_of(sc.force_fns),
                              int(reverse), B, ctypes.cast(ptrs, ctypes.c_void_p), ptr(hinv),
                              ptr(strides), ptr(topo_i), ptr(stat_f), ptr(out))
    assert rc == 0
    return out


LANE_CASES = [("chain4", False), ("chain12", False), ("chain_ground4", False),
              ("chain_ground12", False), ("chain_ground12", True), ("chain12_limits", False),
              ("tree3", False)]


@pytest.mark.parametrize("name,transposed", LANE_CASES)
def test_lane_body_against_the_plain_version(vjp_lib, name, transposed):
    """The g++ body (float32) against the plain version in float64 on the
    same float32 inputs: each cotangent's largest error over its lane's
    largest entry at most 4x the plain version's in float32 (which reads
    5e-8 to 9e-5), on the "reuse" backward (z solved in the body) and with z
    given; forward and reversed tid order bit for bit."""
    sc = compiled(name)
    sc32 = compiled(name, torch.float32)
    inputs = step_inputs(sc, 16, seed=2)
    params, q0, qd0, q1, qd1, q2, hinv, xbar = solved(sc, inputs)
    ins32 = [a.float().numpy() for a in (q2, q0, qd0, q1, qd1, xbar)]
    h32 = hinv.float()
    params32 = {**sc32.params, "tau": params["tau"].float()}
    ins64 = [torch.as_tensor(a).double() for a in ins32]
    q2d, q0d, qd0d, q1d, qd1d, xbd = ins64
    for with_hinv in (True, False):
        if with_hinv:
            hin, z = h32.numpy(), solve_T(h32.double(), xbd)
        else:
            hin, z = None, xbd
        got = run_lane_body(vjp_lib, sc32, params32, ins32, hin, False, transposed)
        rev = run_lane_body(vjp_lib, sc32, params32, ins32, hin, True, transposed)
        assert np.array_equal(got, rev)
        want = residual_vjp.residual_vjp_reference(sc.topo, sc.force_fns, params, q0d, qd0d,
                                                   q1d, qd1d, q2d, -z)
        q2f, q0f, qd0f, q1f, qd1f, _ = (torch.as_tensor(a) for a in ins32)
        plain = residual_vjp.residual_vjp_reference(sc32.topo, sc32.force_fns, params32, q0f,
                                                    qd0f, q1f, qd1f, q2f, -z.float())
        for k, (w, pf) in enumerate(zip(want, plain)):
            w = w.numpy()
            scale = np.abs(w).max(axis=1, keepdims=True)
            err = float((np.abs(got[k] - w) / scale).max())
            err_plain = float((np.abs(pf.numpy() - w) / scale).max())
            assert err <= 4 * err_plain + 1e-6, (k, with_hinv, err, err_plain)


@pytest.mark.parametrize("kinds", [0, 1])
def test_the_record_fits_a_block(vjp_lib, kinds):
    """takes admits every N, nr <= 32 without asking the record's size: the
    widest record fits one block (csrc/residual_vjp.cu's lanes_per_block,
    static_assert), and the cells' (12, 12) takes 8 lanes a block."""
    assert vjp_lib.residual_vjp_record_bytes(32, 32, kinds) <= chord_kernel.SMEM_PER_BLOCK
    assert 8 * vjp_lib.residual_vjp_record_bytes(12, 12, kinds) <= chord_kernel.SMEM_PER_BLOCK


def test_what_the_kernel_takes():
    assert residual_vjp.takes(compiled("chain_ground12").topo, compiled("chain_ground12").force_fns)
    assert residual_vjp.takes(compiled("tree3").topo, ())
    assert not residual_vjp.takes(spring_chain().topo, spring_chain().force_fns)
    assert not residual_vjp.takes(qdep_chain().topo, qdep_chain().force_fns)
    assert not residual_vjp.takes(scene_chain(33).compile(device="cpu").topo, ())


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture
def card():
    """Skips the test where no CUDA card is present."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA); run on the card with python -m pytest "
                    "tests/test_torch_residual_vjp.py --noconftest -o addopts=''")
    return "cuda"


@pytest.mark.card
@pytest.mark.parametrize("name", ["chain12", "chain_ground12"])
def test_kernel_against_the_plain_version_on_the_card(card, name):
    """At B = 32768, f32 on both sides: the kernel's cotangents and the plain
    version's in f32 against the plain version in f64 (the same f32 inputs),
    the kernel's error at most 4x the plain f32 version's at each quantile,
    on the "reuse" backward and with z given, the states read [B, nr] and
    [nr, B]."""
    B = 32768
    sc = compiled(name, torch.float32, card)
    sc64 = compiled(name, torch.float64, card)
    q0, qd0, q1, qd1, tau, xbar = (torch.as_tensor(a, device=card) for a in step_inputs(sc, B))
    params = {**sc.params, "tau": tau}
    guess = q1 + params["h"] * qd1 + 0.5 * params["h"] * (qd1 - qd0)
    q2, hinv = chord_kernel.chord_bdf2(sc.topo, CFG, params, guess, q0, qd0, q1, qd1,
                                       sc.force_fns)   # the kernel's [nr*nr, B] H^-1
    p64 = {**sc64.params, "tau": params["tau"].double()}
    for with_hinv in (True, False):
        z = solve_T(hinv, xbar) if with_hinv else xbar
        z64 = solve_T(hinv.double(), xbar.double()) if with_hinv else xbar.double()
        for layout in ("rows", "columns"):
            st = [q0, qd0, q1, qd1, q2, xbar if with_hinv else z]
            if layout == "columns":
                st = [a.t().contiguous().t() for a in st]
            got = residual_vjp.launch(sc.topo, sc.force_fns, params, *st,
                                      hinv if with_hinv else None)
            torch.cuda.synchronize()
            plain = residual_vjp.residual_vjp_reference(sc.topo, sc.force_fns, params, q0, qd0,
                                                        q1, qd1, q2, -z)
            want = residual_vjp.residual_vjp_reference(
                sc64.topo, sc64.force_fns, p64, q0.double(), qd0.double(), q1.double(),
                qd1.double(), q2.double(), -z64)
            for k, w in enumerate(want):
                fin = torch.isfinite(w).all(1)
                scale = w[fin].abs().amax(1, keepdim=True)
                e_k = ((got[k][fin].double() - w[fin]).abs() / scale).amax(1)
                e_p = ((plain[k][fin].double() - w[fin]).abs() / scale).amax(1)
                assert torch.equal(torch.isfinite(e_k), torch.isfinite(e_p)), (k, with_hinv)
                e_k, e_p = e_k[torch.isfinite(e_k)], e_p[torch.isfinite(e_p)]
                for qq in (0.5, 0.99, 1.0):
                    ek, ep = float(e_k.quantile(qq)), float(e_p.quantile(qq))
                    assert ek <= 4 * ep + 1e-6, (k, with_hinv, layout, qq, ek, ep)


@pytest.mark.card
@pytest.mark.parametrize("case", ["chain12", "chain_ground12", "springs", "qdep", "perlane_I",
                                  "grad_g"])
def test_routing_on_the_card(card, case):
    """One horizon-50 MPC solve at 64 lanes: 49 steps on the kernel (49
    launches counted at the launch) and 2 through autograd on the two
    cells' scenes; 0 on the kernel in the scenes that keep autograd's
    VJP."""
    B, horizon = 64, 50
    if case in ("chain12", "chain_ground12"):
        sc = compiled(case, torch.float32, card)
        params = sc.params
    else:
        base = {"springs": lambda: scene_spring_chain(12), "qdep": lambda: scene_qdep_chain(
            "universal", 6)}.get(case, lambda: scene_chain(12))
        sc = base().compile(dtype=torch.float32, device=card)
        params = dict(sc.params)
        if case == "perlane_I":
            params["I_i"] = params["I_i"].expand(B, -1, -1).contiguous()
        if case == "grad_g":
            params["g"] = params["g"].clone().requires_grad_()
    obj = mpc.make_objective_batched(sc.topo, sc.force_fns,
                                     mpc.PointPosTask(body=sc.topo.njoints - 1, pscale=1e3),
                                     (0.5, 0.0, 0.0), horizon, CFG)
    P = torch.full((B, sc.topo.nr), 1e-3, device=card, requires_grad=True)
    s0 = State(q=sc.state0.q.expand(B, -1).contiguous(),
               qdot=sc.state0.qdot.expand(B, -1).contiguous(),
               aux={k: v.expand(B, *v.shape).contiguous() for k, v in sc.state0.aux.items()})
    before = metrics.counters()
    torch.autograd.grad(obj(params, P, s0, torch.zeros(B, 3, device=card)).sum(), P)
    torch.cuda.synchronize()
    after = metrics.counters()
    moved = tuple(after.get(k, 0) - before.get(k, 0) for k in ("adjoint.vjp.kernel",
                                                               "adjoint.vjp.oplevel",
                                                               "residual_vjp.launch"))
    assert moved == ((49, 2, 49) if case in ("chain12", "chain_ground12") else (0, 51, 0))


@pytest.mark.card
def test_a_failed_launch_raises(card, monkeypatch):
    """The build without contacts given a scene with them returns -2 from
    the launcher, and the wrapper raises with the key."""
    sc = compiled("chain_ground12", torch.float32, card)
    params, q0, qd0, q1, qd1, q2, hinv, xbar = solved(sc, step_inputs(sc, 64), torch.float32,
                                                       card)
    kinds, build, *rest = residual_vjp._scene(sc.topo, sc.force_fns)
    monkeypatch.setattr(residual_vjp, "_scene", lambda topo, force_fns: (
        0, residual_vjp.build_for(12, 12, 0), *rest))
    with pytest.raises(RuntimeError, match=r"residual_vjp_12_12_0 kernel launch failed.*-2"):
        residual_vjp.launch(sc.topo, sc.force_fns, params, q0, qd0, q1, qd1, q2, xbar, hinv)
