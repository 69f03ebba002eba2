"""CPU check of the CUDA kernels' lane bodies. csrc/chord_bdf2_lane.cuh is
compiled with plain g++ behind a tiny extern "C" loop over lanes (no torch
headers, built under a temporary directory) and held against the JAX
package's numpy evaluation of the Pallas kernel body,
pallas_step.chord_bdf2_dense(xp=np), on scene_chain(4) and scene_chain(12)
(the two shapes the kernel is instantiated for) and on a scene with every
constant-S joint type, a penalty limit and body damping, at the tolerances of
tests/test_pallas_step.py (x 5e-6 abs, Hinv 2e-5 of scale). The packing of
the kernel's inputs (chord_kernel.pack) is the wrapper's own.

csrc/dual_pgs_lane.cuh is built the same way and held against
pallas_qp.dual_pgs_dense(xp=np) at both instantiated shapes: (6, 8) on
random QPs with equality, inequality and boxed rows and a lane whose H has a
zero pivot (NaN must come out, not a bound), and (6, 12) on the physical
systems of the 6-link floor chain (masked rows, infinite boxes), x at 2e-5
and lambda at 2e-4 of scale; the inputs are packed by qp_kernel.pack.

With ground contacts (chain-ground-4 and chain-ground-12 at the contact-MPC
workload's coefficients, states with corners out of contact, in static and in
dynamic friction, mu = 0.5 and mu = 0) the lane body is held against
chord_bdf2_dense(force_fns=...) at the same tolerances; a floor out of reach
gives the C = 0 result bit for bit. So with springs (point-point,
spring-damper, tension-only) and cables (taut, slack), in the card's own
instantiations for the spring chain and scene 13; springs with k = d = 0 and a
slack cable give the result without them bit for bit. With per-lane physical
params the lane body is held against chord_bdf2_dense with its perlane reads,
and in the card's per-lane builds lane-shared values in the per-lane buffer
give the build without it bit for bit, and a NaN lane stays in its lane.

These builds are tests only, never a route of a wrapper.
"""

import ctypes
import dataclasses
import os
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from redmax_tpu import integrators as jint
from redmax_tpu import pallas_step
from redmax_tpu import scene as jscene
from redmax_tpu import scenes as jscenes
from redmax_tpu.scenes import scene_chain as jchain
from redmax_tpu.scenes import scene_chain_ground as jground
from redmax_tpu.types import JointType as JJT
from redmax_tpu import pallas_qp
from redmax_tpu_torch import chord_kernel, convert, qp_kernel
from redmax_tpu_torch import integrators as tint
from redmax_tpu_torch.scenes import scene_floor_chain
from test_torch_chord import BENCH_GROUND, contact_states, corner_regimes
from test_torch_model import mixed_builder
from test_torch_perlane import perlane_params
from test_torch_qp import mixed_qp
from test_torch_springs import cable3, lengths, spring3, spring_chain_jax, tension_only


@pytest.fixture(scope="module", autouse=True)
def single_thread():
    """torch's intra-op threads set to 1 for the module, then restored."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "redmax_tpu_torch", "csrc")
LOOP = r"""
#include "chord_bdf2_lane.cuh"
template <int n, int nr, int f>
void run_lane(int lane, int B, const float* x0, const float* q0, const float* qd0,
              const float* q1, const float* qd1, const float* tau, const int* topo_i,
              const float* stat_f, const float* lane_f, chord::ChordConfig cfg,
              chord::RobustConfig rc, float* x_out, float* hinv_out) {
  if constexpr ((f & chord::kRobust) != 0)
    chord::chord_bdf2_lane_robust<n, nr, f>(lane, B, x0, q0, qd0, q1, qd1, tau, topo_i, stat_f,
                                            cfg, rc, x_out, hinv_out);
  else
    chord::chord_bdf2_lane<n, nr, f>(lane, B, x0, q0, qd0, q1, qd1, tau, topo_i, stat_f, cfg,
                                     x_out, hinv_out, lane_f);
}
#define LANE(n, nr, f)                                                                    \
  if (N == n && NR == nr && feat == f) {                                                  \
    for (int lane = 0; lane < B; ++lane)                                                  \
      run_lane<n, nr, f>(lane, B, x0, q0, qd0, q1, qd1, tau, topo_i, stat_f, lane_f, cfg, \
                         rc, x_out, hinv_out);                                            \
    return 0;                                                                             \
  }
// feat: the kinds bitmask of the build (7: every closure kind compiled in;
// 16: the per-lane record lane_f; 32: the robust solve modes)
extern "C" int chord_bdf2_cpu(int N, int NR, int feat, int B, const float* x0, const float* q0,
                              const float* qd0, const float* q1, const float* qd1,
                              const float* tau, const int* topo_i, const float* stat_f,
                              const float* lane_f, int fixed_iters, float growth_reject,
                              float tol_reject, float dx_clamp, int guarded, int guard_last,
                              int chord_mode, float* x_out, float* hinv_out) {
  const chord::ChordConfig cfg{fixed_iters, growth_reject, tol_reject, dx_clamp};
  const chord::RobustConfig rc{guarded, guard_last, chord_mode};
  LANE(4, 4, 7)
  LANE(6, 8, 7)
  LANE(12, 12, 7)
  LANE(3, 3, 7)
  LANE(12, 12, 0)
  LANE(12, 12, 1)
  LANE(12, 12, 2)
  LANE(4, 3, 4)
  LANE(3, 3, 23)
  LANE(12, 12, 17)
  LANE(12, 12, 18)
  LANE(4, 3, 20)
  LANE(12, 12, 32)
  LANE(12, 12, 33)
  LANE(3, 3, 39)
  return -1;
}
"""
QP_LOOP = r"""
#include "dual_pgs_lane.cuh"
extern "C" int dual_pgs_cpu(int n, int m, int B, const float* H, const float* f, const float* A,
                            const float* b, const float* lo, const float* hi, int iters,
                            float reg, float* x_out, float* lam_out) {
  for (int lane = 0; lane < B; ++lane) {
    if (n == 6 && m == 12)
      qp::dual_pgs_lane<6, 12>(lane, B, H, f, A, b, lo, hi, iters, reg, x_out, lam_out);
    else if (n == 6 && m == 8)
      qp::dual_pgs_lane<6, 8>(lane, B, H, f, A, b, lo, hi, iters, reg, x_out, lam_out);
    else
      return -1;
  }
  return 0;
}
"""
CFG_KW = dict(fixed_iters=3, predictor="quadratic", chord=True,
              hessian="structured", linsolve="gj")


def _gxx_build(tmp_path_factory, name, source):
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    d = tmp_path_factory.mktemp(name)
    src, so = d / "loop.cpp", d / "liblane.so"
    src.write_text(source)
    subprocess.run(["g++", "-O2", "-std=c++17", "-shared", "-fPIC", "-I", CSRC,
                    "-o", str(so), str(src)], check=True)
    return ctypes.CDLL(str(so))


@pytest.fixture(scope="module")
def lane_lib(tmp_path_factory):
    lib = _gxx_build(tmp_path_factory, "lane_body", LOOP)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.chord_bdf2_cpu.argtypes = [i, i, i, i] + [p] * 9 + [i, f, f, f, i, i, i, p, p]
    lib.chord_bdf2_cpu.restype = i
    return lib


def _states(nr, B):
    rng = np.random.default_rng(1)
    q1 = (0.3 * rng.normal(size=(B, nr))).astype(np.float32)
    qd1 = rng.normal(size=(B, nr)).astype(np.float32)
    qd1[-1] = 1e6  # a lane that must be rejected
    q0 = q1 - np.float32(0.01) * qd1
    qd0 = qd1 + (0.05 * rng.normal(size=(B, nr))).astype(np.float32)
    x0 = q1 + np.float32(0.01) * qd1
    tau = (3.0 * rng.normal(size=(B, nr))).astype(np.float32)
    return (x0, q0, qd0, q1, qd1), tau


def _port(sc):
    """The JAX scene's topology, float32 params and force closures in the port."""
    topo = convert.topology_from_fields(**dataclasses.asdict(sc.topo))
    params = convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, sc.params),
                                       "cpu", torch.float32)
    fns = convert.forces_from_fields([(type(f).__name__, vars(f)) for f in sc.force_fns])
    return topo, params, fns


def _run_lane_lib(lane_lib, topo, params, tau, states, force_fns=(), feat=7, cfg_kw=CFG_KW):
    """(x [B, nr], Hinv [B, nr, nr]) of the g++ lane body (built with the
    kinds feat) in the solve mode of cfg_kw, on the wrapper's own packing of
    the inputs (with per-lane params, the per-lane record buffer too)."""
    B, nr = states[0].shape
    packed = chord_kernel.pack(topo, {**params, "tau": torch.tensor(tau)},
                               *(torch.tensor(a) for a in states), force_fns)
    chord_kernel.check_buffers(topo, *packed[6:])
    assert (packed[-1] is not None) == bool(feat & chord_kernel.PERLANE)
    args = [np.ascontiguousarray(a.numpy()) for a in packed[:8]]
    args.append(None if packed[-1] is None else np.ascontiguousarray(packed[-1].numpy()))
    x_out = np.empty((nr, B), np.float32)
    h_out = np.empty((nr * nr, B), np.float32)
    cfg = tint.NewtonConfig(**cfg_kw)
    ptr = lambda a: None if a is None else a.ctypes.data_as(ctypes.c_void_p)
    rc = lane_lib.chord_bdf2_cpu(topo.njoints, nr, feat, B, *(ptr(a) for a in args),
                                 cfg.fixed_iters, cfg.growth_reject, cfg.tol_reject,
                                 cfg.dx_clamp, int(cfg.guarded), int(cfg.guard_last),
                                 int(cfg.chord), ptr(x_out), ptr(h_out))
    assert rc == 0, (topo.njoints, nr, feat)
    return x_out.T, h_out.reshape(nr, nr, B).transpose(2, 0, 1)


@pytest.mark.parametrize("scene", ["chain4", "chain12", "mixed"])
def test_lane_body_matches_kernel_body(lane_lib, scene):
    build = {"chain4": lambda: jchain(nlinks=4), "chain12": lambda: jchain(nlinks=12),
             "mixed": lambda: mixed_builder(jscene, JJT)}
    sc = build[scene]().compile(dtype=jnp.float32)
    B, nr = 9, sc.topo.nr
    states, tau = _states(nr, B)
    jcfg = jint.NewtonConfig(**CFG_KW)
    x_np, hinv_np = pallas_step.chord_bdf2_dense(
        sc.topo, jcfg, {**sc.params, "tau": jnp.asarray(tau)}, *states, xp=np)

    topo, params, _ = _port(sc)
    x, hinv = _run_lane_lib(lane_lib, topo, params, tau, states)

    finite = np.isfinite(x_np).all(-1)
    assert not finite[-1] and finite[:-1].all(), finite
    np.testing.assert_array_equal(np.isfinite(x).all(-1), finite)
    np.testing.assert_allclose(x[finite], x_np[finite], rtol=0, atol=5e-6)
    scale = float(np.abs(hinv_np[finite]).max())
    np.testing.assert_allclose(hinv[finite], hinv_np[finite], rtol=0, atol=2e-5 * scale)


@pytest.mark.parametrize("nlinks,mu", [(4, 0.5), (12, 0.5), (4, 0.0)])
def test_lane_body_with_contacts_matches_kernel_body(lane_lib, nlinks, mu):
    sc = jground(nlinks=nlinks, **{**BENCH_GROUND, "mu": mu}).compile(dtype=jnp.float32)
    B, nr = 16, sc.topo.nr
    states, tau = contact_states(nr, B)
    jcfg = jint.NewtonConfig(**CFG_KW)
    x_np, hinv_np = pallas_step.chord_bdf2_dense(
        sc.topo, jcfg, {**sc.params, "tau": jnp.asarray(tau)}, *states, xp=np,
        force_fns=sc.force_fns)
    topo, params, fns = _port(sc)
    assert len(fns) == nlinks
    qd_pred = 150.0 * (states[0] - (4 / 3) * states[3] + (1 / 3) * states[1])
    out, sta, dyn = corner_regimes(topo, params, fns, states[0], qd_pred)
    assert out > 0 and (sta > 0 and dyn > 0 if mu else sta == dyn == 0), (out, sta, dyn)

    x, hinv = _run_lane_lib(lane_lib, topo, params, tau, states, fns)
    finite = np.isfinite(x_np).all(-1)
    assert finite.mean() >= 0.75, finite
    np.testing.assert_array_equal(np.isfinite(x).all(-1), finite)
    np.testing.assert_allclose(x[finite], x_np[finite], rtol=0, atol=5e-6)
    scale = float(np.abs(hinv_np[finite]).max())
    np.testing.assert_allclose(hinv[finite], hinv_np[finite], rtol=0, atol=2e-5 * scale)
    # the contacts matter: without them the solution differs
    x_free, _ = _run_lane_lib(lane_lib, topo, params, tau, states)
    assert np.abs(x_free[finite] - x[finite]).max() > 1e-4


def test_lane_body_floor_out_of_reach_equals_no_contacts(lane_lib):
    """Contacts that no corner can reach within a step add exact zeros: x and
    H^-1 equal the C = 0 result bit for bit. (The rejected lane moves at
    1e6, so its margin reaches any floor: its x is NaN either way.)"""
    sc = jground(nlinks=4, kn=100.0, kt=0.1, kd=10.0, mu=0.5, floor_z=-50.0).compile(
        dtype=jnp.float32)
    topo, params, fns = _port(sc)
    states, tau = _states(sc.topo.nr, 9)
    x, hinv = _run_lane_lib(lane_lib, topo, params, tau, states, fns)
    x0, hinv0 = _run_lane_lib(lane_lib, topo, params, tau, states)
    assert np.isnan(x[-1]).all() and np.isfinite(x[:-1]).all()
    np.testing.assert_array_equal(x, x0)
    np.testing.assert_array_equal(hinv[:-1], hinv0[:-1])


def _closure_case(case, B=16):
    """(JAX scene in f32, states, tau, feat) of a lane-body case with springs
    or a cable; feat is the build's closure kinds: the card's own
    instantiation where the card has one (the spring chain, scene 13), every
    kind compiled in otherwise. The tension-only spring-damper gets the
    median length of the lanes at the predictor as its rest length, so half
    the lanes start taut and half slack."""
    if case in ("spring3", "tension_only"):
        sc, feat = spring3(jscene, JJT).compile(dtype=jnp.float32), 7
    elif case == "spring_chain":
        sc, feat = spring_chain_jax().compile(dtype=jnp.float32), chord_kernel.SPRINGS
    elif case.startswith("cable3"):
        sc = cable3(jscene, JJT, L=0.5 if case == "cable3_taut" else 50.0).compile(
            dtype=jnp.float32)
        feat = 7
    else:
        sc, feat = jscenes.scene_13_cables().compile(dtype=jnp.float32), chord_kernel.CABLES
    states, tau = _states(sc.topo.nr, B)
    if case == "scene13":   # about the scene's own configuration (links folded over)
        q0 = np.asarray(sc.state0.q, np.float32)
        states = tuple(a + q0 if i in (0, 1, 3) else a for i, a in enumerate(states))
    if case == "tension_only":
        sc = tension_only(sc)
        topo, params, fns = _port(sc)
        sc.params["forces"][fns[1].key]["L"] = jnp.asarray(
            np.median(lengths(topo, params, fns[1], states[0])), jnp.float32)
    return sc, states, tau, feat


@pytest.mark.parametrize("case", ["spring3", "tension_only", "spring_chain", "cable3_taut",
                                  "cable3_slack", "scene13"])
def test_lane_body_with_springs_or_cable_matches_kernel_body(lane_lib, case):
    """Springs (point-point and spring-damper, world and body endpoints, a
    tension-only spring-damper half taut) and cables (taut, slack, scene 13's
    cable over the prismatic slider) against chord_bdf2_dense(force_fns=...)
    at the tolerances of tests/test_pallas_step.py; x of the 12-link spring
    chain at 1e-5: at these states its stiff world spring amplifies f32
    roundoff, and the oracle itself is 4.8e-6 from the f64 solve (the g++
    build 4.8e-6 too, the f32 plain version 1.7e-5)."""
    sc, states, tau, feat = _closure_case(case)
    jcfg = jint.NewtonConfig(**CFG_KW)
    x_np, hinv_np = pallas_step.chord_bdf2_dense(
        sc.topo, jcfg, {**sc.params, "tau": jnp.asarray(tau)}, *states, xp=np,
        force_fns=sc.force_fns)
    topo, params, fns = _port(sc)
    assert [vars(f) for f in fns] == [vars(f) for f in sc.force_fns]
    if case == "tension_only":
        l = lengths(topo, params, fns[1], states[0])
        assert 0 < (l > float(params["forces"][fns[1].key]["L"])).sum() < len(l)
    x, hinv = _run_lane_lib(lane_lib, topo, params, tau, states, fns, feat)
    finite = np.isfinite(x_np).all(-1)
    assert not finite[-1] and finite[:-1].mean() >= 0.75, finite
    np.testing.assert_array_equal(np.isfinite(x).all(-1), finite)
    np.testing.assert_allclose(x[finite], x_np[finite], rtol=0,
                               atol=1e-5 if case == "spring_chain" else 5e-6)
    scale = float(np.abs(hinv_np[finite]).max())
    np.testing.assert_allclose(hinv[finite], hinv_np[finite], rtol=0, atol=2e-5 * scale)
    # the closures act (a slack cable adds exact zeros: the result without it)
    x_free, hinv_free = _run_lane_lib(lane_lib, topo, params, tau, states, (), feat)
    if case == "cable3_slack":
        np.testing.assert_array_equal(x, x_free)
        np.testing.assert_array_equal(hinv[:-1], hinv_free[:-1])
    else:
        assert np.abs(x_free[finite] - x[finite]).max() > 1e-4


def test_lane_body_zero_springs_equal_no_springs(lane_lib):
    """The spring chain with k = d = 0 on every spring, in the build with the
    spring code (the card's), gives the result of the build without it bit
    for bit: the springs add exact zeros."""
    sc = spring_chain_jax().compile(dtype=jnp.float32)
    topo, params, fns = _port(sc)
    zero = {key: {**fp, "k": fp["k"] * 0, "d": fp["d"] * 0}
            for key, fp in params["forces"].items()}
    states, tau = _states(sc.topo.nr, 9)
    x, hinv = _run_lane_lib(lane_lib, topo, {**params, "forces": zero}, tau, states, fns,
                            chord_kernel.SPRINGS)
    x0, hinv0 = _run_lane_lib(lane_lib, topo, params, tau, states, (), 0)
    assert np.isnan(x[-1]).all() and np.isfinite(x[:-1]).all()
    np.testing.assert_array_equal(x, x0)
    np.testing.assert_array_equal(hinv[:-1], hinv0[:-1])


def _perlane_case(case, B=16):
    """(JAX scene in f32, per-lane params, tau, states, the build of the
    per-lane case): chain-ground-12 at the contact-MPC workload's
    coefficients on contact states and scene 13 (the card's builds), the
    3-link spring scene and the 12-link spring chain (the card's build) on
    the states of _closure_case."""
    if case == "contacts":
        sc = jground(nlinks=12, **BENCH_GROUND).compile(dtype=jnp.float32)
        states, feat = contact_states(sc.topo.nr, B)[0], chord_kernel.CONTACTS
    else:
        name = {"springs": "spring3", "spring_chain": "spring_chain", "cable": "scene13"}[case]
        sc, states, _, feat = _closure_case(name, B)
    pn = perlane_params(sc.params, sc.force_fns, B)
    tau = pn.pop("tau").astype(np.float32)
    return sc, pn, tau, states, feat | chord_kernel.PERLANE


@pytest.mark.parametrize("case", ["contacts", "springs", "cable"])
def test_lane_body_perlane_matches_kernel_body(lane_lib, case):
    """The kPerlane lane body on per-lane I_i, body damping, g, h and closure
    coefficients (test_torch_perlane.perlane_params) against
    chord_bdf2_dense(xp=np) with its perlane reads, at the tolerances of the
    builds without them: with contacts and with a cable in the card's
    builds (12,12, contacts) and (4,3, cables), with springs on the 3-link
    spring scene in the build with every kind. (On the 12-link spring chain
    these draws put some lanes on chord steps of many radians, where any two
    float32 evaluations, the JAX package's numpy oracle and its own op-level
    solve included, differ far beyond these tolerances: that build is held
    by the next test.)"""
    sc, pn, tau, states, feat = _perlane_case(case)
    pj = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32), pn)
    assert {"I_i", "gh", "bd"} <= pallas_step._perlane_keys(pj, sc.force_fns)
    jcfg = jint.NewtonConfig(**CFG_KW)
    x_np, hinv_np = pallas_step.chord_bdf2_dense(
        sc.topo, jcfg, {**pj, "tau": jnp.asarray(tau)}, *states, xp=np, force_fns=sc.force_fns)
    topo, _, fns = _port(sc)
    params = convert.params_from_numpy(pn, "cpu", torch.float32)
    x, hinv = _run_lane_lib(lane_lib, topo, params, tau, states, fns, feat)
    finite = np.isfinite(x_np).all(-1)
    assert finite.mean() >= 0.75, finite
    np.testing.assert_array_equal(np.isfinite(x).all(-1), finite)
    np.testing.assert_allclose(x[finite], x_np[finite], rtol=0, atol=5e-6)
    scale = float(np.abs(hinv_np[finite]).max())
    np.testing.assert_allclose(hinv[finite], hinv_np[finite], rtol=0, atol=2e-5 * scale)


@pytest.mark.parametrize("case", ["contacts", "spring_chain", "cable"])
def test_lane_body_perlane_buffer_keeps_lanes_apart(lane_lib, case):
    """In the card's three per-lane builds: lane-shared values broadcast into
    the per-lane buffer give the build without it bit for bit (every field
    read at its offset), and a lane whose h is NaN comes out NaN and leaves
    every other lane bit-equal."""
    sc, pn, tau, states, feat = _perlane_case(case)
    B = states[0].shape[0]
    topo, shared, fns = _port(sc)
    broadcast = {**shared, "h": shared["h"].expand(B)}
    xb, hb = _run_lane_lib(lane_lib, topo, broadcast, tau, states, fns, feat)
    x0, h0 = _run_lane_lib(lane_lib, topo, shared, tau, states, fns, feat & ~chord_kernel.PERLANE)
    np.testing.assert_array_equal(xb, x0)
    np.testing.assert_array_equal(hb, h0)
    params = convert.params_from_numpy(pn, "cpu", torch.float32)
    x, _ = _run_lane_lib(lane_lib, topo, params, tau, states, fns, feat)
    assert np.isfinite(x).all(-1).mean() >= 0.5
    params["h"][3] = float("nan")
    xn, _ = _run_lane_lib(lane_lib, topo, params, tau, states, fns, feat)
    keep = np.arange(B) != 3
    assert np.isnan(xn[3]).all()
    np.testing.assert_array_equal(xn[keep], x[keep])


ROBUST_MODES = {
    "guarded": dict(CFG_KW, guarded=True),
    "guard_last": dict(CFG_KW, guard_last=True),
    "rehess": dict(CFG_KW, chord=False),
    "guarded_rehess": dict(CFG_KW, guarded=True, chord=False),
}


def _robust_case(case, B=24):
    """(JAX scene in f32, states, tau, feat) of a robust-mode case: the card's
    builds (12,12, robust) on the 12-link chain and (12,12, contacts |
    robust) on chain-ground-12 at the contact-MPC coefficients, and the
    ground scene of tests/test_pallas_step.py (chain-ground-3, kn 1e3) in the
    build with every closure kind; the torques of about half the lanes
    scaled up (10x, 300x, 100x) so that the guard takes half steps and stays
    put on some lanes (on chain-12 over 3B lanes, where a lane that stays put
    and is kept is rarer)."""
    if case == "chain12":
        sc, feat, up = jchain(nlinks=12).compile(dtype=jnp.float32), chord_kernel.ROBUST, 10.0
        B = 3 * B
        states, tau = _states(sc.topo.nr, B)
    elif case == "ground12":
        sc = jground(nlinks=12, **BENCH_GROUND).compile(dtype=jnp.float32)
        feat, up = chord_kernel.CONTACTS | chord_kernel.ROBUST, 300.0
        states, tau = contact_states(sc.topo.nr, B)
    else:
        sc = jground(nlinks=3, floor_z=-0.02, kn=1e3, kt=50.0, kd=10.0, mu=0.5).compile(
            dtype=jnp.float32)
        feat, up = 7 | chord_kernel.ROBUST, 100.0
        states, tau = _states(sc.topo.nr, B)
    lanes = np.random.default_rng(7).choice([1.0, up], size=(B, 1)).astype(np.float32)
    return sc, states, tau * lanes, feat


@pytest.mark.parametrize("mode", list(ROBUST_MODES))
@pytest.mark.parametrize("case", ["chain12", "ground12", "ground3"])
def test_lane_body_robust_modes_match_kernel_body(lane_lib, case, mode):
    """The kRobust lane body in each robust mode against
    chord_bdf2_dense(xp=np) with the same config (the port of
    tests/test_pallas_step.py::test_robust_solve_modes_match_newton): the
    finite masks equal, x at 5e-6 (1e-5 on the stiff ground scene, that
    test's own tolerance) and H^-1 (the last one built) at 2e-5 of scale on
    every lane that float32 determines, that is where the oracle
    lies within 1e-3 max(1, |x|) of the port's plain version in float64 (at
    these torques a few lanes end far from any root, where two float32
    evaluations part, each as far from float64; at least 3/4 of the finite
    lanes are held); the guard's branches each fire on some held lane (a
    census from the float64 plain version's steps)."""
    sc, states, tau, feat = _robust_case(case)
    kw = ROBUST_MODES[mode]
    x_np, hinv_np = pallas_step.chord_bdf2_dense(
        sc.topo, jint.NewtonConfig(**kw), {**sc.params, "tau": jnp.asarray(tau)}, *states,
        xp=np, force_fns=sc.force_fns)
    topo, params, fns = _port(sc)
    x, hinv = _run_lane_lib(lane_lib, topo, params, tau, states, fns, feat, kw)
    info = {}
    p64 = jax.tree_util.tree_map(lambda a: a.double(), {**params, "tau": torch.tensor(tau)})
    x64, _ = chord_kernel.chord_bdf2_reference(
        topo, tint.NewtonConfig(**kw), p64, *(torch.tensor(a).double() for a in states), fns,
        info=info)
    finite = np.isfinite(x_np).all(-1)
    assert finite.mean() >= 0.5, finite
    np.testing.assert_array_equal(np.isfinite(x).all(-1), finite)
    x64 = x64.numpy()
    held = finite & (np.abs(x_np - x64) <= 1e-3 * np.maximum(1.0, np.abs(x64))).all(-1)
    assert held.sum() >= 0.75 * finite.sum(), (held.sum(), finite.sum())
    if "steps" in info:
        # lanes on which each branch of the guard fired, among the lanes held
        steps = info["steps"].numpy()
        census = {s: int(((steps == s).any(-1) & held).sum()) for s in (1.0, 0.5, 0.0)}
        assert min(census.values()) > 0, census
    # the stiff ground scene (kn 1e3) at test_robust_solve_modes_match_newton's 1e-5
    np.testing.assert_allclose(x[held], x_np[held], rtol=0,
                               atol=1e-5 if case == "ground3" else 5e-6)
    scale = float(np.abs(hinv_np[held]).max())
    np.testing.assert_allclose(hinv[held], hinv_np[held], rtol=0, atol=2e-5 * scale)


@pytest.mark.parametrize("case", ["chain12", "ground12"])
def test_lane_body_robust_build_in_chord_mode_equals_plain_build(lane_lib, case):
    """The card's robust builds run unguarded chord through the code of the
    builds without kRobust: bit for bit the same x and H^-1."""
    sc, states, tau, feat = _robust_case(case)
    topo, params, fns = _port(sc)
    x, hinv = _run_lane_lib(lane_lib, topo, params, tau, states, fns, feat)
    x0, hinv0 = _run_lane_lib(lane_lib, topo, params, tau, states, fns,
                              feat & ~chord_kernel.ROBUST)
    np.testing.assert_array_equal(x, x0)
    np.testing.assert_array_equal(hinv, hinv0)


@pytest.fixture(scope="module")
def qp_lane_lib(tmp_path_factory):
    lib = _gxx_build(tmp_path_factory, "qp_lane_body", QP_LOOP)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.dual_pgs_cpu.argtypes = [i, i, i] + [p] * 6 + [i, ctypes.c_float, p, p]
    lib.dual_pgs_cpu.restype = i
    return lib


def floor_chain_systems(B, device="cpu", seed=0):
    """The contact QPs of the 6-link floor chain (n = 6, m = 12) in float32
    at states q0 + 0.3 N(0,1), qdot N(0,1): (H, f, A, b, lo, hi) tensors."""
    sc = scene_floor_chain(6).compile(dtype=torch.float32, device=device)
    rng = np.random.default_rng(seed)
    q = sc.state0.q.cpu().numpy()[None] + 0.3 * rng.normal(size=(B, sc.topo.nr))
    qd = rng.normal(size=(B, sc.topo.nr))
    f32 = lambda a: torch.tensor(a, dtype=torch.float32, device=device)
    H, f, (A, b, lo, hi, _) = tint.euler_qp_system(
        sc.topo, (), sc.constraint_fns, sc.params, f32(q), f32(qd))
    return H, f, A, b, lo, hi


@pytest.mark.parametrize("shape", [(6, 8), (6, 12)])
def test_dual_pgs_lane_body_matches_kernel_body(qp_lane_lib, shape):
    n, m = shape
    if shape == (6, 8):
        sys = list(mixed_qp(11, 9, 6, 1, 4, 3, np.float32))
        sys[0][-1] = 1.0  # all-ones H: the second pivot is exactly 0
        iters = 60
    else:
        sys = [a.numpy() for a in floor_chain_systems(64)]
        iters = 40
        hi = sys[5]
        assert np.isinf(hi).any() and (hi == 0).any()  # active and masked rows
    B = sys[1].shape[0]
    assert (sys[1].shape[1], sys[2].shape[1]) == shape
    x_np, lam_np = pallas_qp.dual_pgs_dense(*sys, iters=iters)

    packed = [np.ascontiguousarray(a.numpy()) for a in
              qp_kernel.pack(*(torch.tensor(a) for a in sys))]
    x_out = np.empty((n, B), np.float32)
    lam_out = np.empty((m, B), np.float32)
    ptr = lambda a: a.ctypes.data_as(ctypes.c_void_p)
    rc = qp_lane_lib.dual_pgs_cpu(n, m, B, *(ptr(a) for a in packed), iters, 1e-10,
                                  ptr(x_out), ptr(lam_out))
    assert rc == 0
    x, lam = x_out.T, lam_out.T

    finite = np.isfinite(x_np).all(-1)
    assert finite[:B - 1].all() and finite[-1] == (shape == (6, 12))
    np.testing.assert_array_equal(np.isfinite(x).all(-1), finite)
    np.testing.assert_array_equal(np.isnan(lam), np.isnan(lam_np))
    xs = max(1.0, float(np.abs(x_np[finite]).max()))
    ls = max(1.0, float(np.abs(lam_np[finite]).max()))
    np.testing.assert_allclose(x[finite], x_np[finite], rtol=0, atol=2e-5 * xs)
    np.testing.assert_allclose(lam[finite], lam_np[finite], rtol=0, atol=2e-4 * ls)
