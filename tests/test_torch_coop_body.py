"""CPU check of the chord kernel's cooperative body (one warp per lane).
csrc/chord_bdf2_coop.cuh is compiled with plain g++ behind an extern "C"
loop over lanes that runs each phase for every tid of the warp in turn
(forward, or in reverse order), and held against the JAX package's numpy
evaluation of the Pallas kernel body, pallas_step.chord_bdf2_dense(xp=np),
at the tolerances of tests/test_pallas_step.py (x 5e-6 abs where |x| <= 1,
5e-6 of |x| above; Hinv 2e-5 of scale): on scene_chain(4) and
scene_chain(12), on chain-ground-4 and chain-ground-12 at the contact-MPC
workload's coefficients with mu = 0.5 and mu = 0 (states with corners out
of contact, in static and, with friction, in dynamic friction), on a scene
with every constant-S joint type, a penalty limit and body damping, on a
branched tree (scene_tree of depth 3) and on two chains hung from the
world; chain-12 also with the step clamp and tol_reject on. The forward and
the reverse order must agree bit for bit, so that a phase that reads what
another thread writes in the same phase shows; each lane's record starts
as NaN, so that a read of a value no phase wrote shows. A floor out of
reach gives the build without contacts bit for bit, a body with two
contacts takes both, and a NaN lane stays in its lane. The packing of the
inputs (chord_kernel.pack) is the wrapper's own. On the card's four shapes,
the tree and the forest the cooperative body gives the thread-per-lane
body's result (chord_bdf2_lane.cuh, built in the same g++ unit) bit for
bit: it sums in the same order, and g++ contracts no multiply-add.

The wrapper routes the builds of the cooperative library (the four chord
shapes, the two robust ones, the per-lane contact one, the spring chain's
and scene 13's cable with lane-shared and with per-lane params) to it and
passes each its closure counts, solve mode and per-lane buffer; a scene
with more springs than that library's records hold goes to a cooperative
build made for it, and one with more springs than a block's shared memory
holds to the thread-per-lane library, by rule; a failed cooperative build
or launch raises without falling back to the thread-per-lane library.

These builds are tests only, never a route of a wrapper.
"""

import ctypes
import types
from functools import lru_cache

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from redmax_tpu import integrators as jint
from redmax_tpu import pallas_step
from redmax_tpu import scene as jscene
from redmax_tpu.scenes import scene_13_cables as jscene13
from redmax_tpu.scenes import scene_chain as jchain
from redmax_tpu.scenes import scene_chain_ground as jground
from redmax_tpu.scenes import scene_tree as jtree
from redmax_tpu.types import JointType as JJT
from redmax_tpu_torch import chord_kernel
from redmax_tpu_torch import integrators as tint
from redmax_tpu_torch.kernel_build import KernelBuild
from test_torch_chord import BENCH_GROUND, chord_launches, contact_states, corner_regimes
from test_torch_lane_body import CFG_KW, _gxx_build, _port, _states
from test_torch_model import mixed_builder
from test_torch_springs import spring_chain_jax


@pytest.fixture(scope="module", autouse=True)
def single_thread():
    """torch's intra-op threads set to 1 for the module, then restored."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


LOOP = r"""
#include <cstring>
#include "chord_bdf2_coop.cuh"
// One phase on every tid of the lane's warp in turn, forward or in reverse.
struct SerialRun {
  int reverse;
  template <class F>
  void operator()(int, F&& f) const {
    for (int i = 0; i < chord::coop::kWarp; ++i) f(reverse ? chord::coop::kWarp - 1 - i : i);
  }
};
#define COOP(n, nr, f)                                                                 \
  if (N == n && NR == nr && feat == f) {                                               \
    static chord::coop::Lane<n, nr> L;                                                 \
    for (int lane = 0; lane < B; ++lane) {                                             \
      std::memset(&L, 0xff, sizeof L); /* NaN floats, -1 ints */                       \
      chord::coop::solve<n, nr, f>(run, L, lane, B, x0, q0, qd0, q1, qd1, tau, topo_i, \
                                   stat_f, cfg, x_out, hinv_out);                      \
    }                                                                                  \
    return 0;                                                                          \
  }
// feat: 1 with the ground-contact code, 0 without
extern "C" int chord_bdf2_coop_cpu(int N, int NR, int feat, int reverse, int B, const float* x0,
                                   const float* q0, const float* qd0, const float* q1,
                                   const float* qd1, const float* tau, const int* topo_i,
                                   const float* stat_f, int fixed_iters, float growth_reject,
                                   float tol_reject, float dx_clamp, float* x_out,
                                   float* hinv_out) {
  const chord::ChordConfig cfg{fixed_iters, growth_reject, tol_reject, dx_clamp};
  const SerialRun run{reverse};
  COOP(4, 4, 0)
  COOP(4, 4, 1)
  COOP(12, 12, 0)
  COOP(12, 12, 1)
  COOP(6, 8, 0)
  COOP(7, 7, 0)
  return -1;
}
// The thread-per-lane body at the same shapes, to compare with.
extern "C" int chord_bdf2_lane_cpu(int N, int NR, int feat, int B, const float* x0,
                                   const float* q0, const float* qd0, const float* q1,
                                   const float* qd1, const float* tau, const int* topo_i,
                                   const float* stat_f, int fixed_iters, float growth_reject,
                                   float tol_reject, float dx_clamp, float* x_out,
                                   float* hinv_out) {
  const chord::ChordConfig cfg{fixed_iters, growth_reject, tol_reject, dx_clamp};
#define LANE(n, nr, f)                                                                   \
  if (N == n && NR == nr && feat == f) {                                                 \
    for (int lane = 0; lane < B; ++lane)                                                 \
      chord::chord_bdf2_lane<n, nr, f>(lane, B, x0, q0, qd0, q1, qd1, tau, topo_i, stat_f, \
                                       cfg, x_out, hinv_out);                            \
    return 0;                                                                            \
  }
  LANE(4, 4, 0)
  LANE(4, 4, 1)
  LANE(12, 12, 0)
  LANE(12, 12, 1)
  LANE(7, 7, 0)
  return -1;
}
"""
JCFG = jint.NewtonConfig(**CFG_KW)


def forest_builder():
    """Two 2-link revolute chains hung from the world (N = nr = 4): the
    second root is joint 2."""
    T = jscene.transl
    b = jscene.SceneBuilder(name="forest", h=1e-2, tEnd=0.1, grav=(0.0, 0.0, -980.0))
    for k in range(2):
        b.body_cuboid(1.0, (1.0, 0.1, 0.1), E_ji=T([0.5, 0, 0]))
        root = b.joint(JJT.REVOLUTE, None, 2 * k, E_pj=T([0.0, 0.5 * k, 0.0]), axis=(0, 1, 0))
        b.body_cuboid(1.0, (0.8, 0.1, 0.1), E_ji=T([0.4, 0, 0]))
        b.joint(JJT.REVOLUTE, root, 2 * k + 1, E_pj=T([1.0, 0, 0]), axis=(0, 0, 1))
    return b


@pytest.fixture(scope="module")
def coop_lib(tmp_path_factory):
    lib = _gxx_build(tmp_path_factory, "coop_body", LOOP)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.chord_bdf2_coop_cpu.argtypes = [i] * 5 + [p] * 8 + [i, f, f, f, p, p]
    lib.chord_bdf2_coop_cpu.restype = i
    lib.chord_bdf2_lane_cpu.argtypes = [i] * 4 + [p] * 8 + [i, f, f, f, p, p]
    lib.chord_bdf2_lane_cpu.restype = i
    return lib


@lru_cache(maxsize=None)
def jax_scene(name, mu=0.5, floor_z=BENCH_GROUND["floor_z"]):
    """The JAX scene in f32, compiled once per module."""
    if name == "mixed":
        return mixed_builder(jscene, JJT).compile(dtype=jnp.float32)
    if name == "tree-7":  # parents -1, 0, 1, 1, 0, 4, 4
        return jtree(depth=3, branch=2).compile(dtype=jnp.float32)
    if name == "forest-4":
        return forest_builder().compile(dtype=jnp.float32)
    if name == "spring-chain-12":
        return spring_chain_jax().compile(dtype=jnp.float32)
    if name == "scene-13":
        return jscene13().compile(dtype=jnp.float32)
    if name.startswith("spring-chain-12-plus"):
        # a fourth spring (more than the fixed library's records hold), or
        # MANY_SPRINGS in all (more than a block's shared memory holds)
        b = spring_chain_jax()
        for k in range(1 if name == "spring-chain-12-plus" else MANY_SPRINGS - 3):
            b.force_point_point(-1, 6 + k % 6, xl1=(3.0, 0.0, 1.0), xl2=(0.5, 0, 0), k=20.0,
                                d=1.0)
        return b.compile(dtype=jnp.float32)
    nlinks = int(name.split("-")[-1])
    if name.startswith("chain-ground"):
        return jground(nlinks=nlinks, **{**BENCH_GROUND, "mu": mu, "floor_z": floor_z}).compile(
            dtype=jnp.float32)
    return jchain(nlinks=nlinks).compile(dtype=jnp.float32)


# Springs on the 12-link spring chain past what a cooperative record a
# block holds (about 1.98 KB a spring at (12, 12), 232,448 bytes a block).
MANY_SPRINGS = 110


def _run_coop(lib, topo, params, tau, states, force_fns=(), reverse=False, cfg_kw=CFG_KW,
              body="coop"):
    """(x [B, nr], Hinv [B, nr, nr]) of the g++ cooperative body (body
    "lane": the thread-per-lane one) in the config of cfg_kw on the
    wrapper's own packing of the inputs."""
    B, nr = states[0].shape
    packed = chord_kernel.pack(topo, {**params, "tau": torch.tensor(tau)},
                               *(torch.tensor(a) for a in states), force_fns)
    chord_kernel.check_buffers(topo, *packed[6:])
    args = [np.ascontiguousarray(a.numpy()) for a in packed[:8]]
    x_out = np.empty((nr, B), np.float32)
    h_out = np.empty((nr * nr, B), np.float32)
    ptr = lambda a: a.ctypes.data_as(ctypes.c_void_p)
    cfg = tint.NewtonConfig(**cfg_kw)
    head = [topo.njoints, nr, int(packed[8].contacts > 0)]
    if body == "coop":
        fn, head = lib.chord_bdf2_coop_cpu, head + [int(reverse)]
    else:
        fn = lib.chord_bdf2_lane_cpu
    rc = fn(*head, B, *(ptr(a) for a in args), cfg.fixed_iters, cfg.growth_reject,
            cfg.tol_reject, cfg.dx_clamp, ptr(x_out), ptr(h_out))
    assert rc == 0, (topo.njoints, nr)
    return x_out.T, h_out.reshape(nr, nr, B).transpose(2, 0, 1)


def _both_orders(lib, topo, params, tau, states, force_fns=(), cfg_kw=CFG_KW):
    """The forward-order result, after checking that the reverse order gives
    it bit for bit."""
    x, hinv = _run_coop(lib, topo, params, tau, states, force_fns, cfg_kw=cfg_kw)
    xr, hinvr = _run_coop(lib, topo, params, tau, states, force_fns, True, cfg_kw)
    np.testing.assert_array_equal(xr, x)
    np.testing.assert_array_equal(hinvr, hinv)
    return x, hinv


def _hold(x, hinv, x_np, hinv_np):
    """x at 5e-6 max(1, |x|) (5e-6 abs wherever |x| <= 1, as
    tests/test_pallas_step.py holds it; the forest's lane at qdot 1e6 ends
    near |x| = 8e3, where f32 resolves 5e-4) and H^-1 at 2e-5 of scale on
    the oracle's finite lanes, the finite masks equal."""
    finite = np.isfinite(x_np).all(-1)
    np.testing.assert_array_equal(np.isfinite(x).all(-1), finite)
    dx = np.abs(x[finite] - x_np[finite]) / np.maximum(1.0, np.abs(x_np[finite]))
    assert dx.max(initial=0.0) <= 5e-6, dx.max()
    scale = float(np.abs(hinv_np[finite]).max())
    np.testing.assert_allclose(hinv[finite], hinv_np[finite], rtol=0, atol=2e-5 * scale)
    return finite


# The step clamp binds on some lanes of chain-12 at these states, and
# tol_reject rejects some others (the lane at qdot 1e6 among them).
CLAMPED = dict(CFG_KW, dx_clamp=0.05, tol_reject=3e-4)


@pytest.mark.parametrize("scene", ["chain-4", "chain-12", "mixed", "tree-7", "forest-4",
                                   "chain-12-clamped"])
def test_coop_body_matches_kernel_body(coop_lib, scene):
    cfg_kw = CLAMPED if scene.endswith("clamped") else CFG_KW
    sc = jax_scene(scene.replace("-clamped", ""))
    B, nr = 9, sc.topo.nr
    states, tau = _states(nr, B)
    x_np, hinv_np = pallas_step.chord_bdf2_dense(
        sc.topo, jint.NewtonConfig(**cfg_kw), {**sc.params, "tau": jnp.asarray(tau)}, *states,
        xp=np)
    topo, params, _ = _port(sc)
    x, hinv = _both_orders(coop_lib, topo, params, tau, states, cfg_kw=cfg_kw)
    finite = _hold(x, hinv, x_np, hinv_np)
    if cfg_kw is CFG_KW:  # the lane at qdot 1e6 is rejected, but in the forest
        assert finite[:-1].all() and finite[-1] == (scene == "forest-4"), finite
    else:
        assert 0 < finite.sum() < B, finite
        x_free, _ = _run_coop(coop_lib, topo, params, tau, states)
        assert (np.abs(x_free - x)[finite] > 1e-6).any()


@pytest.mark.parametrize("nlinks,mu", [(4, 0.5), (12, 0.5), (4, 0.0), (12, 0.0)])
def test_coop_body_with_contacts_matches_kernel_body(coop_lib, nlinks, mu):
    sc = jax_scene(f"chain-ground-{nlinks}", mu=mu)
    B, nr = 16, sc.topo.nr
    states, tau = contact_states(nr, B)
    x_np, hinv_np = pallas_step.chord_bdf2_dense(
        sc.topo, JCFG, {**sc.params, "tau": jnp.asarray(tau)}, *states, xp=np,
        force_fns=sc.force_fns)
    topo, params, fns = _port(sc)
    assert len(fns) == nlinks
    qd_pred = 150.0 * (states[0] - (4 / 3) * states[3] + (1 / 3) * states[1])
    out, sta, dyn = corner_regimes(topo, params, fns, states[0], qd_pred)
    assert out > 0 and (sta > 0 and dyn > 0 if mu else sta == dyn == 0), (out, sta, dyn)

    x, hinv = _both_orders(coop_lib, topo, params, tau, states, fns)
    finite = _hold(x, hinv, x_np, hinv_np)
    assert finite.mean() >= 0.75, finite
    # the contacts matter: without them the solution differs
    x_free, _ = _run_coop(coop_lib, topo, params, tau, states)
    assert np.abs(x_free[finite] - x[finite]).max() > 1e-4


def test_coop_body_two_contacts_on_a_body(coop_lib):
    """Body 0 of chain-ground-4 with its contact twice (twice the force and
    blocks): the second is taken in a second round of the body phase. Held
    against the oracle with the same closures, and bit for bit against the
    thread-per-lane body."""
    sc = jax_scene("chain-ground-4")
    jfns = tuple(sc.force_fns) + (sc.force_fns[0],)
    states, tau = contact_states(sc.topo.nr, 16)
    x_np, hinv_np = pallas_step.chord_bdf2_dense(
        sc.topo, JCFG, {**sc.params, "tau": jnp.asarray(tau)}, *states, xp=np, force_fns=jfns)
    topo, params, fns = _port(sc)
    fns = tuple(fns) + (fns[0],)
    x, hinv = _both_orders(coop_lib, topo, params, tau, states, fns)
    _hold(x, hinv, x_np, hinv_np)
    xl, hinvl = _run_coop(coop_lib, topo, params, tau, states, fns, body="lane")
    np.testing.assert_array_equal(x, xl)
    np.testing.assert_array_equal(hinv, hinvl)
    x1, _ = _run_coop(coop_lib, topo, params, tau, states, fns[:-1])
    assert np.abs(x1 - x).max() > 1e-6


def test_coop_body_floor_out_of_reach_equals_no_contacts(coop_lib):
    """Contacts that no corner can reach within a step add exact zeros: x and
    H^-1 equal the build without contacts bit for bit. (The rejected lane
    moves at 1e6, so its margin reaches any floor: its x is NaN either
    way.)"""
    sc = jax_scene("chain-ground-4", floor_z=-50.0)
    topo, params, fns = _port(sc)
    states, tau = _states(sc.topo.nr, 9)
    x, hinv = _both_orders(coop_lib, topo, params, tau, states, fns)
    x0, hinv0 = _run_coop(coop_lib, topo, params, tau, states)
    assert np.isnan(x[-1]).all() and np.isfinite(x[:-1]).all()
    np.testing.assert_array_equal(x, x0)
    np.testing.assert_array_equal(hinv[:-1], hinv0[:-1])


@pytest.mark.parametrize("scene", ["chain-4", "chain-12", "chain-ground-4", "chain-ground-12",
                                   "tree-7", "forest-4"])
def test_coop_body_equals_thread_per_lane_body(coop_lib, scene):
    """The two designs' bodies on the same inputs, 64 lanes, built by g++
    in one unit: equal bit for bit (NaN where the other is NaN)."""
    sc = jax_scene(scene)
    topo, params, fns = _port(sc)
    states, tau = (contact_states if "ground" in scene else _states)(sc.topo.nr, 64)
    x, hinv = _run_coop(coop_lib, topo, params, tau, states, fns)
    xl, hinvl = _run_coop(coop_lib, topo, params, tau, states, fns, body="lane")
    assert np.isfinite(x).all(-1).mean() >= 0.75
    np.testing.assert_array_equal(x, xl)
    np.testing.assert_array_equal(hinv, hinvl)


@pytest.mark.parametrize("scene", ["chain-12", "chain-ground-12"])
def test_coop_body_nan_lane_stays_in_its_lane(coop_lib, scene):
    sc = jax_scene(scene)
    topo, params, fns = _port(sc)
    states, tau = contact_states(sc.topo.nr, 8)
    x, hinv = _run_coop(coop_lib, topo, params, tau, states, fns)
    poisoned = [a.copy() for a in states]
    poisoned[3][5] = np.nan
    xp, hinvp = _run_coop(coop_lib, topo, params, tau, poisoned, fns)
    keep = np.arange(8) != 5
    assert np.isnan(xp[5]).all() and np.isfinite(x).all()
    np.testing.assert_array_equal(xp[keep], x[keep])
    np.testing.assert_array_equal(hinvp[keep], hinv[keep])


C, R, PL, S = chord_kernel.CONTACTS, chord_kernel.ROBUST, chord_kernel.PERLANE, chord_kernel.SPRINGS
CAB = chord_kernel.CABLES
# A launch of each cooperative build: (scene, solve mode, per-lane h), and
# the (N, nr, kinds) it runs.
COOP_CASES = {
    "chain-12": ("chain-12", "chord", False, (12, 12, 0)),
    "chain-ground-12": ("chain-ground-12", "chord", False, (12, 12, C)),
    "chain-4": ("chain-4", "chord", False, (4, 4, 0)),
    "chain-ground-4": ("chain-ground-4", "chord", False, (4, 4, C)),
    "chain-12-guarded": ("chain-12", "guarded", False, (12, 12, R)),
    "chain-12-guard_last": ("chain-12", "guard_last", False, (12, 12, R)),
    "chain-ground-12-rehess": ("chain-ground-12", "rehess", False, (12, 12, C | R)),
    "chain-ground-12-guarded_rehess": ("chain-ground-12", "guarded_rehess", False,
                                       (12, 12, C | R)),
    "chain-ground-12-perlane": ("chain-ground-12", "chord", True, (12, 12, C | PL)),
    "spring-chain-12": ("spring-chain-12", "chord", False, (12, 12, S)),
    "spring-chain-12-perlane": ("spring-chain-12", "chord", True, (12, 12, S | PL)),
    "scene-13": ("scene-13", "chord", False, (4, 3, CAB)),
    "scene-13-perlane": ("scene-13", "chord", True, (4, 3, CAB | PL)),
}
MODES = {"chord": CFG_KW, "guarded": dict(CFG_KW, guarded=True),
         "guard_last": dict(CFG_KW, guard_last=True), "rehess": dict(CFG_KW, chord=False),
         "guarded_rehess": dict(CFG_KW, guarded=True, chord=False)}


def _coop_launch_case(case, B=4):
    """(topo, cfg, the packed inputs) of one launch of COOP_CASES[case]."""
    scene, mode, perlane, _ = COOP_CASES[case]
    sc = jax_scene(scene)
    topo, params, fns = _port(sc)
    if perlane:
        params = {**params, "h": params["h"] * (1 + 0.1 * torch.arange(B))}
    states, tau = contact_states(sc.topo.nr, B)
    packed = chord_kernel.pack(topo, {**params, "tau": torch.tensor(tau)},
                               *(torch.tensor(a) for a in states), fns)
    return topo, tint.NewtonConfig(**MODES[mode]), packed


def test_wrapper_routes_the_four_shapes_to_the_cooperative_build():
    """The builds without q-dependent joints that the paths run go to the
    cooperative library: the unguarded chord builds with lane-shared params
    at (12, 12) and (4, 4), with and without contacts, the robust builds at
    (12, 12), with and without contacts, the per-lane build with contacts
    at (12, 12), the spring builds at (12, 12) and the cable builds at
    (4, 3), each with and without per-lane params (up to
    COOP_LIBRARY_SPRINGS springs; more go to a cooperative build made for
    the scene, its store sized from it); the thread-per-lane libraries keep
    them for an explicit call. The other fixed thread-per-lane keys go to
    the cooperative build made for their shape where the shape rule
    (takes_coop) gives them to it, as it gives the q-dependent builds
    (K1b). A robust mode at (4, 4) goes to a cooperative build made for it,
    and so does one with per-lane params at (12, 12)."""
    assert set(chord_kernel.COOP_INSTANTIATED) == {c[3] for c in COOP_CASES.values()}
    assert set(chord_kernel.COOP_INSTANTIATED) <= set(chord_kernel.INSTANTIATED)
    assert chord_kernel.BUILD_COOP in chord_kernel.BUILDS
    for N, nr, kinds in chord_kernel.INSTANTIATED:
        if (N, nr, kinds) in chord_kernel.COOP_INSTANTIATED:
            want = chord_kernel.BUILD_COOP
        elif chord_kernel.takes_coop(N, nr, kinds):
            want = chord_kernel.build_for(True, N, nr, kinds)
        else:
            want = chord_kernel.build_of(kinds)
        assert chord_kernel.library_of(N, nr, kinds) is want
        assert chord_kernel.library_of(N, nr, kinds, thread_per_lane=True) \
            is chord_kernel.build_of(kinds)
    for key in ((6, 12, chord_kernel.QDEP), (4, 12, chord_kernel.QDEP), (1, 6, chord_kernel.QDEP)):
        assert chord_kernel.is_coop(chord_kernel.library_of(*key)), key
    # springs up to COOP_LIBRARY_SPRINGS go to the cooperative library, more
    # to a cooperative build sized for them; scene 13's cable builds go to
    # the cooperative library, their thread-per-lane builds stay for an
    # explicit call
    most = chord_kernel.COOP_LIBRARY_SPRINGS
    for kinds, lane in ((S, chord_kernel.BUILD), (S | PL, chord_kernel.BUILD_PERLANE)):
        rec = (7 * 12 + 4 + 9 * (most + 1)) if kinds & PL else 0
        assert chord_kernel.library_of(12, 12, kinds, springs=most) is chord_kernel.BUILD_COOP
        more = chord_kernel.library_of(12, 12, kinds, springs=most + 1, record=rec)
        assert more is chord_kernel.build_for(True, 12, 12, kinds, -(-rec // 4) * 4 if rec else 0,
                                              0, most + 1)
        assert f"-DCHORD_MAX_SPRINGS={most + 1}" in more.defines
        assert chord_kernel.library_of(12, 12, kinds, thread_per_lane=True,
                                       springs=most + 1, record=rec) is lane
    assert chord_kernel.library_of(4, 3, CAB | PL, cables=1, cable_points=3) \
        is chord_kernel.BUILD_COOP
    assert chord_kernel.library_of(4, 3, CAB | PL, thread_per_lane=True, cables=1,
                                   cable_points=3) is chord_kernel.BUILD_PERLANE
    assert chord_kernel.library_of(4, 4, C | R) is chord_kernel.build_for(True, 4, 4, C | R)
    assert chord_kernel.library_of(12, 12, C | PL | R, record=244) \
        is chord_kernel.build_for(True, 12, 12, C | PL | R, 244)


@pytest.mark.parametrize("case", list(COOP_CASES))
def test_wrapper_launches_the_cooperative_build(monkeypatch, case):
    """launch sends each cooperative build's inputs to chord_bdf2_coop_launch
    with the kinds it routed them by, its closure counts (contacts, springs,
    cables, cable points), its per-lane buffer and its solve mode (guarded,
    guard_last, chord), and counts the launch on the cooperative counter
    only."""
    topo, cfg, packed = _coop_launch_case(case)
    seen = []
    lib = types.SimpleNamespace(chord_bdf2_coop_launch=lambda *a: seen.append(a) or 0)
    monkeypatch.setattr(chord_kernel, "_build_lib",
                        lambda b: lib if b is chord_kernel.BUILD_COOP else None)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *a: types.SimpleNamespace(cuda_stream=0))
    before = chord_launches()
    kinds = chord_kernel.kinds_of(topo, packed[8], packed[9] is not None,
                                  chord_kernel.is_robust(cfg))
    assert (topo.njoints, topo.nr, kinds) == COOP_CASES[case][3]
    chord_kernel.launch(topo, cfg, *packed)
    assert chord_launches() == (before[0], before[1] + 1)
    (a,) = seen
    lane_f = packed[9]
    assert a[:8] == (topo.njoints, topo.nr, kinds, *packed[8], 4)
    assert a[8:14] == tuple(t.data_ptr() for t in packed[:6])
    assert a[16] == (None if lane_f is None else lane_f.data_ptr())
    assert a[17:24] == (cfg.fixed_iters, cfg.growth_reject, cfg.tol_reject, cfg.dx_clamp,
                        int(cfg.guarded), int(cfg.guard_last), int(cfg.chord))


@pytest.mark.parametrize("fault", ["build", "launch", "build-chain-12-guarded",
                                   "launch-chain-12-guarded", "build-chain-ground-12-rehess",
                                   "launch-chain-ground-12-rehess",
                                   "build-chain-ground-12-perlane",
                                   "launch-chain-ground-12-perlane",
                                   "build-spring-chain-12", "launch-spring-chain-12",
                                   "build-spring-chain-12-perlane",
                                   "launch-spring-chain-12-perlane",
                                   "build-scene-13", "launch-scene-13",
                                   "build-scene-13-perlane", "launch-scene-13-perlane"])
def test_failed_coop_build_or_launch_raises_without_fallback(monkeypatch, fault):
    """A cooperative build that fails, or a launch that returns an error,
    raises: the thread-per-lane library is never loaded and no counter
    moves (on chain-ground-4, and on each of the robust, per-lane, spring
    and cable cooperative builds)."""
    fault, _, case = fault.partition("-")
    topo, cfg, packed = _coop_launch_case(case or "chain-ground-4")

    def no_fallback(*_):
        raise AssertionError("fell back to the thread-per-lane library")

    for build in set(chord_kernel.BUILDS) - {chord_kernel.BUILD_COOP}:
        monkeypatch.setattr(build, "load", no_fallback)
    if fault == "build":
        def failed_build():
            raise RuntimeError("nvcc failed")
        monkeypatch.setattr(chord_kernel.BUILD_COOP, "load", failed_build)
    else:
        lib = types.SimpleNamespace(chord_bdf2_coop_launch=lambda *a: 700)
        monkeypatch.setattr(chord_kernel, "_build_lib",
                            lambda b: lib if b is chord_kernel.BUILD_COOP else no_fallback())
        monkeypatch.setattr(torch.cuda, "current_stream",
                            lambda *a: types.SimpleNamespace(cuda_stream=0))
    before = chord_launches()
    with pytest.raises(RuntimeError, match="nvcc failed" if fault == "build" else "error 700"):
        chord_kernel.launch(topo, cfg, *packed)
    assert chord_launches() == before


@pytest.mark.parametrize("fault", ["build", "launch"])
def test_failed_mix_build_or_launch_raises_without_fallback(monkeypatch, fault):
    """A kind mix on the cooperative build made for its scene (chain-ground-4
    with a spring-damper, contacts and a spring, no fixed library's key):
    a failed build, or a launch that returns an error, raises with the key,
    no thread-per-lane build is ever loaded and no counter moves."""
    b = jground(nlinks=4, **BENCH_GROUND)
    b.force_spring_damper(-1, 3, [0.0, 0.0, 3.0], [0.5, 0.0, 0.0], k=200.0, d=2.0)
    topo, params, fns = _port(b.compile(dtype=jnp.float32))
    states, tau = contact_states(topo.nr, 4)
    p = {**params, "tau": torch.tensor(tau)}
    cfg = tint.NewtonConfig(**CFG_KW)
    packed = chord_kernel.pack(topo, p, *(torch.tensor(a) for a in states), fns)
    build = chord_kernel.scene_build(topo, fns, p, cfg)
    assert chord_kernel.is_coop(build) and build not in chord_kernel.BUILDS
    assert "-DCHORD_FEAT=3" in build.defines and "-DCHORD_MAX_SPRINGS=1" in build.defines

    def load(b):
        if b is build and fault == "build":
            raise RuntimeError("nvcc failed")
        raise AssertionError(f"loaded {b.name}")

    monkeypatch.setattr(KernelBuild, "load", load)
    if fault == "launch":
        lib = types.SimpleNamespace(chord_bdf2_coop_launch=lambda *a: 700)
        monkeypatch.setattr(chord_kernel, "_build_lib", lambda b: lib if b is build else load(b))
        monkeypatch.setattr(torch.cuda, "current_stream",
                            lambda *a: types.SimpleNamespace(cuda_stream=0))
    before = chord_launches()
    with pytest.raises(RuntimeError, match="nvcc failed" if fault == "build"
                       else r"\(N, nr, kinds\) = \(4, 4, 3\): error 700"):
        chord_kernel.launch(topo, cfg, *packed)
    assert chord_launches() == before


@pytest.mark.parametrize("perlane", [False, True])
def test_wrapper_routes_more_springs_than_the_record_holds_to_thread_per_lane(monkeypatch,
                                                                              perlane):
    """The spring chain with MANY_SPRINGS springs, with lane-shared and
    with per-lane params: no cooperative record of them fits a block's
    shared memory, so library_of's rule sends it to the thread-per-lane
    library before any launch (the cooperative library is never loaded),
    launch passes that library its counts and counts the launch on its
    counter; chip_smoke.design_of reports the thread-per-lane design there
    and the cooperative one for the spring chain itself and with a fourth
    spring (a build made for it)."""
    import chip_smoke

    B = 4
    for name, want in (("spring-chain-12", "cooperative"),
                       ("spring-chain-12-plus", "cooperative"),
                       ("spring-chain-12-plus-many", "thread_per_lane")):
        topo, params, fns = _port(jax_scene(name))
        if perlane:
            params = {**params, "h": params["h"] * (1 + 0.1 * torch.arange(B))}
        sc = types.SimpleNamespace(topo=topo, force_fns=fns)
        assert chip_smoke.design_of(sc, params) == want, name
    assert len(fns) == MANY_SPRINGS
    kinds = S | (PL if perlane else 0)
    record = 7 * 12 + 4 + 9 * MANY_SPRINGS
    assert chord_kernel.coop_lanes(12, 12, kinds, record, 2, MANY_SPRINGS, 1) == 0
    assert chord_kernel.coop_lanes(12, 12, kinds, record, 2, 4, 1) == chord_kernel.COOP_LANES // 2
    states, tau = contact_states(topo.nr, B)
    packed = chord_kernel.pack(topo, {**params, "tau": torch.tensor(tau)},
                               *(torch.tensor(a) for a in states), fns)
    lane_build = (chord_kernel.build_for(False, 12, 12, kinds, -(-record // 4) * 4) if perlane
                  else chord_kernel.BUILD)
    seen = []
    lib = types.SimpleNamespace(chord_bdf2_launch=lambda *a: seen.append(a) or 0)

    def only_thread_per_lane(b):
        assert b is lane_build, b.name
        return lib

    monkeypatch.setattr(chord_kernel, "_build_lib", only_thread_per_lane)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *a: types.SimpleNamespace(cuda_stream=0))
    before = chord_launches()
    chord_kernel.launch(topo, tint.NewtonConfig(**CFG_KW), *packed)
    assert chord_launches() == (before[0] + 1, before[1])
    (a,) = seen
    assert a[:9] == (12, 12, 0, int(perlane), 0, MANY_SPRINGS, 0, 0, B)
