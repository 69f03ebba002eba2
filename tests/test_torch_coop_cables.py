"""CPU check of the chord kernel's cooperative body (one warp per lane) with
multi-point cables (K1e) and with cables under per-lane params (K1f).
csrc/chord_bdf2_coop.cuh is compiled with plain g++ behind an extern "C"
loop over lanes that runs each phase for every tid of the warp in turn
(forward, or in reverse order, which must agree bit for bit), each lane's
record filled with NaN first, as in tests/test_torch_coop_springs.py; the
thread-per-lane body (chord_bdf2_lane.cuh) is built in the same g++ unit.

- The cable build on scene 13 (the card's (4, 3) build: a tension-only
  cable over two links to a stiff prismatic slider), on the 3-link cable
  scene with a world point (taut) and on a scene with two cables gives the
  thread-per-lane body's x and H^-1 bit for bit, and is held against
  pallas_step.chord_bdf2_dense(xp=np, force_fns=...) at the tolerances of
  tests/test_torch_lane_body.py; the cable acts.
- The per-lane cable build on scene 13 under per-lane I_i, body damping, g,
  h and the cable's k, d, L gives the thread-per-lane PERLANE body's result
  bit for bit and is held against chord_bdf2_dense with its perlane reads;
  lane-shared params broadcast into the per-lane buffer give the build
  without it bit for bit.
- A slack cable (L raised above every lane's length) gives the build
  without cables bit for bit.
- A NaN lane stays in its lane, with and without per-lane params.
- A cable with ground contacts (the 3-link cable scene, taut, with a
  contact on every link; C | CABLES at (3, 3)) gives the thread-per-lane
  body's result bit for bit and is held against chord_bdf2_dense; both
  closures act.
- The records: the cable builds' fit a block's shared memory at 8 lanes,
  their size is chord_kernel.coop_record_bytes', and the cables the record
  holds are the wrapper's COOP_LIBRARY_CABLES.

These builds are tests only, never a route of a wrapper.
"""

import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from redmax_tpu import integrators as jint
from redmax_tpu import pallas_step
from redmax_tpu import scene as jscene
from redmax_tpu.types import JointType as JJT
from redmax_tpu_torch import chord_kernel, convert
from redmax_tpu_torch.forces import ForceCable
from test_torch_chord import contact_states
from test_torch_coop_springs import _hold
from test_torch_lane_body import CFG_KW, _closure_case, _gxx_build, _perlane_case, _port, _states
from test_torch_springs import cable3, lengths
from test_torch_zoo_kernel import _hold as hold_rel


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
struct Args {
  int B;
  const float *x0, *q0, *qd0, *q1, *qd1, *tau;
  const int* topo_i;
  const float *stat_f, *lane_f;
  chord::ChordConfig cfg;
  float *x_out, *hinv_out;
};
template <int n, int nr, int f>
void run_coop(const SerialRun& run, const Args& a) {
  static chord::coop::LaneOf<n, nr, f> L;
  for (int lane = 0; lane < a.B; ++lane) {
    std::memset(&L, 0xff, sizeof L);  // NaN floats, -1 ints
    chord::coop::solve<n, nr, f>(run, L, lane, a.B, a.x0, a.q0, a.qd0, a.q1, a.qd1, a.tau,
                                 a.topo_i, a.stat_f, a.cfg, a.x_out, a.hinv_out, a.lane_f);
  }
}
template <int n, int nr, int f>
void run_thread(const Args& a) {
  for (int lane = 0; lane < a.B; ++lane)
    chord::chord_bdf2_lane<n, nr, f>(lane, a.B, a.x0, a.q0, a.qd0, a.q1, a.qd1, a.tau, a.topo_i,
                                     a.stat_f, a.cfg, a.x_out, a.hinv_out, a.lane_f);
}
#define BODY(n, nr, f)                               \
  if (N == n && NR == nr && feat == f) {             \
    if (coop)                                        \
      run_coop<n, nr, f>(SerialRun{reverse}, a);     \
    else                                             \
      run_thread<n, nr, f>(a);                       \
    return 0;                                        \
  }
// coop: 1 the cooperative body, 0 the thread-per-lane one; feat: the kinds
// of the build (1 contacts, 4 cables, 16 per-lane params).
extern "C" int chord_bdf2_cables_cpu(int coop, int reverse, int N, int NR, int feat, int B,
                                     const float* x0, const float* q0, const float* qd0,
                                     const float* q1, const float* qd1, const float* tau,
                                     const int* topo_i, const float* stat_f,
                                     const float* lane_f, int fixed_iters,
                                     float growth_reject, float tol_reject, float dx_clamp,
                                     float* x_out, float* hinv_out) {
  const Args a{B, x0, q0, qd0, q1, qd1, tau, topo_i, stat_f, lane_f,
               chord::ChordConfig{fixed_iters, growth_reject, tol_reject, dx_clamp}, x_out,
               hinv_out};
  BODY(4, 3, 0)
  BODY(4, 3, 4)
  BODY(4, 3, 20)
  BODY(3, 3, 0)
  BODY(3, 3, 4)
  BODY(3, 3, 5)
  return -1;
}
// Bytes of one lane's record of the cooperative build (N, NR, feat), -1 for
// a build not listed; the cables and cable points a cable build holds.
extern "C" long coop_lane_bytes(int N, int NR, int feat) {
#define SIZE(n, nr, f)             \
  if (N == n && NR == nr && feat == f) \
    return static_cast<long>(sizeof(chord::coop::LaneOf<n, nr, f>));
  SIZE(4, 3, 4)
  SIZE(4, 3, 20)
  SIZE(3, 3, 4)
  SIZE(12, 12, 4)
  SIZE(12, 12, 20)
  SIZE(2, 6, 4)
  SIZE(3, 3, 5)
#undef SIZE
  return -1;
}
extern "C" int coop_max_cables() { return chord::coop::kCoopCables; }
extern "C" int coop_max_cable_points() { return chord::coop::kCoopCablePoints; }
"""
CAB, PL = chord_kernel.CABLES, chord_kernel.PERLANE
JCFG = jint.NewtonConfig(**CFG_KW)


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    lib = _gxx_build(tmp_path_factory, "coop_cables", LOOP)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.chord_bdf2_cables_cpu.argtypes = [i] * 6 + [p] * 9 + [i, f, f, f, p, p]
    lib.chord_bdf2_cables_cpu.restype = i
    lib.coop_lane_bytes.argtypes = [i, i, i]
    lib.coop_lane_bytes.restype = ctypes.c_long
    lib.coop_max_cables.restype = i
    lib.coop_max_cable_points.restype = i
    return lib


def _run(lib, topo, params, tau, states, fns, feat, body="coop", reverse=False):
    """(x [B, nr], Hinv [B, nr, nr]) of the g++ body ("coop" or "thread")
    of the build of kinds feat at the scene's (N, nr), on the wrapper's own
    packing of the inputs (with per-lane params, the per-lane buffer too)."""
    B, nr = states[0].shape
    packed = chord_kernel.pack(topo, {**params, "tau": torch.tensor(tau)},
                               *(torch.tensor(a) for a in states), fns)
    chord_kernel.check_buffers(topo, *packed[6:])
    assert (packed[-1] is not None) == bool(feat & PL)
    args = [np.ascontiguousarray(a.numpy()) for a in packed[:8]]
    args.append(None if packed[-1] is None else np.ascontiguousarray(packed[-1].numpy()))
    x_out = np.empty((nr, B), np.float32)
    h_out = np.empty((nr * nr, B), np.float32)
    cfg = JCFG
    ptr = lambda a: None if a is None else a.ctypes.data_as(ctypes.c_void_p)
    rc = lib.chord_bdf2_cables_cpu(int(body == "coop"), int(reverse), topo.njoints, nr, feat, B,
                                   *(ptr(a) for a in args), cfg.fixed_iters, cfg.growth_reject,
                                   cfg.tol_reject, cfg.dx_clamp, ptr(x_out), ptr(h_out))
    assert rc == 0, (topo.njoints, nr, feat)
    return x_out.T, h_out.reshape(nr, nr, B).transpose(2, 0, 1)


def _coop_equals_thread(lib, topo, params, tau, states, fns, feat):
    """The cooperative body's result, after checking that its forward and
    reverse tid orders and the thread-per-lane body give it bit for bit."""
    x, hinv = _run(lib, topo, params, tau, states, fns, feat)
    for kw in (dict(reverse=True), dict(body="thread")):
        xo, hinvo = _run(lib, topo, params, tau, states, fns, feat, **kw)
        np.testing.assert_array_equal(xo, x, err_msg=str(kw))
        np.testing.assert_array_equal(hinvo, hinv, err_msg=str(kw))
    return x, hinv


def two_cables():
    """The 3-link cable scene (a world anchor over three links, taut) with a
    second, 3-point cable from the tip over a world point to the first link,
    taut on most lanes of _states and slack on the others."""
    b = cable3(jscene, JJT, L=0.5)
    b.force_cable([2, -1, 0], [[0.9, 0.0, 0.0], [0.0, -1.0, 1.0], [0.2, 0.05, 0.0]],
                  k=50.0, d=2.0, L=4.0)
    return b


def _case(case, B=16):
    """(JAX scene in f32, states, tau) of a cable case."""
    if case == "two_cables":
        sc = two_cables().compile(dtype=jnp.float32)
        states, tau = _states(sc.topo.nr, B)
        return sc, states, tau
    sc, states, tau, feat = _closure_case(case, B)
    assert feat in (CAB, 7)
    return sc, states, tau


@pytest.mark.parametrize("case", ["scene13", "cable3_taut", "two_cables"])
def test_coop_cable_body_matches_kernel_body(lib, case):
    """The cooperative cable build (the card's (4, 3) on scene 13, (3, 3) on
    the 3-link scene with a world point and on the scene with two cables):
    bit for bit the thread-per-lane body (both tid orders), and against
    chord_bdf2_dense(xp=np, force_fns=...) at x 5e-6 and H^-1 2e-5 of scale;
    the cables act (the build without them gives another x)."""
    sc, states, tau = _case(case)
    topo, params, fns = _port(sc)
    counts = chord_kernel.counts_of(chord_kernel.closure_spec(topo, fns))
    assert counts.cables == len(fns) <= chord_kernel.COOP_LIBRARY_CABLES
    if case == "cable3_taut":
        assert -1 in fns[0].bodies   # a world point
    x, hinv = _coop_equals_thread(lib, topo, params, tau, states, fns, CAB)
    x_np, hinv_np = pallas_step.chord_bdf2_dense(
        sc.topo, JCFG, {**sc.params, "tau": jnp.asarray(tau)}, *states, xp=np,
        force_fns=sc.force_fns)
    finite = _hold(x, hinv, x_np, hinv_np, 5e-6)
    assert not finite[-1] and finite[:-1].mean() >= 0.75, finite
    x_free, _ = _run(lib, topo, params, tau, states, (), 0)
    assert np.abs(x_free[finite] - x[finite]).max() > 1e-4
    for fn in fns:   # taut on some lanes at the predictor
        assert (lengths(topo, params, fn, states[0])
                > float(params["forces"][fn.key]["L"])).any(), fn.key


def test_coop_perlane_cable_matches_kernel_body(lib):
    """The cooperative per-lane cable build on scene 13 under per-lane I_i,
    body damping, g, h and the cable's k, d, L (test_torch_perlane's
    perlane_params): bit for bit the thread-per-lane PERLANE body (both tid
    orders), the draws mattering (the lane-shared params give another x),
    and against chord_bdf2_dense(xp=np) with its perlane reads at 5e-6."""
    sc, pn, tau, states, feat = _perlane_case("cable")
    assert feat == CAB | PL
    topo, shared, fns = _port(sc)
    params = convert.params_from_numpy(pn, "cpu", torch.float32)
    assert params["forces"][fns[0].key]["L"].shape == (16,)
    x, hinv = _coop_equals_thread(lib, topo, params, tau, states, fns, CAB | PL)
    finite = np.isfinite(x).all(-1)
    xs, _ = _run(lib, topo, shared, tau, states, fns, CAB)
    both = finite & np.isfinite(xs).all(-1)
    assert np.abs(xs[both] - x[both]).max() > 1e-4
    pj = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32), pn)
    assert {"I_i", "gh", "bd"} <= pallas_step._perlane_keys(pj, sc.force_fns)
    x_np, hinv_np = pallas_step.chord_bdf2_dense(
        sc.topo, JCFG, {**pj, "tau": jnp.asarray(tau)}, *states, xp=np, force_fns=sc.force_fns)
    assert _hold(x, hinv, x_np, hinv_np, 5e-6).mean() >= 0.75


def test_coop_perlane_cable_broadcast_equals_shared_build(lib):
    """Lane-shared params broadcast into the per-lane buffer (h expanded to
    [B]) give the cooperative cable build without per-lane params bit for
    bit: every field, the cable's xls, k, d, L included, is read at its
    offset of the lane's record."""
    sc, _, tau, states, _ = _perlane_case("cable")
    B = states[0].shape[0]
    topo, shared, fns = _port(sc)
    xb, hb = _coop_equals_thread(lib, topo, {**shared, "h": shared["h"].expand(B)}, tau, states,
                                 fns, CAB | PL)
    x0, h0 = _run(lib, topo, shared, tau, states, fns, CAB)
    assert np.isfinite(x0).all(-1).mean() >= 0.75
    np.testing.assert_array_equal(xb, x0)
    np.testing.assert_array_equal(hb, h0)


def test_coop_slack_cable_equals_no_cable(lib):
    """Scene 13 with the cable's L raised above every lane's length at any
    iterate: the cooperative cable build gives the cooperative build without
    cables bit for bit (the rejected lane's H^-1 aside, as in
    tests/test_torch_lane_body.py): a slack cable adds exact zeros."""
    sc, states, tau = _case("scene13")
    topo, params, fns = _port(sc)
    key = fns[0].key
    l = lengths(topo, params, fns[0], states[0])
    slack = {**params, "forces": {key: {**params["forces"][key],
                                        "L": torch.tensor(10.0 * float(l.max()))}}}
    x, hinv = _coop_equals_thread(lib, topo, slack, tau, states, fns, CAB)
    x0, hinv0 = _run(lib, topo, params, tau, states, (), 0)
    assert np.isnan(x[-1]).all() and np.isfinite(x[:-1]).all()
    np.testing.assert_array_equal(x, x0)
    np.testing.assert_array_equal(hinv[:-1], hinv0[:-1])


@pytest.mark.parametrize("case", ["shared", "perlane"])
def test_coop_cable_nan_lane_stays_in_its_lane(lib, case):
    """A lane with a NaN input (lane-shared params: a NaN q1; per-lane: a NaN
    h) comes out NaN and leaves every other lane's x and H^-1 bit-equal."""
    sc, pn, tau, states, _ = _perlane_case("cable")
    topo, shared, fns = _port(sc)
    if case == "perlane":
        params, feat = convert.params_from_numpy(pn, "cpu", torch.float32), CAB | PL
        poisoned_params = {**params, "h": params["h"].clone()}
        poisoned_params["h"][5] = float("nan")
        poisoned = states
    else:
        params, feat, poisoned_params = shared, CAB, shared
        poisoned = [a.copy() for a in states]
        poisoned[3][5] = np.nan
    B = states[0].shape[0]
    x, hinv = _run(lib, topo, params, tau, states, fns, feat)
    xp, hinvp = _run(lib, topo, poisoned_params, tau, poisoned, fns, feat)
    keep = np.arange(B) != 5
    assert np.isnan(xp[5]).all() and np.isfinite(x).all(-1).mean() >= 0.5
    np.testing.assert_array_equal(xp[keep], x[keep])
    np.testing.assert_array_equal(hinvp[keep], hinv[keep])


# The cable layouts of the g++ unit (kMaxCablePoints 8, as the fixed library)
CABLE_LAYOUTS = [(4, 3, CAB), (4, 3, CAB | PL), (3, 3, CAB), (12, 12, CAB), (12, 12, CAB | PL),
                 (2, 6, CAB), (3, 3, CAB | chord_kernel.CONTACTS)]


def test_coop_cable_records_fit_shared_memory(lib):
    """The cable builds' records are coop_record_bytes' (the wrapper's
    mirror of sizeof) and hold COOP_LIBRARY_CABLES cables of
    MAX_CABLE_POINTS points in all; the fixed library's at 8 lanes a block
    fit the 232,448 bytes of dynamic shared memory a Hopper block may
    have."""
    assert lib.coop_max_cables() == chord_kernel.COOP_LIBRARY_CABLES >= 1
    assert lib.coop_max_cable_points() == chord_kernel.MAX_CABLE_POINTS
    for key in CABLE_LAYOUTS:
        assert chord_kernel.coop_record_bytes(*key) == lib.coop_lane_bytes(*key), key
    for key in chord_kernel.COOP_INSTANTIATED:
        if key[2] & CAB:
            block = 8 * lib.coop_lane_bytes(*key)
            assert 0 < block <= 232_448 and chord_kernel.coop_lanes(*key) == 8, (key, block)
    assert chord_kernel.coop_lanes(12, 12, CAB) == 4   # wider records: fewer lanes a block


def test_cable_shape_rule():
    """takes_coop sends a cable build of any mix (alone, with contacts,
    springs or a robust mode, lane-shared or per lane) and any count of
    cables to the cooperative design; library_of gives the fixed cooperative
    library at scene 13's keys, a build of its own, its stores sized from
    the scene, with more points or cables than the library holds or another
    mix, and the old builds with thread_per_lane."""
    C, S, R = chord_kernel.CONTACTS, chord_kernel.SPRINGS, chord_kernel.ROBUST
    ck = chord_kernel
    for kinds in (CAB, CAB | PL):
        assert ck.takes_coop(4, 3, kinds, cables=1, cable_points=3)
        assert ck.takes_coop(4, 3, kinds, cables=2, cable_points=8)
        assert ck.takes_coop(4, 3, kinds, cables=3, cable_points=9)
        assert ck.library_of(4, 3, kinds, cables=1, cable_points=3) is ck.BUILD_COOP
        assert ck.library_of(4, 3, kinds, thread_per_lane=True, cables=1,
                             cable_points=3) is ck.build_of(kinds)
    for kinds in (CAB | C, CAB | S, CAB | R, CAB | PL | R):
        assert ck.takes_coop(4, 3, kinds, cables=1, cable_points=3), kinds
        b = ck.library_of(4, 3, kinds, springs=1, record=64, cables=1, cable_points=3)
        assert ck.is_coop(b) and b not in ck.BUILDS and "-DCHORD_MAX_CABLES=1" in b.defines
    big = ck.library_of(4, 3, CAB, cables=2, cable_points=12)
    assert ck.is_coop(big) and "-DCHORD_MAX_CABLE_POINTS=12" in big.defines
    assert big is ck.build_for(True, 4, 3, CAB, 0, 12, cables=2)
    three = ck.library_of(4, 3, CAB, cables=3, cable_points=9)
    assert ck.is_coop(three) and "-DCHORD_MAX_CABLE_POINTS=9" in three.defines
    assert "-DCHORD_MAX_CABLES=3" in three.defines
    assert not ck.takes_coop(4, 3, CAB, cables=1, cable_points=64)   # no lane fits a block


def cable_ground():
    """The 3-link cable scene (a world anchor over three links, taut) with a
    ground contact on every link at the contact-MPC workload's
    coefficients, the floor 0.06 below the joints."""
    b = cable3(jscene, JJT, L=0.5)
    E_g = np.eye(4)
    E_g[2, 3] = -0.06
    for i in range(3):
        b.force_ground_cuboid(i, E_ground=E_g, kn=100.0, kt=0.1, kd=10.0, mu=0.5)
    return b


def test_coop_cable_with_contacts_matches_kernel_body(lib):
    """A cable with ground contacts (C | CABLES at (3, 3)): bit for bit the
    thread-per-lane body (both tid orders), against chord_bdf2_dense(xp=np)
    at x 5e-6 max(1, |x|) and H^-1 2e-5 of scale; the cable is taut on some
    lanes and both closures act (with the cable's k = d = 0, or the
    contacts' kn = kt = kd = 0, x is another); the shape rule routes it to
    the cooperative design."""
    C = chord_kernel.CONTACTS
    sc = cable_ground().compile(dtype=jnp.float32)
    states, tau = contact_states(sc.topo.nr, 16)
    topo, params, fns = _port(sc)
    counts = chord_kernel.counts_of(chord_kernel.closure_spec(topo, fns))
    assert chord_kernel.kinds_of(topo, counts) == C | CAB
    assert chord_kernel.is_coop(chord_kernel.scene_build(topo, fns, params, JCFG))
    x, hinv = _coop_equals_thread(lib, topo, params, tau, states, fns, C | CAB)
    x_np, hinv_np = pallas_step.chord_bdf2_dense(
        sc.topo, JCFG, {**sc.params, "tau": jnp.asarray(tau)}, *states, xp=np,
        force_fns=sc.force_fns)
    hold_rel(x, hinv, x_np, hinv_np)
    finite = np.isfinite(x).all(-1)
    cable = next(fn for fn in fns if isinstance(fn, ForceCable))
    assert (lengths(topo, params, cable, states[0])
            > float(params["forces"][cable.key]["L"])).any()
    for coefs in (("k", "d"), ("kn", "kt", "kd")):
        off = {key: {c: v * 0 if c in coefs else v for c, v in fp.items()}
               for key, fp in params["forces"].items()}
        x_off, _ = _run(lib, topo, {**params, "forces": off}, tau, states, fns, C | CAB)
        both = finite & np.isfinite(x_off).all(-1)
        assert np.abs(x_off[both] - x[both]).max() > 1e-4, coefs
