"""CPU check of the chord kernel's cooperative body (one warp per lane) with
two-point springs (K1d) and with springs under per-lane params (K1f).
csrc/chord_bdf2_coop.cuh is compiled with plain g++ behind an extern "C"
loop over lanes that runs each phase for every tid of the warp in turn
(forward, or in reverse order, which must agree bit for bit), each lane's
record filled with NaN first, as in tests/test_torch_coop_body.py; the
thread-per-lane body (chord_bdf2_lane.cuh) is built in the same g++ unit.

- The spring build on the spring chain (the card's (12, 12) build: a
  world-to-tip spring-damper, a body-body spring-damper and a point-point
  coupler), on the 3-link spring scene and on its half-taut tension-only
  variant gives the thread-per-lane body's x and H^-1 bit for bit, and is
  held against pallas_step.chord_bdf2_dense(xp=np, force_fns=...) at the
  tolerances of tests/test_torch_lane_body.py.
- The per-lane spring build on the spring chain under per-lane I_i, body
  damping, g, h and spring k, d, L gives the thread-per-lane PERLANE body's
  result bit for bit (on the 3-link scene also held against
  chord_bdf2_dense with its perlane reads); lane-shared params broadcast
  into the per-lane buffer give the build without it bit for bit.
- Springs with k = d = 0 give the build without springs bit for bit.
- A NaN lane stays in its lane, with and without per-lane params.
- The records: the spring builds' fit a block's shared memory at 8 lanes,
  the other cooperative builds keep theirs, and the spring count the record
  holds is the wrapper's MAX_COOP_SPRINGS.

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
from redmax_tpu_torch import chord_kernel, convert
from redmax_tpu_torch import integrators as tint
from test_torch_lane_body import CFG_KW, _closure_case, _gxx_build, _perlane_case, _port


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
// of the build (2 springs, 16 per-lane params).
extern "C" int chord_bdf2_springs_cpu(int coop, int reverse, int N, int NR, int feat, int B,
                                      const float* x0, const float* q0, const float* qd0,
                                      const float* q1, const float* qd1, const float* tau,
                                      const int* topo_i, const float* stat_f,
                                      const float* lane_f, int fixed_iters,
                                      float growth_reject, float tol_reject, float dx_clamp,
                                      float* x_out, float* hinv_out) {
  const Args a{B, x0, q0, qd0, q1, qd1, tau, topo_i, stat_f, lane_f,
               chord::ChordConfig{fixed_iters, growth_reject, tol_reject, dx_clamp}, x_out,
               hinv_out};
  BODY(12, 12, 0)
  BODY(12, 12, 2)
  BODY(12, 12, 18)
  BODY(3, 3, 0)
  BODY(3, 3, 2)
  BODY(3, 3, 18)
  return -1;
}
// Bytes of one lane's record of the cooperative build (N, NR, feat), -1 for
// a build not listed; the springs a spring build's record holds.
extern "C" long coop_lane_bytes(int N, int NR, int feat) {
#define SIZE(n, nr, f)             \
  if (N == n && NR == nr && feat == f) \
    return static_cast<long>(sizeof(chord::coop::LaneOf<n, nr, f>));
  SIZE(12, 12, 0)
  SIZE(12, 12, 1)
  SIZE(4, 4, 0)
  SIZE(4, 4, 1)
  SIZE(12, 12, 32)
  SIZE(12, 12, 33)
  SIZE(12, 12, 17)
  SIZE(12, 12, 2)
  SIZE(12, 12, 18)
  SIZE(4, 3, 4)
  SIZE(4, 3, 20)
#undef SIZE
  return -1;
}
extern "C" int coop_max_springs() { return chord::coop::kCoopSprings; }
"""
S, PL = chord_kernel.SPRINGS, chord_kernel.PERLANE
JCFG = jint.NewtonConfig(**CFG_KW)


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    lib = _gxx_build(tmp_path_factory, "coop_springs", LOOP)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.chord_bdf2_springs_cpu.argtypes = [i] * 6 + [p] * 9 + [i, f, f, f, p, p]
    lib.chord_bdf2_springs_cpu.restype = i
    lib.coop_lane_bytes.argtypes = [i, i, i]
    lib.coop_lane_bytes.restype = ctypes.c_long
    lib.coop_max_springs.restype = i
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
    cfg = tint.NewtonConfig(**CFG_KW)
    ptr = lambda a: None if a is None else a.ctypes.data_as(ctypes.c_void_p)
    rc = lib.chord_bdf2_springs_cpu(int(body == "coop"), int(reverse), topo.njoints, nr, feat, B,
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
        np.testing.assert_array_equal(xo, x)
        np.testing.assert_array_equal(hinvo, hinv)
    return x, hinv


def _hold(x, hinv, x_np, hinv_np, xtol):
    """x at xtol and H^-1 at 2e-5 of scale on the oracle's finite lanes, the
    finite masks equal; returns the finite mask."""
    finite = np.isfinite(x_np).all(-1)
    np.testing.assert_array_equal(np.isfinite(x).all(-1), finite)
    np.testing.assert_allclose(x[finite], x_np[finite], rtol=0, atol=xtol)
    scale = float(np.abs(hinv_np[finite]).max())
    np.testing.assert_allclose(hinv[finite], hinv_np[finite], rtol=0, atol=2e-5 * scale)
    return finite


@pytest.mark.parametrize("case", ["spring_chain", "spring3", "tension_only"])
def test_coop_springs_body_matches_kernel_body(lib, case):
    """The cooperative spring build (the card's (12, 12) on the spring chain,
    (3, 3) on the 3-link spring scene and its tension-only variant, half the
    lanes taut): bit for bit the thread-per-lane body (both tid orders), and
    against chord_bdf2_dense(xp=np, force_fns=...) at the tolerances of
    tests/test_torch_lane_body.py (x of the spring chain at 1e-5, its stiff
    world spring's roundoff; 5e-6 elsewhere; H^-1 at 2e-5 of scale); the
    springs act (the build without them gives another x)."""
    sc, states, tau, _ = _closure_case(case)
    topo, params, fns = _port(sc)
    assert len(fns) <= chord_kernel.MAX_COOP_SPRINGS
    x, hinv = _coop_equals_thread(lib, topo, params, tau, states, fns, S)
    x_np, hinv_np = pallas_step.chord_bdf2_dense(
        sc.topo, JCFG, {**sc.params, "tau": jnp.asarray(tau)}, *states, xp=np,
        force_fns=sc.force_fns)
    finite = _hold(x, hinv, x_np, hinv_np, 1e-5 if case == "spring_chain" else 5e-6)
    assert not finite[-1] and finite[:-1].mean() >= 0.75, finite
    x_free, _ = _run(lib, topo, params, tau, states, (), 0)
    assert np.abs(x_free[finite] - x[finite]).max() > 1e-4


@pytest.mark.parametrize("case", ["spring_chain", "springs"])
def test_coop_perlane_springs_matches_kernel_body(lib, case):
    """The cooperative per-lane spring build under per-lane I_i, body damping,
    g, h and each spring's k, d, L (test_torch_perlane.perlane_params): bit
    for bit the thread-per-lane PERLANE body (both tid orders) on the spring
    chain and on the 3-link spring scene, the draws mattering (the
    lane-shared params give another x); on the 3-link scene also against
    chord_bdf2_dense(xp=np) with its perlane reads at 5e-6 (on the spring
    chain these draws put some lanes on chord steps of many radians, where
    two float32 evaluations part: tests/test_torch_lane_body.py holds that
    build bit for bit only, as here)."""
    sc, pn, tau, states, _ = _perlane_case(case)
    topo, shared, fns = _port(sc)
    params = convert.params_from_numpy(pn, "cpu", torch.float32)
    x, hinv = _coop_equals_thread(lib, topo, params, tau, states, fns, S | PL)
    finite = np.isfinite(x).all(-1)
    assert finite.mean() >= 0.5, finite
    xs, _ = _run(lib, topo, shared, tau, states, fns, S)
    both = finite & np.isfinite(xs).all(-1)
    assert np.abs(xs[both] - x[both]).max() > 1e-4
    if case == "springs":
        pj = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32), pn)
        assert {"I_i", "gh", "bd"} <= pallas_step._perlane_keys(pj, sc.force_fns)
        x_np, hinv_np = pallas_step.chord_bdf2_dense(
            sc.topo, JCFG, {**pj, "tau": jnp.asarray(tau)}, *states, xp=np,
            force_fns=sc.force_fns)
        assert _hold(x, hinv, x_np, hinv_np, 5e-6).mean() >= 0.75


@pytest.mark.parametrize("case", ["spring_chain", "springs"])
def test_coop_perlane_springs_broadcast_equals_shared_build(lib, case):
    """Lane-shared params broadcast into the per-lane buffer (h expanded to
    [B]) give the cooperative spring build without per-lane params bit for
    bit: every field, the springs' xl1, xl2, k, d, L included, is read at its
    offset of the lane's record."""
    sc, _, tau, states, _ = _perlane_case(case)
    B = states[0].shape[0]
    topo, shared, fns = _port(sc)
    xb, hb = _coop_equals_thread(lib, topo, {**shared, "h": shared["h"].expand(B)}, tau, states,
                                 fns, S | PL)
    x0, h0 = _run(lib, topo, shared, tau, states, fns, S)
    assert np.isfinite(x0).all(-1).mean() >= 0.75
    np.testing.assert_array_equal(xb, x0)
    np.testing.assert_array_equal(hb, h0)


def test_coop_zero_springs_equal_no_springs(lib):
    """The spring chain with k = d = 0 on every spring in the cooperative
    spring build gives the cooperative build without springs bit for bit
    (the rejected lane's H^-1 aside, as in tests/test_torch_lane_body.py):
    the springs' wrenches and pair blocks add exact zeros."""
    sc, states, tau, _ = _closure_case("spring_chain", B=9)
    topo, params, fns = _port(sc)
    zero = {key: {**fp, "k": fp["k"] * 0, "d": fp["d"] * 0}
            for key, fp in params["forces"].items()}
    x, hinv = _coop_equals_thread(lib, topo, {**params, "forces": zero}, tau, states, fns, S)
    x0, hinv0 = _run(lib, topo, params, tau, states, (), 0)
    assert np.isnan(x[-1]).all() and np.isfinite(x[:-1]).all()
    np.testing.assert_array_equal(x, x0)
    np.testing.assert_array_equal(hinv[:-1], hinv0[:-1])


@pytest.mark.parametrize("case", ["shared", "perlane"])
def test_coop_springs_nan_lane_stays_in_its_lane(lib, case):
    """A lane with a NaN input (lane-shared params: a NaN q1; per-lane: a NaN
    h) comes out NaN and leaves every other lane's x and H^-1 bit-equal."""
    sc, pn, tau, states, _ = _perlane_case("spring_chain")
    topo, shared, fns = _port(sc)
    if case == "perlane":
        params, feat = convert.params_from_numpy(pn, "cpu", torch.float32), S | PL
        poisoned_params = {**params, "h": params["h"].clone()}
        poisoned_params["h"][5] = float("nan")
        poisoned = states
    else:
        params, feat, poisoned_params = shared, S, shared
        poisoned = [a.copy() for a in states]
        poisoned[3][5] = np.nan
    B = states[0].shape[0]
    x, hinv = _run(lib, topo, params, tau, states, fns, feat)
    xp, hinvp = _run(lib, topo, poisoned_params, tau, poisoned, fns, feat)
    keep = np.arange(B) != 5
    assert np.isnan(xp[5]).all() and np.isfinite(x).all(-1).mean() >= 0.5
    np.testing.assert_array_equal(xp[keep], x[keep])
    np.testing.assert_array_equal(hinvp[keep], hinv[keep])


# Shared memory a block of each cooperative build at 8 lanes a block: the
# seven builds before the spring ones keep theirs.
BLOCK_BYTES = {(12, 12, 0): 206_336, (12, 12, 1): 206_336, (4, 4, 0): 39_168,
               (4, 4, 1): 39_168, (12, 12, 32): 208_000, (12, 12, 33): 208_000,
               (12, 12, 17): 222_720}


def test_coop_records_fit_shared_memory(lib):
    """Every cooperative build's record at 8 lanes a block fits the 232,448
    bytes of dynamic shared memory a Hopper block may have, the earlier
    builds' records are as they were, and the spring builds hold the
    wrapper's MAX_COOP_SPRINGS springs (the spring chain's three)."""
    assert lib.coop_max_springs() == chord_kernel.MAX_COOP_SPRINGS >= 3
    for key in chord_kernel.COOP_INSTANTIATED:
        block = 8 * lib.coop_lane_bytes(*key)
        assert 0 < block <= 232_448, (key, block)
        if key in BLOCK_BYTES:
            assert block == BLOCK_BYTES[key], (key, block)
    cables = {(4, 3, chord_kernel.CABLES), (4, 3, chord_kernel.CABLES | PL)}
    assert set(BLOCK_BYTES) | {(12, 12, S), (12, 12, S | PL)} | cables == \
        set(chord_kernel.COOP_INSTANTIATED)
