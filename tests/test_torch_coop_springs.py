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
  holds is the wrapper's COOP_LIBRARY_SPRINGS.
- Springs mixed with other kinds and more springs than the fixed library
  holds, in a second g++ unit whose records hold MIX_SPRINGS = 34 springs
  (-DCHORD_MAX_SPRINGS, as a build made for a scene sizes them):
  chain-ground-6 with a spring-damper (contacts and a spring on one body),
  the umbrella's (8, 7) with its six spring-dampers (24 pair blocks, G J_s
  in a store of their own), the mixed-joint scene (N = 6, nr = 8 > N) with
  two springs and a 3-link chain with 34 springs (more springs, endpoints
  and pair blocks than a warp has threads), each bit for bit the
  thread-per-lane body (both tid orders), held against
  chord_bdf2_dense(xp=np) (x 5e-6 max(1, |x|), H^-1 2e-5 of scale), its
  record coop_record_bytes', the shape rule sending it to the cooperative
  design; a NaN lane stays in its lane.

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
from redmax_tpu import scenes as jscenes
from redmax_tpu.scenes import scene_chain as jchain
from redmax_tpu.scenes import scene_chain_ground as jground
from redmax_tpu.types import JointType as JJT
from redmax_tpu_torch import chord_kernel, convert
from redmax_tpu_torch import integrators as tint
from redmax_tpu_torch.forces import ForcePointPoint, ForceSpringDamper
from test_torch_chord import BENCH_GROUND, contact_states
from test_torch_lane_body import CFG_KW, _closure_case, _gxx_build, _perlane_case, _port, \
    _states
from test_torch_model import mixed_builder
from test_torch_zoo_kernel import _hold as hold_rel
from test_torch_zoo_kernel import zoo_states


@pytest.fixture(scope="module", autouse=True)
def single_thread():
    """torch's intra-op threads set to 1 for the module, then restored."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


LOOP = r"""
HEAD
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
// of the build (1 contacts, 2 springs, 16 per-lane params).
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
  BODIES
  return -1;
}
// Bytes of one lane's record of the cooperative build (N, NR, feat), -1 for
// a build not listed; the springs a spring build's record holds.
extern "C" long coop_lane_bytes(int N, int NR, int feat) {
#define SIZE(n, nr, f)             \
  if (N == n && NR == nr && feat == f) \
    return static_cast<long>(sizeof(chord::coop::LaneOf<n, nr, f>));
  SIZES
#undef SIZE
  return -1;
}
extern "C" int coop_max_springs() { return chord::coop::kCoopSprings; }
"""

def _loop(bodies, sizes, head=""):
    """LOOP with the (N, NR, feat) builds of its bodies and sizes."""
    return (LOOP.replace("HEAD", head)
            .replace("  BODIES", "\n".join(f"  BODY({n}, {nr}, {f})" for n, nr, f in bodies))
            .replace("  SIZES", "\n".join(f"  SIZE({n}, {nr}, {f})" for n, nr, f in sizes)))


# The builds of the unit as the fixed library sizes them, and of the unit
# whose records hold MIX_SPRINGS springs (the mixes: chain-ground-6 with a
# spring, the umbrella, the mixed-joint scene with springs).
BODIES = [(12, 12, 0), (12, 12, 2), (12, 12, 18), (3, 3, 0), (3, 3, 2), (3, 3, 18)]
SIZES = [(12, 12, 0), (12, 12, 1), (4, 4, 0), (4, 4, 1), (12, 12, 32), (12, 12, 33),
         (12, 12, 17), (12, 12, 2), (12, 12, 18), (4, 3, 4), (4, 3, 20)]
MIX_SPRINGS = 34
MIX_BODIES = [(6, 6, 3), (8, 7, 2), (6, 8, 2), (3, 3, 2)]
S, PL = chord_kernel.SPRINGS, chord_kernel.PERLANE
JCFG = jint.NewtonConfig(**CFG_KW)


def _bind(lib):
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.chord_bdf2_springs_cpu.argtypes = [i] * 6 + [p] * 9 + [i, f, f, f, p, p]
    lib.chord_bdf2_springs_cpu.restype = i
    lib.coop_lane_bytes.argtypes = [i, i, i]
    lib.coop_lane_bytes.restype = ctypes.c_long
    lib.coop_max_springs.restype = i
    return lib


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    return _bind(_gxx_build(tmp_path_factory, "coop_springs", _loop(BODIES, SIZES)))


@pytest.fixture(scope="module")
def mix_lib(tmp_path_factory):
    head = f"#define CHORD_MAX_SPRINGS {MIX_SPRINGS}"
    return _bind(_gxx_build(tmp_path_factory, "coop_spring_mixes",
                            _loop(MIX_BODIES, MIX_BODIES, head)))


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
    assert len(fns) <= chord_kernel.COOP_LIBRARY_SPRINGS
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
    wrapper's COOP_LIBRARY_SPRINGS springs (the spring chain's three)."""
    assert lib.coop_max_springs() == chord_kernel.COOP_LIBRARY_SPRINGS >= 3
    for key in chord_kernel.COOP_INSTANTIATED:
        block = 8 * lib.coop_lane_bytes(*key)
        assert 0 < block <= 232_448, (key, block)
        if key in BLOCK_BYTES:
            assert block == BLOCK_BYTES[key], (key, block)
    cables = {(4, 3, chord_kernel.CABLES), (4, 3, chord_kernel.CABLES | PL)}
    assert set(BLOCK_BYTES) | {(12, 12, S), (12, 12, S | PL)} | cables == \
        set(chord_kernel.COOP_INSTANTIATED)


def chain_ground_spring():
    """chain-ground-6 at the contact-MPC workload's coefficients (a contact on
    every link) with a spring-damper from a world point above the root to
    the tip: the tip body takes a contact and the spring's wrench."""
    b = jground(nlinks=6, **BENCH_GROUND)
    b.force_spring_damper(-1, 5, [0.0, 0.0, 3.0], [0.5, 0.0, 0.0], k=200.0, d=2.0)
    return b


def mixed_springs():
    """The mixed-joint scene (N = 6, nr = 8: planar and translational
    joints) with a spring-damper from the world to body 5 and a point-point
    spring between bodies 1 and 4."""
    b = mixed_builder(jscene, JJT)
    b.force_spring_damper(-1, 5, [2.0, 0.0, 1.0], [0.2, 0.0, 0.0], k=100.0, d=1.0)
    b.force_point_point(1, 4, xl1=(0.5, 0, 0.05), xl2=(0.3, 0, -0.05), k=50.0, d=2.0)
    return b


def chain_many_springs(n=MIX_SPRINGS):
    """scene_chain(3) with n soft springs, spring-dampers and point-point
    ones in turn, between the world and the links and between links: more
    springs (and endpoints and pair blocks) than a warp has threads."""
    b = jchain(nlinks=3)
    for k in range(n):
        b1, b2 = (k % 4) - 1, k % 3
        xl1 = (0.3 + 0.01 * k, 0.0, 0.5 if b1 < 0 else 0.02)
        xl2 = (0.2 + 0.02 * (k % 5), 0.0, -0.02)
        if k % 2:
            b.force_point_point(b1, b2, xl1=xl1, xl2=xl2, k=2.0, d=0.1)
        else:
            b.force_spring_damper(b1, b2, list(xl1), list(xl2), k=5.0, d=0.2)
    return b


# (scene, states, the build's kinds) of each mix
MIXES = {
    "chain-ground-6-spring": (chain_ground_spring, lambda sc: contact_states(sc.topo.nr, 8),
                              chord_kernel.CONTACTS | S),
    "umbrella": (jscenes.scene_umbrella, lambda sc: zoo_states(sc, 8, seed=3), S),
    "mixed-springs": (mixed_springs, lambda sc: _states(sc.topo.nr, 8), S),
    "chain-34-springs": (chain_many_springs, lambda sc: _states(sc.topo.nr, 8), S),
}


@pytest.mark.parametrize("case", list(MIXES))
def test_coop_spring_mixes_match_kernel_body(mix_lib, case):
    """Springs with contacts, six springs, and springs at nr > N in the
    cooperative body (records of six springs): bit for bit the
    thread-per-lane body (both tid orders), against chord_bdf2_dense(xp=np)
    at x 5e-6 max(1, |x|) and H^-1 2e-5 of scale, the springs acting (with
    their k = d = 0 x is another); the record is coop_record_bytes',
    and the shape rule routes the scene to the cooperative design at 8
    lanes a block."""
    make, states_of, feat = MIXES[case]
    sc = make().compile(dtype=jnp.float32)
    states, tau = states_of(sc)
    topo, params, fns = _port(sc)
    N, nr = topo.njoints, topo.nr
    counts = chord_kernel.counts_of(chord_kernel.closure_spec(topo, fns))
    assert chord_kernel.kinds_of(topo, counts) == feat and counts.springs <= MIX_SPRINGS
    assert chord_kernel.takes_coop(N, nr, feat, springs=counts.springs)
    lanes = chord_kernel.coop_lanes(N, nr, feat, springs=counts.springs)
    assert lanes == (4 if counts.springs > 32 else chord_kernel.COOP_LANES), lanes
    assert chord_kernel.coop_record_bytes(N, nr, feat, springs=MIX_SPRINGS) == \
        mix_lib.coop_lane_bytes(N, nr, feat)
    assert (case == "umbrella") == (counts.springs == 6)
    assert (case == "mixed-springs") == (nr > N)
    x, hinv = _coop_equals_thread(mix_lib, topo, params, tau, states, fns, feat)
    x_np, hinv_np = pallas_step.chord_bdf2_dense(
        sc.topo, JCFG, {**sc.params, "tau": jnp.asarray(tau)}, *states, xp=np,
        force_fns=sc.force_fns)
    finite = np.isfinite(x_np).all(-1)
    # _states' last lane (qdot 1e6, angles near 1e4 rad, where numpy's
    # float32 sin and cos are not libm's) is not float32's to determine:
    # with the 34 soft springs neither solve rejects it, and it is held on
    # the other lanes only (bit for bit the thread-per-lane body above)
    n = -1 if case == "chain-34-springs" else None
    hold_rel(x[:n], hinv[:n], x_np[:n], hinv_np[:n])
    springs = {fn.key for fn in fns if isinstance(fn, (ForcePointPoint, ForceSpringDamper))}
    zero = {key: {**fp, "k": fp["k"] * 0, "d": fp["d"] * 0} if key in springs else fp
            for key, fp in params["forces"].items()}
    x_free, _ = _run(mix_lib, topo, {**params, "forces": zero}, tau, states, fns, feat)
    both = finite & np.isfinite(x_free).all(-1)
    assert np.abs(x_free[both] - x[both]).max() > 1e-4


def test_coop_spring_mix_nan_lane_stays_in_its_lane(mix_lib):
    """chain-ground-6 with a spring: a lane with a NaN q1 comes out NaN and
    leaves every other lane's x and H^-1 bit-equal."""
    make, states_of, feat = MIXES["chain-ground-6-spring"]
    sc = make().compile(dtype=jnp.float32)
    states, tau = states_of(sc)
    topo, params, fns = _port(sc)
    poisoned = [a.copy() for a in states]
    poisoned[3][5] = np.nan
    x, hinv = _run(mix_lib, topo, params, tau, states, fns, feat)
    xp, hinvp = _run(mix_lib, topo, params, tau, poisoned, fns, feat)
    keep = np.arange(len(x)) != 5
    assert np.isnan(xp[5]).all() and np.isfinite(x).all(-1).mean() >= 0.75
    np.testing.assert_array_equal(xp[keep], x[keep])
    np.testing.assert_array_equal(hinvp[keep], hinv[keep])
