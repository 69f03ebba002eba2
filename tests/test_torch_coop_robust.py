"""CPU check of the chord kernel's cooperative body (one warp per lane) in
the robust solve modes (K1g) and with per-lane params (K1f).
csrc/chord_bdf2_coop.cuh is compiled with plain g++ behind an extern "C"
loop over lanes that runs each phase for every tid of the warp in turn
(forward, or in reverse order, which must agree bit for bit), each lane's
record filled with NaN first, as in tests/test_torch_coop_body.py; the
thread-per-lane body (chord_bdf2_lane.cuh) is built in the same g++ unit.

- The robust body in each of guarded, guard_last, chord=False and guarded
  chord=False on the card's two robust shapes (chain-12 on the states of
  tests/test_torch_lane_body.py::_robust_case, torques scaled up on half
  the lanes, and chain-ground-12 at the contact-MPC workload's
  coefficients) gives the thread-per-lane robust body's x and H^-1 bit for
  bit, and is held against pallas_step.chord_bdf2_dense(xp=np) in the same
  mode at that file's tolerances on the lanes float32 determines; each
  branch of the guard (full, half, stay put) is taken on some of them. In
  the chord mode the robust body gives the chord body's result bit for bit.
- The per-lane body on chain-ground-12 under per-lane I_i, body damping, g,
  h and contact kn, mu gives the thread-per-lane PERLANE body's result bit
  for bit and is held against chord_bdf2_dense with its perlane reads;
  lane-shared params broadcast into the per-lane buffer give the build
  without it bit for bit.
- Per-lane params in the robust modes (C | PERLANE | ROBUST, the randomized
  contact solve's build) on chain-ground-12 under the same draws, the
  torques of about half the lanes scaled up 300x, in guarded, guard_last
  and chord=False: bit for bit the thread-per-lane robust PERLANE body
  (both tid orders), and held against chord_bdf2_dense(xp=np) with its
  perlane reads in the same mode as the robust cases above are; the guard
  acts on some held lane.
- A NaN lane stays in its lane in each.

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
from test_torch_lane_body import CFG_KW, ROBUST_MODES, _gxx_build, _perlane_case, _port, \
    _robust_case


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
  chord::RobustConfig rc;
  float *x_out, *hinv_out;
};
template <int n, int nr, int f>
void run_coop(const SerialRun& run, const Args& a) {
  static chord::coop::LaneOf<n, nr, f> L;
  for (int lane = 0; lane < a.B; ++lane) {
    std::memset(&L, 0xff, sizeof L);  // NaN floats, -1 ints
    chord::coop::solve<n, nr, f>(run, L, lane, a.B, a.x0, a.q0, a.qd0, a.q1, a.qd1, a.tau,
                                 a.topo_i, a.stat_f, a.cfg, a.x_out, a.hinv_out, a.lane_f, a.rc);
  }
}
template <int n, int nr, int f>
void run_thread(const Args& a) {
  for (int lane = 0; lane < a.B; ++lane) {
    if constexpr ((f & chord::kRobust) != 0)
      chord::chord_bdf2_lane_robust<n, nr, f>(lane, a.B, a.x0, a.q0, a.qd0, a.q1, a.qd1, a.tau,
                                              a.topo_i, a.stat_f, a.cfg, a.rc, a.x_out,
                                              a.hinv_out, a.lane_f);
    else
      chord::chord_bdf2_lane<n, nr, f>(lane, a.B, a.x0, a.q0, a.qd0, a.q1, a.qd1, a.tau,
                                       a.topo_i, a.stat_f, a.cfg, a.x_out, a.hinv_out,
                                       a.lane_f);
  }
}
#define BODY(f)                           \
  if (feat == f) {                        \
    if (coop)                             \
      run_coop<12, 12, f>(SerialRun{reverse}, a); \
    else                                  \
      run_thread<12, 12, f>(a);           \
    return 0;                             \
  }
// coop: 1 the cooperative body, 0 the thread-per-lane one; feat: the kinds
// of the (12, 12) build (1 contacts, 16 per-lane params, 32 robust modes).
extern "C" long coop_lane_bytes_12(int feat) {
  return feat == 49 ? static_cast<long>(sizeof(chord::coop::LaneOf<12, 12, 49>)) : -1;
}
extern "C" int chord_bdf2_12_cpu(int coop, int reverse, int feat, int B, const float* x0,
                                 const float* q0, const float* qd0, const float* q1,
                                 const float* qd1, const float* tau, const int* topo_i,
                                 const float* stat_f, const float* lane_f, int fixed_iters,
                                 float growth_reject, float tol_reject, float dx_clamp,
                                 int guarded, int guard_last, int chord_mode, float* x_out,
                                 float* hinv_out) {
  const Args a{B, x0, q0, qd0, q1, qd1, tau, topo_i, stat_f, lane_f,
               chord::ChordConfig{fixed_iters, growth_reject, tol_reject, dx_clamp},
               chord::RobustConfig{guarded, guard_last, chord_mode}, x_out, hinv_out};
  BODY(0)
  BODY(1)
  BODY(17)
  BODY(32)
  BODY(33)
  BODY(49)
  return -1;
}
"""


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    lib = _gxx_build(tmp_path_factory, "coop_robust", LOOP)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.chord_bdf2_12_cpu.argtypes = [i] * 4 + [p] * 9 + [i, f, f, f, i, i, i, p, p]
    lib.chord_bdf2_12_cpu.restype = i
    lib.coop_lane_bytes_12.argtypes = [i]
    lib.coop_lane_bytes_12.restype = ctypes.c_long
    return lib


def _run(lib, topo, params, tau, states, fns, feat, cfg_kw=CFG_KW, body="coop", reverse=False):
    """(x [B, nr], Hinv [B, nr, nr]) of the g++ body ("coop" or "thread")
    of the (12, 12) build of kinds feat, in the solve mode of cfg_kw, on the
    wrapper's own packing of the inputs (with per-lane params, the per-lane
    buffer too)."""
    B, nr = states[0].shape
    packed = chord_kernel.pack(topo, {**params, "tau": torch.tensor(tau)},
                               *(torch.tensor(a) for a in states), fns)
    chord_kernel.check_buffers(topo, *packed[6:])
    assert (packed[-1] is not None) == bool(feat & chord_kernel.PERLANE)
    args = [np.ascontiguousarray(a.numpy()) for a in packed[:8]]
    args.append(None if packed[-1] is None else np.ascontiguousarray(packed[-1].numpy()))
    x_out = np.empty((nr, B), np.float32)
    h_out = np.empty((nr * nr, B), np.float32)
    cfg = tint.NewtonConfig(**cfg_kw)
    ptr = lambda a: None if a is None else a.ctypes.data_as(ctypes.c_void_p)
    rc = lib.chord_bdf2_12_cpu(int(body == "coop"), int(reverse), feat, B,
                               *(ptr(a) for a in args), cfg.fixed_iters, cfg.growth_reject,
                               cfg.tol_reject, cfg.dx_clamp, int(cfg.guarded),
                               int(cfg.guard_last), int(cfg.chord), ptr(x_out), ptr(h_out))
    assert rc == 0, feat
    return x_out.T, h_out.reshape(nr, nr, B).transpose(2, 0, 1)


def _coop_equals_thread(lib, topo, params, tau, states, fns, feat, cfg_kw=CFG_KW):
    """The cooperative body's result, after checking that its forward and
    reverse tid orders and the thread-per-lane body give it bit for bit."""
    x, hinv = _run(lib, topo, params, tau, states, fns, feat, cfg_kw)
    for kw in (dict(reverse=True), dict(body="thread")):
        xo, hinvo = _run(lib, topo, params, tau, states, fns, feat, cfg_kw, **kw)
        np.testing.assert_array_equal(xo, x)
        np.testing.assert_array_equal(hinvo, hinv)
    return x, hinv


@pytest.mark.parametrize("mode", list(ROBUST_MODES))
@pytest.mark.parametrize("case", ["chain12", "ground12"])
def test_coop_robust_body_matches_kernel_body(lib, case, mode):
    """The cooperative robust body in each robust mode: bit for bit the
    thread-per-lane robust body (both tid orders), and against
    chord_bdf2_dense(xp=np) in the same mode with the finite masks equal, x
    at 5e-6 and H^-1 (the last one built) at 2e-5 of scale on every lane
    float32 determines (the oracle within 1e-3 max(1, |x|) of the port's
    plain version in float64, at least 3/4 of the finite lanes, as
    tests/test_torch_lane_body.py holds the thread-per-lane body); in the
    guarded modes each branch of the guard fires on some held lane (a census
    from the float64 plain version's steps)."""
    sc, states, tau, feat = _robust_case(case)
    kw = ROBUST_MODES[mode]
    topo, params, fns = _port(sc)
    x, hinv = _coop_equals_thread(lib, topo, params, tau, states, fns, feat, kw)
    x_np, hinv_np = pallas_step.chord_bdf2_dense(
        sc.topo, jint.NewtonConfig(**kw), {**sc.params, "tau": jnp.asarray(tau)}, *states,
        xp=np, force_fns=sc.force_fns)
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
        steps = info["steps"].numpy()
        census = {s: int(((steps == s).any(-1) & held).sum()) for s in (1.0, 0.5, 0.0)}
        assert min(census.values()) > 0, census
    np.testing.assert_allclose(x[held], x_np[held], rtol=0, atol=5e-6)
    scale = float(np.abs(hinv_np[held]).max())
    np.testing.assert_allclose(hinv[held], hinv_np[held], rtol=0, atol=2e-5 * scale)


@pytest.mark.parametrize("case", ["chain12", "ground12"])
def test_coop_robust_body_guard_moves_lanes(lib, case):
    """The guard acts in the cooperative body: guarded and guard_last each
    end some lanes elsewhere than the unguarded chord solve (another x, or
    a rejection), and chord=False ends with another H^-1 than chord."""
    sc, states, tau, feat = _robust_case(case)
    topo, params, fns = _port(sc)
    x0, h0 = _run(lib, topo, params, tau, states, fns, feat & ~chord_kernel.ROBUST)
    fin0 = np.isfinite(x0).all(-1)
    for mode in ("guarded", "guard_last"):
        x, _ = _run(lib, topo, params, tau, states, fns, feat, ROBUST_MODES[mode])
        fin = np.isfinite(x).all(-1)
        moved = (fin != fin0) | (fin & fin0 & (np.abs(x - x0) > 1e-4).any(-1))
        assert moved.sum() > 0, mode
    _, hr = _run(lib, topo, params, tau, states, fns, feat, ROBUST_MODES["rehess"])
    assert (np.abs(hr - h0).reshape(len(hr), -1).max(-1) > 1e-6 * np.abs(h0).max()).mean() > 0.5


@pytest.mark.parametrize("case", ["chain12", "ground12"])
def test_coop_robust_body_in_chord_mode_equals_chord_body(lib, case):
    """The kRobust build of the cooperative solve run in the unguarded chord
    mode gives the build without kRobust x and H^-1 bit for bit: the
    robust parts of the one solve loop leave the chord mode as it is (the
    launcher sends that mode to the chord build)."""
    sc, states, tau, feat = _robust_case(case)
    topo, params, fns = _port(sc)
    x, hinv = _run(lib, topo, params, tau, states, fns, feat)
    x0, hinv0 = _run(lib, topo, params, tau, states, fns, feat & ~chord_kernel.ROBUST)
    np.testing.assert_array_equal(x, x0)
    np.testing.assert_array_equal(hinv, hinv0)


def test_coop_perlane_contacts_matches_kernel_body(lib):
    """The cooperative body with per-lane I_i, body damping, g, h and each
    contact's kn and mu on chain-ground-12 (test_torch_perlane.perlane_params):
    bit for bit the thread-per-lane PERLANE body (both tid orders), and
    against chord_bdf2_dense(xp=np) with its perlane reads at the
    tolerances of tests/test_pallas_step.py; the draws matter (the
    lane-shared params give another result)."""
    sc, pn, tau, states, feat = _perlane_case("contacts")
    assert feat == chord_kernel.CONTACTS | chord_kernel.PERLANE
    pj = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32), pn)
    assert {"I_i", "gh", "bd"} <= pallas_step._perlane_keys(pj, sc.force_fns)
    topo, shared, fns = _port(sc)
    params = convert.params_from_numpy(pn, "cpu", torch.float32)
    x, hinv = _coop_equals_thread(lib, topo, params, tau, states, fns, feat)
    x_np, hinv_np = pallas_step.chord_bdf2_dense(
        sc.topo, jint.NewtonConfig(**CFG_KW), {**pj, "tau": jnp.asarray(tau)}, *states, xp=np,
        force_fns=sc.force_fns)
    finite = np.isfinite(x_np).all(-1)
    assert finite.mean() >= 0.75, finite
    np.testing.assert_array_equal(np.isfinite(x).all(-1), finite)
    np.testing.assert_allclose(x[finite], x_np[finite], rtol=0, atol=5e-6)
    scale = float(np.abs(hinv_np[finite]).max())
    np.testing.assert_allclose(hinv[finite], hinv_np[finite], rtol=0, atol=2e-5 * scale)
    xs, _ = _run(lib, topo, shared, tau, states, fns, chord_kernel.CONTACTS)
    assert np.abs(xs[finite] - x[finite]).max() > 1e-4


def test_coop_perlane_broadcast_equals_shared_build(lib):
    """Lane-shared params broadcast into the per-lane buffer (h expanded to
    [B]) give the cooperative build without per-lane params bit for bit:
    every field is read at its offset of the lane's record."""
    sc, _, tau, states, feat = _perlane_case("contacts")
    B = states[0].shape[0]
    topo, shared, fns = _port(sc)
    xb, hb = _coop_equals_thread(lib, topo, {**shared, "h": shared["h"].expand(B)}, tau, states,
                                 fns, feat)
    x0, h0 = _run(lib, topo, shared, tau, states, fns, chord_kernel.CONTACTS)
    assert np.isfinite(x0).all(-1).mean() >= 0.75
    np.testing.assert_array_equal(xb, x0)
    np.testing.assert_array_equal(hb, h0)


def _perlane_robust_case(B=24, up=True):
    """chain-ground-12 under _perlane_case's per-lane draws (I_i, body
    damping, g, h, each contact's kn and mu), its torques 3x the draws' and,
    with up, scaled up 300x on about half the lanes, so that the guard takes
    half steps and stays put on some (as _robust_case does)."""
    sc, pn, tau, states, feat = _perlane_case("contacts", B)
    lanes = np.random.default_rng(7).choice([1.0, 300.0 if up else 1.0], size=(B, 1))
    return sc, pn, (3.0 * tau * lanes).astype(np.float32), states, feat | chord_kernel.ROBUST


@pytest.mark.parametrize("mode", ["guarded", "guard_last", "rehess"])
def test_coop_perlane_robust_matches_kernel_body(lib, mode):
    """The cooperative body with per-lane params in a robust mode (the
    (12, 12) C | PERLANE | ROBUST build): bit for bit the thread-per-lane
    robust PERLANE body (both tid orders), and against chord_bdf2_dense(
    xp=np) with its perlane reads in the same mode, the finite masks equal,
    x at 5e-6 and H^-1 at 2e-5 of scale on the lanes float32 determines
    (the oracle within 1e-3 max(1, |x|) of the port's plain version in
    float64, at least 3/4 of the finite lanes); in the guarded modes the
    guard acts on some held lane; its record is coop_record_bytes'.
    chord=False has no guard: it is held against the oracle on the draws'
    torques without the 300x lanes, and bit for bit against the
    thread-per-lane body on both (with the 300x lanes, where H is rebuilt
    at stiff iterates from their own roundoff, the two bodies, bit for bit
    one, and the oracle part by up to 1e-5 in x and 3e-5 of scale in
    H^-1)."""
    sc, pn, tau, states, feat = _perlane_robust_case()
    assert feat == chord_kernel.CONTACTS | chord_kernel.PERLANE | chord_kernel.ROBUST
    assert chord_kernel.coop_record_bytes(12, 12, feat) == lib.coop_lane_bytes_12(feat)
    kw = ROBUST_MODES[mode]
    topo, _, fns = _port(sc)
    params = convert.params_from_numpy(pn, "cpu", torch.float32)
    if mode == "rehess":
        _coop_equals_thread(lib, topo, params, tau, states, fns, feat, kw)
        tau = _perlane_robust_case(up=False)[2]
    p = {**params, "tau": torch.tensor(tau)}
    assert chord_kernel.is_coop(chord_kernel.scene_build(topo, fns, p, tint.NewtonConfig(**kw)))
    x, hinv = _coop_equals_thread(lib, topo, params, tau, states, fns, feat, kw)
    pj = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32), pn)
    x_np, hinv_np = pallas_step.chord_bdf2_dense(
        sc.topo, jint.NewtonConfig(**kw), {**pj, "tau": jnp.asarray(tau)}, *states, xp=np,
        force_fns=sc.force_fns)
    info = {}
    p64 = jax.tree_util.tree_map(lambda a: a.double(), p)
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
        assert ((info["steps"].numpy() < 1.0).any(-1) & held).sum() > 0
    np.testing.assert_allclose(x[held], x_np[held], rtol=0, atol=5e-6)
    scale = float(np.abs(hinv_np[held]).max())
    np.testing.assert_allclose(hinv[held], hinv_np[held], rtol=0, atol=2e-5 * scale)


@pytest.mark.parametrize("case", ["guarded", "rehess", "perlane", "perlane_guarded"])
def test_coop_nan_lane_stays_in_its_lane(lib, case):
    """A lane with a NaN input (robust: a NaN q1; per-lane: a NaN h) comes out
    NaN and leaves every other lane's x and H^-1 bit-equal."""
    if case == "perlane_guarded":
        sc, pn, tau, states, feat = _perlane_robust_case()
        topo, _, fns = _port(sc)
        params, kw = convert.params_from_numpy(pn, "cpu", torch.float32), ROBUST_MODES["guarded"]
        poisoned_params = {**params, "h": params["h"].clone()}
        poisoned_params["h"][5] = float("nan")
        poisoned = states
    elif case == "perlane":
        sc, pn, tau, states, feat = _perlane_case("contacts")
        topo, _, fns = _port(sc)
        params, kw = convert.params_from_numpy(pn, "cpu", torch.float32), CFG_KW
        poisoned_params = {**params, "h": params["h"].clone()}
        poisoned_params["h"][5] = float("nan")
        poisoned = states
    else:
        sc, states, tau, feat = _robust_case("ground12")
        topo, params, fns = _port(sc)
        kw, poisoned_params = ROBUST_MODES[case], params
        poisoned = [a.copy() for a in states]
        poisoned[3][5] = np.nan
    B = states[0].shape[0]
    x, hinv = _run(lib, topo, params, tau, states, fns, feat, kw)
    xp, hinvp = _run(lib, topo, poisoned_params, tau, poisoned, fns, feat, kw)
    keep = np.arange(B) != 5
    assert np.isnan(xp[5]).all() and np.isfinite(x).all(-1).mean() >= 0.5
    np.testing.assert_array_equal(xp[keep], x[keep])
    np.testing.assert_array_equal(hinvp[keep], hinv[keep])
