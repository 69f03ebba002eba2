"""The chord kernel at the scene zoo's shapes, on the CPU.

  * The kernel's plain version (chord_kernel.chord_bdf2_reference, what a
    CPU tensor runs) against the JAX package's numpy evaluation of the
    Pallas kernel body, pallas_step.chord_bdf2_dense(xp=np), at the
    tolerances of tests/test_pallas_step.py (x 5e-6 max(1, |x|), H^-1 2e-5
    of scale) on states about the initial state of scenes 1-5 and 14 (half
    of 14's lanes on either side of a joint limit, within 0.05 of it),
    scene_tree, scene_bridge and scene_umbrella. The bridge's H reaches
    cond 3.4e3 there, where each float32 H^-1 lies about 5e-5 of scale from
    the float64 one, so two float32 orders cannot agree to 2e-5: its H^-1 is
    held against the port's plain version in float64 instead, no farther
    from it than twice the oracle's own distance.
  * The cooperative body (csrc/chord_bdf2_coop.cuh, each phase run for
    every tid in turn, forward and reversed, the record started as NaN) at
    scene 14's (3, 3), the bridge's (10, 8) and the tree's (15, 15), bit for
    bit against the thread-per-lane body (csrc/chord_bdf2_lane.cuh, the same
    g++ unit) and against the oracle; at scene 14 on lanes straddling
    qlimL and qlimU. The thread-per-lane body at the umbrella's (8, 7) with
    its six spring-dampers (its yardstick on the card), against the oracle;
    tests/test_torch_coop_springs.py holds the cooperative body there.
  * chord_kernel.scene_build names the design each scene runs on the card:
    the cooperative one for every scene (the umbrella's record sized for
    its six springs), a build made for the scene (no fixed library holds
    these shapes), and chord_kernel.supports is false for scenes 7 and 9 on
    Euler charts (the op-level route).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from redmax_tpu import integrators as jint
from redmax_tpu import pallas_step
from redmax_tpu import scenes as jscenes
from redmax_tpu_torch import chord_kernel as ck
from redmax_tpu_torch import convert
from redmax_tpu_torch import integrators as tint
from redmax_tpu_torch import scenes as tscenes
from test_torch_any_shape import _run_lane
from test_torch_certificates import single_thread  # noqa: F401
from test_torch_lane_body import CFG_KW, _gxx_build, _port

SCENES = {
    **{str(s): (lambda s=s: jscenes.SCENES[s](), lambda s=s: tscenes.SCENES[s]())
       for s in (1, 2, 3, 4, 5, 14, -2, -1, 100)},
    "tree": (jscenes.scene_tree, tscenes.scene_tree),
    "bridge": (jscenes.scene_bridge, tscenes.scene_bridge),
    "umbrella": (jscenes.scene_umbrella, tscenes.scene_umbrella),
}
LOOP = r"""
#include <cstring>
#include "chord_bdf2_coop.cuh"
namespace co = chord::coop;
extern "C" int chord_bdf2_cpu(int N, int NR, int feat, int B, const float* x0, const float* q0,
                              const float* qd0, const float* q1, const float* qd1,
                              const float* tau, const int* topo_i, const float* stat_f,
                              const float* lane_f, int fixed_iters, float growth_reject,
                              float tol_reject, float dx_clamp, int guarded, int guard_last,
                              int chord_mode, float* x_out, float* hinv_out) {
  const chord::ChordConfig cfg{fixed_iters, growth_reject, tol_reject, dx_clamp};
#define LANE(n, nr, f)                                                                      \
  if (N == n && NR == nr && feat == f) {                                                    \
    for (int lane = 0; lane < B; ++lane)                                                    \
      chord::chord_bdf2_lane<n, nr, f>(lane, B, x0, q0, qd0, q1, qd1, tau, topo_i, stat_f, \
                                       cfg, x_out, hinv_out, lane_f);                       \
    return 0;                                                                               \
  }
  LANE(3, 3, 0)
  LANE(10, 8, 0)
  LANE(15, 15, 0)
  LANE(8, 7, 2)
  return -1;
}
struct SerialRun {
  int reverse;
  template <class F>
  void operator()(int, F&& f) const {
    for (int i = 0; i < co::kWarp; ++i) f(reverse ? co::kWarp - 1 - i : i);
  }
};
extern "C" int chord_coop_cpu(int N, int NR, int feat, int reverse, int B, const float* x0,
                              const float* q0, const float* qd0, const float* q1,
                              const float* qd1, const float* tau, const int* topo_i,
                              const float* stat_f, const float* lane_f, int fixed_iters,
                              float growth_reject, float tol_reject, float dx_clamp,
                              float* x_out, float* hinv_out) {
  const chord::ChordConfig cfg{fixed_iters, growth_reject, tol_reject, dx_clamp};
  const SerialRun run{reverse};
#define COOP(n, nr, f)                                                                      \
  if (N == n && NR == nr && feat == f) {                                                    \
    static co::LaneOf<n, nr, f> L;                                                          \
    for (int lane = 0; lane < B; ++lane) {                                                  \
      std::memset(&L, 0xff, sizeof L);                                                      \
      co::solve<n, nr, f>(run, L, lane, B, x0, q0, qd0, q1, qd1, tau, topo_i, stat_f, cfg,  \
                          x_out, hinv_out, lane_f);                                         \
    }                                                                                       \
    return 0;                                                                               \
  }
  COOP(3, 3, 0)
  COOP(10, 8, 0)
  COOP(15, 15, 0)
  return -1;
}
"""


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    import ctypes

    lib = _gxx_build(tmp_path_factory, "zoo_kernel", LOOP)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.chord_bdf2_cpu.argtypes = [i, i, i, i] + [p] * 9 + [i, f, f, f, i, i, i, p, p]
    lib.chord_bdf2_cpu.restype = i
    lib.chord_coop_cpu.argtypes = [i] * 5 + [p] * 9 + [i, f, f, f, p, p]
    lib.chord_coop_cpu.restype = i
    return lib


def zoo_states(sc, B, seed=1):
    """Chord-solve inputs about a JAX scene's initial state (float32): q1 =
    q + 0.2 N(0, 1), qdot1 = qdot + 0.5 N(0, 1), the history one step back,
    the quadratic predictor, tau 0.3 N(0, 1); on a scene with joint limits
    half the lanes put each joint within 0.05 of a limit, on either side."""
    rng = np.random.default_rng(seed)
    nr, h = sc.topo.nr, float(sc.params["h"])
    q1 = np.asarray(sc.state0.q) + 0.2 * rng.normal(size=(B, nr))
    qd1 = np.asarray(sc.state0.qdot) + 0.5 * rng.normal(size=(B, nr))
    lo, hi = np.asarray(sc.params["qlimL"]), np.asarray(sc.params["qlimU"])
    if (hi < 1e7).any():
        lim = np.where(rng.random(size=(B, nr)) < 0.5, lo, hi)
        near = lim + rng.uniform(-0.05, 0.05, size=(B, nr))
        q1[::2] = near[::2]
        qd1[::2] *= 0.1
    q0 = q1 - h * qd1
    qd0 = qd1 + 0.05 * rng.normal(size=(B, nr))
    x0 = q1 + h * qd1 + 0.5 * h * (qd1 - qd0)
    tau = 0.3 * rng.normal(size=(B, nr))
    f = lambda a: a.astype(np.float32)
    return tuple(f(a) for a in (x0, q0, qd0, q1, qd1)), f(tau)


def _oracle(sc, states, tau):
    return pallas_step.chord_bdf2_dense(sc.topo, jint.NewtonConfig(**CFG_KW),
                                        {**sc.params, "tau": tau}, *states, xp=np,
                                        force_fns=sc.force_fns)


def _plain64(sc, states, tau):
    """H^-1 of the port's plain version in float64 on the same inputs."""
    topo, _, fns = _port(sc)
    p64 = {**convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, sc.params), "cpu"),
           "tau": torch.tensor(tau).double()}
    return ck.chord_bdf2_reference(topo, tint.NewtonConfig(**CFG_KW), p64,
                                   *(torch.tensor(a).double() for a in states), fns)[1].numpy()


def _hold(x, hinv, x_np, hinv_np, min_finite=0.75, hinv64=None):
    """x within 5e-6 max(1, |x|) of the oracle and H^-1 within 2e-5 of scale
    on the lanes where the oracle is finite (the finite masks equal); with
    hinv64, H^-1 no farther from it than twice the oracle's distance."""
    finite = np.isfinite(x_np).all(-1)
    assert finite.mean() >= min_finite, finite
    np.testing.assert_array_equal(np.isfinite(np.asarray(x)).all(-1), finite)
    x, hinv = np.asarray(x)[finite], np.asarray(hinv)[finite]
    dx = np.abs(x - x_np[finite]) / np.maximum(1.0, np.abs(x_np[finite]))
    assert float(dx.max()) <= 5e-6, float(dx.max())
    scale = float(np.abs(hinv_np[finite]).max())
    if hinv64 is None:
        np.testing.assert_allclose(hinv, hinv_np[finite], rtol=0, atol=2e-5 * scale)
        return
    gap = lambda h: float(np.abs(h - hinv64[finite]).max()) / scale
    assert gap(hinv) <= 2.0 * gap(hinv_np[finite]), (gap(hinv), gap(hinv_np[finite]))


def _limit_census(sc, x):
    """Lanes whose solution lies past a limit, and lanes within 1e-5 of one
    (where two float32 orders could take the limit's branch differently)."""
    lo, hi = np.asarray(sc.params["qlimL"]), np.asarray(sc.params["qlimU"])
    past = ((x < lo) | (x > hi)).any(-1)
    close = (np.minimum(np.abs(x - lo), np.abs(x - hi)) <= 1e-5).any(-1)
    return past, close


@pytest.mark.parametrize("scene", ["1", "2", "3", "4", "5", "14", "tree", "bridge", "umbrella"])
def test_plain_version_matches_kernel_body(scene):
    sc = SCENES[scene][0]().compile(dtype=jnp.float32)
    states, tau = zoo_states(sc, 16)
    x_np, hinv_np = _oracle(sc, states, tau)
    topo, params, fns = _port(sc)
    x, hinv = ck.chord_bdf2_reference(topo, tint.NewtonConfig(**CFG_KW),
                                      {**params, "tau": torch.tensor(tau)},
                                      *(torch.tensor(a) for a in states), fns)
    if scene == "14":
        past, close = _limit_census(sc, x_np)
        assert 0 < past.sum() < len(past) and not close.any(), (past, close)
    _hold(x.numpy(), hinv.numpy(), x_np, hinv_np,
          hinv64=_plain64(sc, states, tau) if scene == "bridge" else None)


@pytest.mark.parametrize("scene", ["14", "bridge", "tree"])
def test_coop_body_equals_lane_body(lib, scene):
    sc = SCENES[scene][0]().compile(dtype=jnp.float32)
    states, tau = zoo_states(sc, 16, seed=2)
    topo, params, fns = _port(sc)
    key = (topo.njoints, topo.nr, 0)
    assert ck.takes_coop(*key) and key not in ck.COOP_INSTANTIATED
    x, hinv = _run_lane(lib, topo, params, tau, states, fns, 0, CFG_KW, coop="forward")
    for other in ("reverse", None):
        xo, hinvo = _run_lane(lib, topo, params, tau, states, fns, 0, CFG_KW, coop=other)
        np.testing.assert_array_equal(xo, x, err_msg=str(other))
        np.testing.assert_array_equal(hinvo, hinv, err_msg=str(other))
    x_np, hinv_np = _oracle(sc, states, tau)
    if scene == "14":
        lo, hi = np.asarray(sc.params["qlimL"]), np.asarray(sc.params["qlimU"])
        below, above = (x_np < lo).any(-1), (x_np > hi).any(-1)
        assert below.any() and above.any() and not (x_np[:, None] == lo).any()
        assert not _limit_census(sc, x_np)[1].any()
    _hold(x, hinv, x_np, hinv_np, hinv64=_plain64(sc, states, tau) if scene == "bridge" else None)


def test_umbrella_lane_body(lib):
    """The umbrella's thread-per-lane build (the yardstick its cooperative
    build is timed against on the card): its body with six spring-dampers
    against the oracle."""
    sc = jscenes.scene_umbrella().compile(dtype=jnp.float32)
    states, tau = zoo_states(sc, 16, seed=3)
    topo, params, fns = _port(sc)
    assert ck.counts_of(ck.closure_spec(topo, fns)).springs == 6
    x, hinv = _run_lane(lib, topo, params, tau, states, fns, ck.SPRINGS, CFG_KW)
    _hold(x, hinv, *_oracle(sc, states, tau))


@pytest.mark.parametrize("scene", sorted(SCENES) + ["7-euler", "9-euler"])
def test_scene_build_names_the_design(scene):
    cfg = tint.NewtonConfig(**CFG_KW)
    if scene.endswith("euler"):
        make = {"7": tscenes.scene_07_spherical, "9": tscenes.scene_09_free3d}[scene[0]]
        sc = make(exp_coords=False).compile(dtype=torch.float32, device="cpu")
        assert not ck.supports(sc.topo, sc.force_fns, cfg)
        step = tint.make_bdf2_step_batched(sc.topo, sc.force_fns, cfg)
        assert step.inner.__qualname__.startswith("make_bdf2_step.")   # the op-level route
        with pytest.raises(ValueError, match="not supported"):
            tint.make_bdf2_step_batched(sc.topo, sc.force_fns, cfg, use_kernel=True)
        return
    sc = SCENES[scene][1]().compile(dtype=torch.float32, device="cpu")
    assert ck.supports(sc.topo, sc.force_fns, cfg)
    build = ck.scene_build(sc.topo, sc.force_fns, sc.params, cfg)
    assert ck.is_coop(build), build.name
    if (sc.topo.njoints, sc.topo.nr) not in ((12, 12), (4, 4), (4, 3)):
        assert build not in ck.BUILDS and "-DCHORD_ONE" in build.defines
        assert f"-DCHORD_N={sc.topo.njoints}" in build.defines
