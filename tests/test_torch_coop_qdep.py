"""CPU check of the chord kernel's cooperative body with the q-dependent
joints (K1b: the kQdep build of csrc/chord_bdf2_coop.cuh, one warp per
lane). The body is compiled with plain g++ behind an extern "C" loop over
lanes that runs each phase for every tid of the warp in turn (forward, or
in reverse order; the two must agree bit for bit, so that a phase that
reads what another thread writes in the same phase shows), each lane's
record started as NaN (so that a read of a value no phase wrote shows), at
(2, 4) (a two-joint universal chain), (2, 6) (a two-joint exp-map
spherical chain), (1, 6) (scene 9's FREE3D body) and (4, 12) (a FREE3D
root, a SPHERICAL, a UNIVERSAL and a REVOLUTE joint). Each is held

  * bit for bit against the thread-per-lane QDEP body
    (chord_bdf2_lane.cuh, built in the same g++ unit): the cooperative body
    calls its qdep_joint and sums in its order, and g++ contracts no
    multiply-add;
  * against the JAX package's numpy evaluation of the Pallas kernel body,
    pallas_step.chord_bdf2_dense(xp=np), at the tolerances of
    tests/test_pallas_step.py (x 5e-6, H^-1 2e-5 of scale), on states
    whose rotation vectors drive every branch of so3_exp_S (the Taylor
    branch s < 0.04, just above it, near |w| = 1.5 pi).

The same with closures beside the q-dependent joints: universal-3 with a
ground contact on every link (C | QDEP, (3, 6): the contacts' blocks beside
the q-dependent columns) and universal-2 with a spring-damper (QDEP |
SPRINGS, (2, 4), nr > N: the springs' G J_s in a store of their own), each
bit for bit the thread-per-lane body (both tid orders), held against
chord_bdf2_dense(xp=np) at the same tolerances, its record
coop_record_bytes'.

The packing of the inputs (chord_kernel.pack) is the wrapper's own, and the
wrapper's shape rule sends these shapes to the cooperative design.
"""

import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from redmax_tpu import integrators as jint
from redmax_tpu import pallas_step
from redmax_tpu import scene as jscene
from redmax_tpu import scenes as jscenes
from redmax_tpu.types import JointType as JJT
from redmax_tpu_torch import chord_kernel
from redmax_tpu_torch import integrators as tint
from test_torch_joints import qdep_chain_jax, qdep_mixed
from test_torch_chord import contact_states
from test_torch_lane_body import CFG_KW, _gxx_build, _port
from test_torch_qdep import qdep_states


@pytest.fixture(scope="module", autouse=True)
def single_thread():
    """torch's intra-op threads set to 1 for the module, then restored."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


QDEP = chord_kernel.QDEP
LOOP = r"""
#include <cstring>
#include "chord_bdf2_coop.cuh"
struct SerialRun {
  int reverse;
  template <class F>
  void operator()(int, F&& f) const {
    for (int i = 0; i < chord::coop::kWarp; ++i) f(reverse ? chord::coop::kWarp - 1 - i : i);
  }
};
// body 0: the cooperative body, tids forward; 1: reversed; 2: thread per lane
extern "C" int chord_qdep_cpu(int N, int NR, int body, int B, const float* x0, const float* q0,
                              const float* qd0, const float* q1, const float* qd1,
                              const float* tau, const int* topo_i, const float* stat_f,
                              int fixed_iters, float growth_reject, float tol_reject,
                              float dx_clamp, float* x_out, float* hinv_out) {
  const chord::ChordConfig cfg{fixed_iters, growth_reject, tol_reject, dx_clamp};
  const SerialRun run{body == 1};
#define QDEP_BODY(n, nr)                                                                      \
  if (N == n && NR == nr) {                                                                   \
    static chord::coop::LaneOf<n, nr, chord::kQdep> L;                                        \
    for (int lane = 0; lane < B; ++lane) {                                                    \
      if (body == 2) {                                                                        \
        chord::chord_bdf2_lane<n, nr, chord::kQdep>(lane, B, x0, q0, qd0, q1, qd1, tau,       \
                                                    topo_i, stat_f, cfg, x_out, hinv_out);    \
        continue;                                                                             \
      }                                                                                       \
      std::memset(&L, 0xff, sizeof L); /* NaN floats, -1 ints */                              \
      chord::coop::solve<n, nr, chord::kQdep>(run, L, lane, B, x0, q0, qd0, q1, qd1, tau,     \
                                              topo_i, stat_f, cfg, x_out, hinv_out);          \
    }                                                                                         \
    return 0;                                                                                 \
  }
  QDEP_BODY(2, 4)
  QDEP_BODY(2, 6)
  QDEP_BODY(1, 6)
  QDEP_BODY(4, 12)
#undef QDEP_BODY
  return -1;
}
// The same with closures beside the q-dependent joints (feat: the build's
// kinds).
extern "C" int chord_qdep_mix_cpu(int N, int NR, int feat, int body, int B, const float* x0,
                                  const float* q0, const float* qd0, const float* q1,
                                  const float* qd1, const float* tau, const int* topo_i,
                                  const float* stat_f, int fixed_iters, float growth_reject,
                                  float tol_reject, float dx_clamp, float* x_out,
                                  float* hinv_out) {
  const chord::ChordConfig cfg{fixed_iters, growth_reject, tol_reject, dx_clamp};
  const SerialRun run{body == 1};
#define MIX_BODY(n, nr, f)                                                                    \
  if (N == n && NR == nr && feat == f) {                                                      \
    static chord::coop::LaneOf<n, nr, f> L;                                                   \
    for (int lane = 0; lane < B; ++lane) {                                                    \
      if (body == 2) {                                                                        \
        chord::chord_bdf2_lane<n, nr, f>(lane, B, x0, q0, qd0, q1, qd1, tau, topo_i, stat_f,  \
                                         cfg, x_out, hinv_out);                               \
        continue;                                                                             \
      }                                                                                       \
      std::memset(&L, 0xff, sizeof L);                                                        \
      chord::coop::solve<n, nr, f>(run, L, lane, B, x0, q0, qd0, q1, qd1, tau, topo_i,        \
                                   stat_f, cfg, x_out, hinv_out);                             \
    }                                                                                         \
    return 0;                                                                                 \
  }
  MIX_BODY(3, 6, chord::kContacts | chord::kQdep)
  MIX_BODY(2, 4, chord::kQdep | chord::kSprings)
#undef MIX_BODY
  return -1;
}
extern "C" long qdep_mix_bytes(int N, int NR, int feat) {
  if (N == 3 && NR == 6 && feat == (chord::kContacts | chord::kQdep))
    return sizeof(chord::coop::LaneOf<3, 6, chord::kContacts | chord::kQdep>);
  if (N == 2 && NR == 4 && feat == (chord::kQdep | chord::kSprings))
    return sizeof(chord::coop::LaneOf<2, 4, chord::kQdep | chord::kSprings>);
  return -1;
}
"""

CASES = {
    "universal-2": lambda: qdep_chain_jax("universal", 2),
    "spherical-2": lambda: qdep_chain_jax("spherical", 2),
    "free3d-scene9": jscenes.scene_09_free3d,
    "mixed": lambda: qdep_mixed(jscene, JJT),
}


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    lib = _gxx_build(tmp_path_factory, "coop_qdep", LOOP)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.chord_qdep_cpu.argtypes = [i] * 4 + [p] * 8 + [i, f, f, f, p, p]
    lib.chord_qdep_cpu.restype = i
    lib.chord_qdep_mix_cpu.argtypes = [i] * 5 + [p] * 8 + [i, f, f, f, p, p]
    lib.chord_qdep_mix_cpu.restype = i
    lib.qdep_mix_bytes.argtypes = [i, i, i]
    lib.qdep_mix_bytes.restype = ctypes.c_long
    return lib


def _run(lib, topo, params, tau, states, body):
    """(x [B, nr], Hinv [B, nr, nr]) of one g++ body on the wrapper's own
    packing of the inputs."""
    B, nr = states[0].shape
    packed = chord_kernel.pack(topo, {**params, "tau": torch.tensor(tau)},
                               *(torch.tensor(a) for a in states))
    args = [np.ascontiguousarray(a.numpy()) for a in packed[:8]]
    x_out = np.empty((nr, B), np.float32)
    h_out = np.empty((nr * nr, B), np.float32)
    ptr = lambda a: a.ctypes.data_as(ctypes.c_void_p)
    cfg = tint.NewtonConfig(**CFG_KW)
    rc = lib.chord_qdep_cpu(topo.njoints, nr, body, B, *(ptr(a) for a in args), cfg.fixed_iters,
                            cfg.growth_reject, cfg.tol_reject, cfg.dx_clamp, ptr(x_out),
                            ptr(h_out))
    assert rc == 0, (topo.njoints, nr)
    return x_out.T, h_out.reshape(nr, nr, B).transpose(2, 0, 1)


@pytest.mark.parametrize("case", list(CASES))
def test_coop_qdep_body_matches_lane_body_and_kernel_body(lib, case):
    sc = CASES[case]().compile(dtype=jnp.float32)
    states, tau, norms = qdep_states(sc)
    if case != "universal-2":  # every branch of so3_exp_S is run
        s = norms ** 2
        assert (s < 0.04).sum() >= 3 and ((s > 0.04) & (s < 0.05)).sum() >= 1
        assert (np.abs(norms - 1.5 * np.pi) < 0.1).sum() >= 2
    topo, params, _ = _port(sc)
    assert chord_kernel.has_qdep(topo)
    assert chord_kernel.takes_coop(topo.njoints, topo.nr, QDEP)
    x, hinv = _run(lib, topo, params, tau, states, 0)
    for body in (1, 2):  # tids reversed, and the thread-per-lane body
        xb, hinvb = _run(lib, topo, params, tau, states, body)
        np.testing.assert_array_equal(xb, x, err_msg=f"body {body}")
        np.testing.assert_array_equal(hinvb, hinv, err_msg=f"body {body}")

    jcfg = jint.NewtonConfig(**CFG_KW)
    x_np, hinv_np = pallas_step.chord_bdf2_dense(
        sc.topo, jcfg, {**sc.params, "tau": jnp.asarray(tau)}, *states, xp=np)
    # The last lane (qdot 1e6, angles near 1e4 rad) diverges in both: the g++
    # bodies reject it; on universal-2 the oracle's float32 sin and cos of
    # 1e4 rad (numpy's, not libm's) carry its solve to |x| ~ 1e5 unrejected.
    assert np.isnan(x[-1]).all()
    assert np.isnan(x_np[-1]).all() or np.abs(x_np[-1] - states[0][-1]).max() > 1e3
    finite = np.isfinite(x_np).all(-1)
    finite[-1] = False
    assert finite.mean() >= 0.75, finite
    np.testing.assert_array_equal(np.isfinite(x).all(-1), finite)
    np.testing.assert_allclose(x[finite], x_np[finite], rtol=0, atol=5e-6)
    scale = float(np.abs(hinv_np[finite]).max())
    np.testing.assert_allclose(hinv[finite], hinv_np[finite], rtol=0, atol=2e-5 * scale)


def universal_ground(n):
    """universal-n (qdep_chain_jax) with a ground contact on every link at
    the contact-MPC workload's coefficients, the floor 0.06 below the
    joints."""
    b = qdep_chain_jax("universal", n)
    E_g = np.eye(4)
    E_g[2, 3] = -0.06
    for i in range(n):
        b.force_ground_cuboid(i, E_ground=E_g, kn=100.0, kt=0.1, kd=10.0, mu=0.5)
    return b


def universal_spring(n):
    """universal-n with a spring-damper from a world point to the tip."""
    b = qdep_chain_jax("universal", n)
    b.force_spring_damper(-1, n - 1, [0.0, 0.0, 3.0], [0.5, 0.0, 0.0], k=200.0, d=2.0)
    return b


# (scene, states, the build's kinds) of each q-dependent mix
MIXES = {
    "universal-3-ground": (lambda: universal_ground(3),
                           lambda sc: contact_states(sc.topo.nr, 12),
                           chord_kernel.CONTACTS | QDEP),
    "universal-2-spring": (lambda: universal_spring(2), lambda sc: qdep_states(sc)[:2],
                           QDEP | chord_kernel.SPRINGS),
}


def _run_mix(lib, topo, params, tau, states, fns, feat, body):
    B, nr = states[0].shape
    packed = chord_kernel.pack(topo, {**params, "tau": torch.tensor(tau)},
                               *(torch.tensor(a) for a in states), fns)
    chord_kernel.check_buffers(topo, *packed[6:])
    args = [np.ascontiguousarray(a.numpy()) for a in packed[:8]]
    x_out = np.empty((nr, B), np.float32)
    h_out = np.empty((nr * nr, B), np.float32)
    ptr = lambda a: a.ctypes.data_as(ctypes.c_void_p)
    cfg = tint.NewtonConfig(**CFG_KW)
    rc = lib.chord_qdep_mix_cpu(topo.njoints, nr, feat, body, B, *(ptr(a) for a in args),
                                cfg.fixed_iters, cfg.growth_reject, cfg.tol_reject,
                                cfg.dx_clamp, ptr(x_out), ptr(h_out))
    assert rc == 0, (topo.njoints, nr, feat)
    return x_out.T, h_out.reshape(nr, nr, B).transpose(2, 0, 1)


@pytest.mark.parametrize("case", list(MIXES))
def test_coop_qdep_mixes_match_lane_body_and_kernel_body(lib, case):
    make, states_of, feat = MIXES[case]
    sc = make().compile(dtype=jnp.float32)
    states, tau = states_of(sc)
    topo, params, fns = _port(sc)
    N, nr = topo.njoints, topo.nr
    counts = chord_kernel.counts_of(chord_kernel.closure_spec(topo, fns))
    assert chord_kernel.kinds_of(topo, counts) == feat
    assert chord_kernel.takes_coop(N, nr, feat, springs=counts.springs)
    assert chord_kernel.is_coop(chord_kernel.library_of(N, nr, feat, springs=counts.springs))
    assert chord_kernel.coop_record_bytes(N, nr, feat) == lib.qdep_mix_bytes(N, nr, feat)
    x, hinv = _run_mix(lib, topo, params, tau, states, fns, feat, 0)
    for body in (1, 2):  # tids reversed, and the thread-per-lane body
        xb, hinvb = _run_mix(lib, topo, params, tau, states, fns, feat, body)
        np.testing.assert_array_equal(xb, x, err_msg=f"body {body}")
        np.testing.assert_array_equal(hinvb, hinv, err_msg=f"body {body}")
    x_np, hinv_np = pallas_step.chord_bdf2_dense(
        sc.topo, jint.NewtonConfig(**CFG_KW), {**sc.params, "tau": jnp.asarray(tau)}, *states,
        xp=np, force_fns=sc.force_fns)
    # the last lane of qdep_states (qdot 1e6), as in the test above: rejected
    # here, not always by the oracle
    finite = np.isfinite(x_np).all(-1)
    n = -1 if case == "universal-2-spring" else None
    finite[len(finite) if n is None else n:] = False
    assert finite.mean() >= 0.75, finite
    np.testing.assert_array_equal(np.isfinite(x).all(-1)[:n], finite[:n])
    dx = np.abs(x[finite] - x_np[finite]) / np.maximum(1.0, np.abs(x_np[finite]))
    assert float(dx.max()) <= 5e-6, float(dx.max())
    scale = float(np.abs(hinv_np[finite]).max())
    np.testing.assert_allclose(hinv[finite], hinv_np[finite], rtol=0, atol=2e-5 * scale)
    # the closures act: with their coefficients zero x is another
    off = {key: {c: v * 0 if c in ("k", "d", "kn", "kt", "kd") else v for c, v in fp.items()}
           for key, fp in params["forces"].items()}
    x_off, _ = _run_mix(lib, topo, {**params, "forces": off}, tau, states, fns, feat, 0)
    both = finite & np.isfinite(x_off).all(-1)
    assert np.abs(x_off[both] - x[both]).max() > 1e-4
