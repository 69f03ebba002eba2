"""The chord and QP kernels at any shape the JAX package runs, on the CPU.

  * The routing rule and the build keys, in pure Python: the cooperative
    design takes a shape by a rule decided before anything is built
    (chord_kernel.takes_coop: any kind mix, N, nr <= 32, a lane's record
    sized for the scene fits a block), every other key goes to the thread-per-lane
    design; a key a fixed library holds goes to it, any other to the build
    made for it (build_for), the same KernelBuild for the same key and
    other defines for another.
  * chord_kernel.coop_record_bytes, the wrapper's mirror of
    sizeof(coop::LaneOf<N, NR, FEAT>), against g++'s sizeof on a grid of
    shapes and kind mixes, one whose record fits no block among them.
  * The thread-per-lane lane body (csrc/chord_bdf2_lane.cuh) compiled with
    plain g++ as a build made for one scene is (its per-lane record sized
    from the scene by -DCHORD_MAX_RECORD), at shapes and kind mixes no fixed
    library holds, against the JAX package's numpy evaluation of the Pallas
    kernel body, pallas_step.chord_bdf2_dense(xp=np), at the tolerances of
    tests/test_pallas_step.py (x 5e-6 max(1, |x|), as
    tests/test_torch_coop_body.py reads them, H^-1 2e-5 of scale): scene 0
    (N, nr) = (5, 3); scene_chain(3) with a ground contact and a
    spring-damper; a two-joint universal chain with a ground contact on
    each link; chain-ground-4 with per-lane params in the guarded and the
    guard_last modes (held where float32 determines the result, as
    tests/test_torch_lane_body.py holds the robust modes).
  * The cooperative body (csrc/chord_bdf2_coop.cuh, each phase run for
    every tid in turn, forward and reversed, the record started as NaN) at
    the shapes the rule gives it that no fixed library holds: scene 0,
    scene 12 (2, 2, springs) and scene_chain(8) with per-lane params, bit
    for bit against the thread-per-lane body and against the oracle.
  * csrc/dual_pgs_lane.cuh at (n, m) = (2, 1), reference case 6's joint
    limit QP, against pallas_qp.dual_pgs_dense(xp=np) (x 2e-5, lambda 2e-4
    of scale).
"""

import ctypes
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from redmax_tpu import integrators as jint
from redmax_tpu import pallas_qp, pallas_step
from redmax_tpu import scenes as jscenes
from redmax_tpu.scenes import scene_chain as jchain
from redmax_tpu.scenes import scene_chain_ground as jground
from redmax_tpu_torch import chord_kernel as ck
from redmax_tpu_torch import convert, qp_kernel
from redmax_tpu_torch import integrators as tint
from redmax_tpu_torch.kernel_build import KernelBuild
from redmax_tpu_torch.scenes_matlab import build_mscene
from test_torch_chord import BENCH_GROUND, contact_states
from test_torch_joints import qdep_chain_jax
from test_torch_lane_body import CFG_KW, CSRC, _port, _states
from test_torch_perlane import perlane_params


@pytest.fixture(scope="module", autouse=True)
def single_thread():
    """torch's intra-op threads set to 1 for the module, then restored."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


C, S, CAB, Q, PL, R = ck.CONTACTS, ck.SPRINGS, ck.CABLES, ck.QDEP, ck.PERLANE, ck.ROBUST
# The per-lane record of chain-ground-4 (7N + 4 + 13 C floats), the size a
# build made for it holds.
GROUND4_RECORD = 7 * 4 + 4 + 13 * 4
SIZES = [(12, 12, 0), (4, 4, C), (12, 12, R), (12, 12, C | R), (12, 12, C | PL),
         (12, 12, S), (12, 12, S | PL), (6, 12, Q), (4, 12, Q), (1, 6, Q), (5, 3, 0),
         (2, 2, S), (8, 8, 0), (8, 8, PL), (3, 3, C | PL), (32, 32, 0), (2, 4, Q),
         (4, 3, CAB), (4, 3, CAB | PL), (3, 3, CAB), (12, 12, CAB | PL), (32, 32, CAB)] + [
    (n, nr, f) for n, nr in ((6, 8), (3, 6)) for f in range(64)]   # every kind mix
# records of explicit size: (N, nr, kinds, record floats); the last fits no block
RECORDS = [(4, 4, C | PL, GROUND4_RECORD), (5, 3, PL, 40), (32, 32, C | PL, 24000)]
LOOP = r"""
#include <cstdio>
#include "chord_bdf2_coop.cuh"
namespace co = chord::coop;
// sizeof the cooperative records of the grid
extern "C" long coop_sizeof(int i) {
  const long sizes[] = {
#define SZ(n, nr, f) static_cast<long>(sizeof(co::LaneOf<n, nr, f>)),
    SIZES
#define SZR(n, nr, f, p) static_cast<long>(sizeof(co::LanePerlane<co::LaneBase<n, nr, f>, p>)),
    RECORDS
  };
  return sizes[i];
}
// The thread-per-lane bodies of the builds made for one scene (the per-lane
// record sized by -DCHORD_MAX_RECORD, as build_for sizes it).
template <int n, int nr, int f>
void run_lane(int lane, int B, const float* x0, const float* q0, const float* qd0,
              const float* q1, const float* qd1, const float* tau, const int* topo_i,
              const float* stat_f, const float* lane_f, chord::ChordConfig cfg,
              chord::RobustConfig rc, float* x_out, float* hinv_out) {
  if constexpr ((f & chord::kRobust) != 0)
    chord::chord_bdf2_lane_robust<n, nr, f>(lane, B, x0, q0, qd0, q1, qd1, tau, topo_i, stat_f,
                                            cfg, rc, x_out, hinv_out, lane_f);
  else
    chord::chord_bdf2_lane<n, nr, f>(lane, B, x0, q0, qd0, q1, qd1, tau, topo_i, stat_f, cfg,
                                     x_out, hinv_out, lane_f);
}
extern "C" int chord_bdf2_cpu(int N, int NR, int feat, int B, const float* x0, const float* q0,
                              const float* qd0, const float* q1, const float* qd1,
                              const float* tau, const int* topo_i, const float* stat_f,
                              const float* lane_f, int fixed_iters, float growth_reject,
                              float tol_reject, float dx_clamp, int guarded, int guard_last,
                              int chord_mode, float* x_out, float* hinv_out) {
  const chord::ChordConfig cfg{fixed_iters, growth_reject, tol_reject, dx_clamp};
  const chord::RobustConfig rc{guarded, guard_last, chord_mode};
#define LANE(n, nr, f)                                                                    \
  if (N == n && NR == nr && feat == f) {                                                  \
    for (int lane = 0; lane < B; ++lane)                                                  \
      run_lane<n, nr, f>(lane, B, x0, q0, qd0, q1, qd1, tau, topo_i, stat_f, lane_f, cfg, \
                         rc, x_out, hinv_out);                                            \
    return 0;                                                                             \
  }
  LANE(5, 3, 0)
  LANE(3, 3, 3)
  LANE(2, 4, 9)
  LANE(4, 4, 49)
  LANE(2, 2, 2)
  LANE(8, 8, 16)
  return -1;
}
#include <cstring>
struct SerialRun {
  int reverse;
  template <class F>
  void operator()(int, F&& f) const {
    for (int i = 0; i < co::kWarp; ++i) f(reverse ? co::kWarp - 1 - i : i);
  }
};
// The cooperative body, each phase on every tid in turn (reverse: in
// reverse order), each lane's record started as NaN.
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
  COOP(5, 3, 0)
  COOP(2, 2, 2)
  COOP(8, 8, 16)
  return -1;
}
#include "dual_pgs_lane.cuh"
extern "C" int dual_pgs_cpu(int n, int m, int B, const float* H, const float* f, const float* A,
                            const float* b, const float* lo, const float* hi, int iters,
                            float reg, float* x_out, float* lam_out) {
  if (n != 2 || m != 1) return -1;
  for (int lane = 0; lane < B; ++lane)
    qp::dual_pgs_lane<2, 1>(lane, B, H, f, A, b, lo, hi, iters, reg, x_out, lam_out);
  return 0;
}
"""


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    """One g++ unit: the grid's sizeof, the lane bodies, the QP body."""
    d = tmp_path_factory.mktemp("any_shape")
    src, so = d / "loop.cpp", d / "libany.so"
    sizes = " ".join(f"SZ({n}, {nr}, {f})" for n, nr, f in SIZES)
    records = " ".join(f"SZR({n}, {nr}, {f}, {p})" for n, nr, f, p in RECORDS)
    src.write_text(LOOP.replace("    SIZES", "    " + sizes).replace("    RECORDS",
                                                                       "    " + records))
    subprocess.run(["g++", "-O2", "-std=c++17", "-shared", "-fPIC", "-I", CSRC,
                    f"-DCHORD_MAX_RECORD={GROUND4_RECORD}", "-o", str(so), str(src)], check=True)
    lib = ctypes.CDLL(str(so))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.coop_sizeof.argtypes = [i]
    lib.coop_sizeof.restype = ctypes.c_long
    lib.chord_bdf2_cpu.argtypes = [i, i, i, i] + [p] * 9 + [i, f, f, f, i, i, i, p, p]
    lib.chord_bdf2_cpu.restype = i
    lib.chord_coop_cpu.argtypes = [i] * 5 + [p] * 9 + [i, f, f, f, p, p]
    lib.chord_coop_cpu.restype = i
    lib.dual_pgs_cpu.argtypes = [i, i, i] + [p] * 6 + [i, f, p, p]
    lib.dual_pgs_cpu.restype = i
    return lib


def test_shape_rule_routes_by_kinds_width_and_room():
    """takes_coop: every kind mix, N and nr at most 32, a record (sized for
    the scene's closures) that fits one lane in a block: the kinds weigh
    only through the record's size; lanes a block the most of 8, 4, 2, 1
    that fit."""
    for key in [(5, 3, 0), (2, 2, S), (8, 8, 0), (6, 12, Q), (4, 12, Q), (1, 6, Q),
                (4, 4, C | R), (3, 3, PL), (32, 32, 0), (4, 3, CAB), (4, 3, CAB | PL),
                (6, 6, C | S), (3, 6, C | Q), (12, 12, C | PL | R), (4, 3, CAB | C),
                (6, 12, Q | R), (4, 8, S)]:
        assert ck.takes_coop(*key), key
    for key in [(33, 33, 0), (4, 32 + 1, 0), (33, 6, C | S)]:
        assert not ck.takes_coop(*key), key
    assert ck.takes_coop(12, 12, S, springs=3) and ck.takes_coop(12, 12, S, springs=6)
    assert ck.takes_coop(12, 12, S | PL, springs=3, record=200)
    assert ck.takes_coop(8, 7, S, springs=6) and ck.coop_lanes(8, 7, S, 4, 2, 6) == 8
    assert not ck.takes_coop(12, 12, S, springs=110)   # no lane fits a block
    assert ck.takes_coop(32, 32, C | PL, record=4000)
    assert not ck.takes_coop(32, 32, C | PL, record=24000)   # no lane fits a block
    assert ck.coop_lanes(32, 32, 0) == 1 and ck.coop_lanes(12, 12, 0) == 8
    assert ck.coop_lanes(32, 32, C | PL, 24000) == 0
    for key in ck.COOP_INSTANTIATED:
        assert ck.coop_lanes(*key) == ck.COOP_LANES, key


def test_library_of_fixed_and_built_for_the_scene():
    """A key a fixed library holds goes to it; any other to the build made
    for it, of the design the rule picks, with the key in its defines."""
    for key in ck.COOP_INSTANTIATED:
        assert ck.library_of(*key) is ck.BUILD_COOP
    assert ck.library_of(4, 3, CAB) is ck.BUILD_COOP
    assert ck.library_of(4, 3, CAB, thread_per_lane=True) is ck.BUILD
    assert ck.library_of(6, 12, Q, thread_per_lane=True) is ck.BUILD_QDEP
    b = ck.library_of(6, 12, Q)
    assert ck.is_coop(b) and b is ck.build_for(True, 6, 12, Q)
    assert b.defines == ("-DCHORD_ONE", "-DCHORD_N=6", "-DCHORD_NR=12", "-DCHORD_FEAT=8",
                         "-DCOOP_LANES=8")
    t = ck.library_of(12, 12, C | PL | R, record=244)
    assert ck.is_coop(t) and t.sources[0] == "chord_bdf2_coop.cu"
    assert t.defines == ("-DCHORD_ONE", "-DCHORD_N=12", "-DCHORD_NR=12", "-DCHORD_FEAT=49",
                         "-DCHORD_MAX_RECORD=244", "-DCOOP_LANES=8")
    t = ck.library_of(12, 12, C | PL | R, thread_per_lane=True, record=244)
    assert not ck.is_coop(t) and t.sources[0] == "chord_bdf2.cu"
    assert t.defines == ("-DCHORD_ONE", "-DCHORD_N=12", "-DCHORD_NR=12", "-DCHORD_FEAT=49",
                         "-DCHORD_MAX_RECORD=244")
    u = ck.library_of(8, 7, S, springs=6)
    assert u.defines == ("-DCHORD_ONE", "-DCHORD_N=8", "-DCHORD_NR=7", "-DCHORD_FEAT=2",
                         "-DCHORD_MAX_SPRINGS=6", "-DCOOP_LANES=8")
    assert ck.library_of(33, 6, C | S, springs=1).sources[0] == "chord_bdf2.cu"
    # a fixed library's limits: a longer record or cable goes to a build of its own
    assert ck.library_of(12, 12, C | PL, record=ck.MAX_LANE_RECORD) is ck.BUILD_COOP
    big = ck.library_of(12, 12, C | PL, record=ck.MAX_LANE_RECORD + 1)
    assert big is not ck.BUILD_COOP and "-DCHORD_MAX_RECORD=516" in big.defines
    cab = ck.library_of(4, 3, CAB, cable_points=9)
    assert cab is not ck.BUILD_COOP and "-DCHORD_MAX_CABLE_POINTS=9" in cab.defines
    assert ck.library_of(4, 3, CAB, cable_points=8) is ck.BUILD_COOP
    cab = ck.library_of(4, 3, CAB, thread_per_lane=True, cable_points=9)
    assert cab is not ck.BUILD and "-DCHORD_MAX_CABLE_POINTS=9" in cab.defines
    assert ck.library_of(4, 3, CAB, thread_per_lane=True, cable_points=8) is ck.BUILD
    # the QP: the fixed shapes, else one unit a shape
    assert qp_kernel.build_for(6, 12) is qp_kernel.BUILD
    qb = qp_kernel.build_for(2, 1)
    assert qb is qp_kernel.build_for(2, 1) and qb.defines == ("-DPGS_N=2", "-DPGS_M=1")


def test_build_keys_cache_and_differ():
    """The same key gives the same KernelBuild (one nvcc a key and process);
    keys that differ give other defines, so other libraries under _build/
    (KernelBuild hashes its sources and flags)."""
    keys = [(True, 5, 3, 0), (False, 5, 3, 0), (True, 8, 8, 0), (True, 2, 2, S),
            (False, 3, 6, C | Q), (False, 12, 12, C | PL | R, 244),
            (False, 12, 12, C | PL | R, 248), (False, 4, 3, CAB, 0, 9),
            (True, 2, 2, S, 0, 0, 4), (True, 4, 3, C | CAB, 0, 9, 0, 3)]
    builds = [ck.build_for(*k) for k in keys]
    assert all(ck.build_for(*k) is b for k, b in zip(keys, builds))
    flags = [(b.sources[0],) + b.flags for b in builds]
    assert len(set(flags)) == len(keys)
    paths = {b._paths()[0] for b in builds}
    assert len(paths) == len(keys)
    assert isinstance(builds[0], KernelBuild)


def test_nvcc_messages_never_stop_a_build(tmp_path, monkeypatch):
    """A compiler that writes far more than a pipe holds (ptxas -v of many
    kernels, or warnings with their instantiation chains) still finishes
    while the caller only polls compiling(), as chip_smoke's build phase
    does; its messages become the build's ptxas report, and a failure
    raises with them. (A stand-in nvcc on PATH: g++ builds the library.)"""
    import os
    import time

    from redmax_tpu_torch import kernel_build

    stub = tmp_path / "stub.so"
    subprocess.run(["g++", "-shared", "-fPIC", "-x", "c++", "-", "-o", str(stub)],
                   input=b"extern \"C\" int stub() { return 7; }", check=True)
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\n"
                    "python3 -c \"import sys; sys.stderr.write('warning ' * 50000)\"\n"
                    "[ -n \"$NVCC_FAILS\" ] && exit 2\n"
                    "while [ $# -gt 0 ]; do [ \"$1\" = -o ] && out=$2; shift; done\n"
                    f"cp {stub} \"$out\"\n")
    fake.chmod(0o755)
    monkeypatch.setenv("PATH", f"{tmp_path}:{os.environ['PATH']}")
    monkeypatch.setattr(kernel_build, "BUILD", str(tmp_path / "_build"))
    build = KernelBuild("noisy", ("dual_pgs.cu", "dual_pgs_lane.cuh"))
    build.start()
    t0 = time.perf_counter()
    while build.compiling():
        assert time.perf_counter() - t0 < 30, "the compiler stopped on its own messages"
        time.sleep(0.02)
    assert build.load().stub() == 7
    assert build.ptxas_report.count("warning") == 50000
    assert not os.path.exists(build._messages())
    monkeypatch.setenv("NVCC_FAILS", "1")
    failing = KernelBuild("noisy_fails", ("dual_pgs.cu", "dual_pgs_lane.cuh"), ("-DX",))
    with pytest.raises(RuntimeError, match="nvcc failed on noisy_fails"):
        failing.load()


def test_coop_record_bytes_equals_gxx_sizeof(lib):
    """coop_record_bytes mirrors sizeof(coop::LaneOf<N, NR, FEAT>) (and of a
    per-lane record of any size) exactly, as g++ lays the records out (the
    unit's kMaxLaneRecord is GROUND4_RECORD: a per-lane record without
    springs holds that many floats)."""
    for i, (n, nr, f) in enumerate(SIZES):
        assert ck.coop_record_bytes(n, nr, f, GROUND4_RECORD) == lib.coop_sizeof(i), (n, nr, f)
    for i, (n, nr, f, p) in enumerate(RECORDS):
        assert ck.coop_record_bytes(n, nr, f, p) == lib.coop_sizeof(len(SIZES) + i), (n, nr, f)
    assert 8 * ck.coop_record_bytes(12, 12, 0) == 206_336   # the main path's block
    assert ck.coop_record_bytes(32, 32, C | PL, 24000) > ck.SMEM_PER_BLOCK


def _jax_case(case):
    """(JAX scene in f32, numpy params or None, states, tau, feat, NewtonConfig
    kwargs) of a lane-body case."""
    kw = CFG_KW
    if case == "scene0":
        sc = jscenes.scene_00_serial_chain().compile(dtype=jnp.float32)
        states, tau = _states(sc.topo.nr, 16)
        return sc, None, states, tau, 0, kw
    if case == "chain3-ground-spring":
        b = jchain(nlinks=3)
        E_g = np.eye(4)
        E_g[2, 3] = -0.06
        b.force_ground_cuboid(1, E_ground=E_g, kn=100.0, kt=0.1, kd=10.0, mu=0.5)
        b.force_spring_damper(-1, 2, [0.0, 0.0, 3.0], [0.5, 0.0, 0.0], k=200.0, d=2.0)
        sc = b.compile(dtype=jnp.float32)
        states, tau = contact_states(sc.topo.nr, 16)
        return sc, None, states, tau, C | S, kw
    if case == "universal2-ground":
        b = qdep_chain_jax("universal", 2)
        E_g = np.eye(4)
        E_g[2, 3] = -0.06
        for i in range(2):
            b.force_ground_cuboid(i, E_ground=E_g, kn=100.0, kt=0.1, kd=10.0, mu=0.5)
        sc = b.compile(dtype=jnp.float32)
        states, tau = contact_states(sc.topo.nr, 16)
        return sc, None, states, tau, C | Q, kw
    # chain-ground-4 with per-lane params, the torques of about half the
    # lanes scaled up 300x so that the guard takes half steps and stays put
    mode = case.rsplit("-", 1)[1]
    sc = jground(nlinks=4, **BENCH_GROUND).compile(dtype=jnp.float32)
    B = 48
    states, _ = contact_states(sc.topo.nr, B)
    pn = perlane_params(sc.params, sc.force_fns, B)
    up = np.random.default_rng(7).choice([1.0, 300.0], size=(B, 1))
    tau = (pn.pop("tau") * 30.0 * up).astype(np.float32)
    return sc, pn, states, tau, C | PL | R, dict(CFG_KW, **{mode: True})


def _run_lane(lib, topo, params, tau, states, fns, feat, kw, coop=None):
    """(x [B, nr], Hinv [B, nr, nr]) of the g++ thread-per-lane body (coop
    "forward" or "reverse": the cooperative body, tids in that order) on the
    wrapper's own packing of the inputs."""
    B, nr = states[0].shape
    packed = ck.pack(topo, {**params, "tau": torch.tensor(tau)},
                     *(torch.tensor(a) for a in states), fns)
    ck.check_buffers(topo, *packed[6:])
    assert (packed[-1] is not None) == bool(feat & PL)
    if packed[-1] is not None:   # within the unit's kMaxLaneRecord
        assert packed[-1].shape[0] <= GROUND4_RECORD
    args = [np.ascontiguousarray(a.numpy()) for a in packed[:8]]
    args.append(None if packed[-1] is None else np.ascontiguousarray(packed[-1].numpy()))
    x_out = np.empty((nr, B), np.float32)
    h_out = np.empty((nr * nr, B), np.float32)
    cfg = tint.NewtonConfig(**kw)
    ptr = lambda a: None if a is None else a.ctypes.data_as(ctypes.c_void_p)
    solver = (cfg.fixed_iters, cfg.growth_reject, cfg.tol_reject, cfg.dx_clamp)
    if coop is None:
        rc = lib.chord_bdf2_cpu(topo.njoints, nr, feat, B, *(ptr(a) for a in args), *solver,
                                int(cfg.guarded), int(cfg.guard_last), int(cfg.chord),
                                ptr(x_out), ptr(h_out))
    else:
        rc = lib.chord_coop_cpu(topo.njoints, nr, feat, int(coop == "reverse"), B,
                                *(ptr(a) for a in args), *solver, ptr(x_out), ptr(h_out))
    assert rc == 0, (topo.njoints, nr, feat)
    return x_out.T, h_out.reshape(nr, nr, B).transpose(2, 0, 1)


@pytest.mark.parametrize("case", ["scene0", "chain3-ground-spring", "universal2-ground",
                                  "ground4-perlane-guarded", "ground4-perlane-guard_last"])
def test_lane_body_at_new_shapes_matches_kernel_body(lib, case):
    sc, pn, states, tau, feat, kw = _jax_case(case)
    topo, params, fns = _port(sc)
    if pn is not None:
        params = convert.params_from_numpy(pn, "cpu", torch.float32)
        pj = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32), pn)
    else:
        pj = sc.params
    kinds = ck.kinds_of(topo, ck.counts_of(ck.closure_spec(topo, fns)), pn is not None,
                        ck.is_robust(tint.NewtonConfig(**kw)))
    assert kinds == feat
    # no fixed library holds these keys: each runs on a build made for it
    build = ck.scene_build(topo, fns, {**params, "tau": torch.tensor(tau)},
                           tint.NewtonConfig(**kw))
    assert build not in ck.BUILDS
    assert ck.is_coop(build)
    x_np, hinv_np = pallas_step.chord_bdf2_dense(
        sc.topo, jint.NewtonConfig(**kw), {**pj, "tau": jnp.asarray(tau)}, *states, xp=np,
        force_fns=sc.force_fns)
    x, hinv = _run_lane(lib, topo, params, tau, states, fns, feat, kw)
    finite = np.isfinite(x_np).all(-1)
    assert finite.mean() >= 0.5, finite
    np.testing.assert_array_equal(np.isfinite(x).all(-1), finite)
    held = finite
    if feat & R:
        # where float32 determines the result: the oracle within 1e-3
        # max(1, |x|) of the port's plain version in float64
        info = {}
        p64 = jax.tree_util.tree_map(lambda a: a.double(), {**params, "tau": torch.tensor(tau)})
        x64, _ = ck.chord_bdf2_reference(topo, tint.NewtonConfig(**kw), p64,
                                         *(torch.tensor(a).double() for a in states), fns,
                                         info=info)
        x64 = x64.numpy()
        held = finite & (np.abs(x_np - x64) <= 1e-3 * np.maximum(1.0, np.abs(x64))).all(-1)
        assert held.sum() >= 0.75 * finite.sum(), (held.sum(), finite.sum())
        steps = info["steps"].numpy()
        assert ((steps < 1.0).any(-1) & held).sum() > 0   # the guard acts on a held lane
    dx = np.abs(x[held] - x_np[held]) / np.maximum(1.0, np.abs(x_np[held]))
    assert float(dx.max()) <= 5e-6, float(dx.max())
    scale = float(np.abs(hinv_np[held]).max())
    np.testing.assert_allclose(hinv[held], hinv_np[held], rtol=0, atol=2e-5 * scale)


@pytest.mark.parametrize("case", ["scene0", "scene12", "chain8-perlane"])
def test_coop_body_at_new_shapes_equals_lane_body(lib, case):
    """The cooperative body at shapes the rule gives it and no fixed library
    holds (no closure at (5, 3); springs at (2, 2); per-lane params without
    a closure at (8, 8)): tids forward and reversed and the thread-per-lane
    body agree bit for bit, and all match chord_bdf2_dense at the
    tolerances above."""
    pn = None
    if case == "scene0":
        sc, feat = jscenes.scene_00_serial_chain().compile(dtype=jnp.float32), 0
    elif case == "scene12":
        sc, feat = jscenes.scene_12_spring_damper().compile(dtype=jnp.float32), S
    else:
        sc, feat = jchain(nlinks=8).compile(dtype=jnp.float32), PL
    states, tau = _states(sc.topo.nr, 16)
    topo, params, fns = _port(sc)
    if feat & PL:
        pn = perlane_params(sc.params, sc.force_fns, 16)
        pn.pop("tau")
        params = convert.params_from_numpy(pn, "cpu", torch.float32)
    key = (topo.njoints, topo.nr, feat)
    assert ck.takes_coop(*key, springs=len(fns), record=ck.record_floats(
        ck.counts_of(ck.closure_spec(topo, fns)), topo.njoints) if pn else 0)
    assert key not in ck.COOP_INSTANTIATED
    x, hinv = _run_lane(lib, topo, params, tau, states, fns, feat, CFG_KW, coop="forward")
    for other in ("reverse", None):
        xo, hinvo = _run_lane(lib, topo, params, tau, states, fns, feat, CFG_KW, coop=other)
        np.testing.assert_array_equal(xo, x, err_msg=str(other))
        np.testing.assert_array_equal(hinvo, hinv, err_msg=str(other))
    pj = sc.params if pn is None else jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, jnp.float32), pn)
    x_np, hinv_np = pallas_step.chord_bdf2_dense(
        sc.topo, jint.NewtonConfig(**CFG_KW), {**pj, "tau": jnp.asarray(tau)}, *states, xp=np,
        force_fns=sc.force_fns)
    finite = np.isfinite(x_np).all(-1)
    assert finite.mean() >= 0.75, finite
    np.testing.assert_array_equal(np.isfinite(x).all(-1), finite)
    dx = np.abs(x[finite] - x_np[finite]) / np.maximum(1.0, np.abs(x_np[finite]))
    assert float(dx.max()) <= 5e-6, float(dx.max())
    scale = float(np.abs(hinv_np[finite]).max())
    np.testing.assert_allclose(hinv[finite], hinv_np[finite], rtol=0, atol=2e-5 * scale)


def test_dual_pgs_lane_at_mscene6_matches_kernel_body(lib):
    """dual_pgs_lane<2, 1>, the (n, m) of reference case 6's joint-limit
    QP, against pallas_qp.dual_pgs_dense(xp=np) on the QPs of the scene at
    states that put the limited joint past its limit on some lanes; the
    plain version (qp_kernel.dual_pgs on a CPU tensor) too."""
    sc = build_mscene(6, dtype=torch.float32, device="cpu")
    B = 32
    rng = np.random.default_rng(5)
    q = np.stack([0.3 * rng.normal(size=B), rng.uniform(-1.2, 1.2, size=B)], axis=1)
    qd = rng.normal(size=(B, 2))
    H, f, (A, b, lo, hi, _) = tint.euler_qp_system(
        sc.topo, (), sc.constraint_fns, sc.params, torch.tensor(q, dtype=torch.float32),
        torch.tensor(qd, dtype=torch.float32))
    qps = [a.numpy().astype(np.float32) for a in (H, f, A, b, lo, hi)]
    assert qps[2].shape == (B, 1, 2) and np.isinf(qps[5]).any()
    x_np, lam_np = pallas_qp.dual_pgs_dense(*qps, iters=40, reg=1e-10)
    packed = [np.ascontiguousarray(a.numpy()) for a in qp_kernel.pack(H, f, A, b, lo, hi)]
    x_out, lam_out = np.empty((2, B), np.float32), np.empty((1, B), np.float32)
    ptr = lambda a: a.ctypes.data_as(ctypes.c_void_p)
    assert lib.dual_pgs_cpu(2, 1, B, *(ptr(a) for a in packed), 40, 1e-10, ptr(x_out),
                            ptr(lam_out)) == 0
    x_ref, lam_ref = qp_kernel.dual_pgs(H, f, A, b, lo, hi, iters=40, reg=1e-10)
    xs, ls = max(1.0, np.abs(x_np).max()), max(1.0, np.abs(lam_np).max())
    assert (np.abs(lam_np) > 0).any()  # a limit acts
    for name, xv, lv in (("lane body", x_out.T, lam_out.T),
                         ("plain version", x_ref.numpy(), lam_ref.numpy())):
        np.testing.assert_allclose(xv, x_np, rtol=0, atol=2e-5 * xs, err_msg=name)
        np.testing.assert_allclose(lv, lam_np, rtol=0, atol=2e-4 * ls, err_msg=name)
