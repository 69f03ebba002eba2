"""CPU check of the dual-PGS kernel's cooperative body (a group of threads
per lane). csrc/dual_pgs_coop.cuh is compiled with plain g++ behind an
extern "C" loop over lanes that runs each phase for every tid of the lane's
group in turn (forward, or in reverse order, which must agree bit for bit),
each thread's registers an element of an array, each lane's record and
registers filled with NaN first; the thread-per-lane body
(csrc/dual_pgs_lane.cuh) is built in the same g++ unit.

- At (n, m) = (6, 8) (random QPs with equality, inequality and boxed rows,
  a lane whose H has a zero pivot), (6, 12) (the 6-link floor chain's
  contact QPs: masked rows, infinite boxes, m > n so D is singular), (2, 1)
  (reference case 6's joint-limit QP) and (7, 3) (n > m, odd counts: one
  float an access) the cooperative body, reading the inputs as the callers
  hold them ([B, P] row-major), gives the thread-per-lane body's x and
  lambda bit for bit, and both are held against
  pallas_qp.dual_pgs_dense(xp=np) at the tolerances of
  tests/test_torch_lane_body.py (x 2e-5, lambda 2e-4 of scale).
- A NaN lane stays in its lane; a lane's result depends on its own row of
  each input only.
- The shape rule (qp_kernel.takes_coop), the threads a lane and the build
  keys, in pure Python; the records fit a block's shared memory.

These builds are tests only, never a route of a wrapper.
"""

import ctypes
import types

import numpy as np
import pytest
import torch

from redmax_tpu import pallas_qp
from redmax_tpu_torch import qp_kernel
from redmax_tpu_torch import integrators as tint
from redmax_tpu_torch.scenes_matlab import build_mscene
from test_torch_lane_body import _gxx_build, floor_chain_systems
from test_torch_qp import mixed_qp


@pytest.fixture(scope="module", autouse=True)
def single_thread():
    """torch's intra-op threads set to 1 for the module, then restored."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SHAPES = [(6, 8), (6, 12), (2, 1), (7, 3)]
LOOP = r"""
#include <cmath>
#include <cstring>
#include "dual_pgs_coop.cuh"
namespace co = qp::coop;
// One phase on every tid of the lane's group in turn, forward or in reverse
// (with or without the card's barrier); thread t's registers are regs[t],
// and the broadcast of thread src's candidate reads regs[src].
struct SerialRun {
  int reverse, G;
  template <class F>
  void operator()(int, F&& f) const {
    for (int i = 0; i < G; ++i) f(reverse ? G - 1 - i : i);
  }
  template <class F>
  void local(int phase, F&& f) const {
    (*this)(phase, f);
  }
  template <class R>
  float bcast(const R* regs, int src) const {
    return regs[src].cand;
  }
  int slot(int t) const { return t; }
};
template <int n, int m>
void run_coop(int reverse, int B, const float* H, const float* f, const float* A,
              const float* b, const float* lo, const float* hi, int iters, float reg,
              float* x_out, float* lam_out) {
  constexpr int G = co::group_threads<n, m>();
  static co::LaneQP<n, m> L;
  static co::SweepRegs<m> regs[G];
  for (int lane = 0; lane < B; ++lane) {
    std::memset(&L, 0xff, sizeof L);  // NaN floats
    std::memset(regs, 0xff, sizeof regs);
    co::solve<n, m>(SerialRun{reverse, G}, L, regs, lane, H, f, A, b, lo, hi, iters, reg, x_out,
                    lam_out);
  }
}
// coop: the cooperative body on [B, P] inputs, x [B, n], lam [B, m] (tids
// in reverse order where reverse); else the thread-per-lane body on packed
// [P, B] inputs, x [n, B], lam [m, B].
extern "C" int dual_pgs_cpu(int coop, int reverse, int n, int m, int B, const float* H,
                            const float* f, const float* A, const float* b, const float* lo,
                            const float* hi, int iters, float reg, float* x_out,
                            float* lam_out) {
#define QP(n_, m_)                                                                          \
  if (n == n_ && m == m_) {                                                                 \
    if (coop)                                                                               \
      run_coop<n_, m_>(reverse, B, H, f, A, b, lo, hi, iters, reg, x_out, lam_out);        \
    else                                                                                    \
      for (int lane = 0; lane < B; ++lane)                                                  \
        qp::dual_pgs_lane<n_, m_>(lane, B, H, f, A, b, lo, hi, iters, reg, x_out, lam_out); \
    return 0;                                                                               \
  }
  QP(6, 8)
  QP(6, 12)
  QP(2, 1)
  QP(7, 3)
#undef QP
  return -1;
}
// Bytes of one lane's record and threads a lane of the cooperative build.
extern "C" long qp_lane_bytes(int n, int m) {
#define SZ(n_, m_) \
  if (n == n_ && m == m_) return static_cast<long>(sizeof(co::LaneQP<n_, m_>));
  SZ(6, 8)
  SZ(6, 12)
  SZ(2, 1)
  SZ(7, 3)
  SZ(32, 32)
#undef SZ
  return -1;
}
// row_quotient of each (resid, safe) pair, and resid / safe.
extern "C" void qp_row_quotient(int n, const float* resid, const float* safe, float* q,
                                float* div) {
  for (int k = 0; k < n; ++k) {
    co::SweepRegs<1> R;
    R.safe = safe[k];
    R.safe_finite = std::fabs(R.safe) <= 3.402823466e38f && R.safe != 0.0f;
    q[k] = co::row_quotient(R, resid[k]);
    div[k] = resid[k] / safe[k];
  }
}
extern "C" int qp_group_threads(int n, int m) {
#define GT(n_, m_) \
  if (n == n_ && m == m_) return co::group_threads<n_, m_>();
  GT(6, 8)
  GT(6, 12)
  GT(2, 1)
  GT(7, 3)
  GT(32, 32)
#undef GT
  return -1;
}
"""
ITERS, REG = 40, 1e-10


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    lib = _gxx_build(tmp_path_factory, "qp_coop", LOOP)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.dual_pgs_cpu.argtypes = [i] * 5 + [p] * 6 + [i, f, p, p]
    lib.dual_pgs_cpu.restype = i
    lib.qp_lane_bytes.argtypes = [i, i]
    lib.qp_lane_bytes.restype = ctypes.c_long
    lib.qp_row_quotient.argtypes = [i, p, p, p, p]
    lib.qp_group_threads.argtypes = [i, i]
    lib.qp_group_threads.restype = i
    return lib


def mscene6_qps(B, seed=5):
    """Reference case 6's joint-limit QPs (n, m) = (2, 1) at states that put
    the limited joint past a limit on some lanes."""
    sc = build_mscene(6, dtype=torch.float32, device="cpu")
    rng = np.random.default_rng(seed)
    q = np.stack([0.3 * rng.normal(size=B), rng.uniform(-1.2, 1.2, size=B)], axis=1)
    qd = rng.normal(size=(B, 2))
    H, f, (A, b, lo, hi, _) = tint.euler_qp_system(
        sc.topo, (), sc.constraint_fns, sc.params, torch.tensor(q, dtype=torch.float32),
        torch.tensor(qd, dtype=torch.float32))
    return [a.numpy() for a in (H, f, A, b, lo, hi)]


def qps_of(shape):
    """float32 QPs (H, f, A, b, lo, hi) of a case, numpy [B, ...]."""
    if shape == (6, 8):
        sys = list(mixed_qp(11, 9, 6, 1, 4, 3, np.float32))
        sys[0][-1] = 1.0  # all-ones H: the second pivot is exactly 0
    elif shape == (6, 12):
        sys = [a.numpy() for a in floor_chain_systems(64)]
        assert np.isinf(sys[5]).any() and (sys[5] == 0).any()  # active and masked rows
    elif shape == (2, 1):
        sys = mscene6_qps(32)
        assert np.isinf(sys[5]).any()
    else:
        sys = list(mixed_qp(4, 12, 7, 1, 1, 1, np.float32))
    assert (sys[1].shape[1], sys[2].shape[1]) == shape
    return [np.ascontiguousarray(a, np.float32) for a in sys]


def run(lib, sys, body="coop", reverse=False):
    """(x [B, n], lam [B, m]) of the g++ body: "coop" on the inputs as the
    callers hold them, "lane" on qp_kernel.pack's copies."""
    B, n = sys[1].shape
    m = sys[2].shape[1]
    ptr = lambda a: a.ctypes.data_as(ctypes.c_void_p)
    if body == "coop":
        ins = [np.ascontiguousarray(a) for a in sys]
        x, lam = np.empty((B, n), np.float32), np.empty((B, m), np.float32)
    else:
        ins = [np.ascontiguousarray(a.numpy())
               for a in qp_kernel.pack(*(torch.tensor(a) for a in sys))]
        x, lam = np.empty((n, B), np.float32), np.empty((m, B), np.float32)
    rc = lib.dual_pgs_cpu(int(body == "coop"), int(reverse), n, m, B, *(ptr(a) for a in ins),
                          ITERS, REG, ptr(x), ptr(lam))
    assert rc == 0, (n, m)
    return (x, lam) if body == "coop" else (x.T, lam.T)


def coop_equals_lane(lib, sys):
    """The cooperative body's result, after checking that its reversed tid
    order and the thread-per-lane body give it bit for bit."""
    x, lam = run(lib, sys)
    for kw in (dict(reverse=True), dict(body="lane")):
        xo, lamo = run(lib, sys, **kw)
        np.testing.assert_array_equal(xo, x, err_msg=str(kw))
        np.testing.assert_array_equal(lamo, lam, err_msg=str(kw))
    return x, lam


@pytest.mark.parametrize("shape", SHAPES)
def test_qp_coop_body_matches_lane_body(lib, shape):
    """Bit for bit the thread-per-lane body (both tid orders), and against
    dual_pgs_dense(xp=np) at x 2e-5 and lambda 2e-4 of scale on the
    oracle's finite lanes, with the finite masks and lambda's NaN equal."""
    sys = qps_of(shape)
    x, lam = coop_equals_lane(lib, sys)
    x_np, lam_np = pallas_qp.dual_pgs_dense(*sys, iters=ITERS, reg=REG)
    finite = np.isfinite(x_np).all(-1)
    assert finite.mean() >= 0.75 and finite[-1] == (shape != (6, 8)), finite
    np.testing.assert_array_equal(np.isfinite(x).all(-1), finite)
    np.testing.assert_array_equal(np.isnan(lam), np.isnan(lam_np))
    xs = max(1.0, float(np.abs(x_np[finite]).max()))
    ls = max(1.0, float(np.abs(lam_np[finite]).max()))
    np.testing.assert_allclose(x[finite], x_np[finite], rtol=0, atol=2e-5 * xs)
    np.testing.assert_allclose(lam[finite], lam_np[finite], rtol=0, atol=2e-4 * ls)
    assert (lam[finite] != 0).any()  # a row acts
    if shape != (6, 12):
        # infinite boxes on equality rows: lambda takes either sign there
        assert np.isinf(sys[4]).any() or shape == (2, 1)


@pytest.mark.parametrize("shape", [(6, 12), (2, 1)])
def test_qp_coop_nan_lane_stays_in_its_lane(lib, shape):
    """A lane with a NaN in f comes out NaN and leaves every other lane's x
    and lambda bit-equal."""
    sys = qps_of(shape)
    x, lam = run(lib, sys)
    poisoned = [a.copy() for a in sys]
    poisoned[1][3, 0] = np.nan
    xp, lamp = run(lib, poisoned)
    keep = np.arange(sys[1].shape[0]) != 3
    assert np.isnan(xp[3]).any()
    np.testing.assert_array_equal(xp[keep], x[keep])
    np.testing.assert_array_equal(lamp[keep], lam[keep])


def test_qp_coop_reads_each_lane_in_the_callers_layout(lib):
    """The [B, P] row-major layout: lanes permuted in every input come out
    permuted, bit for bit; and a batch of one lane gives that lane's result."""
    sys = qps_of((6, 12))
    x, lam = run(lib, sys)
    perm = np.random.default_rng(3).permutation(sys[1].shape[0])
    xp, lamp = run(lib, [np.ascontiguousarray(a[perm]) for a in sys])
    np.testing.assert_array_equal(xp, x[perm])
    np.testing.assert_array_equal(lamp, lam[perm])
    x1, lam1 = run(lib, [np.ascontiguousarray(a[7:8]) for a in sys])
    np.testing.assert_array_equal(x1, x[7:8])
    np.testing.assert_array_equal(lam1, lam[7:8])


def test_qp_shape_rule_and_builds():
    """takes_coop: every (n, m) with max(n, m) <= 32; the fixed cooperative
    library at the
    paths' shapes, a unit of its own for any other, the thread-per-lane
    builds reached by thread_per_lane or past the width."""
    for shape in [(6, 12), (6, 8), (2, 1), (7, 3), (1, 1), (32, 32), (1, 32)]:
        assert qp_kernel.takes_coop(*shape), shape
    for shape in [(33, 1), (1, 33), (40, 40)]:
        assert not qp_kernel.takes_coop(*shape), shape
    for shape in qp_kernel.INSTANTIATED:
        assert qp_kernel.library_of(*shape) is qp_kernel.BUILD_COOP
        assert qp_kernel.library_of(*shape, thread_per_lane=True) is qp_kernel.BUILD
    b = qp_kernel.library_of(2, 1)
    assert qp_kernel.is_coop(b) and b is qp_kernel.coop_build_for(2, 1)
    assert b.defines == ("-DPGS_N=2", "-DPGS_M=1") and b.sources[0] == "dual_pgs_coop.cu"
    assert qp_kernel.library_of(2, 1, thread_per_lane=True) is qp_kernel.build_for(2, 1)
    wide = qp_kernel.library_of(40, 3)
    assert not qp_kernel.is_coop(wide) and wide.defines == ("-DPGS_N=40", "-DPGS_M=3")
    assert len({qp_kernel.library_of(*s)._paths()[0] for s in [(2, 1), (7, 3), (6, 12)]}) == 3


def test_qp_cpu_tensors_launch_nothing():
    """On CPU tensors dual_pgs runs its plain version: neither design's
    counter moves."""
    sys = qps_of((6, 8))
    before = (qp_kernel.dual_pgs_launches, qp_kernel.dual_pgs_coop_launches)
    x, lam = qp_kernel.dual_pgs(*(torch.tensor(a) for a in sys), iters=ITERS, reg=REG)
    assert (qp_kernel.dual_pgs_launches, qp_kernel.dual_pgs_coop_launches) == before
    assert x.shape == sys[1].shape and lam.shape == sys[3].shape


def test_qp_coop_records_fit_shared_memory(lib):
    """Threads a lane: the smallest power of two at or above max(n, m) (16 at
    (6, 12), 8 at (6, 8), 2 at (2, 1)); 8 records of each fixed and tested
    shape fit the 232,448 bytes of shared memory a Hopper block may have,
    and one of the widest shape (32, 32) does."""
    assert [lib.qp_group_threads(*s) for s in SHAPES + [(32, 32)]] == [8, 16, 2, 8, 32]
    for shape in SHAPES + [(32, 32)]:
        size = lib.qp_lane_bytes(*shape)
        assert 0 < size <= 232_448 and size % 16 == 0, (shape, size)
        if shape != (32, 32):
            assert 8 * size <= 232_448, (shape, size)


@pytest.mark.parametrize("fault", ["build", "launch"])
def test_qp_failed_coop_build_or_launch_raises_without_fallback(monkeypatch, fault):
    """A cooperative build that fails, or a launch that returns an error,
    raises with the shape: the thread-per-lane library is never loaded and
    neither counter moves."""
    sys = [torch.tensor(a) for a in qps_of((6, 12))]

    def no_fallback(*_):
        raise AssertionError("fell back to the thread-per-lane library")

    monkeypatch.setattr(qp_kernel.BUILD, "load", no_fallback)
    if fault == "build":
        def failed_build():
            raise RuntimeError("nvcc failed")
        monkeypatch.setattr(qp_kernel.BUILD_COOP, "load", failed_build)
    else:
        lib = types.SimpleNamespace(dual_pgs_coop_launch=lambda *a: 700)
        monkeypatch.setattr(qp_kernel, "_build_lib",
                            lambda b: lib if b is qp_kernel.BUILD_COOP else no_fallback())
        monkeypatch.setattr(torch.cuda, "current_stream",
                            lambda *a: types.SimpleNamespace(cuda_stream=0))
    before = (qp_kernel.dual_pgs_launches, qp_kernel.dual_pgs_coop_launches)
    with pytest.raises(RuntimeError, match="nvcc failed" if fault == "build"
                       else r"\(n, m\) = \(6, 12\): error 700"):
        qp_kernel.launch(*sys, ITERS, REG)
    assert (qp_kernel.dual_pgs_launches, qp_kernel.dual_pgs_coop_launches) == before


def test_qp_launch_passes_callers_layout(monkeypatch):
    """launch hands the cooperative kernel the callers' [B, P] tensors
    themselves (no copy where they are contiguous and aligned), with (n, m),
    B, iters and reg, returns [B, n] and [B, m] and counts the launch on the
    cooperative counter only; thread_per_lane takes the packed inputs to the
    other build and its counter."""
    sys = [torch.tensor(a) for a in qps_of((6, 12))]
    B = sys[1].shape[0]
    seen = []
    lib = types.SimpleNamespace(dual_pgs_coop_launch=lambda *a: seen.append(("coop", a)) or 0,
                                dual_pgs_launch=lambda *a: seen.append(("lane", a)) or 0)
    monkeypatch.setattr(qp_kernel, "_build_lib", lambda b: lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *a: types.SimpleNamespace(cuda_stream=0))
    before = (qp_kernel.dual_pgs_launches, qp_kernel.dual_pgs_coop_launches)
    x, lam = qp_kernel.launch(*sys, ITERS, REG)
    assert x.shape == (B, 6) and lam.shape == (B, 12)
    (design, a), = seen
    assert design == "coop" and a[:3] == (6, 12, B)
    assert a[3:9] == tuple(t.data_ptr() for t in sys) and a[9] == ITERS
    assert (qp_kernel.dual_pgs_launches, qp_kernel.dual_pgs_coop_launches) == \
        (before[0], before[1] + 1)
    x, lam = qp_kernel.launch(*qp_kernel.pack(*sys), ITERS, REG, thread_per_lane=True)
    assert seen[-1][0] == "lane" and seen[-1][1][:3] == (6, 12, B)
    assert x.shape == (6, B) and lam.shape == (12, B)
    assert (qp_kernel.dual_pgs_launches, qp_kernel.dual_pgs_coop_launches) == \
        (before[0] + 1, before[1] + 1)
    with pytest.raises(ValueError, match="does not take"):
        qp_kernel.launch(torch.zeros(2, 33, 33), torch.zeros(2, 33), torch.zeros(2, 1, 33),
                         *(torch.zeros(2, 1) for _ in range(3)), ITERS, REG)


def test_qp_row_quotient_is_the_division(lib):
    """The sweeps' quotient (a zero dividend over a finite non-zero safe
    taken as resid * safe, so that the card's division never sees a zero
    dividend) equals resid / safe bit for bit on every pair of signed
    zeros, denormals, normals, infinities and NaN."""
    vals = np.array([0.0, -0.0, 1e-45, -1e-45, 1e-38, 1.0, -2.5, 3e38, -3e38, np.inf, -np.inf,
                     np.nan, 1e-10, -7.0], np.float32)
    resid, safe = (np.ascontiguousarray(a.ravel()) for a in np.meshgrid(vals, vals))
    q, div = np.empty_like(resid), np.empty_like(resid)
    ptr = lambda a: a.ctypes.data_as(ctypes.c_void_p)
    lib.qp_row_quotient(resid.size, ptr(resid), ptr(safe), ptr(q), ptr(div))
    np.testing.assert_array_equal(np.isnan(q), np.isnan(div))
    np.testing.assert_array_equal(q.view(np.uint32)[~np.isnan(div)],
                                  div.view(np.uint32)[~np.isnan(div)])
