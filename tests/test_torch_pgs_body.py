"""The K3 kernel's lane body (csrc/pgs_sweeps_lane.cuh) under g++.

The CPU route (pgs_kernel.pgs_sweeps on CPU tensors, the host build) is
held against its plain version qp.pgs_sweeps: within 1e-12 of scale in
float64 and 1e-5 in float32, at m = 1, 7, 24, 33 (a boundary of the warp
design's 32-row slots) and 80 (the friction zoo's QP and friction-pass
widths), and at m = 200 (a width built at first launch), with
+-inf boxes, zero-width boxes, the reg guard on the diagonal, a NaN lane and
a lane that is not active; without g++ the CPU route raises and does not
fall back.

The card's two designs run here too: a g++ unit (LOOP) runs the warp
design's phases (warp_sweeps) for each of the warp's 32 threads in turn,
forward and in reverse order, and the thread design's block load
(thread_load) for each thread of a block in turn, then each lane's sweeps
(thread_sweeps). Each design must give the host build's result bit for bit
(all three compute the same arithmetic in the same order, every
multiply-add an explicit fma), the two orders must agree bit for bit (a
phase that reads what another thread writes in the same phase shows), and
the warp design's lower-triangle store of a symmetric D must give its full
store's result bit for bit. The rules that pick the design (design_of) and
the warp design's store (warp_store, which leaves the widths where no store
fits a block to the earlier design), and the routes' guards, are held too.
Inputs from a numpy seed."""

import ctypes
import shutil
import subprocess
from functools import lru_cache

import numpy as np
import pytest
import torch

from redmax_tpu_torch import kernel_build, metrics, pgs_kernel, qp


@pytest.fixture(scope="module", autouse=True)
def single_thread():
    """torch's intra-op threads set to 1 for the module, then restored."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


LOOP = r"""
#include <algorithm>
#include <cmath>
#include <cstring>
#include <vector>
#include "pgs_sweeps_lane.cuh"

// The warp as warp_sweeps's team: its 32 threads one after another, forward
// or in reverse order; a shuffle reads the owner's d.
template <typename T, int K>
struct SerialTeam {
  pgs::WarpRows<T, K> w[32];
  int reverse;
  template <class F>
  void each(F&& f) {
    for (int i = 0; i < 32; ++i) {
      const int t = reverse ? 31 - i : i;
      f(t, w[t]);
    }
  }
  T from(int s) const { return w[s].d; }
  void sync() const {}
};

template <typename T, int K, bool kTri>
void warp_lane(int reverse, int m, const T* D, const T* r, const T* lo, const T* hi, int iters,
               T reg, T* lam) {
  // every store, shared array and register starts as NaN: a read of a value
  // no phase wrote shows
  std::vector<T> Ds(pgs::store_elems(m, kTri), NAN), lam_s(32 * K, NAN);
  static SerialTeam<T, K> team;
  std::memset(static_cast<void*>(team.w), 0xff, sizeof team.w);
  team.reverse = reverse;
  pgs::warp_sweeps<T, K, kTri>(team, m, D, r, lo, hi, iters, reg, Ds.data(), lam_s.data(), lam);
}

template <typename T, int M>
void thread_blocks(int reverse, int B, const T* D, const T* r, const T* lo, const T* hi,
                   const unsigned char* active, int iters, T reg, T* lam) {
  constexpr int L = 32;
  std::vector<T> Ds(L * M * M);
  for (int lane0 = 0; lane0 < B; lane0 += L) {
    const int n = B - lane0 < L ? B - lane0 : L;
    std::fill(Ds.begin(), Ds.end(), T(NAN));
    for (int i = 0; i < L; ++i)
      pgs::thread_load<T, M>(reverse ? L - 1 - i : i, L, n, D + static_cast<long>(lane0) * M * M,
                             Ds.data());
    for (int i = 0; i < L; ++i) {
      const int l = reverse ? L - 1 - i : i;
      if (l >= n) continue;
      const long off = static_cast<long>(lane0 + l) * M;
      if (active && !active[lane0 + l]) {
        for (int j = 0; j < M; ++j) lam[off + j] = T(0);
        continue;
      }
      pgs::thread_sweeps<T, M>(pgs::BlockStore<T, M>{Ds.data(), L, l}, D + off * M, r + off,
                               lo + off, hi + off, iters, reg, lam + off);
    }
  }
}

template <typename T>
int run(int design, int store, int reverse, int m, int B, const T* D, const T* r, const T* lo,
        const T* hi, const unsigned char* active, int iters, T reg, T* lam) {
  if (design == 0) {
#define THREAD(M) \
  if (m == M) return thread_blocks<T, M>(reverse, B, D, r, lo, hi, active, iters, reg, lam), 0;
    THREAD(1) THREAD(2) THREAD(7) THREAD(9) THREAD(14)
    return -1;
  }
  const int K = (m + 31) / 32;
  for (int b = 0; b < B; ++b) {
    const long off = static_cast<long>(b) * m;
    if (active && !active[b]) {
      for (int j = 0; j < m; ++j) lam[off + j] = T(0);
      continue;
    }
#define WARP(k, t)                                                                          \
  else if (K == k && store == t) warp_lane<T, k, t>(reverse, m, D + off * m, r + off, lo + off, \
                                                    hi + off, iters, reg, lam + off);
#define WARP2(k) WARP(k, 0) WARP(k, 1)
    if (false) {}
    WARP2(1) WARP2(2) WARP2(3) WARP2(4) WARP2(7)
    else return -1;
  }
  return 0;
}

extern "C" int pgs_design_cpu_f32(int design, int store, int reverse, int m, int B, const float* D,
                                  const float* r, const float* lo, const float* hi,
                                  const unsigned char* active, int iters, float reg, float* lam) {
  return run<float>(design, store, reverse, m, B, D, r, lo, hi, active, iters, reg, lam);
}

extern "C" int pgs_design_cpu_f64(int design, int store, int reverse, int m, int B,
                                  const double* D, const double* r, const double* lo,
                                  const double* hi, const unsigned char* active, int iters,
                                  double reg, double* lam) {
  return run<double>(design, store, reverse, m, B, D, r, lo, hi, active, iters, reg, lam);
}
"""
THREAD_MS = (1, 2, 7, 9, 14)   # the thread design's widths LOOP instantiates
TOL = {torch.float64: 1e-12, torch.float32: 1e-5}


@pytest.fixture(scope="module")
def design_lib(tmp_path_factory):
    """LOOP built by g++ (as the host build is: -O2, -std=c++17)."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    d = tmp_path_factory.mktemp("pgs_designs")
    src, so = d / "loop.cpp", d / "libpgs_designs.so"
    src.write_text(LOOP)
    subprocess.run(["g++", "-O2", "-std=c++17", "-shared", "-fPIC", "-I", kernel_build.CSRC,
                    "-o", str(so), str(src)], check=True)
    lib = ctypes.CDLL(str(so))
    p, i = ctypes.c_void_p, ctypes.c_int
    for suffix, ct in (("f32", ctypes.c_float), ("f64", ctypes.c_double)):
        fn = getattr(lib, f"pgs_design_cpu_{suffix}")
        fn.argtypes = [i] * 5 + [p] * 5 + [i, ct, p]
        fn.restype = i
    return lib


def emulate(lib, design, D, r, lo, hi, iters, reg, active=None, store="full", reverse=False):
    """The card design ("thread" or "warp", the latter with its store of D,
    pgs_kernel.STORES) run by LOOP: lam [B, m]."""
    B, m = r.shape
    ins = [a.contiguous() for a in (D, r, lo, hi)]
    act = None if active is None else active.to(torch.uint8).contiguous()
    lam = torch.empty_like(ins[1])
    suffix = "f64" if D.dtype == torch.float64 else "f32"
    err = getattr(lib, f"pgs_design_cpu_{suffix}")(
        pgs_kernel.DESIGNS[design], pgs_kernel.STORES[store], int(reverse), m, B,
        *(a.data_ptr() for a in ins), None if act is None else act.data_ptr(), iters, reg,
        lam.data_ptr())
    assert err == 0, f"LOOP holds no {design} build at m = {m}"
    return lam


def duals(m, B=5, seed=0, dtype=torch.float64, symmetric=False):
    """B lanes of (D, r, lo, hi): D symmetric positive semidefinite of rank
    about m/2 plus a small ridge (a friction pass's Hf is semidefinite), r
    and boxes from the seed; lane 0 with +-inf boxes on every row, lane 1
    with zero-width boxes on every other row, lane 2 with a row whose
    diagonal is below reg (a masked row: a zero row and column).
    symmetric=True: D symmetric bit for bit (0.5 (D + D^T)), as the
    friction pass makes its Hf."""
    rng = np.random.default_rng(seed)
    k = max(1, m // 2)
    A = rng.normal(size=(B, m, k))
    D = A @ A.transpose(0, 2, 1) / k + 1e-3 * np.eye(m)
    r = rng.normal(size=(B, m))
    lo = -rng.uniform(0.1, 1.0, size=(B, m))
    hi = rng.uniform(0.1, 1.0, size=(B, m))
    lo[0], hi[0] = -np.inf, np.inf
    lo[1, ::2] = hi[1, ::2] = 0.0
    D[2, 0, :] = D[2, :, 0] = 0.0
    t = lambda a: torch.tensor(a, dtype=dtype)
    D = t(D)
    if symmetric:
        D = 0.5 * (D + D.transpose(-1, -2))
    return D, t(r), t(lo), t(hi)


def skewed(m, dtype):
    """duals(m) with D made unsymmetric (a dual QP's A H^-1 A^T rounds so):
    D + 0.05 of a skew part from the seed."""
    D, r, lo, hi = duals(m, dtype=dtype)
    S = torch.tensor(np.random.default_rng(7).normal(size=tuple(D.shape)), dtype=dtype)
    return D + 0.05 * (S - S.transpose(-1, -2)), r, lo, hi


def route_of(lib, route):
    """A runner of (D, r, lo, hi, iters, reg[, active]) for route: "host"
    (pgs_sweeps on CPU tensors), "thread", "warp" (D transposed in shared
    memory) or "warp_triangle" (its lower triangle) under LOOP."""
    if route == "host":
        return lambda *a: pgs_kernel.pgs_sweeps(*a)
    design, _, where = route.partition("_")
    return lambda *a: emulate(lib, design, *a, store=where or "full")


@lru_cache(maxsize=None)
def plain(m, dtype, iters, symmetric=False):
    """qp.pgs_sweeps on duals(m), computed once."""
    D, r, lo, hi = duals(m, dtype=dtype, symmetric=symmetric)
    return qp.pgs_sweeps(D, r, lo, hi, iters, 1e-12)


def check(lam, ref, tol):
    scale = max(1.0, float(ref[torch.isfinite(ref)].abs().max()))
    np.testing.assert_array_equal(torch.isnan(lam).numpy(), torch.isnan(ref).numpy())
    ok = torch.isfinite(ref)
    assert float((lam[ok] - ref[ok]).abs().max()) <= tol * scale


def same_bits(a, b):
    """Equal bit for bit, a NaN equal to a NaN."""
    np.testing.assert_array_equal(a.numpy().view(np.uint8), b.numpy().view(np.uint8))


@pytest.mark.parametrize("dtype, tol", [(torch.float64, 1e-12), (torch.float32, 1e-5)])
@pytest.mark.parametrize("m", [1, 7, 24, 33, 80])
def test_host_body_matches_plain(m, dtype, tol):
    D, r, lo, hi = duals(m, dtype=dtype)
    before = metrics.counters().get("pgs_kernel.host_runs", 0)
    lam = pgs_kernel.pgs_sweeps(D, r, lo, hi, 200, 1e-12)
    assert metrics.counters()["pgs_kernel.host_runs"] == before + 1
    assert lam.dtype == dtype and lam.shape == r.shape
    check(lam, plain(m, dtype, 200), tol)
    # the boxes hold: zero-width rows sit at 0, the others inside [lo, hi]
    assert (lam[1, ::2] == 0).all()
    assert ((lam >= lo) & (lam <= hi)).all()


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("m", [1, 7, 24, 33, 80])
def test_designs_match_host_and_plain(design_lib, m, dtype):
    """Each design that holds m (the thread design at LOOP's widths, the
    warp design at every m), in both thread orders, gives the host build's
    lam bit for bit, on duals(m) (against qp.pgs_sweeps at TOL of scale)
    and on an unsymmetric D."""
    designs = ["warp"] + (["thread"] if m in THREAD_MS else [])
    for k, (D, r, lo, hi) in enumerate((duals(m, dtype=dtype), skewed(m, dtype))):
        host = pgs_kernel.pgs_sweeps(D, r, lo, hi, 200, 1e-12)
        for design in designs:
            for reverse in (False, True):
                lam = emulate(design_lib, design, D, r, lo, hi, 200, 1e-12, reverse=reverse)
                same_bits(lam, host)
                if k == 0:
                    check(lam, plain(m, dtype, 200), TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_wide_m_stores_match_host_and_plain(design_lib, dtype):
    """At m = 200 (K = 7, a unit built at first launch), the warp design's
    two stores, in both thread orders, give the host build's lam bit for
    bit (an unsymmetric D on the transpose, a symmetric one on both), and
    the host build is within TOL of qp.pgs_sweeps."""
    m, iters = 200, 30
    D, r, lo, hi = duals(m, dtype=dtype, symmetric=True)
    host = pgs_kernel.pgs_sweeps(D, r, lo, hi, iters, 1e-12)
    check(host, qp.pgs_sweeps(D, r, lo, hi, iters, 1e-12), TOL[dtype])
    Ds, rs, los, his = skewed(m, dtype)
    host_skewed = pgs_kernel.pgs_sweeps(Ds, rs, los, his, iters, 1e-12)
    for store in ("full", "triangle"):
        for reverse in (False, True):
            same_bits(emulate(design_lib, "warp", D, r, lo, hi, iters, 1e-12, store=store,
                              reverse=reverse), host)
            if store != "triangle":
                same_bits(emulate(design_lib, "warp", Ds, rs, los, his, iters, 1e-12,
                                  store=store, reverse=reverse), host_skewed)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("m", [7, 24, 33, 72, 80])
def test_triangle_store_matches_full_store(design_lib, m, dtype):
    """On a D symmetric bit for bit, the warp design's lower-triangle store
    gives its full store's lam bit for bit, in both thread orders, and the
    full store's lam is the host build's."""
    D, r, lo, hi = duals(m, dtype=dtype, symmetric=True)
    full = emulate(design_lib, "warp", D, r, lo, hi, 100, 1e-12)
    same_bits(full, pgs_kernel.pgs_sweeps(D, r, lo, hi, 100, 1e-12))
    for reverse in (False, True):
        same_bits(emulate(design_lib, "warp", D, r, lo, hi, 100, 1e-12, store="triangle",
                          reverse=reverse), full)
    check(full, plain(m, dtype, 100, symmetric=True), TOL[dtype])


@pytest.mark.parametrize("route", ["host", "warp", "thread", "warp_triangle"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_reg_guard_nan_lane_and_inactive_lane(design_lib, route, dtype):
    """Lane 2's zero diagonal divides by 1 (its row stays at the clip of r);
    a reg above every diagonal divides every row by 1; lane 3 NaN in one
    entry of r comes out NaN in both; lane 4 not active comes out 0 in both
    and the others as when every lane is active. On the host build and on
    each card design (m = 24 for the host and the warp design, 14 for the
    thread design; warp_triangle: the warp design's lower-triangle store,
    on D symmetric bit for bit)."""
    m = 14 if route == "thread" else 24
    run = route_of(design_lib, route)
    D, r, lo, hi = duals(m, dtype=dtype, symmetric=route == "warp_triangle")
    r[3, 5] = float("nan")
    active = torch.tensor([True, True, True, True, False])
    lam = run(D, r, lo, hi, 100, 1e-12, active)
    ref = qp.pgs_sweeps(D, r, lo, hi, 100, 1e-12, active)
    check(lam, ref, TOL[dtype])
    assert torch.isnan(lam[3]).all() and torch.isnan(ref[3]).all()
    assert (lam[4] == 0).all() and (ref[4] == 0).all()
    assert float(lam[2, 0]) == float(torch.clamp(r[2, 0], lo[2, 0], hi[2, 0]))
    full = run(D, r, lo, hi, 100, 1e-12)
    np.testing.assert_array_equal(full[:4].numpy(), lam[:4].numpy())
    big = run(D, r, lo, hi, 100, 1e3)
    check(big, qp.pgs_sweeps(D, r, lo, hi, 100, 1e3), TOL[dtype])


@pytest.mark.parametrize("route", ["host", "warp", "thread", "warp_triangle"])
def test_bounds_nan_and_inf_kept(design_lib, route):
    """A NaN bound gives NaN as torch.maximum / minimum do; an infinite r
    clips to a finite bound; an infinite diagonal gives NaN, as the plain
    version's r - D lambda + D_ii lambda_i does. On the host build and on
    each card design and store."""
    run = route_of(design_lib, route)
    D, r, lo, hi = duals(7, symmetric=route == "warp_triangle")
    lo[0, 2] = float("nan")
    r[4, 1] = float("inf")
    D[3, 4, 4] = float("inf")
    lam = run(D, r, lo, hi, 10, 1e-12)
    ref = qp.pgs_sweeps(D, r, lo, hi, 10, 1e-12)
    check(lam, ref, 1e-12)
    assert torch.isnan(lam[0]).all() and torch.isnan(lam[3]).all()
    assert torch.isfinite(lam[4]).all()


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_design_rule(dtype):
    """design_of sends m <= THREAD_UP_TO to the thread design and wider m to
    the warp design: the friction zoo's dual QPs (m = 1, 2, 7) to the
    thread design, its friction passes (m = 24-80) to the warp design; the
    rule never sends the thread design a width its build does not hold
    (BUILD holds it up to THREAD_UP_TO); every m the fixed build holds in
    the warp designs is BUILD's, a wider one a unit of its K."""
    up_to = pgs_kernel.THREAD_UP_TO[dtype]
    assert up_to >= 7
    assert f"-DPGS_THREAD_UP_TO_{'F64' if dtype == torch.float64 else 'F32'}={up_to}" in \
        pgs_kernel.BUILD.defines
    assert [pgs_kernel.design_of(m, dtype) for m in (1, 2, 7)] == ["thread"] * 3
    assert [pgs_kernel.design_of(m, dtype) for m in (24, 32, 34, 72, 80, 200)] == ["warp"] * 6
    assert pgs_kernel.design_of(up_to, dtype) == "thread"
    assert pgs_kernel.design_of(up_to + 1, dtype) == "warp"
    assert pgs_kernel.build_for(pgs_kernel.MAX_FIXED_M) is pgs_kernel.BUILD
    assert pgs_kernel.build_for(200).defines == ("-DPGS_K=7",)
    assert pgs_kernel.build_for(193) is pgs_kernel.build_for(224)   # one build a K


# an H100's opt-in shared memory a block, in bytes
H100_SMEM = 232448


def test_triangle_rule():
    """warp_store keeps a symmetric D as one triangle only where that runs
    B lanes in fewer waves than the transpose (waves as pgs_kernel.layout
    reads them on an H100 at B = 1024: double m = 80 4 and 8 lanes an SM,
    m = 32 24 and 32, float m = 80 8 and 16; 132 SMs), or where the
    transpose does not fit a block's shared memory and the triangle does;
    it leaves m to the earlier design (None) where no store fits (double
    m >= 170 unsymmetric: m = 169 230,280 bytes, 170 232,992 against the
    card's 232,448; float m >= 241) and in double past WARP_UP_TO = 192
    whatever fits; the shared memory it counts is what the kernel asks for
    (smem_bytes)."""
    lanes_per_sm = {(80, torch.float64, "full"): 4, (80, torch.float64, "triangle"): 8,
                    (32, torch.float64, "full"): 24, (32, torch.float64, "triangle"): 32,
                    (80, torch.float32, "full"): 8, (80, torch.float32, "triangle"): 16}

    def store(m, dtype, symmetric, B=1024):
        waves = lambda st: -(-B // (132 * lanes_per_sm.get((m, dtype, st), 1)))
        return pgs_kernel.warp_store(m, dtype, symmetric, H100_SMEM, waves)

    f64, f32 = torch.float64, torch.float32
    assert store(80, f64, True) == "triangle"              # two waves -> one
    assert store(80, f64, True, B=512) == "full"           # one wave either way
    assert store(80, f64, False) == "full"
    assert store(32, f64, True) == "full"
    assert store(80, f32, True) == "full"
    assert store(80, f32, True, B=2048) == "triangle"      # two waves -> one
    assert pgs_kernel.smem_bytes(169, f64, "full") == 230280 <= H100_SMEM
    assert pgs_kernel.smem_bytes(170, f64, "full") == 232992 > H100_SMEM
    assert [store(m, f64, False) for m in (169, 170, 200)] == ["full", None, None]
    assert [store(m, f64, True) for m in (170, 185, 192)] == ["triangle"] * 3
    assert [store(m, f64, True) for m in (193, 200, 240)] == [None] * 3
    assert [store(m, f32, False) for m in (200, 240, 241)] == ["full", "full", None]
    assert [store(m, f32, True) for m in (241, 300)] == ["triangle"] * 2
    assert store(340, f32, True) is None                   # no store fits
    assert pgs_kernel.smem_bytes(80, f64, "triangle") == 26944


def test_input_checks():
    D, r, lo, hi = duals(7)
    with pytest.raises(ValueError, match="float32 or float64"):
        pgs_kernel.pgs_sweeps(D.half(), r.half(), lo.half(), hi.half(), 1, 1e-12)
    with pytest.raises(ValueError, match="one dtype"):
        pgs_kernel.pgs_sweeps(D, r.float(), lo, hi, 1, 1e-12)
    with pytest.raises(ValueError, match="shape"):
        pgs_kernel.pgs_sweeps(D[:, :6], r, lo, hi, 1, 1e-12)
    with pytest.raises(ValueError, match="active"):
        pgs_kernel.pgs_sweeps(D, r, lo, hi, 1, 1e-12, torch.ones(3, dtype=torch.bool))
    assert pgs_kernel.pgs_sweeps(D[:, :0, :0], r[:, :0], lo[:, :0], hi[:, :0], 5,
                                 1e-12).shape == (5, 0)
    # launch() names a design and a store and takes CUDA tensors only: no
    # CPU route
    with pytest.raises(ValueError, match="design"):
        pgs_kernel.launch(D, r, lo, hi, 1, 1e-12, design="warp_per_lane")
    with pytest.raises(ValueError, match="store"):
        pgs_kernel.launch(D, r, lo, hi, 1, 1e-12, store="shared")
    with pytest.raises(ValueError, match="CUDA tensors"):
        pgs_kernel.launch(D, r, lo, hi, 1, 1e-12, design="warp_div")


def test_missing_gxx_raises_without_fallback(tmp_path, monkeypatch):
    """A host build with no g++ on PATH raises: pgs_sweeps returns no result
    from another route."""
    monkeypatch.setattr(kernel_build, "BUILD", str(tmp_path))
    monkeypatch.setattr(pgs_kernel, "HOST_BUILD", kernel_build.KernelBuild(
        "pgs_sweeps_host_nogxx", pgs_kernel.HOST_BUILD.sources, host=True))
    monkeypatch.setenv("PATH", str(tmp_path))
    D, r, lo, hi = duals(7)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        pgs_kernel.pgs_sweeps(D, r, lo, hi, 10, 1e-12)
