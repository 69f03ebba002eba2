"""CPU check of the CUDA kernels' lane bodies. csrc/chord_bdf2_lane.cuh is
compiled with plain g++ behind a tiny extern "C" loop over lanes (no torch
headers, built under a temporary directory) and held against the JAX
package's numpy evaluation of the Pallas kernel body,
pallas_step.chord_bdf2_dense(xp=np), on scene_chain(4) and scene_chain(12)
(the two shapes the kernel is instantiated for) and on a scene with every
constant-S joint type, a penalty limit and body damping, at the tolerances of
tests/test_pallas_step.py (x 5e-6 abs, Hinv 2e-5 of scale). The packing of
the kernel's inputs (chord_kernel.pack) is the wrapper's own.

csrc/dual_pgs_lane.cuh is built the same way and held against
pallas_qp.dual_pgs_dense(xp=np) at both instantiated shapes: (6, 8) on
random QPs with equality, inequality and boxed rows and a lane whose H has a
zero pivot (NaN must come out, not a bound), and (6, 12) on the physical
systems of the 6-link floor chain (masked rows, infinite boxes), x at 2e-5
and lambda at 2e-4 of scale; the inputs are packed by qp_kernel.pack.

With ground contacts (chain-ground-4 and chain-ground-12 at the contact-MPC
workload's coefficients, states with corners out of contact, in static and in
dynamic friction, mu = 0.5 and mu = 0) the lane body is held against
chord_bdf2_dense(force_fns=...) at the same tolerances; a floor out of reach
gives the C = 0 result bit for bit.

These builds are tests only, never a route of a wrapper.
"""

import ctypes
import dataclasses
import os
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from redmax_tpu import integrators as jint
from redmax_tpu import pallas_step
from redmax_tpu import scene as jscene
from redmax_tpu.scenes import scene_chain as jchain
from redmax_tpu.scenes import scene_chain_ground as jground
from redmax_tpu.types import JointType as JJT
from redmax_tpu import pallas_qp
from redmax_tpu_torch import chord_kernel, convert, qp_kernel
from redmax_tpu_torch import integrators as tint
from redmax_tpu_torch.scenes import scene_floor_chain
from test_torch_chord import BENCH_GROUND, contact_states, corner_regimes
from test_torch_model import mixed_builder
from test_torch_qp import mixed_qp

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "redmax_tpu_torch", "csrc")
LOOP = r"""
#include "chord_bdf2_lane.cuh"
extern "C" void chord_bdf2_cpu(int N, int B, const float* x0, const float* q0, const float* qd0,
                               const float* q1, const float* qd1, const float* tau,
                               const int* topo_i, const float* stat_f, int fixed_iters,
                               float growth_reject, float tol_reject, float dx_clamp,
                               float* x_out, float* hinv_out) {
  const chord::ChordConfig cfg{fixed_iters, growth_reject, tol_reject, dx_clamp};
  for (int lane = 0; lane < B; ++lane) {
    if (N == 4)
      chord::chord_bdf2_lane<4, 4>(lane, B, x0, q0, qd0, q1, qd1, tau, topo_i, stat_f, cfg,
                                   x_out, hinv_out);
    else if (N == 6)
      chord::chord_bdf2_lane<6, 8>(lane, B, x0, q0, qd0, q1, qd1, tau, topo_i, stat_f, cfg,
                                   x_out, hinv_out);
    else
      chord::chord_bdf2_lane<12, 12>(lane, B, x0, q0, qd0, q1, qd1, tau, topo_i, stat_f, cfg,
                                     x_out, hinv_out);
  }
}
"""
QP_LOOP = r"""
#include "dual_pgs_lane.cuh"
extern "C" int dual_pgs_cpu(int n, int m, int B, const float* H, const float* f, const float* A,
                            const float* b, const float* lo, const float* hi, int iters,
                            float reg, float* x_out, float* lam_out) {
  for (int lane = 0; lane < B; ++lane) {
    if (n == 6 && m == 12)
      qp::dual_pgs_lane<6, 12>(lane, B, H, f, A, b, lo, hi, iters, reg, x_out, lam_out);
    else if (n == 6 && m == 8)
      qp::dual_pgs_lane<6, 8>(lane, B, H, f, A, b, lo, hi, iters, reg, x_out, lam_out);
    else
      return -1;
  }
  return 0;
}
"""
CFG_KW = dict(fixed_iters=3, predictor="quadratic", chord=True,
              hessian="structured", linsolve="gj")


def _gxx_build(tmp_path_factory, name, source):
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    d = tmp_path_factory.mktemp(name)
    src, so = d / "loop.cpp", d / "liblane.so"
    src.write_text(source)
    subprocess.run(["g++", "-O2", "-std=c++17", "-shared", "-fPIC", "-I", CSRC,
                    "-o", str(so), str(src)], check=True)
    return ctypes.CDLL(str(so))


@pytest.fixture(scope="module")
def lane_lib(tmp_path_factory):
    lib = _gxx_build(tmp_path_factory, "lane_body", LOOP)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.chord_bdf2_cpu.argtypes = [i, i] + [p] * 8 + [i, f, f, f, p, p]
    lib.chord_bdf2_cpu.restype = None
    return lib


def _states(nr, B):
    rng = np.random.default_rng(1)
    q1 = (0.3 * rng.normal(size=(B, nr))).astype(np.float32)
    qd1 = rng.normal(size=(B, nr)).astype(np.float32)
    qd1[-1] = 1e6  # a lane that must be rejected
    q0 = q1 - np.float32(0.01) * qd1
    qd0 = qd1 + (0.05 * rng.normal(size=(B, nr))).astype(np.float32)
    x0 = q1 + np.float32(0.01) * qd1
    tau = (3.0 * rng.normal(size=(B, nr))).astype(np.float32)
    return (x0, q0, qd0, q1, qd1), tau


def _port(sc):
    """The JAX scene's topology, float32 params and force closures in the port."""
    topo = convert.topology_from_fields(**dataclasses.asdict(sc.topo))
    params = convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, sc.params),
                                       "cpu", torch.float32)
    fns = convert.forces_from_fields([(type(f).__name__, vars(f)) for f in sc.force_fns])
    return topo, params, fns


def _run_lane_lib(lane_lib, topo, params, tau, states, force_fns=()):
    """(x [B, nr], Hinv [B, nr, nr]) of the g++ lane body on the wrapper's
    own packing of the inputs."""
    B, nr = states[0].shape
    packed = chord_kernel.pack(topo, {**params, "tau": torch.tensor(tau)},
                               *(torch.tensor(a) for a in states), force_fns)
    args = [np.ascontiguousarray(a.numpy()) for a in packed]
    x_out = np.empty((nr, B), np.float32)
    h_out = np.empty((nr * nr, B), np.float32)
    cfg = tint.NewtonConfig(**CFG_KW)
    ptr = lambda a: a.ctypes.data_as(ctypes.c_void_p)
    lane_lib.chord_bdf2_cpu(topo.njoints, B, *(ptr(a) for a in args),
                            cfg.fixed_iters, cfg.growth_reject, cfg.tol_reject, cfg.dx_clamp,
                            ptr(x_out), ptr(h_out))
    return x_out.T, h_out.reshape(nr, nr, B).transpose(2, 0, 1)


@pytest.mark.parametrize("scene", ["chain4", "chain12", "mixed"])
def test_lane_body_matches_kernel_body(lane_lib, scene):
    build = {"chain4": lambda: jchain(nlinks=4), "chain12": lambda: jchain(nlinks=12),
             "mixed": lambda: mixed_builder(jscene, JJT)}
    sc = build[scene]().compile(dtype=jnp.float32)
    B, nr = 9, sc.topo.nr
    states, tau = _states(nr, B)
    jcfg = jint.NewtonConfig(**CFG_KW)
    x_np, hinv_np = pallas_step.chord_bdf2_dense(
        sc.topo, jcfg, {**sc.params, "tau": jnp.asarray(tau)}, *states, xp=np)

    topo, params, _ = _port(sc)
    x, hinv = _run_lane_lib(lane_lib, topo, params, tau, states)

    finite = np.isfinite(x_np).all(-1)
    assert not finite[-1] and finite[:-1].all(), finite
    np.testing.assert_array_equal(np.isfinite(x).all(-1), finite)
    np.testing.assert_allclose(x[finite], x_np[finite], rtol=0, atol=5e-6)
    scale = float(np.abs(hinv_np[finite]).max())
    np.testing.assert_allclose(hinv[finite], hinv_np[finite], rtol=0, atol=2e-5 * scale)


@pytest.mark.parametrize("nlinks,mu", [(4, 0.5), (12, 0.5), (4, 0.0)])
def test_lane_body_with_contacts_matches_kernel_body(lane_lib, nlinks, mu):
    sc = jground(nlinks=nlinks, **{**BENCH_GROUND, "mu": mu}).compile(dtype=jnp.float32)
    B, nr = 16, sc.topo.nr
    states, tau = contact_states(nr, B)
    jcfg = jint.NewtonConfig(**CFG_KW)
    x_np, hinv_np = pallas_step.chord_bdf2_dense(
        sc.topo, jcfg, {**sc.params, "tau": jnp.asarray(tau)}, *states, xp=np,
        force_fns=sc.force_fns)
    topo, params, fns = _port(sc)
    assert len(fns) == nlinks
    qd_pred = 150.0 * (states[0] - (4 / 3) * states[3] + (1 / 3) * states[1])
    out, sta, dyn = corner_regimes(topo, params, fns, states[0], qd_pred)
    assert out > 0 and (sta > 0 and dyn > 0 if mu else sta == dyn == 0), (out, sta, dyn)

    x, hinv = _run_lane_lib(lane_lib, topo, params, tau, states, fns)
    finite = np.isfinite(x_np).all(-1)
    assert finite.mean() >= 0.75, finite
    np.testing.assert_array_equal(np.isfinite(x).all(-1), finite)
    np.testing.assert_allclose(x[finite], x_np[finite], rtol=0, atol=5e-6)
    scale = float(np.abs(hinv_np[finite]).max())
    np.testing.assert_allclose(hinv[finite], hinv_np[finite], rtol=0, atol=2e-5 * scale)
    # the contacts matter: without them the solution differs
    x_free, _ = _run_lane_lib(lane_lib, topo, params, tau, states)
    assert np.abs(x_free[finite] - x[finite]).max() > 1e-4


def test_lane_body_floor_out_of_reach_equals_no_contacts(lane_lib):
    """Contacts that no corner can reach within a step add exact zeros: x and
    H^-1 equal the C = 0 result bit for bit. (The rejected lane moves at
    1e6, so its margin reaches any floor: its x is NaN either way.)"""
    sc = jground(nlinks=4, kn=100.0, kt=0.1, kd=10.0, mu=0.5, floor_z=-50.0).compile(
        dtype=jnp.float32)
    topo, params, fns = _port(sc)
    states, tau = _states(sc.topo.nr, 9)
    x, hinv = _run_lane_lib(lane_lib, topo, params, tau, states, fns)
    x0, hinv0 = _run_lane_lib(lane_lib, topo, params, tau, states)
    assert np.isnan(x[-1]).all() and np.isfinite(x[:-1]).all()
    np.testing.assert_array_equal(x, x0)
    np.testing.assert_array_equal(hinv[:-1], hinv0[:-1])


@pytest.fixture(scope="module")
def qp_lane_lib(tmp_path_factory):
    lib = _gxx_build(tmp_path_factory, "qp_lane_body", QP_LOOP)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.dual_pgs_cpu.argtypes = [i, i, i] + [p] * 6 + [i, ctypes.c_float, p, p]
    lib.dual_pgs_cpu.restype = i
    return lib


def floor_chain_systems(B, device="cpu", seed=0):
    """The contact QPs of the 6-link floor chain (n = 6, m = 12) in float32
    at states q0 + 0.3 N(0,1), qdot N(0,1): (H, f, A, b, lo, hi) tensors."""
    sc = scene_floor_chain(6).compile(dtype=torch.float32, device=device)
    rng = np.random.default_rng(seed)
    q = sc.state0.q.cpu().numpy()[None] + 0.3 * rng.normal(size=(B, sc.topo.nr))
    qd = rng.normal(size=(B, sc.topo.nr))
    f32 = lambda a: torch.tensor(a, dtype=torch.float32, device=device)
    H, f, (A, b, lo, hi, _) = tint.euler_qp_system(
        sc.topo, (), sc.constraint_fns, sc.params, f32(q), f32(qd))
    return H, f, A, b, lo, hi


@pytest.mark.parametrize("shape", [(6, 8), (6, 12)])
def test_dual_pgs_lane_body_matches_kernel_body(qp_lane_lib, shape):
    n, m = shape
    if shape == (6, 8):
        sys = list(mixed_qp(11, 9, 6, 1, 4, 3, np.float32))
        sys[0][-1] = 1.0  # all-ones H: the second pivot is exactly 0
        iters = 60
    else:
        sys = [a.numpy() for a in floor_chain_systems(64)]
        iters = 40
        hi = sys[5]
        assert np.isinf(hi).any() and (hi == 0).any()  # active and masked rows
    B = sys[1].shape[0]
    assert (sys[1].shape[1], sys[2].shape[1]) == shape
    x_np, lam_np = pallas_qp.dual_pgs_dense(*sys, iters=iters)

    packed = [np.ascontiguousarray(a.numpy()) for a in
              qp_kernel.pack(*(torch.tensor(a) for a in sys))]
    x_out = np.empty((n, B), np.float32)
    lam_out = np.empty((m, B), np.float32)
    ptr = lambda a: a.ctypes.data_as(ctypes.c_void_p)
    rc = qp_lane_lib.dual_pgs_cpu(n, m, B, *(ptr(a) for a in packed), iters, 1e-10,
                                  ptr(x_out), ptr(lam_out))
    assert rc == 0
    x, lam = x_out.T, lam_out.T

    finite = np.isfinite(x_np).all(-1)
    assert finite[:B - 1].all() and finite[-1] == (shape == (6, 12))
    np.testing.assert_array_equal(np.isfinite(x).all(-1), finite)
    np.testing.assert_array_equal(np.isnan(lam), np.isnan(lam_np))
    xs = max(1.0, float(np.abs(x_np[finite]).max()))
    ls = max(1.0, float(np.abs(lam_np[finite]).max()))
    np.testing.assert_allclose(x[finite], x_np[finite], rtol=0, atol=2e-5 * xs)
    np.testing.assert_allclose(lam[finite], lam_np[finite], rtol=0, atol=2e-4 * ls)
