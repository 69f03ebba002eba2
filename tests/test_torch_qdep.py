"""The q-dependent-joint slice on the CPU: the chord kernel's K1b lane body,
the kernel route's backward and one whole MPC solve, against redmax_tpu.

  * csrc/chord_bdf2_lane.cuh with the QDEP bit, compiled by g++ at the
    card's three instantiations (N, nr) = (6, 12) (universal-6), (4, 12)
    (spherical-4, and a chain of a FREE3D root, a SPHERICAL, a UNIVERSAL and a
    REVOLUTE joint) and (1, 6) (scene 9's FREE3D body), plus (2, 6) and
    (3, 6) (scenes 7 and 8), all in one module-scoped g++ call, and held
    against the JAX package's numpy evaluation of the Pallas kernel body,
    pallas_step.chord_bdf2_dense(xp=np), at x 5e-6 and H^-1 2e-5 of scale,
    on states whose rotation vectors lie in the Taylor branch (s < 0.04),
    just above it and near |w| = 1.5 pi; the plain version
    (chord_kernel.chord_bdf2 on a CPU tensor) against the same oracle;
  * the kernel route's backward (z = H^-T xbar, then the VJP of the op-level
    residual) against JAX's cotangents.

The slice as a whole (one MPC solve through the exp-map rescale) is
tests/test_torch_qdep_mpc.py: its JAX oracle alone takes most of a minute.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from redmax_tpu import integrators as jint
from redmax_tpu import pallas_step
from redmax_tpu import scene as jscene
from redmax_tpu import scenes as jscenes
from redmax_tpu.types import JointType as JJT
from redmax_tpu_torch import chord_kernel, convert
from redmax_tpu_torch import integrators as tint
from test_torch_joints import qdep_chain_jax, qdep_mixed, rotation_samples
from test_torch_lane_body import CFG_KW, _gxx_build, _port, _run_lane_lib, _states


@pytest.fixture(scope="module", autouse=True)
def single_thread():
    """torch's intra-op threads set to 1 for the module, then restored."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


LOOP = r"""
#include "chord_bdf2_lane.cuh"
#define LANE(n, nr, f)                                                                    \
  if (N == n && NR == nr && feat == f) {                                                  \
    for (int lane = 0; lane < B; ++lane)                                                  \
      chord::chord_bdf2_lane<n, nr, f>(lane, B, x0, q0, qd0, q1, qd1, tau, topo_i, stat_f, \
                                       cfg, x_out, hinv_out, lane_f);                     \
    return 0;                                                                             \
  }
extern "C" int chord_bdf2_cpu(int N, int NR, int feat, int B, const float* x0, const float* q0,
                              const float* qd0, const float* q1, const float* qd1,
                              const float* tau, const int* topo_i, const float* stat_f,
                              const float* lane_f, int fixed_iters, float growth_reject,
                              float tol_reject, float dx_clamp, int guarded, int guard_last,
                              int chord_mode, float* x_out, float* hinv_out) {
  // the solve-mode flags of test_torch_lane_body's loop (unguarded chord here)
  (void)guarded, (void)guard_last, (void)chord_mode;
  const chord::ChordConfig cfg{fixed_iters, growth_reject, tol_reject, dx_clamp};
  LANE(6, 12, 8)
  LANE(4, 12, 8)
  LANE(1, 6, 8)
  LANE(2, 6, 8)
  LANE(3, 6, 8)
  return -1;
}
"""

CASES = {
    "uni6": lambda: qdep_chain_jax("universal", 6),
    "sph4": lambda: qdep_chain_jax("spherical", 4),
    "scene7": jscenes.scene_07_spherical,
    "scene8": jscenes.scene_08_universal,
    "scene9": jscenes.scene_09_free3d,
    "mixed": lambda: qdep_mixed(jscene, JJT),
}


@pytest.fixture(scope="module")
def qdep_lib(tmp_path_factory):
    import ctypes

    lib = _gxx_build(tmp_path_factory, "qdep_lane_body", LOOP)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.chord_bdf2_cpu.argtypes = [i, i, i, i] + [p] * 9 + [i, f, f, f, i, i, i, p, p]
    lib.chord_bdf2_cpu.restype = i
    return lib


def qdep_states(sc, B=24):
    """lane_body's states (the last lane rejected) with every exp-map rotation
    set from rotation_samples, about the scene's own configuration: lanes in
    the Taylor branch, just above it and near 1.5 pi. Returns (states, tau,
    the rotation norms of the predictor)."""
    states, tau = _states(sc.topo.nr, B)
    x0, q0, qd0, q1, qd1 = (a.copy() for a in states)
    base = np.asarray(sc.state0.q, np.float32)
    x0, q0, q1 = x0 + base, q0 + base, q1 + base
    norms = []
    for j, jt in enumerate(sc.topo.jtype):
        if JJT(jt) not in (JJT.SPHERICAL, JJT.FREE3D):
            continue
        o = sc.topo.qstart[j] + (3 if JJT(jt) == JJT.FREE3D else 0)
        w = rotation_samples(B, 10 + j).astype(np.float32)
        dw = (q1[:, o:o + 3] - q0[:, o:o + 3], x0[:, o:o + 3] - q1[:, o:o + 3])
        q1[:, o:o + 3] = w
        q0[:, o:o + 3] = w - dw[0]
        x0[:, o:o + 3] = w + dw[1]
        norms.append(np.linalg.norm(x0[:, o:o + 3], axis=1))
    return (x0, q0, qd0, q1, qd1), tau, np.concatenate(norms) if norms else np.zeros(0)


@pytest.mark.parametrize("case", list(CASES))
def test_lane_body_qdep_matches_kernel_body(qdep_lib, case):
    sc = CASES[case]().compile(dtype=jnp.float32)
    states, tau, norms = qdep_states(sc)
    if case in ("sph4", "scene7", "scene9", "mixed"):  # every branch of so3_exp_S is run
        s = norms ** 2
        assert (s < 0.04).sum() >= 3 and ((s > 0.04) & (s < 0.05)).sum() >= 1
        assert (np.abs(norms - 1.5 * np.pi) < 0.1).sum() >= 2
    jcfg = jint.NewtonConfig(**CFG_KW)
    x_np, hinv_np = pallas_step.chord_bdf2_dense(
        sc.topo, jcfg, {**sc.params, "tau": jnp.asarray(tau)}, *states, xp=np)
    topo, params, _ = _port(sc)
    x, hinv = _run_lane_lib(qdep_lib, topo, params, tau, states, (), chord_kernel.QDEP)
    x_ref, hinv_ref = chord_kernel.chord_bdf2(topo, tint.NewtonConfig(**CFG_KW),
                                              {**params, "tau": torch.tensor(tau)},
                                              *(torch.tensor(a) for a in states))
    finite = np.isfinite(x_np).all(-1)
    assert not finite[-1] and finite[:-1].mean() >= 0.75, finite
    scale = float(np.abs(hinv_np[finite]).max())
    # Scene 7's H (two 10-long links at h = 2e-3) has cond up to 4.2e4 at these
    # states: any two float32 orders of H^-1 are 1e-4 of scale apart (the
    # oracle 9.3e-5 and the plain version 1.5e-4 from float64), so there the
    # plain version's H^-1 is held at 2e-4.
    for name, xa, ha, htol in (("lane body", x, hinv, 2e-5),
                               ("plain version", x_ref.numpy(), hinv_ref.numpy(),
                                2e-4 if case == "scene7" else 2e-5)):
        np.testing.assert_array_equal(np.isfinite(xa).all(-1), finite, err_msg=name)
        np.testing.assert_allclose(xa[finite], x_np[finite], rtol=0, atol=5e-6, err_msg=name)
        np.testing.assert_allclose(ha[finite], hinv_np[finite], rtol=0, atol=htol * scale,
                                   err_msg=name)


def test_kernel_route_backward_qdep_matches_jax():
    """The kernel route's inner step on the mixed chain, differentiated by
    autograd (rotations below 1.5 pi: the reparam is the identity), against
    JAX's cotangents of tau, q0, qd0, q1, qd1 (tests/test_torch_chord.py)."""
    sc = qdep_mixed(jscene, JJT).compile(dtype=jnp.float32)
    topo = convert.topology_from_fields(**dataclasses.asdict(sc.topo))
    params = convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, sc.params), "cpu",
                                       torch.float32)
    Bn, nr = 4, sc.topo.nr
    rng = np.random.default_rng(13)
    q1 = (0.6 * rng.normal(size=(Bn, nr))).astype(np.float32)
    qd1 = rng.normal(size=(Bn, nr)).astype(np.float32)
    q0 = q1 - np.float32(0.01) * qd1
    qd0 = qd1 + (0.05 * rng.normal(size=(Bn, nr))).astype(np.float32)
    tau = (0.1 * rng.normal(size=(Bn, nr))).astype(np.float32)
    xbar = rng.normal(size=(Bn, nr)).astype(np.float32)
    jcfg = jint.NewtonConfig(**CFG_KW)
    h = float(np.asarray(sc.params["h"]))
    guess = q1 + h * qd1 + 0.5 * h * (qd1 - qd0)
    xstar, hinv = pallas_step.chord_bdf2_dense(
        sc.topo, jcfg, {**sc.params, "tau": jnp.asarray(tau)}, guess, q0, qd0, q1, qd1, xp=np)
    assert np.isfinite(xstar).all()
    z = jnp.einsum("bsr,bs->br", jnp.asarray(hinv), jnp.asarray(xbar))

    def cots(z, *leaves):
        def res_b(tau_b, a, b, c, d):
            def one(ti, a, b, c, d, xi):
                return jint.residual_bdf2(sc.topo, (), {**sc.params, "tau": ti}, xi, a, b, c, d, {})
            return jax.vmap(one)(tau_b, a, b, c, d, jnp.asarray(xstar))
        return jax.vjp(res_b, *leaves)[1](-z)

    cots_ref = jax.jit(cots)(z, *(jnp.asarray(a) for a in (tau, q0, qd0, q1, qd1)))
    step = tint.make_bdf2_step_batched(topo, (), tint.NewtonConfig(**CFG_KW), differentiable=True,
                                       use_kernel=True)
    leaves = [torch.tensor(a, requires_grad=True) for a in (tau, q0, qd0, q1, qd1)]
    s = tint.Bdf2State(q=leaves[3], qdot=leaves[4], q_prev=leaves[1], qdot_prev=leaves[2], k=1)
    out = step.inner({**params, "tau": leaves[0]}, s)
    np.testing.assert_allclose(out.q.detach().numpy(), xstar, rtol=0, atol=5e-6)
    grads = torch.autograd.grad(out.q, leaves, grad_outputs=torch.tensor(xbar))
    for name, g, r in zip(["tau", "q0", "qd0", "q1", "qd1"], grads, cots_ref):
        r = np.asarray(r, np.float64)
        np.testing.assert_allclose(g.numpy().astype(np.float64), r, rtol=0,
                                   atol=5e-4 * max(np.abs(r).max(), 1e-9), err_msg=name)
