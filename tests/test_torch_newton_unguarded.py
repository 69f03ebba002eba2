"""Parity of redmax_tpu_torch's unguarded Newton modes and reference solver
with redmax_tpu's, in float64 on the CPU:

  * chord=False (the structured H re-built and re-factored at every iterate,
    3 iterations) against JAX's vmapped newton on chain-4 and chain-ground-3
    at tests/test_torch_newton_modes.py's states: x within 1e-10 of scale,
    the rejection masks equal;
  * the damped Newton with backtracking line search (NewtonConfig()'s
    fixed_iters=0) on the BDF2 residual against JAX's vmapped newton, with the
    structured and with the exact Newton matrix, on chain-4 and (exact) on
    chain-ground-3 (tests/test_torch_newton_modes.py's scenes), at torques of
    30 N(0, 1), where every lane converges: x within 1e-10 of scale, the
    divergence masks equal. (A lane that does not converge within iter_max
    takes a path that roundoff decides: the port's exact matrix is a
    reverse-mode Jacobian, JAX's a forward-mode one, equal to 1e-10 but not
    bit for bit.);
  * the exact Newton matrix (adjoint.batched_jacobian) against jax.jacfwd
    at 1e-10;
  * linalg.make_solver("lu" | "gj_pivot" | "gj"): solve and solve_T against
    JAX's, with a matrix whose leading pivot is zero (finite for the
    pivoting solvers, not for unpivoted GJ, in either package).

Each JAX oracle runs under one jax.jit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from redmax_tpu import integrators as jint
from redmax_tpu import linalg as jlinalg
from redmax_tpu_torch import adjoint, linalg
from redmax_tpu_torch import integrators as tint
from test_torch_newton_modes import BASE, TAU, check_mode, rand_states, scene


@pytest.fixture(scope="module", autouse=True)
def single_thread():
    """torch's intra-op threads set to 1 for the module, then restored."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


LOW_TAU = (30.0,)


@pytest.mark.parametrize("name", ["chain4", "ground3"])
def test_rehess_matches_jax(name):
    info = check_mode(name, dict(BASE, chord=False), TAU)
    assert "steps" not in info and info["factor"].shape[-2:] == (scene(name)[1].nr,) * 2


@pytest.mark.parametrize("name,hessian", [("chain4", "structured"), ("chain4", "exact"),
                                          ("ground3", "exact")])
def test_line_search_matches_jax(name, hessian):
    info = check_mode(name, dict(hessian=hessian), LOW_TAU)
    iters = info["iters"].numpy()   # every lane converged, in different numbers of iterations
    assert iters.min() >= 1 and iters.max() > iters.min(), iters
    assert not info["diverged"].any()


@pytest.mark.parametrize("name", ["chain4", "ground3"])
def test_exact_newton_matrix_matches_jacfwd(name):
    sc, topo, params, fns = scene(name)
    states, tau = rand_states(topo.nr, 8)

    def one(x, q0, qd0, q1, qd1, t):
        res = lambda xx: jint.residual_bdf2(sc.topo, sc.force_fns, {**sc.params, "tau": t}, xx,
                                            q0, qd0, q1, qd1, {})
        return jax.jacfwd(res)(x)

    H_ref = np.asarray(jax.jit(jax.vmap(one))(*(jnp.asarray(a) for a in (*states, tau))))
    T = [torch.tensor(a) for a in states]
    p = {**params, "tau": torch.tensor(tau)}
    H = adjoint.batched_jacobian(lambda x: tint.residual_bdf2(topo, fns, p, x, *T[1:]), T[0])
    assert not H.requires_grad
    scale = float(np.abs(H_ref).max())
    np.testing.assert_allclose(H.numpy(), H_ref, rtol=0, atol=1e-10 * scale)


@pytest.mark.parametrize("method", ["lu", "gj_pivot", "gj"])
def test_solvers_match_jax(method):
    rng = np.random.default_rng(4)
    n, B = 5, 6
    A = rng.normal(size=(B, n, n)) + 3 * np.eye(n)
    A[0, 0, 0] = 0.0            # a zero leading pivot: only a pivoting solver takes it
    b = rng.normal(size=(B, n))
    jf, js, jsT = jlinalg.make_solver(method)
    ref = jax.jit(lambda A, b: (js(jf(A), b), jsT(jf(A), b)))(jnp.asarray(A), jnp.asarray(b))
    f, s, sT = linalg.make_solver(method)
    F = f(torch.tensor(A))
    out = (s(F, torch.tensor(b)), sT(F, torch.tensor(b)))
    exact = (np.linalg.solve(A, b[..., None])[..., 0],
             np.linalg.solve(np.swapaxes(A, -1, -2), b[..., None])[..., 0])
    lanes = slice(None) if method != "gj" else slice(1, None)
    for o, r, e in zip(out, ref, exact):
        o, r = o.numpy(), np.asarray(r)
        np.testing.assert_allclose(o[lanes], r[lanes], rtol=0, atol=1e-12)
        np.testing.assert_allclose(o[lanes], e[lanes], rtol=0, atol=1e-12)
        if method == "gj":   # unpivoted: the zero pivot is no bound, in either package
            assert not np.isfinite(o[0]).all() and not np.isfinite(r[0]).all()
    with pytest.raises(ValueError):
        linalg.make_solver("qr")
