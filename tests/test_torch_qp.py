"""Parity of redmax_tpu_torch's QP solves with redmax_tpu on the CPU.

qp.kkt_solve, qp.qp_pgs and qp.qp_pgs_batched against redmax_tpu.qp in
float64 at 1e-10; qp_kernel.dual_pgs_reference (the plain version of the
fused dual-PGS CUDA kernel, and what qp_kernel.dual_pgs runs on a CPU
tensor) in float32 against the JAX package's numpy evaluation of the Pallas
kernel body, pallas_qp.dual_pgs_dense(xp=np): x at 2e-5 of scale, lambda at
2e-4 of scale, two float32 evaluation orders of the same sweeps. Inputs are
made from a seed with numpy and go through both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from redmax_tpu import pallas_qp
from redmax_tpu import qp as jqp
from redmax_tpu_torch import qp as tqp
from redmax_tpu_torch import metrics, qp_kernel


@pytest.fixture(scope="module", autouse=True)
def single_thread():
    """torch's intra-op threads set to 1 for the module, then restored."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def mixed_qp(seed, B, n, me, mi, mb, dtype):
    """Random well-posed QPs with equality, inequality and boxed rows
    (H = Q Q^T + 3 I), as tests/test_linalg.py makes them."""
    rng = np.random.default_rng(seed)
    m = me + mi + mb
    Q = rng.normal(size=(B, n, n)).astype(dtype)
    H = Q @ np.transpose(Q, (0, 2, 1)) + 3.0 * np.eye(n, dtype=dtype)
    f = rng.normal(size=(B, n)).astype(dtype)
    A = rng.normal(size=(B, m, n)).astype(dtype)
    b = rng.normal(size=(B, m)).astype(dtype)
    box = np.abs(rng.normal(size=(B, mb))).astype(dtype)
    inf = np.full((B, 1), np.inf, dtype)
    lo = np.concatenate([np.repeat(-inf, me, 1), np.zeros((B, mi), dtype), -box], axis=1)
    hi = np.concatenate([np.repeat(inf, me + mi, 1), box], axis=1)
    return H, f, A, b, lo, hi


def masked_qp(seed, B, n, m, dtype):
    """Inequality-only QPs where about half the rows are masked (zero row,
    b = 0, lo = hi = 0) and the last lane's H is the all-ones matrix, whose
    second Gauss-Jordan pivot is exactly 0."""
    H, f, A, b, lo, hi = mixed_qp(seed, B, n, 0, m, 0, dtype)
    act = np.random.default_rng(seed + 1).random((B, m)) < 0.5
    A = A * act[..., None]
    b = np.where(act, b, 0).astype(dtype)
    hi = np.where(act, np.inf, 0).astype(dtype)
    H[-1] = 1.0
    return H, f, A, b, lo, hi


def qp_launches():
    """(thread-per-lane, cooperative) dual-PGS launches so far."""
    c = metrics.counters()
    return c.get("qp_kernel.launch.thread", 0), c.get("qp_kernel.launch.coop", 0)


def _t(arrays):
    return [torch.tensor(a) for a in arrays]


def test_qp_pgs_batched_matches_jax():
    sys = mixed_qp(5, 6, 8, 2, 3, 2, np.float64)
    x, lam = tqp.qp_pgs_batched(*_t(sys), iters=60)
    x_j, lam_j = jqp.qp_pgs_batched(*(jnp.asarray(a) for a in sys), iters=60)
    np.testing.assert_allclose(x.numpy(), np.asarray(x_j), rtol=0, atol=1e-10)
    np.testing.assert_allclose(lam.numpy(), np.asarray(lam_j), rtol=0, atol=1e-10)
    # the single-QP form is lane 0 of the batched one, and JAX's qp_pgs
    x0, lam0 = tqp.qp_pgs(*(a[0] for a in _t(sys)), iters=60)
    x0_j, lam0_j = jqp.qp_pgs(*(jnp.asarray(a[0]) for a in sys), iters=60)
    np.testing.assert_allclose(x0.numpy(), np.asarray(x0_j), rtol=0, atol=1e-10)
    np.testing.assert_allclose(lam0.numpy(), np.asarray(lam0_j), rtol=0, atol=1e-10)
    torch.testing.assert_close(x0, x[0], rtol=0, atol=1e-13)


def test_kkt_solve_matches_jax():
    H, f, A, b, _, _ = mixed_qp(7, 5, 6, 3, 0, 0, np.float64)
    x, lam = tqp.kkt_solve(*_t((H, A, f, b)))
    x_j, lam_j = jax.vmap(jqp.kkt_solve)(*(jnp.asarray(a) for a in (H, A, f, b)))
    np.testing.assert_allclose(x.numpy(), np.asarray(x_j), rtol=0, atol=1e-10)
    np.testing.assert_allclose(lam.numpy(), np.asarray(lam_j), rtol=0, atol=1e-10)
    np.testing.assert_allclose((A @ x.numpy()[..., None])[..., 0], b, rtol=0, atol=1e-10)


@pytest.mark.parametrize("case", ["mixed", "masked"])
def test_dual_pgs_reference_matches_kernel_body(case):
    """dual_pgs_reference (through the wrapper, on CPU tensors) against the
    numpy evaluation of the Pallas kernel body, NaN lanes included."""
    if case == "mixed":
        sys = mixed_qp(11, 5, 6, 1, 4, 3, np.float32)
    else:
        sys = masked_qp(13, 7, 6, 12, np.float32)
    x_np, lam_np = pallas_qp.dual_pgs_dense(*sys, iters=60)
    before = qp_launches()
    x, lam = qp_kernel.dual_pgs(*_t(sys), iters=60)
    assert qp_launches() == before  # a CPU tensor launches nothing
    x, lam = x.numpy(), lam.numpy()
    assert x.dtype == np.float32 and x.shape == x_np.shape and lam.shape == lam_np.shape

    finite = np.isfinite(x_np).all(-1)
    np.testing.assert_array_equal(np.isfinite(x).all(-1), finite)
    np.testing.assert_array_equal(np.isnan(lam), np.isnan(lam_np))
    if case == "masked":
        assert not finite[-1] and finite[:-1].all(), finite
        masked = sys[5][finite] == 0
        assert masked.any() and (lam[finite][masked] == 0).all()
    else:
        assert finite.all()
    xs = max(1.0, float(np.abs(x_np[finite]).max()))
    ls = max(1.0, float(np.abs(lam_np[finite]).max()))
    np.testing.assert_allclose(x[finite], x_np[finite], rtol=0, atol=2e-5 * xs)
    np.testing.assert_allclose(lam[finite], lam_np[finite], rtol=0, atol=2e-4 * ls)


def test_dual_pgs_reference_float64_matches_qp_pgs():
    """In float64 the plain version (GJ inverse) and qp_pgs_batched (pivoted
    solve) are the same solve to roundoff."""
    sys = _t(mixed_qp(5, 6, 8, 2, 3, 2, np.float64))
    x, lam = qp_kernel.dual_pgs_reference(*sys, iters=60)
    x_q, lam_q = tqp.qp_pgs_batched(*sys, iters=60)
    torch.testing.assert_close(x, x_q, rtol=0, atol=1e-10)
    torch.testing.assert_close(lam, lam_q, rtol=0, atol=1e-10)
