"""The K3 kernel's lane body (csrc/pgs_sweeps_lane.cuh), built by g++ for
CPU tensors (pgs_kernel.pgs_sweeps), against its plain version
qp.pgs_sweeps: within 1e-12 of scale in float64 and 1e-5 in float32, at
m = 1, 7, 24 and 80 (the friction zoo's QP and friction-pass widths), with
+-inf boxes, zero-width boxes, the reg guard on the diagonal, a NaN lane
and a lane that is not active; without g++ the CPU route raises and does not
fall back. Inputs from a numpy seed."""

import numpy as np
import pytest
import torch

from redmax_tpu_torch import kernel_build, pgs_kernel, qp


@pytest.fixture(scope="module", autouse=True)
def single_thread():
    """torch's intra-op threads set to 1 for the module, then restored."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def duals(m, B=5, seed=0, dtype=torch.float64):
    """B lanes of (D, r, lo, hi): D symmetric positive semidefinite of rank
    about m/2 plus a small ridge (a friction pass's Hf is semidefinite), r
    and boxes from the seed; lane 0 with +-inf boxes on every row, lane 1
    with zero-width boxes on every other row, lane 2 with a row whose
    diagonal is below reg (a masked row: a zero row and column)."""
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
    return t(D), t(r), t(lo), t(hi)


def check(lam, ref, tol):
    scale = max(1.0, float(ref[torch.isfinite(ref)].abs().max()))
    np.testing.assert_array_equal(torch.isnan(lam).numpy(), torch.isnan(ref).numpy())
    ok = torch.isfinite(ref)
    assert float((lam[ok] - ref[ok]).abs().max()) <= tol * scale


@pytest.mark.parametrize("dtype, tol", [(torch.float64, 1e-12), (torch.float32, 1e-5)])
@pytest.mark.parametrize("m", [1, 7, 24, 80])
def test_host_body_matches_plain(m, dtype, tol):
    D, r, lo, hi = duals(m, dtype=dtype)
    before = pgs_kernel.pgs_sweeps_host_runs
    lam = pgs_kernel.pgs_sweeps(D, r, lo, hi, 200, 1e-12)
    assert pgs_kernel.pgs_sweeps_host_runs == before + 1
    assert lam.dtype == dtype and lam.shape == r.shape
    check(lam, qp.pgs_sweeps(D, r, lo, hi, 200, 1e-12), tol)
    # the boxes hold: zero-width rows sit at 0, the others inside [lo, hi]
    assert (lam[1, ::2] == 0).all()
    assert ((lam >= lo) & (lam <= hi)).all()


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_reg_guard_nan_lane_and_inactive_lane(dtype):
    """Lane 2's zero diagonal divides by 1 (its row stays at the clip of r);
    a reg above every diagonal divides every row by 1; lane 3 NaN in one
    entry of r comes out NaN in both; lane 4 not active comes out 0 in both
    and the others as when every lane is active."""
    D, r, lo, hi = duals(24, dtype=dtype)
    r[3, 5] = float("nan")
    active = torch.tensor([True, True, True, True, False])
    lam = pgs_kernel.pgs_sweeps(D, r, lo, hi, 100, 1e-12, active)
    ref = qp.pgs_sweeps(D, r, lo, hi, 100, 1e-12, active)
    check(lam, ref, 1e-12 if dtype == torch.float64 else 1e-5)
    assert torch.isnan(lam[3]).all() and torch.isnan(ref[3]).all()
    assert (lam[4] == 0).all() and (ref[4] == 0).all()
    assert float(lam[2, 0]) == float(torch.clamp(r[2, 0], lo[2, 0], hi[2, 0]))
    full = pgs_kernel.pgs_sweeps(D, r, lo, hi, 100, 1e-12)
    np.testing.assert_array_equal(full[:4].numpy(), lam[:4].numpy())
    big = pgs_kernel.pgs_sweeps(D, r, lo, hi, 100, 1e3)
    check(big, qp.pgs_sweeps(D, r, lo, hi, 100, 1e3), 1e-12 if dtype == torch.float64 else 1e-5)


def test_bounds_nan_and_inf_kept():
    """A NaN bound gives NaN as torch.maximum / minimum do; an infinite r
    clips to a finite bound."""
    D, r, lo, hi = duals(7)
    lo[0, 2] = float("nan")
    r[4, 1] = float("inf")
    lam = pgs_kernel.pgs_sweeps(D, r, lo, hi, 10, 1e-12)
    ref = qp.pgs_sweeps(D, r, lo, hi, 10, 1e-12)
    check(lam, ref, 1e-12)
    assert torch.isnan(lam[0]).all()
    assert torch.isfinite(lam[4]).all()


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
