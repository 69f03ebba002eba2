"""Batched small-matrix linear algebra for the Newton and adjoint solves.

The implicit integrators factor [B, nr, nr] Newton matrices with nr ~ 12-32.
Three solvers, as in the JAX package:

  * "lu": torch.linalg.lu_factor once, lu_solve per right-hand side (the
    reference's semantics, LAPACK on the CPU);
  * "gj": an unrolled, unpivoted Gauss-Jordan inverse materializes H^-1
    once; every chord iteration and the adjoint's transposed backward solve
    are then single batched matvecs. Unpivoted GJ is safe here because the
    Newton matrices are mass-dominated (M + O(h) terms, M SPD);
  * "gj_pivot": the same with branchless partial pivoting (one-hot row
    swaps) for general matrices.
"""

import torch


def gj_inverse(A, pivot: bool = False):
    """Inverse of a batch of small square matrices by unrolled Gauss-Jordan.
    A: [..., n, n]. Returns [..., n, n]. pivot=True swaps in the row of the
    largest |entry| at or below the diagonal before each elimination."""
    n = A.shape[-1]
    I = torch.eye(n, dtype=A.dtype, device=A.device).expand(A.shape)
    M = torch.cat([A, I], dim=-1)                 # [..., n, 2n]
    rows = torch.arange(n, device=A.device)
    for k in range(n):
        if pivot:
            col = torch.where(rows >= k, M[..., :, k].abs(), -float("inf"))
            onep = torch.nn.functional.one_hot(col.argmax(-1), n).to(A.dtype)
            onek = (rows == k).to(A.dtype).expand(onep.shape)
            rk = torch.einsum("...r,...rc->...c", onep, M)  # row p
            rp = torch.einsum("...r,...rc->...c", onek, M)  # row k
            M = (M + onek[..., None] * (rk - rp)[..., None, :]
                 + onep[..., None] * (rp - rk)[..., None, :])
        rowk = M[..., k, :] / M[..., k, k:k + 1]
        notk = torch.ones(n, dtype=A.dtype, device=A.device)
        notk[k] = 0.0
        fac = M[..., :, k] * notk
        M = M - fac[..., :, None] * rowk[..., None, :]
        M = torch.cat([M[..., :k, :], rowk[..., None, :], M[..., k + 1:, :]], dim=-2)
    return M[..., :, n:]


def make_solver(method: str = "gj"):
    """(factor, solve, solve_T) closures for the Newton/adjoint path.

    factor(H) -> F;  solve(F, b) -> H^-1 b;  solve_T(F, b) -> H^-T b, with
    b [..., n]. F is H^-1 for "gj" / "gj_pivot" and the pair (LU, pivots)
    for "lu".
    """
    if method == "lu":
        def solve(F, b):
            return torch.linalg.lu_solve(*F, b[..., None])[..., 0]

        def solve_T(F, b):
            return torch.linalg.lu_solve(*F, b[..., None], adjoint=True)[..., 0]

        def factor(H):
            # no error on a singular lane: its solves give inf / NaN, as JAX's
            return tuple(torch.linalg.lu_factor_ex(H)[:2])

        return factor, solve, solve_T
    if method not in ("gj", "gj_pivot"):
        raise ValueError(f"unknown linsolve method: {method}")

    def factor(H):
        return gj_inverse(H, pivot=method == "gj_pivot")

    def solve(F, b):
        return torch.einsum("...ij,...j->...i", F, b)

    def solve_T(F, b):
        return torch.einsum("...ji,...j->...i", F, b)

    return factor, solve, solve_T
