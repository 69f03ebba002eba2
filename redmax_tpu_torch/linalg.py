"""Batched small-matrix linear algebra for the Newton and adjoint solves.

The implicit integrators factor [B, nr, nr] Newton matrices with nr ~ 12-32.
An unrolled, unpivoted Gauss-Jordan inverse materializes H^-1 once; every
chord iteration and the adjoint's transposed backward solve are then single
batched matvecs. Unpivoted GJ is safe here because the Newton matrices are
mass-dominated (M + O(h) terms, M SPD).

Only method "gj" is ported; "lu" and "gj_pivot" are ROADMAP items.
"""

import torch


def gj_inverse(A):
    """Inverse of a batch of small square matrices by unrolled Gauss-Jordan
    without pivoting. A: [..., n, n]. Returns [..., n, n]."""
    n = A.shape[-1]
    I = torch.eye(n, dtype=A.dtype, device=A.device).expand(A.shape)
    M = torch.cat([A, I], dim=-1)                 # [..., n, 2n]
    for k in range(n):
        rowk = M[..., k, :] / M[..., k, k:k + 1]
        notk = torch.ones(n, dtype=A.dtype, device=A.device)
        notk[k] = 0.0
        fac = M[..., :, k] * notk
        M = M - fac[..., :, None] * rowk[..., None, :]
        M = torch.cat([M[..., :k, :], rowk[..., None, :], M[..., k + 1:, :]], dim=-2)
    return M[..., :, n:]


def make_solver(method: str = "gj"):
    """(factor, solve, solve_T) closures for the Newton/adjoint path.

    factor(H) -> F = H^-1;  solve(F, b) -> H^-1 b;  solve_T(F, b) -> H^-T b.
    """
    if method != "gj":
        raise NotImplementedError(
            f"linsolve {method!r}: only 'gj' is ported (lu / gj_pivot are ROADMAP items)"
        )

    def solve(F, b):
        return torch.einsum("...ij,...j->...i", F, b)

    def solve_T(F, b):
        return torch.einsum("...ji,...j->...i", F, b)

    return gj_inverse, solve, solve_T
