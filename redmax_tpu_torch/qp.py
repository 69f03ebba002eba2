"""Batched dense QP / KKT solves: the fixed-iteration replacement for the
reference's quadprog calls.

  * ``kkt_solve``: equality-constrained quadratic minimization via one
    dense symmetric-indefinite solve of [[H, G^T], [G, 0]].
  * ``qp_pgs`` / ``qp_pgs_batched``: projected Gauss-Seidel on the DUAL of
        min 1/2 x^T H x - f^T x   s.t.  rows A x (<=|=) b
    with per-row projection: equality rows free, inequality rows
    lambda >= 0, boxed rows clipped to [lo, hi] (friction).

Inactive (masked) rows are encoded with a zero row and zero rhs and
lo = hi = 0, so they solve to lambda = 0 and do not perturb the others.
The fused CUDA kernel of the same solve is qp_kernel.dual_pgs; the sweeps
alone, in float32 and float64, are pgs_kernel.pgs_sweeps (K3).
"""

import torch


def kkt_solve(H, G, f, e, reg: float = 0.0):
    """Solve min 1/2 x^T H x - f^T x s.t. G x = e over leading batch dims.
    H [...,n,n], G [...,m,n], f [...,n], e [...,m]. Returns (x, lam)."""
    n, m = H.shape[-1], G.shape[-2]
    Z = (-reg * torch.eye(m, dtype=H.dtype, device=H.device)).expand(*H.shape[:-2], m, m)
    Gt = G.transpose(-1, -2)
    KKT = torch.cat([torch.cat([H, Gt], dim=-1), torch.cat([G, Z], dim=-1)], dim=-2)
    sol = torch.linalg.solve(KKT, torch.cat([f, e], dim=-1))
    return sol[..., :n], sol[..., n:]


def pgs_sweeps(D, r, lo, hi, iters: int, reg: float, active=None, graph: bool = False):
    """`iters` Gauss-Seidel sweeps on D lam = r with per-row clipping.
    D [B,m,m], r, lo, hi [B,m]. Rows update in order and every update reads
    the freshest lam. Near-zero diagonals (|D_ii| < reg, masked rows) divide
    by 1. A NaN stays NaN through the clip. active [B] bool: only those
    lanes are swept, the others come out 0 (None: every lane). Returns
    lam [B,m]. The plain version of the K3 kernel (pgs_kernel.pgs_sweeps).
    graph (CUDA tensors): capture one sweep's operations in a CUDA graph and
    replay it iters times, the same kernels on the same buffers without
    their host launches (lam bit for bit as without)."""
    if active is not None:
        lam = torch.zeros_like(r)
        idx = active.nonzero()[:, 0]
        if idx.numel():
            lam[idx] = pgs_sweeps(D[idx], r[idx], lo[idx], hi[idx], iters, reg, graph=graph)
        return lam
    m = r.shape[-1]
    diag = torch.diagonal(D, dim1=-2, dim2=-1)
    safe = torch.where(diag.abs() < reg, torch.ones_like(diag), diag)
    lam = torch.zeros_like(r)

    def sweep():
        for i in range(m):
            resid = r[:, i] - (D[:, i, :] * lam).sum(-1) + diag[:, i] * lam[:, i]
            lam[:, i] = torch.minimum(torch.maximum(resid / safe[:, i], lo[:, i]), hi[:, i])

    if graph and D.is_cuda and iters > 0:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):     # recorded, not run: lam stays 0
            sweep()
        for _ in range(iters):
            g.replay()
        return lam
    for _ in range(iters):
        sweep()
    return lam


def qp_pgs_batched(H, f, A, b, lo, hi, iters: int = 40, reg: float = 1e-10):
    """Dual projected Gauss-Seidel, lanes = scenes: every argument carries a
    leading batch dim (H [B,n,n], f [B,n], A [B,m,n], b, lo, hi [B,m]).

    A stacks all constraint rows (equalities first by convention); the row
    type is its projection box:
      equality row:         lo = -inf, hi = +inf
      inequality A x <= b:  lo = 0,    hi = +inf   (lambda >= 0)
      boxed friction row:   lo = -mu a, hi = mu a
      masked row:           a zero row with b = 0 and lo = hi = 0.

    Solves the dual D lam = r with D = A H^-1 A^T, r = A H^-1 f - b by PGS
    with per-row clipping, then x = H^-1 (f - A^T lam). Gauss-Seidel is
    sequential in rows; the batch axis carries the parallelism.
    Returns (x [B,n], lam [B,m]).
    """
    Hf = torch.linalg.solve(H, f[..., None])[..., 0]             # [B,n]
    HinvAT = torch.linalg.solve(H, A.transpose(-1, -2))          # [B,n,m]
    D = A @ HinvAT                                               # [B,m,m]
    r = torch.einsum("bmn,bn->bm", A, Hf) - b
    lam = pgs_sweeps(D, r, lo, hi, iters, reg)
    x = Hf - torch.einsum("bnm,bm->bn", HinvAT, lam)
    return x, lam


def qp_pgs(H, f, A, b, lo, hi, iters: int = 40, reg: float = 1e-10):
    """One QP (H [n,n], f [n], A [m,n], b, lo, hi [m]): qp_pgs_batched on a
    single lane. Returns (x [n], lam [m])."""
    x, lam = qp_pgs_batched(*(a[None] for a in (H, f, A, b, lo, hi)), iters=iters, reg=reg)
    return x[0], lam[0]
