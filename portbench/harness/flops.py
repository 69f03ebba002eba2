"""The operation count and bytes of the chord solve, and the card's
published peaks: the yardstick of the chord kernel's roofline share and of
the call's share of the peak.

lane_flops is frozen here as the port had it when the benchmark was
defined (chip_smoke.py's count of csrc/chord_bdf2_lane.cuh's loops). It is
a function of the topology, the Newton mode and the closures only, so it
reads the same work whatever implements the chord solve.
"""

from dataclasses import dataclass
from typing import Tuple

import numpy as np

# NVIDIA H100 SXM data sheet, dense, at the 700 W limit
PEAK_F32_FLOPS = 67e12          # float32 outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12      # HBM3


@dataclass(frozen=True)
class Topo:
    """The topology fields lane_flops reads."""

    parent: Tuple[int, ...]
    jtype: Tuple[int, ...]
    ndof: Tuple[int, ...]

    @property
    def njoints(self):
        return len(self.parent)

    @property
    def nr(self):
        return sum(self.ndof)

    def ancestor_mask(self):
        n = self.njoints
        anc = np.zeros((n, n))
        for i in range(n):
            a = i
            while a >= 0:
                anc[i, a] = 1.0
                a = self.parent[a]
        return anc

    def dof_joint(self):
        return np.repeat(np.arange(self.njoints), self.ndof)


def chord_bytes(nr: int, B: int) -> int:
    """Bytes a chord solve of B lanes must move at the least: per lane the
    five state inputs and the torques read ([nr] each, float32), x [nr] and
    H^-1 [nr, nr] written."""
    return 4 * B * (6 * nr + nr + nr * nr)


def chord_bound_s(flops_per_lane: int, nr: int, B: int) -> float:
    """The least time of one chord solve of B lanes on the card."""
    return max(flops_per_lane * B / PEAK_F32_FLOPS, chord_bytes(nr, B) / PEAK_BYTES_PER_S)


# so3_exp_S per lane, on its closed-form branch (s >= 0.04; the Taylor
# branch is cheaper): |w|^2 5, sqrt, sin, cos 3, c1, a, b, a', b' 21, sd 6,
# W^2 12, Wd W and W Wd 108, R 36, S 36, Sd 99.
SO3_EXP_S = 326


def qdep_joint_flops(jt: int) -> int:
    """qdep_joint of csrc/chord_bdf2_lane.cuh for one joint of type jt (5
    UNIVERSAL, 6 SPHERICAL, 8 FREE3D): A0 = Ad(inv(E0_ji)) 45, then each
    column and its derivative through A0 (put_column, 2 x 66)."""
    put = 2 * 66
    if jt == 5:   # sin, cos 4, R 6, Sdot column 3
        return 45 + 4 + 6 + 3 + 2 * put
    if jt == 6:
        return 45 + SO3_EXP_S + 3 * put
    # FREE3D: the rotation's columns, omega_b = Jr rdot 15, per translation
    # column -(omega_b x R^T e_d) 12
    return 45 + SO3_EXP_S + 3 * put + 15 + 3 * (12 + put)


def mode_of(newton: dict) -> str:
    """The solve mode of a configuration file's fixed-iteration Newton
    settings: chord, rehess (H re-built at every iterate), guarded,
    guarded_rehess or guard_last."""
    chord = newton.get("chord", False)
    if newton.get("guarded", False):
        return "guarded" if chord else "guarded_rehess"
    if newton.get("guard_last", False):
        return "guard_last"
    return "chord" if chord else "rehess"


def lane_flops(topo, fixed_iters: int, ncontacts: int = 0, springs=(), cables=(),
               mode: str = "chord") -> int:
    """Floating-point operations of one lane of csrc/chord_bdf2_lane.cuh,
    counted from its loops (add, sub, mul, div, sqrt, sin, cos: one each;
    compares and selects none), with ncontacts ground contacts, springs as
    (kind, b1, b2, tension) and cables as body tuples (chord_kernel's
    closure_spec), in the solve mode (mode_of). A scene with a q-dependent
    joint runs the QDEP build: its joints' columns per iterate
    (qdep_joint_flops) instead of once, and the Sbd term of every Wdot
    column. Per solve, with it = fixed_iters: chord evaluates it residuals
    (it - 1 FKs past the predictor's); guarded 1 + 2 it residuals, each with
    its FK, and a half step per iteration; guard_last it + 2 residuals and
    it + 1 FKs; chord=False rebuilds H (hessian, closure blocks, GJ) at it - 1
    iterates, with a qdot and (guarded) an FK each."""
    N, NR = topo.njoints, topo.nr
    anc = topo.ancestor_mask()[:, topo.dof_joint()]   # [N, NR] ancestor pairs
    P = int(anc.sum())
    P2 = int((anc.sum(1) ** 2).sum())                 # (r, s) pairs per body
    cols = anc.sum(1)                                 # columns of each body
    frame_mul, frame_inv, adjoint, mat6 = 63, 18, 27, 66
    qdep = [t in (5, 6, 8) for t in topo.jtype]
    q_local = sum(qdep_joint_flops(t) if q else (36 if t == 1 else (3 * (2 * d - 1) if d else 0))
                  for t, d, q in zip(topo.jtype, topo.ndof, qdep))
    fk = (q_local + sum(frame_mul * (2 if p < 0 else 3) for p in topo.parent)
          + NR * (adjoint + mat6)                      # W
          + N * (frame_inv + adjoint) + P * mat6 + P * 12   # J, phi
          + NR * (adjoint + 30 + mat6 + (6 if any(qdep) else 0))  # Wdot (+ Sbd)
          + N * (frame_inv + adjoint) + P * (mat6 + 30 + 6))  # Jdot
    qdot = 6 * NR
    residual = 2 + 27 * NR + N * 99 + P * 36 + 2 * NR
    hessian = 3 + N * 90 + P * 2 * mat6 + P2 * 71 + 11 * NR
    gj = NR + 2 * NR * NR + 4 * NR * NR * (NR - 1)
    static = sum((frame_inv + adjoint + d * mat6) for d, q in zip(topo.ndof, qdep) if not q)
    res_eval = qdot + residual + (2 * NR + 1)          # qdot, g, |g|
    solve = 2 * NR * NR + NR                           # dx = H^-1 g, x - dx
    # ground_contact: R^T n once, then per corner the force (158) and, in the
    # Hessian, the K/D row blocks and their Gamma^T contraction (418 more)
    contact_force, contact_blocks = 15 + 8 * 158, 15 + 8 * (158 + 418)
    # springs and cables: a body point's state 45, its wrench 33 (F, R^T F,
    # r x fb, the sums); pair_block 426 (+12 with hat(fb)); add_pair 66 per
    # column of body c and 12 per (r, s) column pair of bodies b and c
    point, wrench, block = 45, 33, 426

    def add_pair(b, c):
        return int(cols[c]) * 66 + int(cols[b] * cols[c]) * 12

    pairs_once = 6 * N if (springs or cables) else 0   # fm += fcl in the residual
    pair_res = pair_hes = 0
    for kind, b1, b2, _ in springs:
        ends = [b for b in (b1, b2) if b >= 0]
        force = 6 + (37 if kind else 9)              # dx, dv and the law
        blocks_law = 6 + (160 if kind else 9)        # with A = dfW/ddx, Bm = dfW/ddv
        pair_res += len(ends) * (point + wrench) + force
        pair_hes += len(ends) * (point + 18) + blocks_law + sum(
            block + 1 + 12 * (e == f) + add_pair(ends[e], ends[f])
            for e in range(len(ends)) for f in range(len(ends)))
    for bodies in cables:
        Pn, on = len(bodies), [b for b in bodies if b >= 0]
        shared = len(on) * point + 23 * (Pn - 1) + 7 + 3 * Pn   # segments, tension, c_j
        pair_res += shared + len(on) * wrench
        pair_hes += shared + 14 * (Pn - 1) + 36 * Pn + len(on) * 18 + sum(
            8 + 144 + block + 12 * (j == i) + add_pair(bj, bi)
            for j, bj in enumerate(on) for i, bi in enumerate(on))
    it = fixed_iters
    rebuilds = it - 1 if mode in ("rehess", "guarded_rehess") else 0
    n_res, n_fk, n_half = {"chord": (it, it - 1, 0), "rehess": (it, it - 1, 0),
                           "guarded": (1 + 2 * it, 2 * it, it),
                           "guarded_rehess": (1 + 2 * it, 2 * it + rebuilds, it),
                           "guard_last": (it + 2, it + 1, 1)}[mode]
    build = hessian + gj + ncontacts * contact_blocks + pair_hes
    return (static + qdot + fk + (1 + rebuilds) * build + rebuilds * qdot
            + n_res * (res_eval + ncontacts * contact_force + pair_res)
            + it * solve + n_half * 2 * NR + n_fk * fk + pairs_once)
