"""Two-point springs between body points, for the reference:
ForcePointPoint.m:48-141 and ForceSpringGeneric.m:37-83 with
ForceSpringDamper.m:62-72 of sueda/redmax's matlab-diff.

A spring joins point xl1 of body b1 and point xl2 of body b2 (body -1: a
world point, xl in world coordinates). With x the points' world positions,
V their world velocities, dx = x2 - x1 and dv = V2 - V1, the world force on
point 1 is

  point-point (zero rest length):  fW = k dx + d dv
  spring-damper:  l = |dx|, ldot = dx . dv / l,
                  fs = k (l - L)/L + d ldot/L,  fW = g (fs / l) dx,

and point 2 takes -fW; g = (l > L) for a tension-only spring-damper, else 1.
A body point's wrench is Gamma(r)^T R^T F = [r x fb; fb], fb = R^T F.

The structured Newton matrix takes the closed-form derivative of each
endpoint's wrench by each endpoint's body pose (K) and twist (D), cross-body
pairs included: with A = dF_j/dx_i, Bm = dF_j/dv_i (world 3x3),
P = R_j^T A R_i, Q = R_j^T Bm R_i and u_i = w_i x r_i + v_i,

    K_ji = Gamma_j^T [s hat(fb_j) - P hat(r_i) - Q hat(u_i) | P],
    D_ji = Gamma_j^T [-Q hat(r_i) | Q],   Gamma_j^T = [hat(r_j); I],

s = 1 where j and i are one endpoint. For fW: dfW/d(dx) is k I and
dfW/d(dv) is d I (point-point); for the spring-damper, with e = dx / l,
g [(fs / l)(I - e e^T) + e (k/L e + d/L (dv - ldot e)/l)^T] and
g (d/L) e e^T, the gate held where it is. F_1 = fW, F_2 = -fW and
dx = x2 - x1, so dF_j/dx_i = s_j s'_i dfW/d(dx) with s = (1, -1),
s' = (-1, 1). Pairs with a world endpoint have no block.

Departures from the sources, as the port has them: l is sqrt(max(l^2,
1e-24)), so a spring of zero length stays finite; the matlab code's
spring-damper has no tension-only gate (the port's ForceSpringDamper
takes one); the matlab code takes these blocks by finite differences or
its own truncated forms, the port and this module in closed form.
"""

import torch

from portbench.reference import se3

L2_MIN = 1e-24    # floor of a squared spring length under the sqrt
POINT_POINT, SPRING_DAMPER = 0, 1


class PointSprings:
    """The two-point springs of a scene: each a dict with kind (POINT_POINT
    or SPRING_DAMPER), b1, b2, xl1, xl2 ([3] tensors), k, d, L (floats; L
    unused by a point-point spring) and tension (bool)."""

    def __init__(self, springs):
        self.springs = list(springs)

    def chord_spec(self):
        """The springs as (kind, b1, b2, tension): chord_kernel.closure_spec's
        tuples, which harness/flops.py counts."""
        return {"springs": tuple((s["kind"], s["b1"], s["b2"], int(s["tension"]))
                                 for s in self.springs)}

    @staticmethod
    def _point(E_wi, phi, b, xl):
        """(x, V, R, u) of the point xl of body b ([B, 3], [B, 3], [B, 3, 3],
        [B, 3]); a world point has V = 0, and no R or u."""
        if b < 0:
            x = xl.expand(phi.shape[0], 3)
            return x, torch.zeros_like(x), None, None
        R, p = E_wi[:, b, :3, :3], E_wi[:, b, :3, 3]
        u = torch.linalg.cross(phi[:, b, :3], xl.expand_as(p)) + phi[:, b, 3:]
        return (R @ xl[:, None])[..., 0] + p, (R @ u[..., None])[..., 0], R, u

    def _law(self, s, E_wi, phi):
        """The endpoints' states, fW [B, 3], and dfW/d(dx), dfW/d(dv) [B, 3, 3]."""
        ends = [self._point(E_wi, phi, s[b], s[xl]) for b, xl in (("b1", "xl1"), ("b2", "xl2"))]
        dx, dv = ends[1][0] - ends[0][0], ends[1][1] - ends[0][1]
        I3 = torch.eye(3, dtype=dx.dtype, device=dx.device).expand(dx.shape[0], 3, 3)
        k, d = s["k"], s["d"]
        if s["kind"] == POINT_POINT:
            return ends, k * dx + d * dv, k * I3, d * I3
        L = s["L"]
        l = torch.sqrt(torch.clamp((dx * dx).sum(-1), min=L2_MIN))
        e = dx / l[:, None]
        ldot = (dx * dv).sum(-1) / l
        fs = k * (l - L) / L + d * ldot / L
        g = (l > L).to(dx.dtype) if s["tension"] else torch.ones_like(l)
        fW = (g * fs / l)[:, None] * dx
        dfs = (k / L) * e + (d / L) * (dv - ldot[:, None] * e) / l[:, None]
        ee = e[:, :, None] * e[:, None, :]
        A = g[:, None, None] * ((fs / l)[:, None, None] * (I3 - ee)
                                + e[:, :, None] * dfs[:, None, :])
        Bm = (g * d / L)[:, None, None] * ee
        return ends, fW, A, Bm

    def wrenches(self, E_wi, phi):
        """[B, N, 6]: every spring's endpoint wrenches on their bodies."""
        out = torch.zeros_like(phi)
        for s in self.springs:
            ends, fW, _, _ = self._law(s, E_wi, phi)
            for (_, _, R, _), b, xl, F in ((ends[0], s["b1"], s["xl1"], fW),
                                           (ends[1], s["b2"], s["xl2"], -fW)):
                if b >= 0:
                    fb = (R.transpose(-1, -2) @ F[..., None])[..., 0]
                    out[:, b] += torch.cat([torch.linalg.cross(xl.expand_as(fb), fb), fb], -1)
        return out

    def blocks(self, E_wi, phi, h, gmag):
        """No per-body blocks: a spring's blocks couple two bodies, so the
        scene adds them through pair_blocks (scenes/scene_spring_chain.py)."""
        z = torch.zeros(*phi.shape[:2], 6, 6, dtype=phi.dtype, device=phi.device)
        return z, z

    def pair_blocks(self, E_wi, phi):
        """[(bj, bi, K, D)]: the blocks [B, 6, 6] of every endpoint pair (j,
        i) of every spring with both endpoints on bodies, the wrench of j's
        body by the pose (K) and twist (D) of i's."""
        out = []
        sign, sign_x = (1.0, -1.0), (-1.0, 1.0)
        for s in self.springs:
            ends, fW, A, Bm = self._law(s, E_wi, phi)
            bodies, xls = (s["b1"], s["b2"]), (s["xl1"], s["xl2"])
            for j in range(2):
                if bodies[j] < 0:
                    continue
                Rj, rj = ends[j][2], xls[j]
                fbj = (Rj.transpose(-1, -2) @ (sign[j] * fW)[..., None])[..., 0]
                for i in range(2):
                    if bodies[i] < 0:
                        continue
                    Ri, ri, ui = ends[i][2], xls[i], ends[i][3]
                    c = sign[j] * sign_x[i]
                    P = Rj.transpose(-1, -2) @ (c * A) @ Ri
                    Q = Rj.transpose(-1, -2) @ (c * Bm) @ Ri
                    hri = se3.hat(ri)
                    ML = float(i == j) * se3.hat(fbj) - P @ hri - Q @ se3.hat(ui)
                    DL = -(Q @ hri)
                    hrj = se3.hat(rj)
                    K = torch.cat([torch.cat([hrj @ ML, hrj @ P], -1), torch.cat([ML, P], -1)], -2)
                    D = torch.cat([torch.cat([hrj @ DL, hrj @ Q], -1), torch.cat([DL, Q], -1)], -2)
                    out.append((bodies[j], bodies[i], K, D))
        return out
