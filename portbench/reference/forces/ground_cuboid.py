"""Penalty frictional ground contact on the 8 corners of cuboid bodies
(ForceGroundCuboid.m:54-153 of sueda/redmax's matlab-diff):

  per corner at depth d = n . (x - x_ground) <= 0, with world velocity v:
    normal   -kn d n - kd (n . v) n
    friction a = v - (n . v) n; static (mu |kn d| > kt |a|): -kt a,
             else dynamic: -mu kn d a / |a|

and its closed-form stiffness and damping blocks for the structured Newton
matrix, the contact masks frozen: with A = dfW/dx, B = dfW/dv per corner
(world frame), P = R^T A R, Q = R^T B R, u = w x r + v and fb = R^T fW,

    K = Gamma^T [hat(fb) - P hat(r) - Q hat(u) | P],  D = Gamma^T [-Q hat(r) | Q],

Gamma = [hat(r)^T, I]. A corner within one step of the floor
(d <= h |n . v| + h^2 |g|) counts as in contact in the blocks only.
"""

import torch

from portbench.reference import se3

A2_MIN = 1e-24    # floor of the squared tangential speed under the sqrt
SIGNS = ((-1, -1, -1), (-1, -1, 1), (-1, 1, -1), (-1, 1, 1),
         (1, -1, -1), (1, -1, 1), (1, 1, -1), (1, 1, 1))


class GroundCuboids:
    """All ground contacts of a scene: bodies [C] (list), E [C, 4, 4] the
    ground frames (z-up), sides [C, 3], kn, kt, kd, mu [C]."""

    def __init__(self, bodies, E, sides, kn, kt, kd, mu):
        self.bodies = list(bodies)
        self.E, self.sides, self.kn, self.kt, self.kd, self.mu = E, sides, kn, kt, kd, mu
        self.index = torch.tensor(self.bodies, device=E.device)
        self.r = 0.5 * sides[:, None, :] * torch.tensor(SIGNS, dtype=E.dtype, device=E.device)

    def chord_spec(self):
        return {"contacts": len(self.bodies)}

    def _corners(self, E_wi, phi):
        Eb, pb = E_wi[:, self.index], phi[:, self.index]           # [B, C, ...]
        dt = phi.dtype
        R, p = Eb[..., :3, :3], Eb[..., :3, 3]
        r = self.r                                                     # [C, 8, 3] corners
        xc = torch.einsum("bcij,ckj->bcki", R, r) + p[:, :, None]
        n = self.E[:, None, :3, 2]                                     # [C, 1, 3]
        d = ((xc - self.E[:, None, :3, 3]) * n).sum(-1)                # [B, C, 8]
        u = torch.linalg.cross(pb[:, :, None, :3].expand_as(xc), r.expand_as(xc)) \
            + pb[:, :, None, 3:]
        vw = torch.einsum("bcij,bckj->bcki", R, u)
        vn = (vw * n).sum(-1)
        a = vw - vn[..., None] * n
        a2 = (a * a).sum(-1)
        anorm = torch.sqrt(torch.clamp(a2, min=A2_MIN))
        kn, kt, kd, mu = (x[:, None] for x in (self.kn, self.kt, self.kd, self.mu))
        act = (d <= 0).to(dt)
        stick = (mu * torch.abs(kn * d) > kt * anorm).to(dt)
        fric = (mu > 0).to(dt)
        dyn, sta = fric * (1 - stick) * act, fric * stick * act
        fW = (act * (-kn * d - kd * vn))[..., None] * n \
            + (sta * -kt)[..., None] * a + (dyn * -mu * kn * d / anorm)[..., None] * a
        fb = torch.einsum("bcji,bckj->bcki", R, fW)
        return dict(R=R, r=r.expand_as(xc), u=u, d=d, vn=vn, a=a, anorm=anorm, n=n, fb=fb,
                    act=act, flow=(a2 >= A2_MIN).to(dt), dyn=dyn, sta=sta,
                    kn=kn, kt=kt, kd=kd, mu=mu)

    def _scatter(self, x, shape):
        out = torch.zeros(shape, dtype=x.dtype, device=x.device)
        return out.index_add(1, self.index, x)

    def wrenches(self, E_wi, phi):
        """[B, N, 6]: each contact body's summed corner wrench."""
        s = self._corners(E_wi, phi)
        w = torch.cat([torch.linalg.cross(s["r"], s["fb"]).sum(-2), s["fb"].sum(-2)], -1)
        return self._scatter(w, phi.shape)

    def blocks(self, E_wi, phi, h, gmag):
        """(K, D) [B, N, 6, 6] at the contact bodies."""
        s = self._corners(E_wi, phi)
        dt, dev = phi.dtype, phi.device
        n, a, R, r, u = s["n"], s["a"], s["R"], s["r"], s["u"]
        kn, kt, kd, mu = s["kn"], s["kt"], s["kd"], s["mu"]
        act = s["act"] + (1 - s["act"]) * (s["d"] - h * torch.abs(s["vn"]) - h * h * gmag <= 0).to(dt)
        nn = n[..., :, None] * n[..., None, :]
        T = torch.eye(3, dtype=dt, device=dev) - nn
        ahat = a / s["anorm"][..., None]
        cdyn = s["dyn"] * (-mu * kn) * s["d"] / s["anorm"]
        c = lambda x: x[..., None, None]
        A3 = c(act * -kn) * nn + c(s["dyn"] * -mu * kn) * (ahat[..., :, None] * n[..., None, :])
        B3 = c(act * -kd) * nn + c(s["sta"] * -kt + cdyn) * T \
            - c(cdyn * s["flow"]) * (ahat[..., :, None] * ahat[..., None, :])
        Rc = R[:, :, None]
        P = Rc.transpose(-1, -2) @ A3 @ Rc
        Q = Rc.transpose(-1, -2) @ B3 @ Rc
        hr = se3.hat(r)
        ML = se3.hat(s["fb"]) - P @ hr - Q @ se3.hat(u)
        DL = -(Q @ hr)
        K = torch.cat([torch.cat([hr @ ML, hr @ P], -1), torch.cat([ML, P], -1)], -2).sum(2)
        D = torch.cat([torch.cat([hr @ DL, hr @ Q], -1), torch.cat([DL, Q], -1)], -2).sum(2)
        B, N = phi.shape[:2]
        return self._scatter(K, (B, N, 6, 6)), self._scatter(D, (B, N, 6, 6))
