"""Force closures, batch-first: penalty ground contact.

A force is a closure with the JAX package's protocol,

    fn(params, kin, J, phi, q, qdot) -> (fr_add [B, nr], fm_add [B, N, 6]),

registered on the compiled scene, with its parameters in
params["forces"][fn.key] and an .energy(params, kin, q, qdot) -> [B] for the
energy certificates. Ported here: ForceGroundCuboid and the closed-form K/D
blocks of its wrench (ground_contact_blocks), which the structured Newton
matrix uses in place of autodiff. The other closures of the JAX package's
forces.py raise (ROADMAP queue 1 item 10).

A scene holds one closure per contacting body. ground_contact_wrenches,
ground_contact_energy and stack_contact_params evaluate all of them in one
pass over [B, C, 8, 3] corner tensors: model calls these, not the closures one
by one, so a step costs the same few dozen launches whatever C is.

Body points: a point r (body frame) on body b has world position
x = E_wi[b] [r; 1] and world velocity R_wi[b] Gamma(r) phi[b]; a world force f
at it is the body wrench Gamma(r)^T R^T f = [r x R^T f; R^T f].

All contact branches are branchless 0/1 masks (comparisons, which carry no
gradient), and the tangential speed is a where-guarded sqrt of the squared
norm: the scenes rest with zero tangential velocity, where an unguarded norm
has NaN gradients.
"""

from functools import lru_cache
from typing import Dict, Sequence, Tuple

import torch

from redmax_tpu_torch import se3


class _ForceBase:
    """Force closure with a param slot in params['forces'][self.key]."""

    def __init__(self, key: str):
        self.key = key

    def p(self, params: Dict) -> Dict:
        return params["forces"][self.key]


def _not_ported(name: str):
    raise NotImplementedError(f"{name} is not ported yet (ROADMAP queue 1 item 10)")


class ForcePointPoint(_ForceBase):
    def __init__(self, *a, **k):
        _not_ported("ForcePointPoint")


class ForceSpringDamper(_ForceBase):
    def __init__(self, *a, **k):
        _not_ported("ForceSpringDamper")


class SpringDamperM(_ForceBase):
    def __init__(self, *a, **k):
        _not_ported("SpringDamperM")


class ForceCable(_ForceBase):
    def __init__(self, *a, **k):
        _not_ported("ForceCable")


class ForcePointDirection(_ForceBase):
    def __init__(self, *a, **k):
        _not_ported("ForcePointDirection")


class ForceDeformableSegments(_ForceBase):
    def __init__(self, *a, **k):
        _not_ported("ForceDeformableSegments")


# The 8 cuboid corner sign triples (ForceGroundCuboid.m:72-81 column order).
_CORNERS = (
    (-1, -1, -1), (-1, -1, 1), (-1, 1, -1), (-1, 1, 1),
    (1, -1, -1), (1, -1, 1), (1, 1, -1), (1, 1, 1),
)
_A2_MIN = 1e-24  # clamp of the squared tangential speed inside the sqrt


@lru_cache(maxsize=None)
def _corner_signs(dtype, device):
    return torch.tensor(_CORNERS, dtype=dtype, device=device)


@lru_cache(maxsize=None)
def body_index(bodies: Tuple[int, ...], device):
    """The bodies of a group of closures as an index tensor, built once per
    (bodies, device): no host-to-device copy after the first call."""
    return torch.tensor(bodies, dtype=torch.long, device=device)


def corner_state(E_wi_b, phi_b, fp):
    """Per-corner contact state of cuboid bodies with frames E_wi_b [..., 4, 4]
    and twists phi_b [..., 6]; the fields of fp broadcast against the leading
    dims (a single closure's, or stacked [C, ...]). Every entry carries the
    corner dim: vectors [..., 8, 3], scalars and masks [..., 8]."""
    dtype = phi_b.dtype
    E_g = fp["E"]
    xg = E_g[..., None, :3, 3]
    ng = E_g[..., None, :3, 2]
    kn, kt, kd, mu = (fp[k][..., None] for k in ("kn", "kt", "kd", "mu"))
    R = E_wi_b[..., :3, :3]
    p = E_wi_b[..., None, :3, 3]
    w, v = phi_b[..., None, :3], phi_b[..., None, 3:]

    r = 0.5 * fp["sides"][..., None, :] * _corner_signs(dtype, phi_b.device)   # [..., 8, 3]
    xc = torch.einsum("...ij,...cj->...ci", R, r) + p
    d = ((xc - xg) * ng).sum(-1)                                  # depth [..., 8]
    active = (d <= 0).to(dtype)
    u = torch.linalg.cross(w.expand_as(xc), r.expand_as(xc)) + v  # Gamma(r) phi
    vw = torch.einsum("...ij,...cj->...ci", R, u)                 # world corner velocity
    vn = (vw * ng).sum(-1)
    a = vw - vn[..., None] * ng                                   # tangential velocity
    a2 = (a * a).sum(-1)
    flow = (a2 >= _A2_MIN).to(dtype)
    anorm = torch.sqrt(torch.where(a2 < _A2_MIN, torch.full_like(a2, _A2_MIN), a2))
    ainv = 1.0 / anorm
    st = (mu * torch.abs(kn * d) > kt * anorm).to(dtype)
    hf = (mu > 0).to(dtype)
    dyn = hf * (1.0 - st) * active
    sta = hf * st * active

    # normal spring and damper, static friction -kt a, dynamic -mu kn d a/|a|
    fc = (-kn * d - kd * vn)[..., None] * ng
    fW = active[..., None] * fc + (sta * -kt)[..., None] * a \
        + (dyn * (-mu * kn) * d * ainv)[..., None] * a
    fb = torch.einsum("...ji,...cj->...ci", R, fW)                # R^T fW
    return dict(R=R, r=r.expand_as(xc), u=u, d=d, vn=vn, a=a, ainv=ainv, ng=ng, fb=fb,
                active=active, flow=flow, dyn=dyn, sta=sta, kn=kn, kt=kt, kd=kd, mu=mu)


def _wrench(E_wi_b, phi_b, fp):
    """Body wrench [..., 6] of the 8 corner forces: sum_c [r_c x fb_c; fb_c]."""
    s = corner_state(E_wi_b, phi_b, fp)
    return torch.cat([torch.linalg.cross(s["r"], s["fb"]).sum(-2), s["fb"].sum(-2)], dim=-1)


def _energy(E_wi_b, fp):
    """V = 1/2 kn d^2 summed over the penetrating corners [...]."""
    R, p = E_wi_b[..., :3, :3], E_wi_b[..., None, :3, 3]
    r = 0.5 * fp["sides"][..., None, :] * _corner_signs(E_wi_b.dtype, E_wi_b.device)
    xc = torch.einsum("...ij,...cj->...ci", R, r) + p
    d = ((xc - fp["E"][..., None, :3, 3]) * fp["E"][..., None, :3, 2]).sum(-1)
    return 0.5 * fp["kn"] * torch.where(d <= 0, d * d, torch.zeros_like(d)).sum(-1)


class ForceGroundCuboid(_ForceBase):
    """Penalty frictional ground contact on the 8 corners of a cuboid.

    Reference: ForceGroundCuboid.computeValues_ (ForceGroundCuboid.m:54-153),
    Geilinger et al. 2020-style smooth contact:
      per penetrating corner (d = n.(x - xg) <= 0):
        normal:   fc = -kn n d - kd N v            (N = n n^T)
        friction: a = T v (tangential velocity, T = I - N)
          static  (mu |kn d| >  kt |a|):  fs = -kt a
          dynamic (otherwise):            fd = -mu kn d a/|a|
    params: E [4,4] ground frame (z-up), sides [3], kn, kt, kd, mu.
    """

    def __init__(self, key, body: int):
        super().__init__(key)
        self.body = body

    def __call__(self, params, kin, J, phi, q, qdot):
        wrench = _wrench(kin.E_wi[:, self.body], phi[:, self.body], self.p(params))
        fm = q.new_zeros(q.shape[0], kin.E_wi.shape[1], 6)
        fm[:, self.body] = wrench
        return torch.zeros_like(q), fm

    def energy(self, params, kin, q, qdot):
        return _energy(kin.E_wi[:, self.body], self.p(params))


def stack_contact_params(fns: Sequence[ForceGroundCuboid], params: Dict) -> Dict:
    """The closures' parameters stacked along a leading [C] dim."""
    fps = [fn.p(params) for fn in fns]
    return {k: torch.stack([fp[k] for fp in fps]) for k in ("E", "sides", "kn", "kt", "kd", "mu")}


def ground_contact_wrenches(fns: Sequence[ForceGroundCuboid], params: Dict, kin, phi):
    """fm_add [B, N, 6] of all ground contacts of a scene, one batched pass."""
    idx = body_index(tuple(fn.body for fn in fns), phi.device)
    wrench = _wrench(kin.E_wi[:, idx], phi[:, idx], stack_contact_params(fns, params))
    return torch.zeros_like(phi).index_add(1, idx, wrench)


def ground_contact_energy(fns: Sequence[ForceGroundCuboid], params: Dict, kin):
    """Summed contact potential [B] of all ground contacts of a scene."""
    idx = body_index(tuple(fn.body for fn in fns), kin.E_wi.device)
    return _energy(kin.E_wi[:, idx], stack_contact_params(fns, params)).sum(-1)


def ground_contact_blocks(E_wi_b, phi_b, fp, h=None, gmag=None):
    """Closed-form per-body (K, D) [..., 6, 6] blocks of ForceGroundCuboid:
    K = d(wrench)/d(xi) under E <- E exp(xi^), D = d(wrench)/d(phi), masks
    frozen. E_wi_b [..., 4, 4], phi_b [..., 6]; fp broadcasts as in
    corner_state.

    World-frame A = dfW/dx_c, B = dfW/dv_c per corner:
      A = act_h (-kn n n^T) - dyn mu kn a_hat n^T
      B = act_h (-kd n n^T) + (sta (-kt) + cdyn) (I - n n^T)
          - cdyn flow a_hat a_hat^T,          cdyn = dyn (-mu kn d / |a|)
    and with P = R^T A R, Q = R^T B R, u = Gamma(r) phi, fb = R^T fW:
      K = Gamma^T [hat(fb) - P hat(r) - Q hat(u) | P],  D = Gamma^T [-Q hat(r) | Q].

    With (h, gmag) given, the normal spring and damper also count for a corner
    that can reach the floor within one step, d <= h |vn| + h^2 |g| (the
    proximity-margin activation of the Newton matrix): a chord matrix built at
    an out-of-contact predictor otherwise has no contact stiffness while the
    residual does, and the first step at impact overshoots. It changes the
    Newton matrix only, so the converged solution is unchanged.
    """
    s = corner_state(E_wi_b, phi_b, fp)
    dtype = phi_b.dtype
    R, r, u, a, ng, ainv = s["R"], s["r"], s["u"], s["a"], s["ng"], s["ainv"]
    kn, kt, kd, mu = s["kn"], s["kt"], s["kd"], s["mu"]
    act_h = s["active"]
    if h is not None:
        margin = h * torch.abs(s["vn"]) + h * h * gmag
        act_h = act_h + (1.0 - act_h) * ((s["d"] - margin) <= 0).to(dtype)

    nn = ng[..., :, None] * ng[..., None, :]                      # [..., 1, 3, 3]
    T = torch.eye(3, dtype=dtype, device=phi_b.device) - nn
    ahat = a * ainv[..., None]
    cdyn = s["dyn"] * (-mu * kn) * s["d"] * ainv
    c = lambda x: x[..., None, None]
    A3 = c(act_h * -kn) * nn + c(s["dyn"] * (-mu * kn)) * (ahat[..., :, None] * ng[..., None, :])
    B3 = c(act_h * -kd) * nn + c(s["sta"] * -kt + cdyn) * T \
        - c(cdyn * s["flow"]) * (ahat[..., :, None] * ahat[..., None, :])

    Rc = R[..., None, :, :]                                       # over the corner dim
    P = Rc.transpose(-1, -2) @ A3 @ Rc
    Q = Rc.transpose(-1, -2) @ B3 @ Rc
    hr, hfb, hu = se3.hat3(r), se3.hat3(s["fb"]), se3.hat3(u)
    ML = hfb - P @ hr - Q @ hu
    DL = -(Q @ hr)
    K = torch.cat([torch.cat([hr @ ML, hr @ P], dim=-1),
                   torch.cat([ML, P], dim=-1)], dim=-2).sum(-3)
    D = torch.cat([torch.cat([hr @ DL, hr @ Q], dim=-1),
                   torch.cat([DL, Q], dim=-1)], dim=-2).sum(-3)
    return K, D
