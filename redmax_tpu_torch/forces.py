"""Force closures, batch-first: penalty ground contact, two-point springs
and cables.

A force is a closure with the JAX package's protocol,

    fn(params, kin, J, phi, q, qdot) -> (fr_add [B, nr], fm_add [B, N, 6]),

registered on the compiled scene, with its parameters in
params["forces"][fn.key] and an .energy(params, kin, q, qdot) -> [B] for the
energy certificates. Ported here: ForceGroundCuboid, ForcePointPoint,
ForceSpringDamper (with tension_only) and ForceCable, each with the
closed-form K/D blocks of its wrenches (ground_contact_blocks per contact
body; pair_closure_blocks per pair of body points, cross-body blocks
included), which the structured Newton matrix and the Euler system use in
place of autodiff. SpringDamperM, ForcePointDirection and
ForceDeformableSegments (the feature-rich variant's spring-damper,
constant point force and deformable springs) carry implicit_KD = False:
they enter the residual and the energies but no Newton-matrix block, and
the Euler system takes SpringDamperM's own truncated blocks (matlab_KD,
custom_KD = True).

A scene holds one closure per contacting body. ground_contact_wrenches,
ground_contact_energy and stack_contact_params evaluate all of them in one
pass over [B, C, 8, 3] corner tensors: model calls these, not the closures one
by one, so a step costs the same few dozen launches whatever C is. The
springs of one law are evaluated together over [B, S] the same way
(pair_closure_wrenches / _energy / _blocks); a cable is one pass over its P
points.

Body points: a point r (body frame) on body b has world position
x = E_wi[b] [r; 1] and world velocity R_wi[b] Gamma(r) phi[b]; a world force f
at it is the body wrench Gamma(r)^T R^T f = [r x R^T f; R^T f].

All contact and tension branches are branchless 0/1 masks (comparisons,
which carry no gradient), and the tangential speed and every spring or
segment length are where-guarded sqrts of the squared norm: the scenes rest
with zero tangential velocity, where an unguarded norm has NaN gradients.
"""

from functools import lru_cache
from typing import Dict, Sequence, Tuple

import torch

from redmax_tpu_torch import se3
from redmax_tpu_torch.types import lanewise


class _ForceBase:
    """Force closure with a param slot in params['forces'][self.key]."""

    def __init__(self, key: str):
        self.key = key

    def p(self, params: Dict) -> Dict:
        return params["forces"][self.key]


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


def stack_coefs(fps: Sequence[Dict], key: str):
    """One scalar coefficient of several closures: [n], or [B, n] where any of
    them is per lane [B] (the others broadcast), so that it lines up with
    [B, n, ...] closure tensors."""
    return torch.stack(torch.broadcast_tensors(*(fp[key] for fp in fps)), dim=-1)


def stack_contact_params(fns: Sequence[ForceGroundCuboid], params: Dict) -> Dict:
    """The closures' parameters stacked by contact: E [C, 4, 4], sides [C, 3],
    and kn, kt, kd, mu [C], or [B, C] where any is per lane."""
    fps = [fn.p(params) for fn in fns]
    out = {k: torch.stack([fp[k] for fp in fps]) for k in ("E", "sides")}
    return {**out, **{k: stack_coefs(fps, k) for k in ("kn", "kt", "kd", "mu")}}


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


# ---------------------------------------------------------------------------
# Two-point springs and cables
# ---------------------------------------------------------------------------

_L2_MIN = 1e-24  # clamp of a squared spring or segment length inside the sqrt


@lru_cache(maxsize=None)
def _mask(flags: Tuple[bool, ...], device):
    """A static bool tuple as a tensor, built once per (flags, device)."""
    return torch.tensor(flags, dtype=torch.bool, device=device)


def body_points(kin, phi, bodies: Tuple[int, ...], xl):
    """State of the points xl [P, 3] on the static bodies (-1: a world point,
    with xl in world coordinates): world position x [B, P, 3] and, with phi,
    world velocity v, body rotation R [B, P, 3, 3] and body-frame velocity
    u = Gamma(xl) phi. On a world point v = 0, and R, u are body 0's: nothing
    may use them there."""
    idx = body_index(tuple(max(b, 0) for b in bodies), kin.E_wi.device)
    E = kin.E_wi[:, idx]
    R = E[..., :3, :3]
    xle = xl.expand(E.shape[0], *xl.shape)
    x = torch.einsum("bpij,bpj->bpi", R, xle) + E[..., :3, 3]
    world = _mask(tuple(b < 0 for b in bodies), E.device)[:, None] if min(bodies) < 0 else None
    if world is not None:
        x = torch.where(world, xle, x)
    if phi is None:
        return x, None, R, None
    ph = phi[:, idx]
    u = torch.linalg.cross(ph[..., :3], xle) + ph[..., 3:]
    v = torch.einsum("bpij,bpj->bpi", R, u)
    if world is not None:
        v = torch.where(world, torch.zeros_like(v), v)
    return x, v, R, u


def _point_wrenches(bodies, xl, R, F, N):
    """fm [B, N, 6] of world forces F [B, P, 3] at the points xl [P, 3] of the
    static bodies: [xl x fb; fb] with fb = R^T F on each body; world points
    take none."""
    fb = torch.einsum("bpji,bpj->bpi", R, F)
    wr = torch.cat([torch.linalg.cross(xl.expand_as(fb), fb), fb], dim=-1)
    if min(bodies) < 0:
        wr = torch.where(_mask(tuple(b < 0 for b in bodies), F.device)[:, None],
                         torch.zeros_like(wr), wr)
    idx = body_index(tuple(max(b, 0) for b in bodies), F.device)
    return F.new_zeros(F.shape[0], N, 6).index_add(1, idx, wr)


def point_pair_blocks(Rj, rj, fbj, Ri, ri, ui, A, Bm, same):
    """Closed-form wrench-derivative blocks (K, D) [..., 6, 6] between body
    point j and body point i (pallas_step._point_pair_blocks): point j's
    wrench W_j = Gamma_j^T R_j^T F_j with A = dF_j/dx_i, Bm = dF_j/dv_i
    (world 3x3), under E_i <- E_i exp(xi^), phi_i <- phi_i + dphi:

        K = Gamma_j^T [same hat(fb_j) - P hat(r_i) - Q hat(u_i) | P]
        D = Gamma_j^T [-Q hat(r_i) | Q],   P = R_j^T A R_i, Q = R_j^T Bm R_i

    with Gamma_j^T = [hat(r_j); I] and same = 1 where j and i are one point.
    Every argument broadcasts over the leading dims."""
    Rjt = Rj.transpose(-1, -2)
    P = Rjt @ A @ Ri
    Q = Rjt @ Bm @ Ri
    hri = se3.hat3(ri)
    ML = same[..., None, None] * se3.hat3(fbj) - P @ hri - Q @ se3.hat3(ui)
    DL = -(Q @ hri)
    hrj = se3.hat3(rj)
    K = torch.cat([torch.cat([hrj @ ML, hrj @ P], dim=-1), torch.cat([ML, P], dim=-1)], dim=-2)
    D = torch.cat([torch.cat([hrj @ DL, hrj @ Q], dim=-1), torch.cat([DL, Q], dim=-1)], dim=-2)
    return K, D


class _TwoPoint(_ForceBase):
    """A spring between point xl1 of body1 and point xl2 of body2 (-1: a
    world point, xl in world coordinates)."""

    def __init__(self, key, body1: int, body2: int):
        super().__init__(key)
        self.body1 = body1
        self.body2 = body2

    def __call__(self, params, kin, J, phi, q, qdot):
        return torch.zeros_like(q), pair_closure_wrenches((self,), params, kin, phi)

    def energy(self, params, kin, q, qdot):
        return pair_closure_energy((self,), params, kin)


class ForcePointPoint(_TwoPoint):
    """Zero-rest-length linear spring and damper between two body points.

    Reference: ForcePointPoint.m:48-141:
      fW = k (x2 - x1) + d (v2 - v1), applied +fW at point 1, -fW at point 2.
    params: xl1 [3], xl2 [3], k, d. Energy 1/2 k |x2 - x1|^2.
    """


class ForceSpringDamper(_TwoPoint):
    """Finite-rest-length strain spring and damper between two body points.

    Reference: ForceSpringGeneric.m:37-83 with ForceSpringDamper.m:62-72:
      l = |x2 - x1|, ldot = dx.dv / l, fs = k (l - L)/L + d ldot/L,
      fW = (fs / l) dx at point 1, -fW at point 2,
    gated by l > L (tension only) when tension_only. params: xl1, xl2, k, d,
    L (the builder sets L = 0 to the initial distance). Energy
    1/2 k ((l - L)/L)^2 L, gated the same way. l is the where-guarded
    sqrt(max(l^2, 1e-24)), so autograd stays finite.
    """

    def __init__(self, key, body1: int, body2: int, tension_only: bool = False):
        super().__init__(key, body1, body2)
        self.tension_only = tension_only


class ForceCable(_ForceBase):
    """Tension-only spring routed through a sequence of body points.

    Reference: ForceSpringMultiPointGeneric.m:28-95 with ForceCable.m:66-84:
    l = sum_s |dx_s|, ldot = sum_s u_s . dv_s (u_s = dx_s / |dx_s|), one
    tension fs = (l > L) (k (l - L)/L + d ldot/L), and point j takes the
    world force fs c_j, c_j = u_j [j < P-1] - u_{j-1} [j > 0].
    params: xls [P, 3], k, d, L (L = 0 -> the initial length).
    """

    def __init__(self, key, bodies):
        super().__init__(key)
        self.bodies = tuple(bodies)  # static body indices, -1 = world

    def __call__(self, params, kin, J, phi, q, qdot):
        return torch.zeros_like(q), pair_closure_wrenches((self,), params, kin, phi)

    def energy(self, params, kin, q, qdot):
        return pair_closure_energy((self,), params, kin)


PAIR_CLOSURES = (ForcePointPoint, ForceSpringDamper, ForceCable)


def _spring_groups(fns) -> Tuple:
    """The two-point springs of fns by law (point-point, spring-damper), each
    group in fns order; one group is one batched evaluation."""
    pp = tuple(f for f in fns if isinstance(f, ForcePointPoint))
    sd = tuple(f for f in fns if isinstance(f, ForceSpringDamper))
    return tuple(g for g in (pp, sd) if g)


def _spring_eval(fns, params, kin, phi, blocks: bool):
    """One spring group over [B, S]: the endpoint states, stacked end-major
    (bodies and xl [2S]: all first endpoints, then all second), the world
    force fW [B, S, 3] on point 1 and, with blocks, A = dfW/d(dx),
    Bm = dfW/d(dv) [B, S, 3, 3]."""
    S = len(fns)
    fps = [fn.p(params) for fn in fns]
    bodies = tuple(fn.body1 for fn in fns) + tuple(fn.body2 for fn in fns)
    xl = torch.stack([fp["xl1"] for fp in fps] + [fp["xl2"] for fp in fps])
    x, v, R, u = body_points(kin, phi, bodies, xl)
    dx, dv = x[:, S:] - x[:, :S], v[:, S:] - v[:, :S]
    k, d = stack_coefs(fps, "k"), stack_coefs(fps, "d")           # [S] or [B, S]
    A = Bm = None
    eye = torch.eye(3, dtype=dx.dtype, device=dx.device)
    if isinstance(fns[0], ForcePointPoint):
        fW = k[..., None] * dx + d[..., None] * dv
        if blocks:
            A = (k[..., None, None] * eye).expand(*dx.shape, 3)
            Bm = (d[..., None, None] * eye).expand(*dx.shape, 3)
    else:
        L = stack_coefs(fps, "L")
        l = torch.sqrt(torch.clamp((dx * dx).sum(-1), min=_L2_MIN))
        linv = 1.0 / l
        e = dx * linv[..., None]
        ldot = (dx * dv).sum(-1) * linv
        fs = k * (l - L) / L + d * ldot / L
        gate = torch.ones_like(fs)
        if any(fn.tension_only for fn in fns):
            tension = _mask(tuple(bool(fn.tension_only) for fn in fns), dx.device)
            gate = torch.where(tension, (l > L).to(dx.dtype), gate)
        fW = (gate * fs * linv)[..., None] * dx
        if blocks:
            dfs = (k / L)[..., None] * e + (d / L)[..., None] * (dv - ldot[..., None] * e) * linv[..., None]
            outer = e[..., :, None] * e[..., None, :]
            A = gate[..., None, None] * ((fs * linv)[..., None, None] * (eye - outer)
                                         + e[..., :, None] * dfs[..., None, :])
            Bm = (gate * d / L)[..., None, None] * outer
    return bodies, xl, R, u, fW, A, Bm


def _cable_eval(fn, params, kin, phi, blocks: bool):
    """One cable over [B]: the point states, the world forces F [B, P, 3]
    and, with blocks, A = dF_j/dx_i and Bm = dF_j/dv_i [B, P, P, 3, 3]
    (pallas_step._cable_force's closed forms, the shared tension coupling
    every point pair)."""
    fp = fn.p(params)
    P = len(fn.bodies)
    x, v, R, u = body_points(kin, phi, fn.bodies, fp["xls"])
    dx, dv = x[:, 1:] - x[:, :-1], v[:, 1:] - v[:, :-1]
    lk = torch.sqrt(torch.clamp((dx * dx).sum(-1), min=_L2_MIN))       # [B, P-1]
    linv = 1.0 / lk
    us = dx * linv[..., None]
    l, ldot = lk.sum(-1), (us * dv).sum((-1, -2))
    k, d, L = fp["k"], fp["d"], fp["L"]
    gate = (l > L).to(dx.dtype)
    fs = gate * (k * (l - L) / L + d * ldot / L)
    z = torch.zeros_like(us[:, :1])
    c = torch.cat([us, z], dim=1) - torch.cat([z, us], dim=1)          # [B, P, 3]
    F = fs[:, None, None] * c
    if not blocks:
        return x, R, u, F, None, None
    eye = torch.eye(3, dtype=dx.dtype, device=dx.device)
    T = (eye - us[..., :, None] * us[..., None, :]) * linv[..., None, None]   # Pm_s / l_s
    w = torch.einsum("bsij,bsj->bsi", T, dv)
    a = gate[:, None, None] * (-lanewise(k / L, 3) * c + lanewise(d / L, 3) * (
        torch.cat([z, w], dim=1) - torch.cat([w, z], dim=1)))
    Dji = torch.einsum("sji,nsab->njiab", _cable_coef(P, dx.dtype, dx.device), T)
    A = c[:, :, None, :, None] * a[:, None, :, None, :] + fs[:, None, None, None, None] * Dji
    Bm = -(gate * d / L)[:, None, None, None, None] * (c[:, :, None, :, None] * c[:, None, :, None, :])
    return x, R, u, F, A, Bm


@lru_cache(maxsize=None)
def _cable_coef(P: int, dtype, device):
    """coef [P-1, P, P] with D_ji = dc_j/dx_i = sum_s coef[s, j, i] Pm_s / l_s:
    du_s/dx_i = (delta_{i,s+1} - delta_{i,s}) Pm_s / l_s, and c_j holds +u_j
    (s = j) and -u_{j-1} (s = j - 1)."""
    coef = torch.zeros(P - 1, P, P, dtype=dtype)
    for s in range(P - 1):
        for j, sign in ((s, 1.0), (s + 1, -1.0)):
            coef[s, j, s + 1] += sign
            coef[s, j, s] -= sign
    return coef.to(device)


def pair_closure_wrenches(fns: Sequence, params: Dict, kin, phi):
    """fm_add [B, N, 6] of the springs and cables of fns."""
    N = kin.E_wi.shape[1]
    fm = torch.zeros_like(phi)
    for grp in _spring_groups(fns):
        bodies, xl, R, _, fW, _, _ = _spring_eval(grp, params, kin, phi, blocks=False)
        fm = fm + _point_wrenches(bodies, xl, R, torch.cat([fW, -fW], dim=1), N)
    for fn in fns:
        if isinstance(fn, ForceCable):
            _, R, _, F, _, _ = _cable_eval(fn, params, kin, phi, blocks=False)
            fm = fm + _point_wrenches(fn.bodies, fn.p(params)["xls"], R, F, N)
    return fm


def pair_closure_energy(fns: Sequence, params: Dict, kin):
    """Summed potential [B] of the springs and cables of fns."""
    V = kin.E_wi.new_zeros(kin.E_wi.shape[0])
    for fn in fns:
        fp = fn.p(params)
        if isinstance(fn, ForceCable):
            x, _, _, _ = body_points(kin, None, fn.bodies, fp["xls"])
            dx = x[:, 1:] - x[:, :-1]
            l = torch.sqrt(torch.clamp((dx * dx).sum(-1), min=_L2_MIN)).sum(-1)
        else:
            x, _, _, _ = body_points(kin, None, (fn.body1, fn.body2),
                                     torch.stack([fp["xl1"], fp["xl2"]]))
            dx = x[:, 1] - x[:, 0]
            if isinstance(fn, ForcePointPoint):
                V = V + 0.5 * fp["k"] * (dx * dx).sum(-1)
                continue
            l = torch.sqrt(torch.clamp((dx * dx).sum(-1), min=_L2_MIN))
        strain = (l - fp["L"]) / fp["L"]
        Vf = 0.5 * fp["k"] * strain * strain * fp["L"]
        if getattr(fn, "tension_only", True):   # a cable is always tension-only
            Vf = torch.where(strain > 0, Vf, torch.zeros_like(Vf))
        V = V + Vf
    return V


def pair_closure_blocks(fns: Sequence, params: Dict, kin, phi):
    """Closed-form K, D [B, npairs, 6, 6] of the springs and cables of fns, one
    block per (body point j, body point i) pair of a closure with both points
    on bodies: d(wrench of j's body)/d(perturbation of i's body) under the
    structured_hessian convention, cross-body blocks included. Returns
    (K, D, bj, bi) with the static body tuples bj, bi [npairs], or None when
    fns holds no such closure. They equal jacfwd of the closures (masks
    frozen)."""
    Ks, Ds, bj, bi = [], [], [], []
    dev = phi.device
    for grp in _spring_groups(fns):
        S = len(grp)
        bodies, xl, R, u, fW, A, Bm = _spring_eval(grp, params, kin, phi, blocks=True)
        B = phi.shape[0]
        R2, u2, xl2 = R.view(B, 2, S, 3, 3), u.view(B, 2, S, 3), xl.view(2, S, 3)
        fb = torch.einsum("bepji,bepj->bepi", R2, torch.stack([fW, -fW], dim=1))
        # F_1 = +fW, F_2 = -fW and dx = x_2 - x_1: dF_e/dx_c = s_e sig_c A
        coef = torch.tensor([[-1.0, 1.0], [1.0, -1.0]], dtype=fW.dtype, device=dev)
        same = torch.eye(2, dtype=fW.dtype, device=dev)[:, :, None]
        K, D = point_pair_blocks(R2[:, :, None], xl2[:, None], fb[:, :, None], R2[:, None],
                                 xl2[None], u2[:, None], coef[:, :, None, None, None] * A[:, None, None],
                                 coef[:, :, None, None, None] * Bm[:, None, None], same)
        Ks.append(K.reshape(B, 4 * S, 6, 6))
        Ds.append(D.reshape(B, 4 * S, 6, 6))
        ends = (bodies[:S], bodies[S:])
        bj += [ends[e][s] for e in range(2) for c in range(2) for s in range(S)]
        bi += [ends[c][s] for e in range(2) for c in range(2) for s in range(S)]
    for fn in fns:
        if not isinstance(fn, ForceCable):
            continue
        P = len(fn.bodies)
        xls = fn.p(params)["xls"]
        _, R, u, F, A, Bm = _cable_eval(fn, params, kin, phi, blocks=True)
        fb = torch.einsum("bpji,bpj->bpi", R, F)
        same = torch.eye(P, dtype=F.dtype, device=dev)
        K, D = point_pair_blocks(R[:, :, None], xls[:, None], fb[:, :, None], R[:, None],
                                 xls[None], u[:, None], A, Bm, same)
        Ks.append(K.reshape(-1, P * P, 6, 6))
        Ds.append(D.reshape(-1, P * P, 6, 6))
        bj += [b for b in fn.bodies for _ in range(P)]
        bi += [b for _ in range(P) for b in fn.bodies]
    if not Ks:
        return None
    keep = tuple(p for p, (a, b) in enumerate(zip(bj, bi)) if a >= 0 and b >= 0)
    sel = body_index(keep, dev)
    K, D = torch.cat(Ks, dim=1)[:, sel], torch.cat(Ds, dim=1)[:, sel]
    return K, D, tuple(bj[p] for p in keep), tuple(bi[p] for p in keep)


# ---------------------------------------------------------------------------
# The feature-rich variant's closures, explicit in the Newton matrix
# ---------------------------------------------------------------------------


def _point_wrench(xl, R, f):
    """Body wrench [..., 6] of world forces f [..., 3] at body points xl:
    Gamma(xl)^T R^T f = [xl x R^T f; R^T f]."""
    fb = (R.transpose(-1, -2) @ f[..., None])[..., 0]
    return torch.cat([torch.linalg.cross(xl.expand_as(fb), fb), fb], dim=-1)


class SpringDamperM(_TwoPoint):
    """The feature-rich variant's spring-damper with its own sign conventions
    (matlab/+redmax/SpringDamper.m computeFKD):
        fs = k (l - L)/L - d ldot/L        (the MINUS on damping)
        fW = (fs / l) dx at point 1, -fW at point 2.
    Its damping force stays in f0 of the Euler step (strip_damping = False)
    while its D enters the left side through matlab_KD (custom_KD); no
    autodiff block (implicit_KD = False). params: xl1, xl2, k, d, L (the
    builder sets L = 0 to the initial distance). Energy 1/2 k ((l - L)/L)^2.
    """

    strip_damping = False
    implicit_KD = False
    custom_KD = True

    def _geometry(self, params, kin, phi):
        fp = self.p(params)
        x, v, R, u = body_points(kin, phi, (self.body1, self.body2),
                                 torch.stack([fp["xl1"], fp["xl2"]]))
        dx = x[:, 1] - x[:, 0]
        l = torch.sqrt(torch.clamp((dx * dx).sum(-1), min=_L2_MIN))
        return fp, dx, l, v, R

    def __call__(self, params, kin, J, phi, q, qdot):
        fp, dx, l, v, R = self._geometry(params, kin, phi)
        ldot = (dx * (v[:, 1] - v[:, 0])).sum(-1) / l
        fs = fp["k"] * (l - fp["L"]) / fp["L"] - fp["d"] * ldot / fp["L"]
        fW = (fs / l)[:, None] * dx
        F = torch.stack([fW, -fW], dim=1)
        return torch.zeros_like(q), _point_wrenches((self.body1, self.body2),
                                                    torch.stack([fp["xl1"], fp["xl2"]]), R, F,
                                                    kin.E_wi.shape[1])

    def matlab_KD(self, params, kin, phi):
        """The reference's own truncated blocks (SpringDamper.computeFKD,
        :137-157) over the two bodies' 12 coordinates, (Km, Dm) [B, 12, 12]
        in this package's Euler convention (Mrtilde = ... - h J^T Dm J -
        h^2 J^T Km J, so Km = +K_ref, Dm = -D_ref): with
        fn = [-Gamma1^T R1^T dx; Gamma2^T R2^T dx] / l,
            K_ref = -sym(fn (k/L) [-dhat^T R1 Gamma1, dhat^T R2 Gamma2]),
            D_ref = -fn (d/L) [dhat^T R1 Gamma1, -dhat^T R2 Gamma2],
        the -fs d(fn)/dE term dropped as the reference drops it."""
        fp, dx, l, _, R = self._geometry(params, kin, phi)
        xl = torch.stack([fp["xl1"], fp["xl2"]])
        dhat = dx / l[:, None]
        G1 = _point_wrench(xl[0], R[:, 0], dx)
        G2 = _point_wrench(xl[1], R[:, 1], dx)
        fn = torch.cat([-G1, G2], dim=-1) / l[:, None]                     # [B, 12]
        r1 = _point_wrench(xl[0], R[:, 0], dhat)
        r2 = _point_wrench(xl[1], R[:, 1], dhat)
        kL = lanewise(fp["k"] / fp["L"], 2)
        dL = lanewise(fp["d"] / fp["L"], 2)
        row = torch.cat([-kL * r1, kL * r2], dim=-1)
        Kb = fn[:, :, None] * row[:, None, :]
        Km = -0.5 * (Kb + Kb.transpose(-1, -2))
        drow = torch.cat([dL * r1, -dL * r2], dim=-1)
        Dm = fn[:, :, None] * drow[:, None, :]
        return Km, Dm

    def energy(self, params, kin, q, qdot):
        fp, _, l, _, _ = self._geometry(params, kin, None)
        e = (l - fp["L"]) / fp["L"]
        return 0.5 * fp["k"] * e * e


class ForcePointDirection(_ForceBase):
    """A constant world force k d at the body point xl
    (matlab/+redmax/SpringPointDirection.m): wrench Gamma(xl)^T R^T (k d).
    The reference disables its stiffness (K = 0*K, :84; implicit_KD = False)
    and comments its energy out, so energy() is 0 and the certificates
    exclude its work. params: xl [3], d [3], k."""

    implicit_KD = False

    def __init__(self, key, body: int):
        super().__init__(key)
        self.body = body

    def __call__(self, params, kin, J, phi, q, qdot):
        fp = self.p(params)
        R = kin.E_wi[:, self.body, :3, :3]
        f = (lanewise(fp["k"], 2) * fp["d"]).expand(R.shape[0], 3)
        fm = torch.zeros_like(phi)
        fm[:, self.body] = _point_wrench(fp["xl"], R, f)
        return torch.zeros_like(q), fm

    def energy(self, params, kin, q, qdot):
        return kin.E_wi.new_zeros(kin.E_wi.shape[0])


class ForceDeformableSegments(_ForceBase):
    """The segment springs of a DeformableSpring (matlab/+redmax/
    DeformableSpring.m:163-187): per segment s between nodes s and s + 1,
    e = (l - L_s)/L_s, f = K e dx / (L_s l) at node s and -f at node s + 1.
    The nodes are translational point masses with unrotated frames, so a
    node's wrench is [0; f]. Explicit in the Euler step, as the reference
    integrates it (implicit_KD = False). params: K, L [nodes - 1] (the
    builder sets them from the initial configuration). Energy
    sum_s 1/2 K e_s^2."""

    implicit_KD = False

    def __init__(self, key, node_bodies):
        super().__init__(key)
        self.nodes = tuple(node_bodies)

    def _segments(self, params, kin):
        fp = self.p(params)
        xs = kin.E_wi[:, body_index(self.nodes, kin.E_wi.device), :3, 3]     # [B, n, 3]
        dx = xs[:, 1:] - xs[:, :-1]
        l = torch.sqrt(torch.clamp((dx * dx).sum(-1), min=_L2_MIN))
        return fp, dx, l, (l - fp["L"]) / fp["L"]

    def __call__(self, params, kin, J, phi, q, qdot):
        fp, dx, l, e = self._segments(params, kin)
        f = (lanewise(fp["K"], 2) * e / (fp["L"] * l))[..., None] * dx       # [B, n-1, 3]
        z = torch.zeros_like(f[:, :1])
        fn = torch.cat([f, z], dim=1) - torch.cat([z, f], dim=1)             # [B, n, 3]
        fm = torch.zeros_like(phi)
        idx = body_index(self.nodes, phi.device)
        return torch.zeros_like(q), fm.index_add(1, idx, torch.cat([torch.zeros_like(fn), fn], -1))

    def energy(self, params, kin, q, qdot):
        fp, _, _, e = self._segments(params, kin)
        return 0.5 * fp["K"] * (e * e).sum(-1)


# Closures that enter the residual and the energies one by one, with no
# Newton-matrix block (implicit_KD = False).
EXPLICIT_CLOSURES = (SpringDamperM, ForcePointDirection, ForceDeformableSegments)
