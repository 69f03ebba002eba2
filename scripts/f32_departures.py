"""Float32 against float64, in the JAX package and in the port, on the CPU:
the runs that tell a port fault from a limit of float32 itself (ROADMAP.md
queue 3). Each subcommand runs the same thing in both packages from the
same lanes (numpy seeds) and prints one line a comparison.

  python scripts/f32_departures.py friction SID STEPS
      one lane of the friction step (euler_fric) from the JAX float64 run's
      state at each step: JAX float32 and the port's float32 step against
      JAX's float64 step (q and qdot, of scale), and each step's
      staggered-projections iterations
  python scripts/f32_departures.py friction_finite SID STEPS B
      the finite share of float32 friction rollouts of B lanes (lane 0 at
      the initial state, lanes 1.. with qdot0 + 1e-3 N(0, 1), seed 0)
  python scripts/f32_departures.py conditioning SID STEP
      JAX's own float64 friction step at STEP from its rollout's state, and
      from that state with q * (1 + 1e-15 N(0, 1)): how far aux["fbm"] moves
  python scripts/f32_departures.py chain120 B STEPS
      scene_chain(120): the dense Euler step and the PCG tier (tol 1e-4,
      maxit 100) in float32, final q against the float64 dense rollout
  python scripts/f32_departures.py ode45 B
      mscene 0 through dense ode45 in float32 against float64: the share of
      lanes whose final y = (q, qdot), and q alone, lie within 1e-3 of scale
  python scripts/f32_departures.py mppi S [I ...]
      chain-12 MPC (horizon 50, the main path's NewtonConfig): S candidates
      p0 + 3e-3 N(0, 1) (seed 1), their costs in float32 (JAX op level; the
      port's op level and its kernel route's plain version) against JAX's
      float64 costs; each candidate I's costs (scripts/f32_card.py mppi names
      the candidates that depart on the card)
"""

import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

torch.set_num_threads(1)


def scale_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max()) / max(1.0, float(np.abs(want).max()))


def lane_errs(got, want):
    """Per-lane max |got - want| over the scale of want (all lanes)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max(-1) / max(1.0, float(np.abs(want).max()))


def lanes0(q0, qd0, B, seed=0):
    """mzoo_state0's lanes: lane 0 at (q0, qdot0), lanes 1.. with qdot0 +
    1e-3 N(0, 1)."""
    rng = np.random.default_rng(seed)
    qd = np.asarray(qd0, np.float64)[None] + 1e-3 * rng.normal(size=(B, len(q0)))
    qd[0] = qd0
    return np.broadcast_to(np.asarray(q0, np.float64), qd.shape).copy(), qd


def _sp_iterations(step):
    """JAX's friction step returning its staggered-projections iteration
    count beside the state (the while_loop's final carry)."""
    orig, seen = jax.lax.while_loop, []

    def while_loop(cond, body, init):
        out = orig(cond, body, init)
        seen.append(out[0])
        return out

    def run(params, s):
        seen.clear()
        jax.lax.while_loop = while_loop
        try:
            out = step(params, s)
        finally:
            jax.lax.while_loop = orig
        return out, seen[-1]

    return jax.jit(run)


def friction(sid, K):
    from redmax_tpu import scenes_matlab as jms
    from redmax_tpu_torch import scenes_matlab as tms
    from redmax_tpu_torch.types import State
    sc64, sc32 = jms.M_SCENES[sid]().compile(), jms.M_SCENES[sid]().compile(dtype=jnp.float32)
    j64, j32 = (_sp_iterations(s.make_step("euler_fric")) for s in (sc64, sc32))
    t32 = tms.build_mscene(sid, device="cpu", dtype=torch.float32)
    st32 = t32.make_step("euler_fric")
    fn, tfn = getattr(jms, f"scene_fn_{sid}", None), tms.SCENE_FNS.get(sid)
    at = lambda f, p, k: f(p, (k + 1) * p["h"]) if f else p
    s = sc64.state0
    for k in range(K):
        n64, i64 = j64(at(fn, sc64.params, k), s)
        n32, i32 = j32(at(fn, sc32.params, k), jax.tree_util.tree_map(
            lambda a: a.astype(jnp.float32) if a.dtype == jnp.float64 else a, s))
        t = lambda a: torch.tensor(np.asarray(a), dtype=torch.float32)[None]
        o = st32(at(tfn, t32.params, k), State(q=t(s.q), qdot=t(s.qdot),
                                              aux={"fbm": t(s.aux["fbm"])}))
        print(f"mscene {sid} step {k}: JAX f32 off JAX f64: q {scale_err(n32.q, n64.q):.2e}, "
              f"qdot {scale_err(n32.qdot, n64.qdot):.2e}; port f32 off JAX f64: q "
              f"{scale_err(o.q[0], n64.q):.2e}, qdot {scale_err(o.qdot[0], n64.qdot):.2e}; "
              f"staggered-projections iterations JAX f64 {int(i64)}, JAX f32 {int(i32)}, port "
              f"f32 {int(st32.stats['sp_iters'][0])}")
        s = n64


def friction_finite(sid, K, B):
    from redmax_tpu import scenes_matlab as jms
    from redmax_tpu_torch import integrators as tint
    from redmax_tpu_torch import scenes_matlab as tms
    from redmax_tpu_torch.types import State
    sc = jms.M_SCENES[sid]().compile(dtype=jnp.float32)
    fn = getattr(jms, f"scene_fn_{sid}", None)
    step = sc.make_step("euler_fric")
    q, qd = lanes0(np.asarray(sc.state0.q), np.asarray(sc.state0.qdot), B)

    def roll(q0, qd0):
        s = type(sc.state0)(q=q0, qdot=qd0, aux=sc.state0.aux)
        return jax.lax.fori_loop(
            0, K, lambda k, s: step(fn(sc.params, (k + 1) * sc.params["h"]) if fn
                                    else sc.params, s), s)

    t0 = time.perf_counter()
    out = jax.jit(jax.vmap(roll))(jnp.asarray(q, jnp.float32), jnp.asarray(qd, jnp.float32))
    fj = np.isfinite(np.asarray(out.q)).all(-1) & np.isfinite(np.asarray(out.qdot)).all(-1)
    tj = time.perf_counter() - t0
    tc = tms.build_mscene(sid, device="cpu", dtype=torch.float32)
    t0 = time.perf_counter()
    fin = tint.make_simulate(tc.make_step("euler_fric"), K, scene_fn=tms.SCENE_FNS.get(sid))(
        tc.params, State(q=torch.tensor(q, dtype=torch.float32),
                         qdot=torch.tensor(qd, dtype=torch.float32)))
    ft = (torch.isfinite(fin.q).all(-1) & torch.isfinite(fin.qdot).all(-1)).numpy()
    print(f"mscene {sid} f32 {K} steps, {B} lanes: finite share JAX {fj.mean():.4f} "
          f"({tj:.1f} s), port {ft.mean():.4f} ({time.perf_counter() - t0:.1f} s); lanes "
          f"finite in one only: {int((fj != ft).sum())}")


def conditioning(sid, K):
    from redmax_tpu import scenes_matlab as jms
    from redmax_tpu.types import State
    sc = jms.build_mscene(sid)
    step = jax.jit(sc.make_step("euler_fric"))
    fn = getattr(jms, f"scene_fn_{sid}", None)
    at = lambda k: fn(sc.params, (k + 1) * sc.params["h"]) if fn else sc.params
    s = sc.state0
    for k in range(K):
        s = step(at(k), s)
    a = step(at(K), s)
    rng = np.random.default_rng(0)
    for eps in (1e-16, 1e-15):
        s2 = State(q=s.q * (1 + eps * rng.normal(size=s.q.shape)), qdot=s.qdot, aux=s.aux)
        b = step(at(K), s2)
        print(f"mscene {sid} step {K}, q * (1 + {eps:g} N(0, 1)): JAX's fbm moves "
              f"{scale_err(b.aux['fbm'], a.aux['fbm']):.3e} of scale, q "
              f"{scale_err(b.q, a.q):.3e}")


def chain120(B, K):
    from redmax_tpu import integrators as jint
    from redmax_tpu import pcg as jpcg
    from redmax_tpu.scenes import scene_chain as jchain
    from redmax_tpu_torch import integrators as tint
    from redmax_tpu_torch import pcg as tpcg
    from redmax_tpu_torch.scenes import scene_chain as tchain
    from redmax_tpu_torch.types import State
    j64, j32 = jchain(120).compile(), jchain(120).compile(dtype=jnp.float32)
    q, qd = lanes0(np.asarray(j64.state0.q), np.asarray(j64.state0.qdot), B)

    def jroll(sc, step, dtype):
        def roll(q0, qd0):
            s = type(sc.state0)(q=q0, qdot=qd0, aux=sc.state0.aux)
            return jax.lax.fori_loop(0, K, lambda k, s: step(sc.params, s), s).q
        return np.asarray(jax.jit(jax.vmap(roll))(jnp.asarray(q, dtype), jnp.asarray(qd, dtype)))

    ref = jroll(j64, jint.make_euler_step(j64.topo, j64.force_fns), jnp.float64)
    jd = jroll(j32, jint.make_euler_step(j32.topo, j32.force_fns), jnp.float32)
    jp = jroll(j32, jpcg.make_euler_pcg_step(j32.topo, j32.force_fns, tol=1e-4, maxit=100),
               jnp.float32)
    t64 = tchain(120).compile(device="cpu")
    t32 = tchain(120).compile(device="cpu", dtype=torch.float32)

    def troll(sc, step, dtype):
        s = State(q=torch.tensor(q, dtype=dtype), qdot=torch.tensor(qd, dtype=dtype))
        return tint.make_simulate(step, K)(sc.params, s).q.double().numpy()

    tref = troll(t64, tint.make_euler_step(t64.topo, t64.force_fns), torch.float64)
    td = troll(t32, tint.make_euler_step(t32.topo, t32.force_fns), torch.float32)
    tp = troll(t32, tpcg.make_euler_pcg_step(t32.topo, t32.force_fns, tol=1e-4, maxit=100),
               torch.float32)
    print(f"chain-120, {B} lanes, {K} steps: port f64 off JAX f64: max "
          f"{lane_errs(tref, ref).max():.3e} of scale")
    for name, got, want in (("JAX f32 dense Euler vs JAX f64", jd, ref),
                            ("JAX f32 PCG vs JAX f64", jp, ref),
                            ("port f32 dense Euler vs port f64", td, tref),
                            ("port f32 PCG vs port f64", tp, tref),
                            ("port f32 dense Euler vs JAX f32 dense Euler", td, jd)):
        e = lane_errs(got, want)
        print(f"chain-120 {name}: final q off of scale median {np.median(e):.3e}, max "
              f"{e.max():.3e}; {float((e <= 1e-3).mean()):.4f} of lanes within 1e-3")


def ode45(B):
    from redmax_tpu import explicit as jex
    from redmax_tpu import scenes_matlab as jms
    from redmax_tpu_torch import explicit as tex
    from redmax_tpu_torch import scenes_matlab as tms
    from redmax_tpu_torch.types import State
    q, qd = lanes0(np.asarray(jms.build_mscene(0).state0.q),
                   np.asarray(jms.build_mscene(0).state0.qdot), B)
    out = {}
    for dt, jdt in ((torch.float64, jnp.float64), (torch.float32, jnp.float32)):
        # JAX's ode45 builds its tableau at the default float width: float32
        # runs with x64 off, or its carry would mix widths
        with jax.enable_x64(jdt == jnp.float64):
            sc = jms.M_SCENES[0]().compile(dtype=jdt)
            integ = jex.make_ode45(jex.make_deriv_dense(sc.topo, sc.force_fns,
                                                        sc.constraint_fns))
            y0 = jnp.concatenate([jnp.asarray(q, jdt), jnp.asarray(qd, jdt)], -1)
            out[("jax", dt)] = np.asarray(jax.jit(jax.vmap(
                lambda y: integ(sc.params, y, 0.0, sc.tEnd, sc.state0.aux)))(y0), np.float64)
        tc = tms.build_mscene(0, device="cpu", dtype=dt)
        fin = tex.simulate_ode45(tc, "dense", state0=State(q=torch.tensor(q, dtype=dt),
                                                           qdot=torch.tensor(qd, dtype=dt)))
        out[("port", dt)] = torch.cat([fin.q, fin.qdot], -1).double().numpy()
    nr = q.shape[1]
    for pkg in ("jax", "port"):
        for part, sl in (("y", slice(None)), ("q", slice(0, nr))):
            e = lane_errs(out[(pkg, torch.float32)][:, sl], out[(pkg, torch.float64)][:, sl])
            print(f"mscene 0 dense ode45, {B} lanes, {pkg} f32 vs {pkg} f64, final {part}: "
                  f"{float((e <= 1e-3).mean()):.4f} of lanes within 1e-3 (median "
                  f"{np.median(e):.3e})")
    e = lane_errs(out[("port", torch.float64)], out[("jax", torch.float64)])
    print(f"mscene 0 dense ode45: port f64 off JAX f64 max {e.max():.3e} of scale")


def mppi(S, *idx):
    from redmax_tpu import integrators as jint
    from redmax_tpu import mpc as jmpc
    from redmax_tpu.scenes import scene_chain as jchain
    from redmax_tpu.types import State as JState
    from redmax_tpu_torch import integrators as tint
    from redmax_tpu_torch import mpc as tmpc
    from redmax_tpu_torch.scenes import scene_chain as tchain
    from redmax_tpu_torch.types import State
    kw = dict(fixed_iters=3, predictor="quadratic", chord=True, hessian="structured",
              linsolve="gj")
    rng = np.random.default_rng(0)
    p0 = 3.0 / 1e3 * rng.normal(size=(1, 12))[0]
    tgt = rng.uniform(-2.0, 2.0, size=(1, 3))[0]
    cand = p0[None] + 3e-3 * np.random.default_rng(1).normal(size=(S, 12))
    costs = {}
    for name, jdt in (("jax f64", jnp.float64), ("jax f32", jnp.float32)):
        sc = jchain(12).compile(dtype=jdt)
        task = jmpc.PointPosTask(body=11, wp=1.0, wreg=1e-6, pscale=1e3)
        obj = jmpc.make_objective_batched(sc.topo, sc.force_fns, task, (0.5, 0.0, 0.0), 50,
                                          jint.NewtonConfig(**kw), use_pallas=False)
        lanes = lambda a: jnp.broadcast_to(a, (S,) + a.shape)
        s0 = JState(q=lanes(sc.state0.q), qdot=lanes(sc.state0.qdot), aux=sc.state0.aux)
        costs[name] = np.asarray(jax.jit(obj)(sc.params, jnp.asarray(cand, jdt), s0,
                                              jnp.asarray(np.broadcast_to(tgt, (S, 3)), jdt)),
                                 np.float64)
    sc = tchain(12).compile(device="cpu", dtype=torch.float32)
    task = tmpc.PointPosTask(body=11, wp=1.0, wreg=1e-6, pscale=1e3)
    s0 = State(q=sc.state0.q.expand(S, -1), qdot=sc.state0.qdot.expand(S, -1))
    for name, uk in (("port f32 op level", False), ("port f32 kernel route (plain)", True)):
        obj = tmpc.make_objective_batched(sc.topo, sc.force_fns, task, (0.5, 0.0, 0.0), 50,
                                          tint.NewtonConfig(**kw), use_kernel=uk)
        with torch.no_grad():
            costs[name] = obj(sc.params, torch.tensor(cand, dtype=torch.float32), s0,
                              torch.tensor(np.broadcast_to(tgt, (S, 3)).copy(),
                                           dtype=torch.float32)).double().numpy()
    ref = costs["jax f64"]
    rank = np.argsort(np.where(np.isfinite(ref), ref, np.inf))
    for name in ("jax f32", "port f32 op level", "port f32 kernel route (plain)"):
        rel = np.abs(costs[name] - ref) / np.abs(ref)
        off = np.isfinite(ref) & ~(rel <= 1e-3)
        top = [f"{rel[i]:.2e}" for i in rank[:5]]
        print(f"mppi chain-12, {S} candidates: {name} vs jax f64: {float(off.mean()):.4f} of "
              f"candidates off by rel > 1e-3 (max rel {np.nanmax(rel):.3e}); rel of the 5 best "
              f"(by f64 cost) {top}")
    for i in idx:
        print(f"candidate {i} (rank {int(np.flatnonzero(rank == i)[0])} by JAX f64 cost): "
              + ", ".join(f"{name} {c[i]!r}" for name, c in costs.items()))
    a, b = costs["port f32 op level"], costs["port f32 kernel route (plain)"]
    rel = np.abs(a - b) / np.abs(b)
    print(f"mppi chain-12: port f32 op level vs its kernel route: {float((rel > 1e-3).mean()):.4f}"
          f" of candidates off by rel > 1e-3 (max {np.nanmax(rel):.3e})")


if __name__ == "__main__":
    cmd, args = sys.argv[1], [int(a) for a in sys.argv[2:]]
    {"friction": friction, "friction_finite": friction_finite, "conditioning": conditioning,
     "chain120": chain120, "ode45": ode45, "mppi": mppi}[cmd](*args)
