"""Drive redmax_tpu_torch's three paths on one NVIDIA GPU and check them.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (any failure is an exception and a non-zero exit):
  1. card and toolchain: torch.cuda must be available;
  2. build both kernels (csrc/) with nvcc for sm_90a, side by side, and print
     their -Xptxas -v register/spill reports;
  3. hold the chord kernel against its plain PyTorch version on the card
     (scene_chain(12) at B = 1024 and the ragged B = 1000, scene_chain(4)):
     x within 5e-6 max(1, |x|) of the float32 plain version, H^-1 within
     2e-5 of scale of the plain version in float64; time both with CUDA
     events, and compute the kernel's bound;
  4. the main path: bench.py's batched MPC solve (12-link chain, horizon 50,
     B = 1024, f32, one Adam step) through mpc.make_mpc_solver_batched, with
     the launch count read around the timed solves; the same solve on the
     op-level route (float32 and float64) must agree; a small solve on the
     card must agree with the same solve on the CPU in float64;
  5. hold the dual-PGS kernel against its plain version on the card: random
     well-posed QPs at (n, m) = (6, 8), B = 1024 and a ragged B = 1000 (x
     within 2e-5, lambda within 2e-4 of scale), and the contact QPs of the
     6-link floor chain at (6, 12) (m > n makes the dual singular, so x and
     the primal objective are held by quantiles against the plain version in
     float64, not lambda); time the launch, the wrapper and the plain
     version, and compute the kernel's bound;
  6. the contact-QP path: scene_floor_chain(6), B = 1024, f32, 20 linearly
     implicit Euler steps with 40 PGS sweeps through make_euler_step_batched
     and make_simulate on the kernel route, with the launch count read around
     the timed rollouts; the same rollout on the op-level route (float32 and
     float64) must agree; the last step's solution must be feasible; a small
     rollout on the card must agree with the CPU in float64;
  7. the equality branch: reference case 4 (loop closure, dense KKT), B = 64,
     5 steps on the card against the CPU in float64, launching no kernel;
  8. hold the chord kernel with ground contacts against its plain version:
     chain-ground-12 at B = 1024 and B = 1000 and chain-ground-4 at B = 1024,
     on states taken from a contact rollout, with corners out of contact, in
     static and in dynamic friction (counted and asserted); x and H^-1 by the
     tolerances of phase 3 on at least 99% of lanes (a corner within roundoff
     of a regime threshold may flip between two float32 orders), finite masks
     equal, the worst lane printed; also with mu = 0, with a NaN lane, and
     with a floor out of reach, which must give the result of the build
     without contacts to float32 roundoff; time it and compute its bound beside phase 3's;
  9. the contact path: benchmarks/bench_contact.py's differentiable-contact
     MPC solve (chain-ground-12, kn 100, kt 0.1, kd 10, mu 0.5, floor 0.01
     under the links, horizon 50, B = 1024, f32, one Adam step), with the
     checks of phase 4;
 10. print the kernels line, the paths' lines, the card's name and power
     limit, and the result line.
"""

import importlib.util
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

from redmax_tpu_torch import chord_kernel, forces, integrators, model, mpc, qp_kernel
from redmax_tpu_torch.scenes import scene_chain, scene_chain_ground, scene_floor_chain
from redmax_tpu_torch.scenes_matlab import build_mscene
from redmax_tpu_torch.types import State

# H100 SXM peaks at its 700 W limit (NVIDIA data sheet): f32 outside the
# tensor cores, and HBM3 bandwidth.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
CFG = integrators.NewtonConfig(fixed_iters=3, predictor="quadratic", chord=True,
                               hessian="structured", linsolve="gj")


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn() over reps calls, after two warm calls."""
    fn()
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def lane_flops(topo, fixed_iters: int, ncontacts: int = 0) -> int:
    """Floating-point operations of one lane of csrc/chord_bdf2_lane.cuh,
    counted from its loops (add, sub, mul, div, sqrt, sin, cos: one each;
    compares and selects none), with ncontacts ground contacts."""
    N, NR = topo.njoints, topo.nr
    anc = topo.ancestor_mask()[:, topo.dof_joint()]   # [N, NR] ancestor pairs
    P = int(anc.sum())
    P2 = int((anc.sum(1) ** 2).sum())                 # (r, s) pairs per body
    frame_mul, frame_inv, adjoint, mat6 = 63, 18, 27, 66
    q_local = sum(36 if t == 1 else (3 * (2 * d - 1) if d else 0)
                  for t, d in zip(topo.jtype, topo.ndof))
    fk = (q_local + sum(frame_mul * (2 if p < 0 else 3) for p in topo.parent)
          + NR * (adjoint + mat6)                      # W
          + N * (frame_inv + adjoint) + P * mat6 + P * 12   # J, phi
          + NR * (adjoint + 30 + mat6)                 # Wdot
          + N * (frame_inv + adjoint) + P * (mat6 + 30 + 6))  # Jdot
    qdot = 6 * NR
    residual = 2 + 27 * NR + N * 99 + P * 36 + 2 * NR
    hessian = 3 + N * 90 + P * 2 * mat6 + P2 * 71 + 11 * NR
    gj = NR + 2 * NR * NR + 4 * NR * NR * (NR - 1)
    static = N * (frame_inv + adjoint) + NR * mat6
    step = qdot + residual + (2 * NR + 1) + 2 * NR * NR + NR
    # ground_contact: R^T n once, then per corner the force (158) and, in the
    # Hessian, the K/D row blocks and their Gamma^T contraction (418 more)
    contact_force, contact_blocks = 15 + 8 * 158, 15 + 8 * (158 + 418)
    contacts = ncontacts * (contact_blocks + fixed_iters * contact_force)
    return (static + qdot + fk + hessian + gj + fixed_iters * step
            + (fixed_iters - 1) * fk + contacts)


def rand_states(nr, B, seed, device):
    """Chord-solve inputs as in tests/test_torch_chord.py, with per-lane
    torques of the main path's scale (tau = 1e3 * 0.003 * N(0, 1))."""
    rng = np.random.default_rng(seed)
    q1 = 0.3 * rng.normal(size=(B, nr))
    qd1 = rng.normal(size=(B, nr))
    q0 = q1 - 0.01 * qd1
    qd0 = qd1 + 0.05 * rng.normal(size=(B, nr))
    x0 = q1 + 0.01 * qd1
    tau = 3.0 * rng.normal(size=(B, nr))
    t = lambda a: torch.tensor(a, dtype=torch.float32, device=device)
    return [t(a) for a in (x0, q0, qd0, q1, qd1)], t(tau)


def time_chord_kernel(sc, params, states, max_abs_err, label):
    """The kernel record fields at one scene's shapes: launch time, the
    wrapper's with its layout copies, the plain version's, and the bound."""
    B = states[0].shape[0]
    fns = sc.force_fns
    args = chord_kernel.pack(sc.topo, params, *states, fns)
    ms = cuda_ms(lambda: chord_kernel.launch(sc.topo, CFG, *args), reps=200)
    wrap_ms = cuda_ms(lambda: chord_kernel.chord_bdf2(sc.topo, CFG, params, *states, fns), 100)
    plain_ms = cuda_ms(lambda: chord_kernel.chord_bdf2_reference(
        sc.topo, CFG, params, *states, fns), reps=50)
    flops = lane_flops(sc.topo, CFG.fixed_iters, len(fns)) * B
    nbytes = 4 * B * (6 * sc.topo.nr + sc.topo.nr + sc.topo.nr ** 2) + sum(
        a.numel() * a.element_size() for a in args[6:])
    t_ops, t_bytes = flops / PEAK_F32_FLOPS * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
    bound = max(t_ops, t_bytes)
    print(f"chord_bdf2 at {label}, {len(fns)} contacts, B {B}: kernel {ms:.4f} ms, wrapper with "
          f"layout copies {wrap_ms:.4f} ms, plain {plain_ms:.4f} ms; {flops / B:.0f} flops/lane, "
          f"{nbytes} bytes; bound {bound * 1e3:.3f} us "
          f"({'operations' if t_ops >= t_bytes else 'bytes'}), kernel at {bound / ms:.2%} of it")
    return {"max_abs_err": max_abs_err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def phase_kernel_vs_plain(device="cuda", cases=((12, 1024), (12, 1000), (4, 1024))):
    """Kernel vs chord_bdf2_reference on the card; returns the kernel record
    fields measured at the main path's shapes (the first case)."""
    record = {}
    for nlinks, B in cases:
        sc = scene_chain(nlinks).compile(dtype=torch.float32, device=device)
        sc64 = scene_chain(nlinks).compile(dtype=torch.float64, device=device)
        states, tau = rand_states(sc.topo.nr, B, seed=1, device=device)
        params = {**sc.params, "tau": tau}
        x, hinv = chord_kernel.chord_bdf2(sc.topo, CFG, params, *states)
        x_ref, hinv_ref = chord_kernel.chord_bdf2_reference(sc.topo, CFG, params, *states)
        x64, hinv64 = chord_kernel.chord_bdf2_reference(
            sc64.topo, CFG, {**sc64.params, "tau": tau.double()}, *(a.double() for a in states))
        torch.cuda.synchronize()
        fin, fin_ref = torch.isfinite(x).all(-1), torch.isfinite(x_ref).all(-1)
        if not torch.equal(fin, fin_ref):
            raise AssertionError(f"chain {nlinks} B {B}: NaN masks differ "
                                 f"({int((fin != fin_ref).sum())} lanes)")
        if fin.float().mean() < 0.9:
            raise AssertionError(f"chain {nlinks} B {B}: only {float(fin.float().mean())} finite")
        dx = (x[fin] - x_ref[fin]).abs()
        x_ok = bool((dx <= 5e-6 * torch.clamp(x_ref[fin].abs(), min=1.0)).all())
        # H^-1 is held to the plain version evaluated in float64 on the same
        # inputs: at 12 links cond(H) reaches ~1e3 and the float32 plain
        # version is itself ~3e-5 of scale away from it, so two float32
        # evaluations in different orders cannot agree to 2e-5.
        hscale = float(hinv64.abs().max())
        dh = float((hinv.double() - hinv64).abs().max())
        dh_plain = float((hinv_ref.double() - hinv64).abs().max())
        dh_pair = float((hinv - hinv_ref).abs().max())
        ex = [float((a[fin].double() - x64[fin]).abs().max()) for a in (x, x_ref)]
        cond = float(torch.linalg.cond(torch.linalg.inv(hinv64[fin])).max())
        print(f"kernel vs plain chain {nlinks} B {B}: finite {int(fin.sum())}/{B}, "
              f"max|dx| {float(dx.max()):.3e}; x vs f64 plain: kernel {ex[0]:.3e}, "
              f"f32 plain {ex[1]:.3e}; Hinv vs f64 plain: kernel {dh / hscale:.3e}, "
              f"f32 plain {dh_plain / hscale:.3e} of scale {hscale:.3e}; "
              f"kernel vs f32 plain {dh_pair / hscale:.3e}; max cond(H) {cond:.3e}")
        if not x_ok or dh > 2e-5 * hscale:
            raise AssertionError(f"chain {nlinks} B {B}: kernel disagrees with its plain version")
        if (nlinks, B) == cases[0]:
            record = time_chord_kernel(sc, params, states, float(dx.max()), f"chain {nlinks}")
    return record


def bench_inputs(nr, B, device, dtype):
    """bench.py's inputs: seed 0, p0 = 0.003 N(0,1), targets U(-2, 2)."""
    rng = np.random.default_rng(0)
    p0 = torch.tensor(0.003 * rng.normal(size=(B, nr)), dtype=dtype, device=device)
    targets = torch.tensor(rng.uniform(-2.0, 2.0, size=(B, 3)), dtype=dtype, device=device)
    return p0, targets


def chain_ground(nlinks, mu=0.5, floor_z=-0.06):
    """benchmarks/bench_contact.py's scene: a contact on every link, the links'
    bottom corners 0.01 above the floor."""
    return scene_chain_ground(nlinks=nlinks, kn=100.0, kt=0.1, kd=10.0, mu=mu, h=1e-2,
                              floor_z=floor_z)


def mpc_solver(sc, horizon, use_kernel=None):
    task = mpc.PointPosTask(body=sc.topo.njoints - 1, wp=1.0, wreg=1e-6, pscale=1e3)
    obj = mpc.make_objective_batched(sc.topo, sc.force_fns, task, (0.5, 0.0, 0.0), horizon,
                                     CFG, use_kernel=use_kernel)
    return mpc.make_mpc_solver_batched(obj, iters=1, lr=0.05), obj


def phase_mpc_path(name, scene, device="cuda", nlinks=12, horizon=50, B=1024, reps=3):
    """The batched MPC solve of bench.py:53-105 (scene = scene_chain) or of
    benchmarks/bench_contact.py:44-105 (scene = chain_ground) on the port;
    returns (kernel launches of the timed solves, solves/s, finite_frac)."""
    sc = scene(nlinks).compile(dtype=torch.float32, device=device)
    solve, _ = mpc_solver(sc, horizon)
    p0, targets = bench_inputs(sc.topo.nr, B, device, torch.float32)
    s0 = State(q=sc.state0.q.expand(B, -1).contiguous(),
               qdot=sc.state0.qdot.expand(B, -1).contiguous())

    res = solve(sc.params, p0, s0, targets)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    chord_kernel.chord_bdf2_launches = 0
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(reps):
        res = solve(sc.params, p0, s0, targets)
    end.record()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / reps
    launches = chord_kernel.chord_bdf2_launches
    dt = start.elapsed_time(end) / 1e3 / reps
    if launches != (horizon - 1) * reps:
        raise AssertionError(f"chord_bdf2 launched {launches} times in {reps} solves, "
                             f"want {horizon - 1} per solve")
    finite = torch.isfinite(res.objective)
    finite_frac = float(finite.float().mean())
    peak = torch.cuda.max_memory_allocated()
    print(f"{name}: {B / dt:.2f} solves/s ({dt * 1e3:.3f} ms per solve by CUDA events, "
          f"{wall * 1e3:.3f} ms host clock), finite_frac {finite_frac:.4f}, "
          f"kernel launches {launches // reps} per solve, peak memory {peak / 2**20:.1f} MiB")
    if res.objective.shape != (B,) or res.p.shape != (B, sc.topo.nr):
        raise AssertionError(f"{name}: unexpected output shapes")
    if finite_frac < 0.95:
        raise AssertionError(f"{name}: finite_frac {finite_frac} < 0.95")
    if not torch.isfinite(res.p[finite]).all():
        raise AssertionError(f"{name}: non-finite update on a finite lane")

    # where the time goes inside one solve (CUDA events around each phase)
    step = integrators.make_bdf2_step_batched(sc.topo, sc.force_fns, CFG, differentiable=True)
    params = {**sc.params, "tau": (1e3 * p0).requires_grad_(True)}
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    for _ in range(2):  # the first pass warms the allocator; the second is timed
        torch.cuda.synchronize()
        ev[0].record()
        s = step.bootstrap(params, integrators.bdf2_init(s0))
        ev[1].record()
        for _ in range(horizon - 1):
            s = step.inner(params, s)
        ev[2].record()
        torch.autograd.grad(s.q.sum(), params["tau"])
        ev[3].record()
        torch.cuda.synchronize()
    split = [ev[i].elapsed_time(ev[i + 1]) for i in range(3)]
    print(f"{name}, one solve by phase: bootstrap {split[0]:.3f} ms, {horizon - 1} inner steps "
          f"(kernel route forward) {split[1]:.3f} ms, adjoint backward {split[2]:.3f} ms")

    # The same solve on the op-level route, in float32 and in float64: the
    # objective agrees to rtol 1e-3 on at least 99% of the lanes finite in
    # both. The max over ~1000 lanes is not held: a few sensitive lanes
    # drift by ~1e-3 over 50 steps in any float32 rollout (the float32
    # op-level route against float64 too), and it is printed.
    solve_plain, _ = mpc_solver(sc, horizon, use_kernel=False)
    sc64 = scene(nlinks).compile(dtype=torch.float64, device=device)
    solve64, _ = mpc_solver(sc64, horizon, use_kernel=False)
    chord_kernel.chord_bdf2_launches = 0
    ref32 = solve_plain(sc.params, p0, s0, targets).objective
    ref64 = solve64(sc64.params, p0.double(), State(q=s0.q.double(), qdot=s0.qdot.double()),
                    targets.double()).objective
    torch.cuda.synchronize()
    if chord_kernel.chord_bdf2_launches != 0:
        raise AssertionError("op-level route launched the kernel")

    def compare(obj, ref, name):
        fin, fin_ref = torch.isfinite(obj), torch.isfinite(ref)
        agree = float((fin == fin_ref).float().mean())
        both = fin & fin_ref
        rel = (obj[both].double() - ref[both].double()).abs() / ref[both].double().abs()
        within = float((rel <= 1e-3).double().mean())
        q = torch.quantile(rel, torch.tensor([0.5, 0.99], dtype=rel.dtype, device=rel.device))
        print(f"{name}: finite masks agree on {agree:.4f} of lanes; objective rel diff median "
              f"{float(q[0]):.3e}, p99 {float(q[1]):.3e}, max {float(rel.max()):.3e}; "
              f"{within:.4f} of {int(both.sum())} lanes within 1e-3")
        return agree, within, float(rel.max())

    checks = [compare(res.objective, ref32, "kernel route vs op-level f32"),
              compare(res.objective, ref64, "kernel route vs op-level f64")]
    compare(ref32, ref64, "op-level f32 vs op-level f64")
    if any(agree < 0.99 or within < 0.99 for agree, within, _ in checks):
        raise AssertionError(f"{name}: kernel route and op-level route disagree")
    return launches, B / dt, finite_frac


def phase_small_reference(name, scene, device="cuda"):
    """A small solve on the card (f32, kernel route) against the same solve
    on the CPU in float64 (the plain version, held to redmax_tpu by the
    tests)."""
    nlinks, horizon, B = 4, 5, 64
    out = {}
    for dev, dtype in ((device, torch.float32), ("cpu", torch.float64)):
        sc = scene(nlinks).compile(dtype=dtype, device=dev)
        solve, _ = mpc_solver(sc, horizon)
        p0, targets = bench_inputs(sc.topo.nr, B, dev, dtype)
        s0 = State(q=sc.state0.q.expand(B, -1).contiguous(),
                   qdot=sc.state0.qdot.expand(B, -1).contiguous())
        out[dev, dtype] = solve(sc.params, p0, s0, targets).objective.double().cpu()
    card, cpu = out[device, torch.float32], out["cpu", torch.float64]
    err = float((card - cpu).abs().max() / cpu.abs().max())
    print(f"{name}, small solve, card f32 vs CPU f64: max objective diff {err:.3e} of scale")
    if not torch.isfinite(card).all() or err > 1e-3:
        raise AssertionError(f"{name}: small solve on the card disagrees with the CPU "
                             "float64 solve")


# ---------------------------------------------------------------------------
# The dual-PGS kernel and the contact-QP Euler path
# ---------------------------------------------------------------------------

PGS_ITERS = 40
PGS_REG = 1e-10


def quantiles(v, qs=(0.5, 0.95, 0.99)):
    v = v.double().flatten()
    out = torch.quantile(v, torch.tensor(qs, dtype=v.dtype, device=v.device))
    return [float(x) for x in out] + [float(v.max())]


def random_qps(B, n, me, mi, mb, seed, device):
    """Well-posed random QPs (H = Q Q^T + 3 I) with equality, inequality and
    boxed rows, as tests/test_torch_qp.py makes them."""
    rng = np.random.default_rng(seed)
    m = me + mi + mb
    Q = rng.normal(size=(B, n, n))
    H = Q @ np.transpose(Q, (0, 2, 1)) + 3.0 * np.eye(n)
    f, A, b = rng.normal(size=(B, n)), rng.normal(size=(B, m, n)), rng.normal(size=(B, m))
    box = np.abs(rng.normal(size=(B, mb)))
    lo = np.concatenate([np.full((B, me), -np.inf), np.zeros((B, mi)), -box], axis=1)
    hi = np.concatenate([np.full((B, me + mi), np.inf), box], axis=1)
    return [torch.tensor(a, dtype=torch.float32, device=device) for a in (H, f, A, b, lo, hi)]


def floor_chain_states(sc, B, device, dtype, seed=0):
    """benchmarks/bench_qp.py's states: q = q0 + 0.3 N(0,1), qdot = N(0,1)."""
    rng = np.random.default_rng(seed)
    q = sc.state0.q.cpu().numpy()[None] + 0.3 * rng.normal(size=(B, sc.topo.nr))
    qd = rng.normal(size=(B, sc.topo.nr))
    return State(q=torch.tensor(q, dtype=dtype, device=device),
                 qdot=torch.tensor(qd, dtype=dtype, device=device))


def contact_qps(sc, s):
    """(H, f, A, b, lo, hi) of the Euler step at state s."""
    H, f, (A, b, lo, hi, _) = integrators.euler_qp_system(
        sc.topo, (), sc.constraint_fns, sc.params, s.q, s.qdot)
    return H, f, A, b, lo, hi


def dual_pgs_flops(n, m, iters):
    """Floating-point operations of one lane of csrc/dual_pgs_lane.cuh, counted
    from its loops (add, sub, mul, div, compare-and-select of the clip: one
    each)."""
    gj = n * (1 + 2 * n + 4 * n * (n - 1))
    setup = 2 * n * n + 2 * n * n * m + 2 * n * m * m + m * (2 * n + 1)
    sweeps = iters * m * (2 * m + 6)
    return gj + setup + sweeps + n * (2 * m + 1)


def phase_qp_kernel_vs_plain(device="cuda", B=1024):
    """dual_pgs vs dual_pgs_reference on the card at both instantiated shapes;
    returns the kernel record fields measured at the path's shape (6, 12)."""
    # (a) well-posed random QPs at (6, 8): lambda is unique, so it is held too
    for Bq in (B, B - 24):
        qps = random_qps(Bq, 6, 1, 4, 3, seed=11, device=device)
        x, lam = qp_kernel.dual_pgs(*qps, iters=PGS_ITERS, reg=PGS_REG)
        x_ref, lam_ref = qp_kernel.dual_pgs_reference(*qps, iters=PGS_ITERS, reg=PGS_REG)
        torch.cuda.synchronize()
        if not (torch.isfinite(x).all() and torch.isfinite(lam).all()):
            raise AssertionError(f"dual_pgs (6, 8) B {Bq}: non-finite output")
        xs, ls = max(1.0, float(x_ref.abs().max())), max(1.0, float(lam_ref.abs().max()))
        dx, dl = float((x - x_ref).abs().max()), float((lam - lam_ref).abs().max())
        print(f"dual_pgs vs plain (6, 8) B {Bq}: max|dx| {dx:.3e} of scale {xs:.3e}, "
              f"max|dlam| {dl:.3e} of scale {ls:.3e}")
        if dx > 2e-5 * xs or dl > 2e-4 * ls:
            raise AssertionError(f"dual_pgs (6, 8) B {Bq}: kernel disagrees with its plain version")

    # (b) the path's contact QPs at (6, 12). D = A H^-1 A^T is singular
    # (m > n), lambda is not unique and two f32 orders walk different iterate
    # paths on lanes at an active-set boundary: x and the primal objective
    # are held by quantiles against the plain version in float64.
    sc = scene_floor_chain(6).compile(dtype=torch.float32, device=device)
    qps = contact_qps(sc, floor_chain_states(sc, B, device, torch.float32))
    n, m = qps[1].shape[1], qps[2].shape[1]
    x, lam = qp_kernel.dual_pgs(*qps, iters=PGS_ITERS, reg=PGS_REG)
    x_ref, _ = qp_kernel.dual_pgs_reference(*qps, iters=PGS_ITERS, reg=PGS_REG)
    qps64 = [a.double() for a in qps]
    x64, _ = qp_kernel.dual_pgs_reference(*qps64, iters=PGS_ITERS, reg=PGS_REG)
    torch.cuda.synchronize()
    fin, fin_ref = torch.isfinite(x).all(-1), torch.isfinite(x_ref).all(-1)
    if not torch.equal(fin, fin_ref) or not torch.equal(fin, torch.isfinite(x64).all(-1)):
        raise AssertionError("dual_pgs (6, 12): finite masks differ")
    if fin.float().mean() < 0.99:
        raise AssertionError(f"dual_pgs (6, 12): only {float(fin.float().mean())} finite")
    H64, f64 = qps64[0][fin], qps64[1][fin]

    def pobj(xv):
        xv = xv[fin].double()
        return 0.5 * torch.einsum("bi,bij,bj->b", xv, H64, xv) - torch.einsum("bi,bi->b", f64, xv)

    o64 = pobj(x64)
    gap = {name: (pobj(xv) - o64).abs() / (o64.abs() + 1e-9)
           for name, xv in (("kernel", x), ("f32 plain", x_ref))}
    xscale = max(1.0, float(x64[fin].abs().max()))
    act_rows = float(torch.isinf(qps[5]).float().sum(-1).mean())
    print(f"dual_pgs vs plain (6, 12) B {B}: finite {int(fin.sum())}/{B}, "
          f"{act_rows:.2f} active rows per lane of {m}")
    stats = {}
    for name, g in gap.items():
        p50, p95, p99, mx = quantiles(g)
        within = float((g <= 1e-3).double().mean())
        stats[name] = (p50, p95, within)
        print(f"  primal objective gap to f64 plain, {name}: p50 {p50:.3e}, p95 {p95:.3e}, "
              f"p99 {p99:.3e}, max {mx:.3e} (worst lane, not held); {within:.4f} within 1e-3")
    for name, xv in (("kernel", x), ("f32 plain", x_ref)):
        p50, p95, p99, mx = quantiles((xv[fin].double() - x64[fin]).abs().amax(-1) / xscale)
        print(f"  max|dx| to f64 plain of scale {xscale:.3e}, {name}: p50 {p50:.3e}, "
              f"p95 {p95:.3e}, p99 {p99:.3e}, max {mx:.3e}")
    dxk = float((x[fin] - x_ref[fin]).abs().max())
    k, pl = stats["kernel"], stats["f32 plain"]
    if k[0] > 1e-5 or k[2] < 0.95:
        raise AssertionError("dual_pgs (6, 12): primal objective gap to float64 too large")
    # no worse than twice the f32 plain version's gap at the median and the
    # 95% quantile (with a floor of f32 roundoff on the objective, 1e-6)
    if k[0] > 2 * max(pl[0], 1e-6) or k[1] > 2 * max(pl[1], 1e-6):
        raise AssertionError("dual_pgs (6, 12): kernel further from float64 than twice the "
                             "float32 plain version")

    packed = qp_kernel.pack(*qps)
    ms = cuda_ms(lambda: qp_kernel.launch(*packed, PGS_ITERS, PGS_REG), reps=200)
    wrap_ms = cuda_ms(lambda: qp_kernel.dual_pgs(*qps, iters=PGS_ITERS, reg=PGS_REG), reps=100)
    plain_ms = cuda_ms(lambda: qp_kernel.dual_pgs_reference(*qps, iters=PGS_ITERS, reg=PGS_REG),
                       reps=5)
    flops = dual_pgs_flops(n, m, PGS_ITERS) * B
    nbytes = 4 * B * (n * n + n + m * n + 3 * m + n + m)
    t_ops, t_bytes = flops / PEAK_F32_FLOPS * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
    bound = max(t_ops, t_bytes)
    print(f"dual_pgs at (6, 12), B {B}, {PGS_ITERS} sweeps: kernel {ms:.4f} ms, wrapper with "
          f"layout copies {wrap_ms:.4f} ms, plain {plain_ms:.4f} ms; {flops // B} flops/lane "
          f"({t_ops * 1e3:.3f} us), {nbytes} bytes ({t_bytes * 1e3:.3f} us); bound "
          f"{bound * 1e3:.3f} us, kernel at {bound / ms:.2%} of it; dependent chain "
          f"{PGS_ITERS * m} row updates per lane, {ms * 1e6 / (PGS_ITERS * m):.1f} ns each")
    return {"max_abs_err": dxk, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def lane_err(q, ref):
    """Per-lane max |q - ref| over the scale of ref, on lanes finite in both."""
    both = torch.isfinite(q).all(-1) & torch.isfinite(ref).all(-1)
    scale = max(1.0, float(ref[both].abs().max()))
    return (q[both].double() - ref[both].double()).abs().amax(-1) / scale, both


def phase_euler_path(device="cuda", nlinks=6, B=1024, nsteps=20, reps=3):
    """benchmarks/bench_qp.py's workload on the port; returns (kernel
    launches of the timed rollouts, steps/s, finite_frac)."""
    sc = scene_floor_chain(nlinks).compile(dtype=torch.float32, device=device)
    s0 = floor_chain_states(sc, B, device, torch.float32)
    step = integrators.make_euler_step_batched(sc.topo, (), sc.constraint_fns,
                                               pgs_iters=PGS_ITERS, use_kernel=True)
    sim = integrators.make_simulate(step, nsteps)
    final = sim(sc.params, s0)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    qp_kernel.dual_pgs_launches = 0
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(reps):
        final = sim(sc.params, s0)
    end.record()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / reps
    launches = qp_kernel.dual_pgs_launches
    dt = start.elapsed_time(end) / 1e3 / reps
    if launches != nsteps * reps:
        raise AssertionError(f"dual_pgs launched {launches} times in {reps} rollouts, "
                             f"want {nsteps} per rollout")
    finite = torch.isfinite(final.q).all(-1) & torch.isfinite(final.qdot).all(-1)
    finite_frac = float(finite.float().mean())
    peak = torch.cuda.max_memory_allocated()
    print(f"euler path: {B * nsteps / dt:.1f} steps/s ({dt * 1e3:.3f} ms per {nsteps}-step rollout "
          f"by CUDA events, {wall * 1e3:.3f} ms host clock), finite_frac {finite_frac:.4f}, "
          f"kernel launches {launches // reps} per rollout, peak memory {peak / 2**20:.1f} MiB")
    if final.q.shape != (B, sc.topo.nr) or finite_frac < 0.99:
        raise AssertionError(f"euler path: shape {tuple(final.q.shape)}, finite_frac {finite_frac}")

    # one step split into assembly (kinematics, Euler system, constraint rows)
    # and the QP solve (layout copies + kernel), on the warm path
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    for _ in range(2):
        torch.cuda.synchronize()
        ev[0].record()
        qps = contact_qps(sc, s0)
        ev[1].record()
        qp_kernel.dual_pgs(*qps, iters=PGS_ITERS, reg=PGS_REG)
        ev[2].record()
        torch.cuda.synchronize()
    print(f"one step by phase: assembly {ev[0].elapsed_time(ev[1]):.3f} ms, "
          f"QP solve (wrapper) {ev[1].elapsed_time(ev[2]):.3f} ms")

    # The same rollout on the op-level route in float32 and float64. Final q
    # within 1e-3 of scale of the float64 rollout on at least 95% of lanes;
    # the worst lane sits on an active-set boundary and is printed, not held.
    qp_kernel.dual_pgs_launches = 0
    sim_op = integrators.make_simulate(integrators.make_euler_step_batched(
        sc.topo, (), sc.constraint_fns, pgs_iters=PGS_ITERS, use_kernel=False), nsteps)
    q32 = sim_op(sc.params, s0).q
    sc64 = scene_floor_chain(nlinks).compile(dtype=torch.float64, device=device)
    s64 = State(q=s0.q.double(), qdot=s0.qdot.double())
    q64 = sim_op(sc64.params, s64).q
    torch.cuda.synchronize()
    if qp_kernel.dual_pgs_launches != 0:
        raise AssertionError("op-level route launched the kernel")
    within = {}
    for name, a, ref in (("kernel route vs op-level f64", final.q, q64),
                         ("kernel route vs op-level f32", final.q, q32),
                         ("op-level f32 vs op-level f64", q32, q64)):
        err, both = lane_err(a, ref)
        p50, _, p99, mx = quantiles(err)
        within[name] = float((err <= 1e-3).double().mean())
        print(f"{name}: final q diff of scale median {p50:.3e}, p99 {p99:.3e}, max {mx:.3e}; "
              f"{within[name]:.4f} of {int(both.sum())} lanes within 1e-3")
    if within["kernel route vs op-level f64"] < 0.95:
        raise AssertionError("euler path: kernel route and float64 op-level route disagree")

    # Feasibility of the last step's solution on its active rows. A fixed
    # number of dual sweeps leaves a primal violation of its own (it falls
    # with the sweep count), so A x <= b + 1e-4 scale is held relative to
    # the plain version in float64 at the same sweep count, lane by lane, on
    # at least 95% of lanes, and absolutely at 1e-2 of scale.
    s_last = integrators.make_simulate(step, nsteps - 1)(sc.params, s0)
    qps = contact_qps(sc, s_last)
    A, b, active = qps[2], qps[3], torch.isinf(qps[5])
    scale = max(1.0, float(b[active].abs().max()))

    def violation(x):
        Ax = torch.einsum("bmn,bn->bm", A.double(), x.double())
        return torch.where(active, Ax - b, torch.zeros_like(Ax)).amax(-1) / scale

    qps64 = [a.double() for a in qps]
    viol = {
        "kernel": violation(qp_kernel.dual_pgs(*qps, iters=PGS_ITERS, reg=PGS_REG)[0]),
        "f64 plain": violation(qp_kernel.dual_pgs_reference(*qps64, PGS_ITERS, PGS_REG)[0]),
        f"f64 plain at {10 * PGS_ITERS} sweeps":
            violation(qp_kernel.dual_pgs_reference(*qps64, 10 * PGS_ITERS, PGS_REG)[0]),
    }
    fin = torch.isfinite(viol["kernel"]) & torch.isfinite(viol["f64 plain"])
    print(f"last step feasibility: {int(active.sum())} active rows on "
          f"{int(active.any(-1).sum())} lanes; violation max(A x - b) of scale {scale:.3e}:")
    for name, v in viol.items():
        p50, p95, p99, mx = quantiles(v[fin])
        print(f"  {name}: median {p50:.3e}, p95 {p95:.3e}, p99 {p99:.3e}, max {mx:.3e}; "
              f"{float((v[fin] <= 1e-4).double().mean()):.4f} of lanes within 1e-4")
    as_plain = float((viol["kernel"][fin] <= viol["f64 plain"][fin] + 1e-4).double().mean())
    print(f"  kernel within 1e-4 of the f64 plain version's violation on {as_plain:.4f} of lanes")
    if as_plain < 0.95 or float(viol["kernel"][fin].max()) > 1e-2:
        raise AssertionError("euler path: the last step's solution is less feasible than the "
                             "plain version's")
    return launches, B * nsteps / dt, finite_frac


def rollout_q(scene, s0_of, device, dtype, nsteps, use_kernel=None):
    sc = scene(dtype, device)
    step = integrators.make_euler_step_batched(sc.topo, (), sc.constraint_fns,
                                               pgs_iters=PGS_ITERS, use_kernel=use_kernel)
    return integrators.make_simulate(step, nsteps)(sc.params, s0_of(sc, device, dtype)).q


def phase_small_euler(device="cuda", B=64, nsteps=5):
    """Small rollouts on the card in float32 against the CPU in float64: the
    6-link floor chain on the kernel route, and the equality branch
    (reference case 4, dense KKT), which must launch no kernel."""
    floor = lambda dtype, dev: scene_floor_chain(6).compile(dtype=dtype, device=dev)
    states = lambda sc, dev, dtype: floor_chain_states(sc, B, dev, dtype)
    card = rollout_q(floor, states, device, torch.float32, nsteps)
    cpu = rollout_q(floor, states, "cpu", torch.float64, nsteps)
    err, both = lane_err(card.cpu(), cpu)
    p50, _, p99, mx = quantiles(err)
    print(f"small floor-chain rollout, card f32 vs CPU f64: final q diff of scale median "
          f"{p50:.3e}, p99 {p99:.3e}, max {mx:.3e} over {int(both.sum())}/{B} lanes")
    if int(both.sum()) != B or mx > 1e-3:
        raise AssertionError("small rollout on the card disagrees with the CPU float64 rollout")

    def loop_states(sc, dev, dtype):
        rng = np.random.default_rng(3)
        q = sc.state0.q.cpu().numpy()[None] + 0.05 * rng.normal(size=(B, sc.topo.nr))
        qd = sc.state0.qdot.cpu().numpy()[None] + 0.1 * rng.normal(size=(B, sc.topo.nr))
        return State(q=torch.tensor(q, dtype=dtype, device=dev),
                     qdot=torch.tensor(qd, dtype=dtype, device=dev))

    loop = lambda dtype, dev: build_mscene(4, dtype=dtype, device=dev)
    qp_kernel.dual_pgs_launches = 0
    card = rollout_q(loop, loop_states, device, torch.float32, nsteps)
    cpu = rollout_q(loop, loop_states, "cpu", torch.float64, nsteps)
    torch.cuda.synchronize()
    if qp_kernel.dual_pgs_launches != 0:
        raise AssertionError("the equality branch launched the dual-PGS kernel")
    err, both = lane_err(card.cpu(), cpu)
    print(f"equality branch (loop closure, KKT), card f32 vs CPU f64: final q diff of scale "
          f"max {float(err.max()):.3e} over {int(both.sum())}/{B} lanes, 0 kernel launches")
    if int(both.sum()) != B or float(err.max()) > 1e-4:
        raise AssertionError("equality branch on the card disagrees with the CPU float64 rollout")


# ---------------------------------------------------------------------------
# The chord kernel with ground contacts
# ---------------------------------------------------------------------------


def contact_rollout_states(sc, B, device, nsteps=8, seed=1):
    """Chord-solve inputs on the contact path: the scene rolled nsteps from
    rest on the op-level route under the main path's torques
    (tau = 1e3 * 0.003 N(0, 1)), then the next inner step's history and
    predictor. Lanes the rollout rejected are replaced by lane 0's state."""
    rng = np.random.default_rng(seed)
    tau = torch.tensor(3.0 * rng.normal(size=(B, sc.topo.nr)), dtype=torch.float32, device=device)
    params = {**sc.params, "tau": tau}
    step = integrators.make_bdf2_step_batched(sc.topo, sc.force_fns, CFG, use_kernel=False)
    s = integrators.make_simulate(step, nsteps)(params, sc.initial_state("bdf2", B))
    ok = (torch.isfinite(s.q) & torch.isfinite(s.qdot)).all(-1)
    fix = lambda a: torch.where(ok[:, None], a, a[ok][:1])
    q0, qd0, q1, qd1 = (fix(a) for a in (s.q_prev, s.qdot_prev, s.q, s.qdot))
    h = float(sc.params["h"])
    x0 = q1 + h * qd1 + 0.5 * h * (qd1 - qd0)
    return [x0, q0, qd0, q1, qd1], params, int(ok.sum())


def corner_census(sc64, states):
    """Corner counts at the predictor: out of contact, static, dynamic, and
    within 1e-6 (absolute, or relative for the friction cone) of a regime
    threshold: d = 0, d = margin, mu |kn d| = kt |a|."""
    x0, q0, _, q1, _ = (a.double() for a in states)
    topo, p64, fns = sc64.topo, sc64.params, sc64.force_fns
    h = p64["h"]
    qd = (1.5 / h) * (x0 - (4 / 3) * q1 + (1 / 3) * q0)
    kin = model.forward_kinematics(topo, p64, x0, qd)
    _, _, phi = model.jacobians(topo, p64, kin, qd)
    idx = forces.body_index(tuple(fn.body for fn in fns), x0.device)
    s = forces.corner_state(kin.E_wi[:, idx], phi[:, idx], forces.stack_contact_params(fns, p64))
    d, active = s["d"], s["active"] > 0
    margin = h * s["vn"].abs() + h * h * torch.linalg.vector_norm(p64["g"])
    fn_, ft_ = s["mu"] * (s["kn"] * d).abs(), s["kt"] / s["ainv"]
    close = (d.abs() <= 1e-6) | ((d - margin).abs() <= 1e-6) | (
        active & ((fn_ - ft_).abs() <= 1e-6 * torch.maximum(fn_, ft_)))
    return {"corners": d.numel(), "out": int((~active).sum()), "static": int((s["sta"] > 0).sum()),
            "dynamic": int((s["dyn"] > 0).sum()),
            "near_margin_only": int((~active & (d <= margin)).sum()),
            "within_1e-6_of_a_threshold": int(close.sum()),
            "lanes_with_such_a_corner": int(close.flatten(1).any(-1).sum())}


def compare_contact_kernel(sc, sc64, params, states, label, min_ok=0.99):
    """Kernel against the f32 plain version (x) and the f64 plain version
    (H^-1) lane by lane; returns (max |dx| over the lanes inside tolerance,
    x of the kernel)."""
    fns, B = sc.force_fns, states[0].shape[0]
    x, hinv = chord_kernel.chord_bdf2(sc.topo, CFG, params, *states, fns)
    x_ref, hinv_ref = chord_kernel.chord_bdf2_reference(sc.topo, CFG, params, *states, fns)
    p64 = {**sc64.params, "tau": params["tau"].double()}
    x64, hinv64 = chord_kernel.chord_bdf2_reference(
        sc64.topo, CFG, p64, *(a.double() for a in states), sc64.force_fns)
    torch.cuda.synchronize()
    fin, fin_ref = torch.isfinite(x).all(-1), torch.isfinite(x_ref).all(-1)
    both = fin & fin_ref
    if not torch.equal(fin, fin_ref):
        bad = (fin != fin_ref).nonzero().flatten().tolist()
        raise AssertionError(f"{label}: finite masks differ on lanes {bad[:8]} ({len(bad)} lanes)")
    if fin.float().mean() < 0.9:
        raise AssertionError(f"{label}: only {float(fin.float().mean())} finite")
    dx = ((x - x_ref).abs() / torch.clamp(x_ref.abs(), min=1.0)).amax(-1)
    hscale = float(hinv64[both].abs().max())
    dh = (hinv.double() - hinv64).abs().amax((-1, -2)) / hscale
    dh_plain = (hinv_ref.double() - hinv64).abs().amax((-1, -2)) / hscale
    ok = both & (dx <= 5e-6) & (dh <= 2e-5)
    share = float(ok[both].float().mean())
    worst = int(torch.where(both, dx, torch.zeros_like(dx)).argmax())
    qx, qh = quantiles(dx[both]), quantiles(dh[both])
    print(f"kernel vs plain {label}: finite {int(fin.sum())}/{B}, {share:.4f} of them inside "
          f"tolerance; |dx|/max(1,|x|) p50 {qx[0]:.3e} p99 {qx[2]:.3e} max {qx[3]:.3e}; Hinv vs "
          f"f64 plain of scale {hscale:.3e}: kernel p50 {qh[0]:.3e} p99 {qh[2]:.3e} max "
          f"{qh[3]:.3e}, "
          f"f32 plain max {float(dh_plain[both].max()):.3e}; worst lane {worst}: dx "
          f"{float(dx[worst]):.3e}, kernel vs f64 "
          f"{float((x[worst].double() - x64[worst]).abs().max()):.3e}, f32 plain vs f64 "
          f"{float((x_ref[worst].double() - x64[worst]).abs().max()):.3e}")
    if share < min_ok:
        raise AssertionError(f"{label}: kernel disagrees with its plain version on "
                             f"{1 - share:.4f} of lanes")
    return float(dx[ok].max()), x


def phase_contact_kernel_vs_plain(device="cuda", cases=((12, 1024), (12, 1000), (4, 1024))):
    """The chord kernel with ground contacts against chord_bdf2_reference on
    the card; returns the kernel record fields at the contact path's shapes
    (the first case)."""
    record = {}
    for nlinks, B in cases:
        sc = chain_ground(nlinks).compile(dtype=torch.float32, device=device)
        sc64 = chain_ground(nlinks).compile(dtype=torch.float64, device=device)
        states, params, kept = contact_rollout_states(sc, B, device)
        census = corner_census(sc64, states)
        print(f"contact states chain-ground-{nlinks} B {B}: {kept}/{B} lanes from the rollout; "
              f"corners {json.dumps(census)}")
        if min(census["out"], census["static"], census["dynamic"]) == 0:
            raise AssertionError(f"chain-ground-{nlinks}: a contact regime is missing: {census}")
        err, x = compare_contact_kernel(sc, sc64, params, states, f"chain-ground-{nlinks} B {B}")
        if (nlinks, B) != cases[0]:
            continue
        record = time_chord_kernel(sc, params, states, err, f"chain-ground-{nlinks}")

        # mu = 0 is data, not a build option
        sc0 = chain_ground(nlinks, mu=0.0).compile(dtype=torch.float32, device=device)
        sc0_64 = chain_ground(nlinks, mu=0.0).compile(dtype=torch.float64, device=device)
        compare_contact_kernel(sc0, sc0_64, {**sc0.params, "tau": params["tau"]}, states,
                               f"chain-ground-{nlinks} mu 0 B {B}")
        # a NaN lane comes out NaN and leaves every other lane as it was
        poisoned = [a.clone() for a in states]
        poisoned[3][5] = float("nan")
        xp, _ = chord_kernel.chord_bdf2(sc.topo, CFG, params, *poisoned, sc.force_fns)
        keep = torch.ones(B, dtype=torch.bool, device=device)
        keep[5] = False
        if not torch.isnan(xp[5]).all() or not torch.equal(xp[keep].isnan(), x[keep].isnan()) \
                or not torch.equal(torch.nan_to_num(xp[keep]), torch.nan_to_num(x[keep])):
            raise AssertionError("a NaN lane did not stay NaN, or changed another lane")
        # A floor no corner can reach adds exact zeros, so the build with the
        # contact code must reproduce the C = 0 build (compiled without it)
        # to float32 roundoff: nvcc contracts the two builds'
        # common arithmetic into FMAs differently, so not bit for bit (the g++
        # test of the lane body holds the exact zeros).
        far = chain_ground(nlinks, floor_z=-50.0).compile(dtype=torch.float32, device=device)
        far_params = {**far.params, "tau": params["tau"]}
        xf, hf = chord_kernel.chord_bdf2(far.topo, CFG, far_params, *states, far.force_fns)
        x0, h0 = chord_kernel.chord_bdf2(far.topo, CFG, far_params, *states)
        fin0 = torch.isfinite(x0).all(-1)
        dxf = float(((xf - x0).abs() / torch.clamp(x0.abs(), min=1.0))[fin0].max())
        dhf = float((hf - h0).abs().max() / h0.abs().max())
        print(f"chain-ground-{nlinks} B {B}: NaN lane kept, other lanes bit-equal; floor out of "
              f"reach vs the build without contacts on {int(fin0.sum())} finite lanes: "
              f"max|dx|/max(1,|x|) {dxf:.3e}, max|dHinv| {dhf:.3e} of scale")
        if not torch.equal(fin0, torch.isfinite(xf).all(-1)) or dxf > 5e-6 or dhf > 2e-5:
            raise AssertionError("contacts out of reach changed the C = 0 result")
    return record


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda is not available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi_line()
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    print(f"card: {smi}; torch {torch.__version__} cuda {torch.version.cuda}; "
          f"nvcc {nvcc if os.path.exists(nvcc) else 'missing'}; "
          f"triton {'importable' if importlib.util.find_spec('triton') else 'missing'}")

    t0 = time.perf_counter()
    for mod in (chord_kernel, qp_kernel):  # one nvcc per source, side by side
        mod.BUILD.start()
    for mod in (chord_kernel, qp_kernel):
        mod._build_lib()
    print(f"build: {time.perf_counter() - t0:.1f} s")
    for mod in (chord_kernel, qp_kernel):
        for line in mod.BUILD.ptxas_report.splitlines():
            if "Compiling" in line or "registers" in line or "spill" in line:
                print(f"ptxas {mod.BUILD.name}:", line.strip())

    record = phase_kernel_vs_plain()
    launches, rate, finite_frac = phase_mpc_path("main path", scene_chain)
    phase_small_reference("main path", scene_chain)
    qp_record = phase_qp_kernel_vs_plain()
    qp_launches, step_rate, euler_finite = phase_euler_path()
    phase_small_euler()
    contact_record = phase_contact_kernel_vs_plain()
    contact_launches, contact_rate, contact_finite = phase_mpc_path("contact path", chain_ground)
    phase_small_reference("contact path", chain_ground)

    kernels = [{
        "name": "chord_bdf2", "route": "cuda",
        "source": "redmax_tpu_torch/csrc/chord_bdf2.cu",
        "replaces": "redmax_tpu/pallas_step.py:689",
        "launches": launches, **record, "library_ms": None,
    }, {
        # the same kernel with 12 ground contacts, on the contact path
        "name": "chord_bdf2[ground_contact]", "route": "cuda",
        "source": "redmax_tpu_torch/csrc/chord_bdf2.cu",
        "replaces": "redmax_tpu/pallas_step.py:237",
        "launches": contact_launches, **contact_record, "library_ms": None,
    }, {
        # library_ms: no single PyTorch call computes a dual-PGS solve
        "name": "dual_pgs", "route": "cuda",
        "source": "redmax_tpu_torch/csrc/dual_pgs.cu",
        "replaces": "redmax_tpu/pallas_qp.py:40",
        "launches": qp_launches, **qp_record, "library_ms": None,
    }]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"main_path": {"solves_per_s": rate, "finite_frac": finite_frac,
                                    "card": smi}}))
    print(json.dumps({"euler_path": {"steps_per_s": step_rate, "finite_frac": euler_finite,
                                     "card": smi}}))
    print(json.dumps({"contact_path": {"solves_per_s": contact_rate, "finite_frac": contact_finite,
                                       "launches": contact_launches, "card": smi}}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
