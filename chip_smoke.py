"""Drive redmax_tpu_torch's paths on one NVIDIA GPU and check them.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (any failure is an exception and a non-zero exit):
  1. card and toolchain: torch.cuda must be available;
  2. build the kernels (csrc/) with nvcc for sm_90a, one nvcc per library,
     side by side (the chord kernel's fixed libraries: the thread-per-lane
     design as it stands, with the q-dependent joints, with per-lane params
     and with the robust solve modes, its cooperative design, and the dual
     PGS in both designs, a group of threads a lane and one thread a lane,
     K3's fixed library and its unit for phase 30's m = 200;
     and the builds made for one shape that the phases below launch: the
     cooperative K1b builds, the default-route cases of phase 26 and the
     umbrella's of phase 27 (each with the thread-per-lane build it is
     timed against; the QP's in both designs) and uni6's probe build, each
     picked by the shape rule
     before anything is built), and print each library's build time, their
     -Xptxas -v register/spill reports and each cooperative build's layout
     (threads a lane, lanes a block, shared memory a block);
  3. hold the chord kernel against its plain PyTorch version on the card
     (scene_chain(12) at B = 1024, 1000 and 997, scene_chain(4); the
     wrapper runs the cooperative design there, one launch a call): x within
     5e-6 max(1, |x|) of the float32 plain version, H^-1 within 2e-5 of
     scale of the plain version in float64; time the kernel and the
     thread-per-lane build of the same shape (in turns, in this run; each
     200 launches in a CUDA graph, so that the wrapper's host work does not
     set the rate) and the plain version with CUDA events, and compute the
     kernel's bound;
  4. the main path: bench.py's batched MPC solve (12-link chain, horizon 50,
     B = 1024, f32, one Adam step) through mpc.make_mpc_solver_batched, with
     the launch count of the cooperative design read around the timed
     solves (49 a solve, none of the other design); the same solve on the
     op-level route (float32 and float64) must agree; a small solve on the
     card must agree with the same solve on the CPU in float64;
  5. hold the dual-PGS kernel against its plain version on the card through
     the default route (the cooperative design, a group of threads a lane,
     one launch a call and none of the other design): random well-posed QPs
     at (n, m) = (6, 8), B = 1024 and a ragged B = 1000 (x within 2e-5,
     lambda within 2e-4 of scale), and the contact QPs of the 6-link floor
     chain at (6, 12) (m > n makes the dual singular, so x and the primal
     objective are held by quantiles against the plain version in float64,
     not lambda), with a NaN lane; time the launch (200 launches in a CUDA
     graph, and CUDA events over 200 back-to-back launches) in turns with
     the thread-per-lane build, each design's wrapper and the plain version,
     and compute the kernel's bound;
  6. the contact-QP path: scene_floor_chain(6), B = 1024, f32, 20 linearly
     implicit Euler steps with 40 PGS sweeps through make_euler_step_batched
     and make_simulate on the kernel route, with the launch counts read
     around the timed rollouts (20 of the cooperative QP a rollout, none of
     the other design); the same rollout on the op-level route (float32 and
     float64) must agree; the last step's solution must be feasible; a small
     rollout on the card must agree with the CPU in float64;
  7. the equality branch: reference case 4 (loop closure, dense KKT), B = 64,
     5 steps on the card against the CPU in float64, launching no kernel;
  8. hold the chord kernel with ground contacts against its plain version:
     chain-ground-12 at B = 1024, 1000 and 997 and chain-ground-4 at B = 1024,
     on states taken from a contact rollout, with corners out of contact, in
     static and in dynamic friction (counted and asserted); x and H^-1 by the
     tolerances of phase 3 on at least 99% of lanes (a corner within roundoff
     of a regime threshold may flip between two float32 orders), finite masks
     equal, the worst lane printed; also with mu = 0, with a NaN lane, and
     with a floor out of reach, which must give the result of the build
     without contacts to float32 roundoff; time it beside the thread-per-lane
     build as in phase 3, and compute its bound;
  9. the contact path: benchmarks/bench_contact.py's differentiable-contact
     MPC solve (chain-ground-12, kn 100, kt 0.1, kd 10, mu 0.5, floor 0.01
     under the links, horizon 50, B = 1024, f32, one Adam step), with the
     checks of phase 4 (the cooperative design's 49 launches a solve);
 10. hold the chord kernel with springs against its plain version: the
     spring chain (scene_spring_chain(12): a world-to-tip spring-damper, a
     body-body spring-damper and a point-point coupler) at B = 1024, 1000
     and 997 (the cooperative design, its last block partial), on states 8
     steps into a rollout under the path's torques, by the tolerances of
     phase 3 on at least 99% of lanes, a NaN lane, and timed in turns with
     its thread-per-lane build, as in phase 3;
 11. hold the chord kernel with a cable against its plain version: scene 13
     (a tension-only cable over two links to a stiff prismatic slider) at
     B = 1024 on rollout states (the cooperative design), with a census of
     lanes taut, slack and within 1e-6 L of the gate (those left out of the
     tolerance and counted); then the same states with L raised so that
     every lane is slack; timed in turns with the thread-per-lane build;
 12. the spring path: benchmarks/bench_spring_ab.py's spring-MPC solve
     (spring chain, horizon 50, B = 1024, f32, one Adam step) with the checks
     of phase 4 (the cooperative design's 49 launches a solve), the small
     card-against-CPU solve at 12 links;
 13. the cable rollout: scene 13, B = 1024 lanes from its initial state plus
     a seeded perturbation, 50 BDF2 steps on the kernel route (49 launches
     of the cooperative design per rollout, none of the other), timed,
     against the float64 op-level rollout;
 14. hold the chord kernel with the q-dependent joints (K1b: the
     cooperative QDEP builds made for their shapes, timed in turns with the
     thread-per-lane QDEP builds) against its plain version: the
     universal-6 chain at B = 1024 and
     B = 1000, the spherical-4 chain and scene 9's FREE3D body at B = 1024,
     on states 8 steps into a rollout under the path's torques, plus seeded
     lanes whose exp-map rotations lie in the Taylor branch (s < 0.04), just
     above it and near |w| = 1.5 pi (counted per branch); the tolerances of
     phase 3 on at least 99% of lanes, a NaN lane, timed;
 15. the universal-6 path: benchmarks/qdep_ablation.py's uni6_kernel row (6
     universal joints, nr = 12, horizon 50, B = 1024, f32, one Adam step)
     with the checks of phase 4 (the cooperative design's 49 launches a
     solve) and the post-step reparam timed in the split;
 16. the spherical-4 path: its sph4_kernel row (4 exp-map spherical joints),
     the same;
 17. the FREE3D rollout: scene 9, B = 1024 lanes with the rotation drawn
     uniformly in the ball of radius 1.45 pi, 50 BDF2 steps on the kernel
     route (49 launches per rollout), timed, against the float64 op-level
     rollout; the exp-map rescale must fire on the card in some lanes;
 18. hold the PERLANE builds (K1f) against their plain version: per-lane
     I_i, body damping, g, h and contact, spring and cable coefficients
     (perlane_draws) on chain-ground-12 at B = 1024, 1000 and 997, the spring
     chain and scene 13, on rollout states under the same draws, by the
     tolerances of phase 8; a NaN lane; lane-shared params broadcast into
     the per-lane buffer against the builds without it; timed (each build on
     the cooperative design, in turns with its thread-per-lane build, as in
     phase 3);
 19. the randomized contact path: phase 9's solve with per-lane I_i, h, g,
     kn and mu (perlane_draws), with the checks of phase 4 (the cooperative
     design's 49 launches a solve) and the small card-against-CPU solve at
     12 links;
 20. system identification: cotangents of that objective into the per-lane
     I_i, h and every kn, kernel route against op-level route;
 21. 50-step rollouts of the spring chain and of scene 13 under the draws
     of phase 18 on the kernel route (49 launches each on the cooperative
     design, none on the other), against the float64 op-level rollouts;
 22. hold the ROBUST builds (K1g) against their plain version in each of
     guarded, guard_last, chord=False and guarded chord=False: chain-12 at
     B = 1024, 1000 and 997 on states 8 steps into a sigma = 6 rollout and
     chain-ground-12 at B = 1024 on contact-rollout states, by phase 3's
     tolerances on at least 99% of lanes with the finite masks equal on at
     least 99%, and with no allowance on the lanes where the plain version
     took a half step or stayed put; a census of full, half and stay-put
     steps (each taken); with chord=False, the kernel's H^-1 nearer the last
     iterate's than the predictor's wherever the two differ; a NaN lane;
     timed with the bound of lane_flops for the mode (the cooperative
     design, in turns with its thread-per-lane build, as in phase 3);
 23. the robust paths of benchmarks/robust_mode.py: guard_last and guarded3
     on chain-12 and on the contact scene, chord=False on the contact scene,
     at sigma = 3, each with the checks of phase 4 (the cooperative
     design's 49 launches a solve) and the small card-against-CPU solve (12
     links); chord3, guard_last and guarded3 on chain-12 at sigma = 6, rate
     and finite_frac;
 24. the backward modes of benchmarks/backward_ab.py: reuse, refresh and
     exact on the chain-12 solve at sigma = 3, rate and finite_frac, the
     cosine and norm ratio of dObjective/dP against exact (horizon 5), and
     refresh against the op-level route without factor reuse;
 25. where the cooperative kernel's time goes: its probe build (the same
     source with -DCHORD_COOP_PROBE, each phase's clock64() cycles summed on
     each warp) on phase 3's chain-12 and phase 8's chain-ground-12 inputs,
     phase 22's chain-ground-12 inputs in the guarded mode, phase 18's
     per-lane chain-ground-12 inputs, phase 10's spring-chain inputs,
     phase 18's per-lane spring-chain inputs, phase 14's universal-6
     inputs (its own probe build) and the scene-13 cable inputs of phases
     11 and 18 (lane-shared and per-lane), at B = 1024, cycles a lane by
     phase, and the probe build's own time;
 26. the default route (use_kernel=None) at shapes and kind mixes that no
     fixed library holds, at B = 1024 and a ragged 1000: scene 0 (5, 3),
     scene 12 (2, 2, springs), scene_chain(8) with lane-shared and with
     per-lane params, chain-ground-6 with a spring-damper (contacts and
     springs), a universal chain with a contact
     on each link, the randomized contact solve in guarded3 (per-lane
     params and a robust mode) and reference case 6's Euler rollout on
     dual_pgs ((n, m) = (2, 1), the QP's design by its shape rule): each
     case's design (every chord case the cooperative one, asserted: the
     kind mixes too), its build's nvcc seconds and
     ptxas line, a short rollout on the route with its launch count, the
     kernel against its plain version (compare_kernel's tolerances and
     shares; the QP's x and lambda, and its rollout against float64), timed
     in a CUDA graph beside its thread-per-lane build (ptxas of both);
 27. the scene zoo, every scene of redmax_tpu/scenes.py under BDF2 and
     BDF1: (1) scenes 1-5, 14, -2, -1, 100, scene_tree, scene_bridge and
     scene_umbrella at B = 1024, f32, lanes at the initial state with
     q + 1e-2 N(0, 1), one rollout of the scene's own nsteps on the default
     route (make_bdf2_step_batched): the design takes_coop picks (the
     cooperative one for every scene, asserted; the umbrella's record sized
     for its six springs, and timed beside its thread-per-lane build),
     nsteps - 1 launches of it a rollout and none of the
     other, steps/s (CUDA events, 3 rollouts after a warm-up), finite_frac,
     the final q within 1e-3 of scale of the f64 op-level rollout on 95% of
     lanes; on the states after the rollout the kernel against its plain
     version by compare_kernel (scene 14: a census of the lanes past and
     within 1e-5 of a joint limit), timed with its bound; (2) the same
     scenes through make_bdf1_step (op level) for min(nsteps, 50) steps,
     the same checks against f64;
     (3) scenes 7 and 9 on Euler charts, BDF2 and BDF1: supports() false,
     no chord launch, the final charts equal to the f64 run's on 95% of
     lanes, the lanes that switched counted; (4) the energy certificates in
     f64 on the card, one lane, |H - Hexpected| <= 1e-2: BDF1 and BDF2 of
     scenes 1-5, 14, 7 and 9 (Euler charts), BDF1 of 0, 6, 8, 10, 12 and 13
     (scene 11's 1200 steps left out), in a pool of processes on the card
     with the Euler-chart scenes' f64 references, while (5) scene 100's
     adjoint MPC
     (mpc.make_mpc_solver, Adam, 10 steps, BDF1 and BDF2) in f64: the
     objective falls and the gradient lies within 1e-6 of scale of the CPU's;
 28. the feature-rich zoo (redmax_tpu/scenes_matlab.py) under the linearly
     implicit Euler tier: every case but the friction ones (27-31, 33) and
     the two that read the reference's OBJ meshes (26, 34), each through
     make_euler_step_batched and make_simulate with its scene function, at
     B = 1024 (lane 0 at the initial state, lanes 1.. with qdot0 +
     1e-3 N(0, 1)): the full nsteps in float64, lane 0's energy certificate
     |H - Hexpected["euler"]| <= 1e-2; min(nsteps, 100) steps in float32
     on the default route, timed (steps/s), no chord launch and K2 launched
     once a step on mscene 6's joint limit (n, m) = (2, 1), none elsewhere;
     each float32 step from the float64 run's state within 1e-3 of scale of
     the float64 step on >= 95% of lanes at every step; K2 against its plain
     version on mscene 6's QPs after the rollout and at its steps; prints
     mscene_zoo;
 29. the explicit and O(n) tiers and sampling MPC (phase_explicit_tiers):
     (1) the ode45 energy certificates of tests/test_ode45.py (19 cases;
     not 26 and 34, whose OBJ files the repository lacks) through
     explicit.simulate_ode45, dense and recursive (mscene 12 dense only), in
     float64 at B = 1024 (lane 0 at the initial state, lanes 1.. with qdot0
     + 1e-3 N(0, 1)), lane 0's |H - cert| within 1e-2 (5e-2 for mscenes 19
     and 21), the recursive run's final state within 1e-6 of scale of the
     dense run's on >= 95% of lanes (19 and 21 reported only), scene 5's
     time-varying torques (|H - 160.8208| <= 1e-2), mscenes 15 and 22 in
     float32 within 1e-3 of scale of float64 on >= 95% of lanes (mscene
     0's chaotic chain: the share printed); each
     case's controller iterations, accepted lane-steps and rate; in a pool
     of ODE45_WORKERS processes on the card (after (3) and (2)'s float32
     rates, which run alone) while this process runs (2) the PCG tier
     (pcg.make_euler_pcg_step) in float64 one step from each state of a
     20-step dense Euler run at B = 1024: chain-30 (no damping) qdot
     within 1e-8 of the dense step in <= 3 CG iterations, mscene 15 (loop,
     Schur complement, tol 1e-12) within 1e-8, chain-120 within 1e-6 of
     scale; in float32 (tol PCG_F32_TOL) chain-30 and chain-120 timed
     beside the dense Euler step, chain-30 within 1e-3 of scale of float64
     on >= 95% of lanes, chain-120's share printed (float32 is off float64
     in both tiers there), no lane at maxit; and (3) MPPI
     (mpc.make_mppi_solver_batched) at the main path's configuration, 1024
     candidates as the lanes of make_objective_batched: 49 launches of the
     chord kernel's cooperative design a solve and none of the other, the
     costs within rtol 1e-3 of the op-level route's on >= 99% of the same
     candidates, the update within 1e-3 of scale, the mean cost not above
     p0's; MPPI solves/s; at sigma 0.3 the failure masking; prints
     explicit_tiers;
 30. the friction zoo (phase_friction_zoo): mscenes 27-31 and 33 through
     make_step("euler_fric") (staggered projections, friction.py) and
     make_simulate (scene_fn_33 for 33): (1) float64 for the full nsteps at
     B = FRIC_B64 (mzoo_state0 lanes), lane 0's certificate in the band of
     tests/test_friction.py (1e-2 absolute for 28, 29, 31; 7%, 15% and 3%
     relative for 27, 30, 33), the staggered-projections iterations of each
     step (max and mean over lanes) printed; (2) float32 at B = 1024 for
     min(nsteps, 50) steps (2 for the 4-bars 30 and 33), timed (CUDA events
     after a warm step), finite
     share, the K3 kernel (pgs_kernel.pgs_sweeps, csrc/pgs_sweeps.cu: the
     port's own, replacing the op-level sweeps) launched once for each sweep
     solve of the rollout, by the design pgs_kernel.design_of routes it to
     (one thread a lane for the dual QPs, a warp a lane with one triangle of
     the symmetric D for the friction passes), never by the earlier warp
     design and never on the CPU, the per-step share against float64 held
     at 0.95; (3) K3 against its plain version (qp.pgs_sweeps) on real
     solves at 3000 sweeps and 1024 lanes, float64 and float32: mscene 27's
     and mscene 30's friction passes (T^T b within 1e-10 / 2e-4 of scale)
     and mscene 33's first QP (x), each with a lane not active and a NaN
     lane, in the routed launch, the warp design's other store and the
     earlier warp design (k3_variants), each timed (5 launches in a CUDA
     graph, 50 at m <= 8, and CUDA events) beside the plain version and the
     bound, with ns and cycles a row update (the SM clock nvidia-smi reads
     under the routed launch), shared memory, lanes an SM, waves at 1024 and
     ptxas registers and spills; and K3 past the zoo's widths (k3_wide:
     m = 200 on a synthetic dual, symmetric and not, float64 and float32,
     where float64's transpose does not fit a block's shared memory) held
     and timed the same way at 100 sweeps;
     prints friction_zoo;
 31. the last modules (phase_last_modules): (1) the L-BFGS MPC solve
     (mpc.make_mpc_solver(method="lbfgs"), 3 iterations) at bench.py's
     scale on the chord kernel (K1a), timed by metrics.bench_throughput,
     49 launches an evaluation, the median objective before and after, the
     objective at the returned P against the float64 op-level route, the
     optimizer on the card against the CPU; (2) parallel.py on a world of
     one (NCCL, a FileStore): sharded_mpc_batched over the main path's
     Adam solve at
     B = 1024 bit for bit the unsharded solve, its mean the finite-lane
     mean, and __graft_entry__.py's two legs; (3) 6 Adam iterations of the
     main path through checkpoint.checkpointed_run, stopped after 3 and
     resumed, bit for bit the uninterrupted run; (4) tests/test_io.py:16's
     text scene through sceneio.load_scene_text, 50 BDF2 steps at B = 1024
     on the default route, lane 0's energy drift, its OBJ, HTML and JSON
     exports; prints lbfgs_path and sharded_path;
 32. print the kernels line (every row with its design, threads a lane and
     lanes a block; the cooperative rows, the QP's among them, with the
     thread-per-lane build's time of this run), the paths' lines
     (robust_path, backward_modes, coop_phases, scene_zoo, mscene_zoo,
     explicit_tiers, friction_zoo, lbfgs_path and sharded_path among them),
     the card's name and power limit, and the result line.

Every MPC path, the cable rollout and the per-lane rollouts read the launch
counter of the chord kernel design the wrapper routes them to (design_of)
and require none of the other; the FREE3D rollout counts both designs'
launches; the Euler paths read the QP's two counters.
"""

import ctypes
import dataclasses
import functools
import importlib.util
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from redmax_tpu_torch import (checkpoint, chord_kernel, explicit, export, forces, friction,
                              integrators, metrics, model, mpc, parallel, pcg, pgs_kernel, qp,
                              qp_kernel, sceneio, scenes_matlab)
from redmax_tpu_torch.kernel_build import KernelBuild
from redmax_tpu_torch.euler import DEFAULT_CHART
from redmax_tpu_torch.scenes import (SCENES, build_scene, scene_00_serial_chain,
                                     scene_07_spherical, scene_09_free3d, scene_12_spring_damper,
                                     scene_13_cables, scene_bridge, scene_chain,
                                     scene_chain_ground, scene_floor_chain, scene_qdep_chain,
                                     scene_spring_chain, scene_tree, scene_umbrella)
from redmax_tpu_torch.scenes_matlab import build_mscene
from redmax_tpu_torch.types import State, lanewise

# H100 SXM peaks at its 700 W limit (NVIDIA data sheet): f32 outside the
# tensor cores, and HBM3 bandwidth.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
CFG = integrators.NewtonConfig(fixed_iters=3, predictor="quadratic", chord=True,
                               hessian="structured", linsolve="gj")
# The cooperative chord kernel built again with its phase probe: a
# measurement only, never a route of the wrapper.
COOP_PROBE = KernelBuild("chord_bdf2_coop_probe", chord_kernel.BUILD_COOP.sources,
                         defines=("-DCHORD_COOP_PROBE",))


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


def graph_ms(fn, reps: int) -> float:
    """Mean device time of fn() over reps calls captured in one CUDA graph,
    so that no host time falls between the launches (a kernel shorter than
    the wrapper's host work a call would otherwise be timed at that work's
    rate): one warm call, two warm replays, one timed."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(reps):
            fn()
    graph.replay()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def reset_launches() -> None:
    """Set the chord kernel's launch counters (both designs) to 0."""
    chord_kernel.chord_bdf2_launches = chord_kernel.chord_bdf2_coop_launches = 0


def launches_of(design=None) -> int:
    """Chord kernel launches since reset_launches: of one design
    ("cooperative" or "thread_per_lane"), or of both (None)."""
    coop, lane = chord_kernel.chord_bdf2_coop_launches, chord_kernel.chord_bdf2_launches
    return {"cooperative": coop, "thread_per_lane": lane, None: coop + lane}[design]


def design_of(sc, params, cfg=CFG) -> str:
    """The chord kernel design the wrapper routes this scene, params and
    solve mode to (chord_kernel.scene_build's shape rule, decided before
    anything is built)."""
    build = chord_kernel.scene_build(sc.topo, sc.force_fns, params, cfg)
    return "cooperative" if chord_kernel.is_coop(build) else "thread_per_lane"


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


def mode_of(cfg) -> str:
    """The solve mode of a fixed-iteration config: chord, rehess (H re-built
    at every iterate), guarded, guarded_rehess or guard_last."""
    if cfg.guarded:
        return "guarded" if cfg.chord else "guarded_rehess"
    if cfg.guard_last:
        return "guard_last"
    return "chord" if cfg.chord else "rehess"


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


def ptxas_of(build, kinds, topo):
    """(registers, frame bytes, spill stores, spill loads) of the kernel of
    (N, nr, kinds) in build's ptxas report (the most registers where the
    unit holds several kernels of that key), or None where the report has
    none (a library loaded from an earlier run's cache)."""
    key = f"<{topo.njoints},{topo.nr},{kinds}>"
    found = [k[1:] for k in ptxas_kernels(build.ptxas_report or "") if k[0] == key]
    return max(found) if found else None


def time_chord_kernel(sc, params, states, max_abs_err, label, cfg=CFG, both_designs=True):
    """The kernel record fields at one scene's shapes in the solve mode of
    cfg: launch time (device time of 200 launches in a CUDA graph,
    graph_ms; and events_ms, CUDA events over 200 back-to-back launches,
    the way earlier runs timed it), the wrapper's with its layout copies,
    the plain version's, and the bound. Where the wrapper runs the
    cooperative design, also its layout and (both_designs) the
    thread-per-lane build of the same shape, timed in turns with it
    (cooperative, thread-per-lane, thread-per-lane, cooperative), with each
    build's ptxas registers, frame and spills (ptxas_of)."""
    B = states[0].shape[0]
    fns = sc.force_fns
    args = chord_kernel.pack(sc.topo, params, *states, fns)
    coop = design_of(sc, params, cfg) == "cooperative"
    ms = graph_ms(lambda: chord_kernel.launch(sc.topo, cfg, *args), reps=200)
    events_ms = cuda_ms(lambda: chord_kernel.launch(sc.topo, cfg, *args), reps=200)
    design = {"design": "thread_per_lane", "threads_per_lane": 1, "lanes_per_block": 32}
    if coop:
        lib = chord_kernel._build_lib(chord_kernel.scene_build(sc.topo, fns, params, cfg))
        kinds = chord_kernel.kinds_of(sc.topo, args[8], args[9] is not None,
                                      chord_kernel.is_robust(cfg))
        design = {"design": "warp_per_lane", "threads_per_lane": 32,
                  "lanes_per_block": lib.chord_bdf2_coop_lanes_per_block(
                      sc.topo.njoints, sc.topo.nr, kinds)}
    if coop and both_designs:
        prev = lambda: chord_kernel.launch(sc.topo, cfg, *args, thread_per_lane=True)
        prev_ms = (graph_ms(prev, reps=200) + graph_ms(prev, reps=200)) / 2
        ms = (ms + graph_ms(lambda: chord_kernel.launch(sc.topo, cfg, *args), reps=200)) / 2
        lane_build = chord_kernel.scene_build(sc.topo, fns, params, cfg, thread_per_lane=True)
        design.update(prev_design="thread_per_lane", prev_design_ms=prev_ms,
                      ptxas=ptxas_of(chord_kernel.scene_build(sc.topo, fns, params, cfg),
                                     kinds, sc.topo),
                      prev_ptxas=ptxas_of(lane_build, kinds, sc.topo))
        print(f"chord_bdf2 at {label}, B {B}: cooperative (a warp a lane, "
              f"{design['lanes_per_block']} lanes a block) {ms:.4f} ms, thread-per-lane "
              f"{prev_ms:.4f} ms (in turns, this run): {prev_ms / ms:.2f}x")
    wrap_ms = cuda_ms(lambda: chord_kernel.chord_bdf2(sc.topo, cfg, params, *states, fns), 100)
    plain_ms = cuda_ms(lambda: chord_kernel.chord_bdf2_reference(
        sc.topo, cfg, params, *states, fns), reps=50)
    contacts, springs, cables = chord_kernel.closure_spec(sc.topo, fns)
    flops = lane_flops(sc.topo, cfg.fixed_iters, len(contacts), springs, cables,
                       mode_of(cfg)) * B
    nbytes = 4 * B * (6 * sc.topo.nr + sc.topo.nr + sc.topo.nr ** 2) + sum(
        a.numel() * a.element_size() for a in (*args[6:8], args[9]) if a is not None)
    t_ops, t_bytes = flops / PEAK_F32_FLOPS * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
    bound = max(t_ops, t_bytes)
    print(f"chord_bdf2[{mode_of(cfg)}] at {label}, {args[8]}, B {B}: kernel {ms:.4f} ms "
          f"(CUDA events over back-to-back launches {events_ms:.4f} ms), wrapper with "
          f"layout copies {wrap_ms:.4f} ms, plain {plain_ms:.4f} ms; {flops / B:.0f} flops/lane, "
          f"{nbytes} bytes; bound {bound * 1e3:.3f} us "
          f"({'operations' if t_ops >= t_bytes else 'bytes'}), kernel at {bound / ms:.2%} of it")
    return {"max_abs_err": max_abs_err, "ms": ms, "events_ms": events_ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            **design}


def phase_kernel_vs_plain(device="cuda", cases=((12, 1024), (12, 1000), (12, 997), (4, 1024))):
    """Kernel vs chord_bdf2_reference on the card (the cooperative design,
    B = 997 leaving the last block partial); returns the kernel record
    fields measured at the main path's shapes (the first case)."""
    record = {}
    for nlinks, B in cases:
        sc = scene_chain(nlinks).compile(dtype=torch.float32, device=device)
        sc64 = scene_chain(nlinks).compile(dtype=torch.float64, device=device)
        states, tau = rand_states(sc.topo.nr, B, seed=1, device=device)
        params = {**sc.params, "tau": tau}
        reset_launches()
        x, hinv = chord_kernel.chord_bdf2(sc.topo, CFG, params, *states)
        if launches_of("cooperative") != 1 or launches_of() != 1:
            raise AssertionError(f"chain {nlinks}: the wrapper did not launch the cooperative "
                                 "design once")
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


def bench_inputs(nr, B, device, dtype, sigma=3.0):
    """bench.py's inputs: seed 0, p0 = sigma/1e3 N(0,1) (sigma = 3 there;
    benchmarks/robust_mode.py also runs 6), targets U(-2, 2)."""
    rng = np.random.default_rng(0)
    p0 = torch.tensor(sigma / 1e3 * rng.normal(size=(B, nr)), dtype=dtype, device=device)
    targets = torch.tensor(rng.uniform(-2.0, 2.0, size=(B, 3)), dtype=dtype, device=device)
    return p0, targets


def chain_ground(nlinks, mu=0.5, floor_z=-0.06):
    """benchmarks/bench_contact.py's scene: a contact on every link, the links'
    bottom corners 0.01 above the floor."""
    return scene_chain_ground(nlinks=nlinks, kn=100.0, kt=0.1, kd=10.0, mu=mu, h=1e-2,
                              floor_z=floor_z)


def mpc_solver(sc, horizon, use_kernel=None, cfg=CFG, backward="reuse"):
    task = mpc.PointPosTask(body=sc.topo.njoints - 1, wp=1.0, wreg=1e-6, pscale=1e3)
    obj = mpc.make_objective_batched(sc.topo, sc.force_fns, task, (0.5, 0.0, 0.0), horizon,
                                     cfg, use_kernel=use_kernel, backward=backward)
    return mpc.make_mpc_solver_batched(obj, iters=1, lr=0.05), obj


def timed_solves(solve, args, horizon, reps, design):
    """reps calls of the MPC solve solve(*args) after a warm one, the launch
    counts set to 0 before them and checked after (horizon - 1 a solve on
    design's counter, none on the other's): (launches, seconds per solve by
    CUDA events, by the host clock, the last result). Resets the
    peak-memory count before them."""
    res = solve(*args)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(reps):
        res = solve(*args)
    end.record()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / reps
    launches = launches_of(design)
    if launches != (horizon - 1) * reps or launches_of() != launches:
        raise AssertionError(f"chord_bdf2 launched {launches} times in {reps} solves on its "
                             f"{design} design ({launches_of()} in all), want {horizon - 1} "
                             "per solve")
    return launches, start.elapsed_time(end) / 1e3 / reps, wall, res


def phase_mpc_path(name, scene, device="cuda", nlinks=12, horizon=50, B=1024, reps=3,
                   draws=None, cfg=CFG, sigma=3.0, min_finite=0.95, design=None):
    """The batched MPC solve of bench.py:53-105 (scene = scene_chain), of
    benchmarks/bench_contact.py:44-105 (scene = chain_ground),
    bench_spring_ab.py:41-105 or qdep_ablation.py:68-102 (scene = uni6,
    sph4) on the port, with the scene's params, or per lane as
    draws(params, force_fns, B) gives them, in the solve mode of cfg
    (robust_mode.py:40-140 runs guard_last, guarded3 and chord=False) at
    the torque scale sigma; returns (kernel launches of the timed solves,
    solves/s, finite_frac). min_finite None holds the finite share to the
    op-level routes' (the masks agree on 99% of lanes) instead of a floor.
    design, where given, is the chord kernel design the path must run on."""
    sc = scene(nlinks).compile(dtype=torch.float32, device=device)
    sc64 = scene(nlinks).compile(dtype=torch.float64, device=device)
    params, params64 = sc.params, sc64.params
    if draws is not None:
        params, params64 = (draws(c.params, c.force_fns, B) for c in (sc, sc64))
    solve, _ = mpc_solver(sc, horizon, cfg=cfg)
    p0, targets = bench_inputs(sc.topo.nr, B, device, torch.float32, sigma)
    s0 = State(q=sc.state0.q.expand(B, -1).contiguous(),
               qdot=sc.state0.qdot.expand(B, -1).contiguous())

    routed = design_of(sc, params, cfg)
    if design is not None and routed != design:
        raise AssertionError(f"{name}: routed to the {routed} design, want {design}")
    launches, dt, wall, res = timed_solves(solve, (params, p0, s0, targets), horizon, reps,
                                           routed)
    finite = torch.isfinite(res.objective)
    finite_frac = float(finite.float().mean())
    peak = torch.cuda.max_memory_allocated()
    print(f"{name}: {B / dt:.2f} solves/s ({dt * 1e3:.3f} ms per solve by CUDA events, "
          f"{wall * 1e3:.3f} ms host clock), finite_frac {finite_frac:.4f}, "
          f"kernel launches {launches // reps} per solve ({routed} design), "
          f"peak memory {peak / 2**20:.1f} MiB")
    if res.objective.shape != (B,) or res.p.shape != (B, sc.topo.nr):
        raise AssertionError(f"{name}: unexpected output shapes")
    if min_finite is not None and finite_frac < min_finite:
        raise AssertionError(f"{name}: finite_frac {finite_frac} < {min_finite}")
    if not torch.isfinite(res.p[finite]).all():
        raise AssertionError(f"{name}: non-finite update on a finite lane")

    # where the time goes inside one solve (CUDA events around each phase)
    step = integrators.make_bdf2_step_batched(sc.topo, sc.force_fns, cfg, differentiable=True)
    params = {**params, "tau": (1e3 * p0).requires_grad_(True)}
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
    # the post-step reparam of the 49 inner steps, on the last state (with the
    # autograd graph it builds inside a solve)
    for _ in range(2):
        torch.cuda.synchronize()
        ev[0].record()
        for _ in range(horizon - 1):
            model.reparam_all(sc.topo, params, s.q, s.qdot)
        ev[1].record()
        torch.cuda.synchronize()
    print(f"{name}, one solve by phase: bootstrap {split[0]:.3f} ms, {horizon - 1} inner steps "
          f"(kernel route forward) {split[1]:.3f} ms, adjoint backward {split[2]:.3f} ms; "
          f"post-step reparam_all x {horizon - 1} (inside the inner steps) "
          f"{ev[0].elapsed_time(ev[1]):.3f} ms")

    # The same solve on the op-level route, in float32 and in float64: the
    # objective agrees to rtol 1e-3 on at least 99% of the lanes finite in
    # both. The max over ~1000 lanes is not held: a few sensitive lanes
    # drift by ~1e-3 over 50 steps in any float32 rollout (the float32
    # op-level route against float64 too), and it is printed.
    solve_plain, _ = mpc_solver(sc, horizon, use_kernel=False, cfg=cfg)
    solve64, _ = mpc_solver(sc64, horizon, use_kernel=False, cfg=cfg)
    reset_launches()
    ref32 = solve_plain(params, p0, s0, targets).objective
    ref64 = solve64(params64, p0.double(), State(q=s0.q.double(), qdot=s0.qdot.double()),
                    targets.double()).objective
    torch.cuda.synchronize()
    if launches_of() != 0:
        raise AssertionError("op-level route launched the kernel")

    def compare(obj, ref, name):
        fin, fin_ref = torch.isfinite(obj), torch.isfinite(ref)
        agree = float((fin == fin_ref).float().mean())
        both = fin & fin_ref
        rel = (obj[both].double() - ref[both].double()).abs() / ref[both].double().abs()
        within = float((rel <= 1e-3).double().mean())
        q = torch.quantile(rel, torch.tensor([0.5, 0.99], dtype=rel.dtype, device=rel.device))
        top = torch.topk(rel, min(3, rel.numel()))
        worst = ", ".join(f"lane {int(both.nonzero()[i])} {float(v):.3e}"
                          for v, i in zip(top.values, top.indices))
        print(f"{name}: finite masks agree on {agree:.4f} of lanes; objective rel diff median "
              f"{float(q[0]):.3e}, p99 {float(q[1]):.3e}, max {float(rel.max()):.3e}; "
              f"{within:.4f} of {int(both.sum())} lanes within 1e-3; worst: {worst}")
        return agree, within, float(rel.max())

    checks = [compare(res.objective, ref32, "kernel route vs op-level f32"),
              compare(res.objective, ref64, "kernel route vs op-level f64")]
    compare(ref32, ref64, "op-level f32 vs op-level f64")
    if any(agree < 0.99 or within < 0.99 for agree, within, _ in checks):
        raise AssertionError(f"{name}: kernel route and op-level route disagree")
    return launches, B / dt, finite_frac


def phase_small_reference(name, scene, device="cuda", nlinks=4, horizon=5, B=64, draws=None,
                          cfg=CFG, rejects_ok=False):
    """A small solve on the card (f32, kernel route) against the same solve
    on the CPU in float64 (the plain version, held to redmax_tpu by the
    tests), with per-lane params where draws gives them (as in
    phase_mpc_path), in the solve mode of cfg. Every lane must be finite,
    or with rejects_ok (a guard that rejects lanes by design) the finite
    masks equal."""
    out = {}
    for dev, dtype in ((device, torch.float32), ("cpu", torch.float64)):
        sc = scene(nlinks).compile(dtype=dtype, device=dev)
        params = sc.params if draws is None else draws(sc.params, sc.force_fns, B)
        solve, _ = mpc_solver(sc, horizon, cfg=cfg)
        p0, targets = bench_inputs(sc.topo.nr, B, dev, dtype)
        s0 = State(q=sc.state0.q.expand(B, -1).contiguous(),
                   qdot=sc.state0.qdot.expand(B, -1).contiguous())
        out[dev, dtype] = solve(params, p0, s0, targets).objective.double().cpu()
    card, cpu = out[device, torch.float32], out["cpu", torch.float64]
    fin = torch.isfinite(cpu)
    err = float((card[fin] - cpu[fin]).abs().max() / cpu[fin].abs().max())
    print(f"{name}, small solve, card f32 vs CPU f64: max objective diff {err:.3e} of scale "
          f"on {int(fin.sum())} of {B} lanes finite on the CPU")
    if not torch.equal(torch.isfinite(card), fin) or not (rejects_ok or fin.all()) or err > 1e-3:
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


def reset_qp_launches() -> None:
    """Set the dual-PGS kernel's launch counters (both designs) to 0."""
    qp_kernel.dual_pgs_launches = qp_kernel.dual_pgs_coop_launches = 0


def qp_launches():
    """(cooperative, thread-per-lane) dual-PGS launches since
    reset_qp_launches."""
    return qp_kernel.dual_pgs_coop_launches, qp_kernel.dual_pgs_launches


def phase_qp_kernel_vs_plain(device="cuda", B=1024):
    """dual_pgs vs dual_pgs_reference on the card at both instantiated shapes,
    through the default route (the cooperative design: one launch a call,
    none of the other design); a NaN lane at (6, 12); returns the kernel
    record fields measured at the path's shape (6, 12)."""
    # (a) well-posed random QPs at (6, 8): lambda is unique, so it is held too
    for Bq in (B, B - 24):
        qps = random_qps(Bq, 6, 1, 4, 3, seed=11, device=device)
        reset_qp_launches()
        x, lam = qp_kernel.dual_pgs(*qps, iters=PGS_ITERS, reg=PGS_REG)
        if qp_launches() != (1, 0):
            raise AssertionError(f"dual_pgs (6, 8) B {Bq}: launches (cooperative, thread per "
                                 f"lane) {qp_launches()}, want (1, 0)")
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
    reset_qp_launches()
    x, lam = qp_kernel.dual_pgs(*qps, iters=PGS_ITERS, reg=PGS_REG)
    if qp_launches() != (1, 0):
        raise AssertionError(f"dual_pgs (6, 12): launches {qp_launches()}, want (1, 0)")
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

    # a NaN lane stays in its lane
    poisoned = [a.clone() for a in qps]
    poisoned[1][5, 0] = float("nan")
    xp, lamp = qp_kernel.dual_pgs(*poisoned, iters=PGS_ITERS, reg=PGS_REG)
    keep = torch.ones(B, dtype=torch.bool, device=x.device)
    keep[5] = False
    same = lambda a, b: torch.equal(a.isnan(), b.isnan()) and torch.equal(
        torch.nan_to_num(a), torch.nan_to_num(b))
    if not torch.isnan(xp[5]).any() or not same(xp[keep], x[keep]) \
            or not same(lamp[keep], lam[keep]):
        raise AssertionError("dual_pgs (6, 12): a NaN lane did not stay NaN, or changed another "
                             "lane")
    print("dual_pgs (6, 12): NaN lane kept, other lanes bit-equal")
    return time_qp_kernel(qps, dxk, "(6, 12)")


def time_qp_kernel(qps, max_abs_err, label):
    """The kernel record fields of dual_pgs on the QPs qps: launch time (200
    launches in a CUDA graph, graph_ms; and events_ms, CUDA events over 200
    back-to-back launches, the only timing before), the wrapper's, the
    plain version's, and the bound. Where the wrapper runs the cooperative
    design, also the thread-per-lane build of the same shape, timed in turns
    with it (cooperative, thread-per-lane, thread-per-lane, cooperative),
    each design's wrapper (the cooperative one reads the callers' arrays,
    the thread-per-lane one makes pack's [P, B] copies and transposes the
    outputs back) and the cooperative design's layout."""
    B, n = qps[1].shape
    m = qps[2].shape[1]
    packed = qp_kernel.pack(*qps)
    prev = lambda: qp_kernel.launch(*packed, PGS_ITERS, PGS_REG, thread_per_lane=True)
    design = {"design": "thread_per_lane", "threads_per_lane": 1, "lanes_per_block": 32}
    wrap_ms = cuda_ms(lambda: qp_kernel.dual_pgs(*qps, iters=PGS_ITERS, reg=PGS_REG), reps=100)
    if qp_kernel.takes_coop(n, m):
        cur = lambda: qp_kernel.launch(*qps, PGS_ITERS, PGS_REG)
        ms = graph_ms(cur, reps=200)
        prev_ms = (graph_ms(prev, reps=200) + graph_ms(prev, reps=200)) / 2
        ms = (ms + graph_ms(cur, reps=200)) / 2
        events_ms = cuda_ms(cur, reps=200)
        prev_events_ms = cuda_ms(prev, reps=200)
        prev_wrap_ms = cuda_ms(lambda: [a.t() for a in qp_kernel.launch(
            *qp_kernel.pack(*qps), PGS_ITERS, PGS_REG, thread_per_lane=True)], reps=100)
        threads, lanes, smem = qp_kernel.coop_layout(n, m)
        design = {"design": "group_per_lane", "threads_per_lane": threads,
                  "lanes_per_block": lanes, "prev_design": "thread_per_lane",
                  "prev_design_ms": prev_ms, "prev_design_events_ms": prev_events_ms,
                  "prev_design_wrapper_ms": prev_wrap_ms}
        print(f"dual_pgs at {label} {(n, m)}, B {B}: cooperative ({threads} threads a lane, "
              f"{lanes} lanes a block, {smem} bytes of shared memory a block) {ms:.4f} ms, "
              f"thread-per-lane {prev_ms:.4f} ms (in turns, this run): {prev_ms / ms:.2f}x; "
              f"events {events_ms:.4f} and {prev_events_ms:.4f} ms; wrapper by design "
              f"{wrap_ms:.4f} and {prev_wrap_ms:.4f} ms")
    else:
        ms = graph_ms(prev, reps=200)
        events_ms = cuda_ms(prev, reps=200)
    plain_ms = cuda_ms(lambda: qp_kernel.dual_pgs_reference(*qps, iters=PGS_ITERS, reg=PGS_REG),
                       reps=5)
    flops = dual_pgs_flops(n, m, PGS_ITERS) * B
    nbytes = 4 * B * (n * n + n + m * n + 3 * m + n + m)
    t_ops, t_bytes = flops / PEAK_F32_FLOPS * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
    bound = max(t_ops, t_bytes)
    print(f"dual_pgs at {label} {(n, m)}, B {B}, {PGS_ITERS} sweeps: kernel {ms:.4f} ms (CUDA "
          f"events over back-to-back launches {events_ms:.4f} ms), wrapper "
          f"{wrap_ms:.4f} ms, plain {plain_ms:.4f} ms; {flops // B} flops/lane "
          f"({t_ops * 1e3:.3f} us), {nbytes} bytes ({t_bytes * 1e3:.3f} us); bound "
          f"{bound * 1e3:.3f} us, kernel at {bound / ms:.2%} of it; dependent chain "
          f"{PGS_ITERS * m} row updates per lane, {ms * 1e6 / (PGS_ITERS * m):.1f} ns each")
    return {"max_abs_err": max_abs_err, "ms": ms, "events_ms": events_ms, "plain_ms": plain_ms,
            "wrapper_ms": wrap_ms, "bound_ms": bound,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes", **design}


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
    reset_qp_launches()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(reps):
        final = sim(sc.params, s0)
    end.record()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / reps
    launches, lane_launches = qp_launches()
    dt = start.elapsed_time(end) / 1e3 / reps
    if launches != nsteps * reps or lane_launches != 0:
        raise AssertionError(f"dual_pgs launched its cooperative design {launches} times and "
                             f"the thread-per-lane one {lane_launches} times in {reps} "
                             f"rollouts, want {nsteps} and 0 per rollout")
    finite = torch.isfinite(final.q).all(-1) & torch.isfinite(final.qdot).all(-1)
    finite_frac = float(finite.float().mean())
    peak = torch.cuda.max_memory_allocated()
    print(f"euler path: {B * nsteps / dt:.1f} steps/s ({dt * 1e3:.3f} ms per {nsteps}-step rollout "
          f"by CUDA events, {wall * 1e3:.3f} ms host clock), finite_frac {finite_frac:.4f}, "
          f"kernel launches {launches // reps} per rollout (cooperative design; "
          f"thread-per-lane {lane_launches}), peak memory {peak / 2**20:.1f} MiB")
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
    reset_qp_launches()
    sim_op = integrators.make_simulate(integrators.make_euler_step_batched(
        sc.topo, (), sc.constraint_fns, pgs_iters=PGS_ITERS, use_kernel=False), nsteps)
    q32 = sim_op(sc.params, s0).q
    sc64 = scene_floor_chain(nlinks).compile(dtype=torch.float64, device=device)
    s64 = State(q=s0.q.double(), qdot=s0.qdot.double())
    q64 = sim_op(sc64.params, s64).q
    torch.cuda.synchronize()
    if qp_launches() != (0, 0):
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
    reset_qp_launches()
    card = rollout_q(loop, loop_states, device, torch.float32, nsteps)
    cpu = rollout_q(loop, loop_states, "cpu", torch.float64, nsteps)
    torch.cuda.synchronize()
    if qp_launches() != (0, 0):
        raise AssertionError("the equality branch launched the dual-PGS kernel")
    err, both = lane_err(card.cpu(), cpu)
    print(f"equality branch (loop closure, KKT), card f32 vs CPU f64: final q diff of scale "
          f"max {float(err.max()):.3e} over {int(both.sum())}/{B} lanes, 0 kernel launches")
    if int(both.sum()) != B or float(err.max()) > 1e-4:
        raise AssertionError("equality branch on the card disagrees with the CPU float64 rollout")


# ---------------------------------------------------------------------------
# The chord kernel with ground contacts
# ---------------------------------------------------------------------------


def rollout_states(sc, B, device, nsteps=8, seed=1, s0=None, base=None, sigma=3.0):
    """Chord-solve inputs on a path: the scene rolled nsteps from s0 (default:
    rest) on the op-level route under the main path's torques
    (tau = 1e3 * 0.003 N(0, 1); sigma N(0, 1) in general) and the scene's
    params (or base, per-lane ones), then the next inner step's history and
    predictor. Lanes the rollout rejected are replaced by lane 0's state."""
    rng = np.random.default_rng(seed)
    tau = torch.tensor(sigma * rng.normal(size=(B, sc.topo.nr)), dtype=torch.float32,
                       device=device)
    params = {**(sc.params if base is None else base), "tau": tau}
    step = integrators.make_bdf2_step_batched(sc.topo, sc.force_fns, CFG, use_kernel=False)
    s0 = sc.initial_state("bdf2", B) if s0 is None else integrators.bdf2_init(s0)
    s = integrators.make_simulate(step, nsteps)(params, s0)
    ok = (torch.isfinite(s.q) & torch.isfinite(s.qdot)).all(-1)
    fix = lambda a: torch.where(ok[:, None], a, a[ok][:1])
    q0, qd0, q1, qd1 = (fix(a) for a in (s.q_prev, s.qdot_prev, s.q, s.qdot))
    h = lanewise(params["h"], 2)
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


def compare_kernel(sc, sc64, params, states, label, min_ok=0.99, exclude=None, cfg=CFG,
                   mask_ok=1.0, info=None, plain_gap=False):
    """Kernel against the f32 plain version (x) and the f64 plain version
    (H^-1) lane by lane in the solve mode of cfg, on at least min_ok of the
    finite lanes that exclude (a [B] mask) leaves in, the finite masks equal
    on at least mask_ok of the lanes (a guard's accept test may fall either
    way between two float32 orders at a tie); returns (max |dx| over the
    lanes inside tolerance, x of the kernel). Per-lane params (and tau) are
    held in both plain versions as given; info, where given, receives the
    f32 plain version's newton info. In a guarded mode every lane on which
    that plain version took a half step or stayed put is held with no
    allowance: the finite mask and, where finite, x inside tolerance, of
    the f32 or of the f64 plain version (where the f32 one itself is off
    f64 by the tolerance, an f32 rounding, the kernel may be right);
    info["guard_seen"] counts those of them that end more than 50 times the
    tolerance from the unguarded solve (or with another finite mask), where
    a kernel that skipped the guard would fail.
    With chord=False, the lanes on which H^-1 at the last iterate differs
    from the chord mode's (H^-1 at the predictor) by more than twice the
    tolerance must be at least a tenth of the lanes, and on every one of them
    the kernel's H^-1 must lie nearer the former.
    plain_gap: a lane whose H^-1 (kernel's or the f32 plain version's)
    misses 2e-5 of scale from f64 where cond(H) times the float32 unit
    roundoff exceeds 2e-5 (no float32 order can promise 2e-5 there) is held
    by quantiles instead, as phase 5 holds the QP: over those lanes the
    kernel's distance from f64 no more than twice the plain version's at
    the median and the 95% quantile (the lanes counted and printed)."""
    fns, B = sc.force_fns, states[0].shape[0]
    info = {} if info is None else info
    x, hinv = chord_kernel.chord_bdf2(sc.topo, cfg, params, *states, fns)
    x_ref, hinv_ref = chord_kernel.chord_bdf2_reference(sc.topo, cfg, params, *states, fns,
                                                        info=info)
    _, lanes = integrators.split_batched_params(params)   # tau and any per-lane param
    p64 = integrators.merge_batched_params(sc64.params, to64(lanes))
    s64 = [a.double() for a in states]
    x64, hinv64 = chord_kernel.chord_bdf2_reference(sc64.topo, cfg, p64, *s64, sc64.force_fns)
    hinv_chord64 = None if cfg.chord else chord_kernel.chord_bdf2_reference(
        sc64.topo, dataclasses.replace(cfg, chord=True), p64, *s64, sc64.force_fns)[1]
    torch.cuda.synchronize()
    fin, fin_ref = torch.isfinite(x).all(-1), torch.isfinite(x_ref).all(-1)
    both = fin & fin_ref
    if float((fin == fin_ref).float().mean()) < mask_ok:
        bad = (fin != fin_ref).nonzero().flatten().tolist()
        raise AssertionError(f"{label}: finite masks differ on lanes {bad[:8]} ({len(bad)} lanes)")
    if not torch.equal(fin, fin_ref):
        print(f"{label}: finite masks differ on {int((fin != fin_ref).sum())} of {B} lanes "
              f"(held on {mask_ok})")
    if fin.float().mean() < 0.9:
        raise AssertionError(f"{label}: only {float(fin.float().mean())} finite")
    dx = ((x - x_ref).abs() / torch.clamp(x_ref.abs(), min=1.0)).amax(-1)
    hscale = float(hinv64[both].abs().max())
    dh = (hinv.double() - hinv64).abs().amax((-1, -2)) / hscale
    dh_plain = (hinv_ref.double() - hinv64).abs().amax((-1, -2)) / hscale
    held = both if exclude is None else both & ~exclude
    ill = torch.zeros_like(held)
    if plain_gap:
        cond = torch.linalg.cond(torch.linalg.inv(torch.where(
            both[:, None, None], hinv64, torch.eye(hinv64.shape[-1], dtype=hinv64.dtype,
                                                   device=hinv64.device))))
        ill = held & ((dh > 2e-5) | (dh_plain > 2e-5)) & (cond * 2.0 ** -24 > 2e-5)
    ok = held & (dx <= 5e-6) & ((dh <= 2e-5) | ill)
    if ill.any():
        qk, qp = quantiles(dh[ill]), quantiles(dh_plain[ill])
        print(f"{label}: on the {int(ill.sum())} held lanes whose H^-1 misses 2e-5 of scale from "
              f"f64 at cond(H) past 2e-5 / 2^-24 (max cond {float(cond[ill].max()):.3e}), kernel "
              f"p50 {qk[0]:.3e} p95 {qk[1]:.3e} against the f32 plain version's p50 {qp[0]:.3e} "
              f"p95 {qp[1]:.3e}")
        if qk[0] > 2.0 * qp[0] or qk[1] > 2.0 * qp[1]:
            raise AssertionError(f"{label}: the kernel's H^-1 is off f64 by more than twice the "
                                 "f32 plain version's")
    share = float(ok[held].float().mean())
    worst = int(torch.where(both, dx, torch.zeros_like(dx)).argmax())
    qx, qh = quantiles(dx[both]), quantiles(dh[both])
    print(f"kernel vs plain {label}: finite {int(fin.sum())}/{B}, {share:.4f} of the "
          f"{int(held.sum())} held inside "
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
    if "steps" in info:
        branch = (info["steps"] != 1.0).any(-1)
        fin64 = torch.isfinite(x64).all(-1)
        dx64 = ((x.double() - x64).abs() / torch.clamp(x64.abs(), min=1.0)).amax(-1)
        near = lambda f, d: (fin == f) & (~fin | ((d <= 5e-6) & (dh <= 2e-5)))
        bad = branch & ~(near(fin_ref, dx) | near(fin64, dx64))
        x_plain, _ = chord_kernel.chord_bdf2_reference(
            sc.topo, dataclasses.replace(cfg, guarded=False, guard_last=False), params, *states,
            fns)
        fin_plain = torch.isfinite(x_plain).all(-1)
        moved = ((x_ref - x_plain).abs() / torch.clamp(x_ref.abs(), min=1.0)).amax(-1)
        info["guard_seen"] = seen = int((branch & ((fin_ref != fin_plain) | (
            fin_ref & fin_plain & (moved > 2.5e-4)))).sum())
        print(f"{label}: {int(branch.sum())} lanes took a half step or stayed put, "
              f"{int((branch & ~fin_ref).sum())} of them rejected, {seen} of them ending more "
              "than 50 times the tolerance from the unguarded solve (or with another finite "
              f"mask); {int(bad.sum())} off both plain versions (tolerance or finite mask)")
        if bad.any():
            raise AssertionError(f"{label}: the kernel leaves its plain version on guard-branch "
                                 f"lanes {bad.nonzero().flatten().tolist()[:8]}")
    if hinv_chord64 is not None:
        d_modes = (hinv64 - hinv_chord64).abs().amax((-1, -2)) / hscale
        dc = (hinv.double() - hinv_chord64).abs().amax((-1, -2)) / hscale
        seen = both & (d_modes > 4e-5)
        nearer = seen & (dh < dc)
        print(f"{label}: H^-1 at the last iterate differs from the chord mode's by more than "
              f"4e-5 of scale on {int(seen.sum())}/{B} lanes (max {float(d_modes[both].max()):.3e})"
              f"; the kernel's lies nearer the last iterate's on {int(nearer.sum())} of them")
        if int(seen.sum()) < B // 10 or not torch.equal(nearer, seen):
            raise AssertionError(f"{label}: the kernel's H^-1 is not shown to be the last "
                                 "iterate's")
    return float(dx[ok].max()), x


def check_nan_lane(sc, params, states, x, cfg=CFG):
    """A NaN lane comes out NaN and leaves every other lane as it was."""
    B = states[0].shape[0]
    poisoned = [a.clone() for a in states]
    poisoned[3][5] = float("nan")
    xp, _ = chord_kernel.chord_bdf2(sc.topo, cfg, params, *poisoned, sc.force_fns)
    keep = torch.ones(B, dtype=torch.bool, device=x.device)
    keep[5] = False
    if not torch.isnan(xp[5]).all() or not torch.equal(xp[keep].isnan(), x[keep].isnan()) \
            or not torch.equal(torch.nan_to_num(xp[keep]), torch.nan_to_num(x[keep])):
        raise AssertionError("a NaN lane did not stay NaN, or changed another lane")


def phase_contact_kernel_vs_plain(device="cuda",
                                  cases=((12, 1024), (12, 1000), (12, 997), (4, 1024))):
    """The chord kernel with ground contacts against chord_bdf2_reference on
    the card (the cooperative design, B = 997 leaving the last block
    partial); returns the kernel record fields at the contact path's shapes
    (the first case)."""
    record = {}
    for nlinks, B in cases:
        sc = chain_ground(nlinks).compile(dtype=torch.float32, device=device)
        sc64 = chain_ground(nlinks).compile(dtype=torch.float64, device=device)
        states, params, kept = rollout_states(sc, B, device)
        census = corner_census(sc64, states)
        print(f"contact states chain-ground-{nlinks} B {B}: {kept}/{B} lanes from the rollout; "
              f"corners {json.dumps(census)}")
        if min(census["out"], census["static"], census["dynamic"]) == 0:
            raise AssertionError(f"chain-ground-{nlinks}: a contact regime is missing: {census}")
        if design_of(sc, params) != "cooperative":
            raise AssertionError(f"chain-ground-{nlinks}: not routed to the cooperative design")
        err, x = compare_kernel(sc, sc64, params, states, f"chain-ground-{nlinks} B {B}")
        if (nlinks, B) != cases[0]:
            continue
        record = time_chord_kernel(sc, params, states, err, f"chain-ground-{nlinks}")

        # mu = 0 is data, not a build option
        sc0 = chain_ground(nlinks, mu=0.0).compile(dtype=torch.float32, device=device)
        sc0_64 = chain_ground(nlinks, mu=0.0).compile(dtype=torch.float64, device=device)
        compare_kernel(sc0, sc0_64, {**sc0.params, "tau": params["tau"]}, states,
                       f"chain-ground-{nlinks} mu 0 B {B}")
        check_nan_lane(sc, params, states, x)
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


# ---------------------------------------------------------------------------
# The chord kernel with springs and with a cable; the cable rollout
# ---------------------------------------------------------------------------


def phase_spring_kernel_vs_plain(device="cuda", cases=(1024, 1000, 997)):
    """The chord kernel with the spring chain's three springs against
    chord_bdf2_reference on rollout states (the cooperative design, B = 997
    leaving the last block partial); returns the kernel record fields at the
    spring path's shapes (the first case). As in phase 8, at least 99% of
    the lanes: at some states of the 12-link spring chain the float32 plain
    version's own H^-1 is 2.2e-5 of scale from float64, just outside 2e-5 (a
    CPU rehearsal at B = 64), so a lane may fall outside on roundoff; every
    lane is printed in the share."""
    record = {}
    sc = scene_spring_chain(12).compile(dtype=torch.float32, device=device)
    sc64 = scene_spring_chain(12).compile(dtype=torch.float64, device=device)
    for B in cases:
        states, params, kept = rollout_states(sc, B, device)
        print(f"spring states spring-chain-12 B {B}: {kept}/{B} lanes from the rollout")
        if design_of(sc, params) != "cooperative":
            raise AssertionError("spring-chain-12: not routed to the cooperative design")
        err, x = compare_kernel(sc, sc64, params, states, f"spring-chain-12 B {B}")
        if B != cases[0]:
            continue
        check_nan_lane(sc, params, states, x)
        print(f"spring-chain-12 B {B}: NaN lane kept, other lanes bit-equal")
        record = time_chord_kernel(sc, params, states, err, "spring-chain-12")
    return record


def cable_lengths(sc64, q):
    """(l [B], L) of the scene's one cable at q, in float64."""
    fn = sc64.force_fns[0]
    fp = sc64.params["forces"][fn.key]
    kin = model.forward_kinematics(sc64.topo, sc64.params, q, torch.zeros_like(q))
    x, _, _, _ = forces.body_points(kin, None, fn.bodies, fp["xls"])
    return torch.linalg.vector_norm(x[:, 1:] - x[:, :-1], dim=-1).sum(-1), float(fp["L"])


def cable_states0(sc, B, device, dtype, seed=2):
    """The cable path's lanes: scene 13's initial state, q + 0.05 N(0, 1),
    qdot = 0.5 N(0, 1)."""
    rng = np.random.default_rng(seed)
    q = sc.state0.q.cpu().numpy()[None] + 0.05 * rng.normal(size=(B, sc.topo.nr))
    qd = 0.5 * rng.normal(size=(B, sc.topo.nr))
    return State(q=torch.tensor(q, dtype=dtype, device=device),
                 qdot=torch.tensor(qd, dtype=dtype, device=device))


def phase_cable_kernel_vs_plain(device="cuda", B=1024):
    """The chord kernel with scene 13's cable against chord_bdf2_reference on
    states 8 steps into the cable path's rollout; lanes within 1e-6 L of the
    gate at the predictor (where two float32 orders may disagree on l > L)
    are counted and left out of the tolerance; the wrapper runs the
    cooperative design there (its launches counted, none of the other
    design). Then the same states with L raised so that every lane is slack.
    Timed in turns with the thread-per-lane build. Returns the kernel record
    fields."""
    sc = scene_13_cables().compile(dtype=torch.float32, device=device)
    sc64 = scene_13_cables().compile(dtype=torch.float64, device=device)
    states, params, kept = rollout_states(sc, B, device,
                                          s0=cable_states0(sc, B, device, torch.float32))
    l, L = cable_lengths(sc64, states[0].double())
    near = (l - L).abs() <= 1e-6 * L
    census = {"taut": int((l > L).sum()), "slack": int((l <= L).sum()),
              "within_1e-6_L_of_the_gate": int(near.sum())}
    print(f"cable states scene-13 B {B}: {kept}/{B} lanes from the rollout; at the predictor "
          f"{json.dumps(census)} (L {L:.6f}, l - L median {float((l - L).median()):.3e})")
    if census["taut"] == 0:
        raise AssertionError(f"scene 13: no lane has its cable taut: {census}")
    if design_of(sc, params) != "cooperative":
        raise AssertionError("scene 13: not routed to the cooperative design")
    reset_launches()
    err, x = compare_kernel(sc, sc64, params, states, f"scene-13 B {B}", exclude=near)
    check_nan_lane(sc, params, states, x)
    if launches_of("cooperative") != 2 or launches_of() != 2:
        raise AssertionError(f"scene 13: {launches_of('cooperative')} cooperative launches "
                             f"({launches_of()} in all), want 2")
    print(f"scene-13 B {B}: NaN lane kept, other lanes bit-equal")
    record = time_chord_kernel(sc, params, states, err, "scene-13")

    # L is data: raised above every lane's length, the cable goes slack
    Ls = 2.0 * float(l.max())
    slack = {**params, "forces": {"f0": {**params["forces"]["f0"],
                                         "L": torch.tensor(Ls, device=device)}}}
    sc64.params["forces"]["f0"]["L"] = torch.tensor(Ls, dtype=torch.float64, device=device)
    if int((cable_lengths(sc64, states[0].double())[0] > Ls).sum()) != 0:
        raise AssertionError("scene 13 with L raised: a lane is still taut")
    compare_kernel(sc, sc64, slack, states, f"scene-13 slack B {B}")
    return record


def phase_cable_path(device="cuda", B=1024, nsteps=50, reps=3):
    """Scene 13's cable rollout on the kernel route, 49 launches a rollout of
    the cooperative design and none of the other; returns (kernel launches
    of the timed rollouts, steps/s, finite_frac)."""
    sc = scene_13_cables().compile(dtype=torch.float32, device=device)
    s0 = integrators.bdf2_init(cable_states0(sc, B, device, torch.float32))
    sim = integrators.make_simulate(
        integrators.make_bdf2_step_batched(sc.topo, sc.force_fns, CFG, use_kernel=True), nsteps)
    final = sim(sc.params, s0)  # warm-up
    torch.cuda.synchronize()
    reset_launches()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(reps):
        final = sim(sc.params, s0)
    end.record()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / reps
    launches = launches_of("cooperative")
    dt = start.elapsed_time(end) / 1e3 / reps
    if launches != (nsteps - 1) * reps or launches_of() != launches:
        raise AssertionError(f"chord_bdf2 launched its cooperative design {launches} times "
                             f"({launches_of()} in all) in {reps} rollouts, want {nsteps - 1} "
                             "per rollout")
    finite = torch.isfinite(final.q).all(-1) & torch.isfinite(final.qdot).all(-1)
    finite_frac = float(finite.float().mean())
    print(f"cable path: {B * nsteps / dt:.1f} steps/s ({dt * 1e3:.3f} ms per {nsteps}-step "
          f"rollout by CUDA events, {wall * 1e3:.3f} ms host clock), finite_frac "
          f"{finite_frac:.4f}, kernel launches {launches // reps} per rollout (cooperative "
          "design)")
    if final.q.shape != (B, sc.topo.nr) or finite_frac < 0.95:
        raise AssertionError(f"cable path: shape {tuple(final.q.shape)}, finite_frac {finite_frac}")
    sc64 = scene_13_cables().compile(dtype=torch.float64, device=device)
    l, L = cable_lengths(sc64, final.q[finite].double())
    print(f"cable path, last step: {int((l > L).sum())} lanes taut, {int((l <= L).sum())} slack")

    # where the time goes inside one rollout (CUDA events around each phase)
    step = integrators.make_bdf2_step_batched(sc.topo, sc.force_fns, CFG, use_kernel=True)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    for _ in range(2):  # the first pass warms the allocator; the second is timed
        torch.cuda.synchronize()
        ev[0].record()
        s = step.bootstrap(sc.params, s0)
        ev[1].record()
        for _ in range(nsteps - 1):
            s = step.inner(sc.params, s)
        ev[2].record()
        torch.cuda.synchronize()
    print(f"cable path, one rollout by phase: bootstrap {ev[0].elapsed_time(ev[1]):.3f} ms, "
          f"{nsteps - 1} inner steps (kernel route) {ev[1].elapsed_time(ev[2]):.3f} ms")

    reset_launches()
    sim64 = integrators.make_simulate(
        integrators.make_bdf2_step_batched(sc64.topo, sc64.force_fns, CFG, use_kernel=False),
        nsteps)
    q64 = sim64(sc64.params, integrators.bdf2_init(cable_states0(sc, B, device, torch.float64))).q
    torch.cuda.synchronize()
    if launches_of() != 0:
        raise AssertionError("op-level route launched the kernel")
    err, both = lane_err(final.q, q64)
    p50, _, p99, mx = quantiles(err)
    within = float((err <= 1e-3).double().mean())
    print(f"cable path vs op-level f64: final q diff of scale median {p50:.3e}, p99 {p99:.3e}, "
          f"max {mx:.3e}; {within:.4f} of {int(both.sum())} lanes within 1e-3")
    if within < 0.95:
        raise AssertionError("cable path: kernel route and float64 op-level route disagree")
    return launches, B * nsteps / dt, finite_frac


# ---------------------------------------------------------------------------
# The chord kernel with the q-dependent joints; the universal, spherical and
# FREE3D paths
# ---------------------------------------------------------------------------


def uni6(n=6):
    return scene_qdep_chain("universal", n)


def sph4(n=4):
    return scene_qdep_chain("spherical", n)


def free3d(_n=1):
    return scene_09_free3d()


def exp_rotations(topo):
    """[(DOF offset of the rotation)] of the scene's exp-map joints."""
    return [topo.qstart[j] + (3 if t == 8 else 0) for j, t in enumerate(topo.jtype) if t in (6, 8)]


def rotation_census(topo, x):
    """Joint-lanes of the exp-map rotations at the predictor x, per branch of
    so3_exp_S: Taylor (s < 0.04), just above (0.04 <= s < 0.05), the closed
    form below 1.4 pi, near 1.5 pi (|w| >= 1.4 pi)."""
    n = torch.cat([torch.linalg.vector_norm(x[:, o:o + 3].double(), dim=-1)
                   for o in exp_rotations(topo)])
    s = n * n
    return {"taylor": int((s < 0.04).sum()), "just_above": int(((s >= 0.04) & (s < 0.05)).sum()),
            "closed_form": int(((s >= 0.05) & (n < 1.4 * np.pi)).sum()),
            "near_1.5pi": int((n >= 1.4 * np.pi).sum())}


def seed_rotations(topo, h, states, lanes, seed):
    """Set the exp-map rotations of the first `lanes` lanes (every joint) to
    |w| cycling through the Taylor branch, just around s = 0.04 and around
    1.5 pi, along seeded directions, turning at 0.1 rad/s (q0 = w - h v,
    x0 = w + h v), so that the predictor stays in the seeded branch."""
    rng = np.random.default_rng(seed)
    norms = [0.0, 1e-4, 0.05, 0.15, 0.199, 0.2001, 0.21, 1.45 * np.pi, 1.5 * np.pi - 1e-3,
             1.5 * np.pi + 1e-3, 1.55 * np.pi]
    x0, q0, qd0, q1, qd1 = (a.clone() for a in states)
    for o in exp_rotations(topo):
        u, v = rng.normal(size=(lanes, 3)), 0.1 * rng.normal(size=(lanes, 3))
        u /= np.linalg.norm(u, axis=1, keepdims=True)
        t = lambda a: torch.tensor(a, dtype=x0.dtype, device=x0.device)
        w, v = t(u * np.resize(norms, lanes)[:, None]), t(v)
        q1[:lanes, o:o + 3], q0[:lanes, o:o + 3], x0[:lanes, o:o + 3] = w, w - h * v, w + h * v
        qd1[:lanes, o:o + 3], qd0[:lanes, o:o + 3] = v, v
    return [x0, q0, qd0, q1, qd1]


def phase_qdep_kernel_vs_plain(device="cuda"):
    """The QDEP build against chord_bdf2_reference on the card (phase 14);
    returns the kernel record fields of the three instantiations, by name."""
    records = {}
    cases = (("universal-6", uni6, 1024), ("universal-6", uni6, 1000),
             ("spherical-4", sph4, 1024), ("free3d scene 9", free3d, 1024))
    for label, scene, B in cases:
        sc = scene().compile(dtype=torch.float32, device=device)
        sc64 = scene().compile(dtype=torch.float64, device=device)
        s0 = free3d_states0(sc, B, device, torch.float32) if scene is free3d else None
        states, params, kept = rollout_states(sc, B, device, s0=s0)
        if exp_rotations(sc.topo):
            states = seed_rotations(sc.topo, float(sc.params["h"]), states, 64, seed=4)
            census = rotation_census(sc.topo, states[0])
            print(f"{label} B {B}: {kept}/{B} lanes from the rollout, 64 seeded; rotations at the "
                  f"predictor per branch of so3_exp_S: {json.dumps(census)}")
            if min(census.values()) == 0:
                raise AssertionError(f"{label}: a branch of so3_exp_S is not driven: {census}")
        else:
            print(f"{label} B {B}: {kept}/{B} lanes from the rollout")
        err, x = compare_kernel(sc, sc64, params, states, f"{label} B {B}")
        if B != 1024:
            continue
        check_nan_lane(sc, params, states, x)
        print(f"{label} B {B}: NaN lane kept, other lanes bit-equal")
        records[label] = time_chord_kernel(sc, params, states, err, label)
    return records


def free3d_states0(sc, B, device, dtype, seed=3):
    """The FREE3D path's lanes: scene 9's initial state with the rotation
    drawn uniformly in the ball of radius 1.45 pi, qdot the scene's plus
    0.5 N(0, 1)."""
    rng = np.random.default_rng(seed)
    u = rng.normal(size=(B, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    q = np.tile(sc.state0.q.cpu().numpy(), (B, 1))
    q[:, 3:6] = u * (1.45 * np.pi * rng.uniform(size=(B, 1)) ** (1.0 / 3.0))
    qd = sc.state0.qdot.cpu().numpy()[None] + 0.5 * rng.normal(size=(B, sc.topo.nr))
    return State(q=torch.tensor(q, dtype=dtype, device=device),
                 qdot=torch.tensor(qd, dtype=dtype, device=device))


def phase_free3d_path(device="cuda", B=1024, nsteps=50, reps=3):
    """Scene 9's FREE3D rollout on the kernel route (phase 17); returns
    (kernel launches of the timed rollouts, steps/s, finite_frac)."""
    sc = free3d().compile(dtype=torch.float32, device=device)
    s0 = integrators.bdf2_init(free3d_states0(sc, B, device, torch.float32))
    step = integrators.make_bdf2_step_batched(sc.topo, (), CFG, use_kernel=True)
    sim = integrators.make_simulate(step, nsteps)
    final = sim(sc.params, s0)  # warm-up
    torch.cuda.synchronize()
    reset_launches()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(reps):
        final = sim(sc.params, s0)
    end.record()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / reps
    launches = launches_of()
    dt = start.elapsed_time(end) / 1e3 / reps
    if launches != (nsteps - 1) * reps:
        raise AssertionError(f"chord_bdf2 launched {launches} times in {reps} rollouts, "
                             f"want {nsteps - 1} per rollout")
    finite = torch.isfinite(final.q).all(-1) & torch.isfinite(final.qdot).all(-1)
    finite_frac = float(finite.float().mean())
    print(f"free3d path: {B * nsteps / dt:.1f} steps/s ({dt * 1e3:.3f} ms per {nsteps}-step "
          f"rollout by CUDA events, {wall * 1e3:.3f} ms host clock), finite_frac "
          f"{finite_frac:.4f}, kernel launches {launches // reps} per rollout")
    if final.q.shape != (B, sc.topo.nr) or finite_frac < 0.95:
        raise AssertionError(f"free3d path: shape {tuple(final.q.shape)}, "
                             f"finite_frac {finite_frac}")

    # where the rescale fired on the card: a step after which |w| fell by more
    # than pi (from above 1.5 pi to 2 pi - |w|; a step moves |w| by about
    # |omega| h otherwise, h = 0.05)
    s, fired, nfired = step.bootstrap(sc.params, s0), None, 0
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    for _ in range(nsteps - 1):
        n_prev = torch.linalg.vector_norm(s.q[:, 3:6], dim=-1)
        s = step.inner(sc.params, s)
        jump = n_prev - torch.linalg.vector_norm(s.q[:, 3:6], dim=-1) > np.pi
        fired = jump if fired is None else fired | jump
        nfired += int(jump.sum())
    torch.cuda.synchronize()
    print(f"free3d path: the exp-map rescale fired in {int(fired.sum())} of {B} lanes "
          f"({nfired} lane-steps)")
    if int(fired.sum()) == 0:
        raise AssertionError("free3d path: the exp-map rescale never fired")
    for _ in range(2):  # the first pass warms the allocator; the second is timed
        torch.cuda.synchronize()
        ev[0].record()
        s = step.bootstrap(sc.params, s0)
        ev[1].record()
        for _ in range(nsteps - 1):
            s = step.inner(sc.params, s)
        ev[2].record()
        torch.cuda.synchronize()
    print(f"free3d path, one rollout by phase: bootstrap {ev[0].elapsed_time(ev[1]):.3f} ms, "
          f"{nsteps - 1} inner steps (kernel route, reparam included) "
          f"{ev[1].elapsed_time(ev[2]):.3f} ms")

    reset_launches()
    sc64 = free3d().compile(dtype=torch.float64, device=device)
    sim64 = integrators.make_simulate(
        integrators.make_bdf2_step_batched(sc64.topo, (), CFG, use_kernel=False), nsteps)
    q64 = sim64(sc64.params, integrators.bdf2_init(free3d_states0(sc, B, device,
                                                                  torch.float64))).q
    torch.cuda.synchronize()
    if launches_of() != 0:
        raise AssertionError("op-level route launched the kernel")
    err, both = lane_err(final.q, q64)
    p50, _, p99, mx = quantiles(err)
    within = float((err <= 1e-3).double().mean())
    print(f"free3d path vs op-level f64: final q diff of scale median {p50:.3e}, p99 {p99:.3e}, "
          f"max {mx:.3e}; {within:.4f} of {int(both.sum())} lanes within 1e-3")
    if within < 0.95:
        raise AssertionError("free3d path: kernel route and float64 op-level route disagree")
    return launches, B * nsteps / dt, finite_frac


# ---------------------------------------------------------------------------
# Per-lane physical params (K1f): the PERLANE builds, the domain-randomized
# contact path and the system-identification gradients
# ---------------------------------------------------------------------------


def to64(tree):
    """A nested dict of tensors in float64."""
    return {k: to64(v) if isinstance(v, dict) else v.double() for k, v in tree.items()}


def perlane_draws(params, force_fns, B, seed=0, extra=False, shared=()):
    """params with per-lane leaves, drawn as tests/test_pallas_step.py:818-844
    draws them (U uniform on [0, 1), numpy seed, in params' dtype): I_i
    (1 + 0.3U) [B, 1, 1], h (1 + 0.2U) [B], g (1 + 0.1U) [B, 1] and each
    contact's kn (1 + 0.5U) and mu U [B]; with extra also body damping
    (bd + 0.05)(1 + 0.5U) [B, N] (the scenes' bd is 0) and each spring's and
    cable's k, d, L (1 + 0.3U) [B]. The leaves named in shared are drawn and
    then left lane-shared."""
    rng = np.random.default_rng(seed)
    dt, dev = params["I_i"].dtype, params["I_i"].device
    u = lambda *shape: torch.tensor(rng.uniform(size=shape), dtype=dt, device=dev)
    p = {**params, "I_i": params["I_i"][None] * (1.0 + 0.3 * u(B, 1, 1)),
         "h": params["h"] * (1 + 0.2 * u(B)), "g": params["g"][None] * (1 + 0.1 * u(B, 1))}
    forces = {k: dict(v) for k, v in params.get("forces", {}).items()}
    for fn in force_fns:
        fp = forces[fn.key]
        if "kn" in fp:
            fp["kn"], fp["mu"] = fp["kn"] * (1 + 0.5 * u(B)), fp["mu"] * u(B)
    if extra:
        p["body_damping"] = (params["body_damping"] + 0.05)[None] * (1 + 0.5 * u(B, 1))
        for fn in force_fns:
            fp = forces[fn.key]
            for c in ("k", "d", "L"):
                if c in fp:
                    fp[c] = fp[c] * (1 + 0.3 * u(B))
    for fn in force_fns:
        forces[fn.key].update({c: params["forces"][fn.key][c] for c in shared
                               if c in forces[fn.key]})
    p.update({k: params[k] for k in shared if k in params})
    return {**p, "forces": forces}


def draws_extra(params, force_fns, B):
    """perlane_draws(extra=True); on the spring chain with h, k and L
    lane-shared: its world spring (k = 2e3) under up to 1.2 h, 1.3 k or 1.3 L
    makes the 3-iteration chord solve reject most lanes within 8 steps
    under the spring path's torques, in every arithmetic (a CPU rehearsal
    of rollout_states on the op-level route)."""
    springs = any(isinstance(fn, forces.ForceSpringDamper) for fn in force_fns)
    return perlane_draws(params, force_fns, B, extra=True,
                         shared=("h", "k", "L") if springs else ())


def phase_perlane_kernel_vs_plain(device="cuda", B=1024):
    """The PERLANE builds (K1f) against chord_bdf2_reference on the card, on
    perlane_draws(extra=True) and rollout states under them: chain-ground-12
    at B = 1024, 1000 and 997 (the cooperative design's last block partial),
    the spring chain and scene 13 at 1024, by the
    tolerances of phase 8 (on scene 13, lanes within 1e-6 L of the cable's
    gate are counted and left out, as in phase 11). At B = 1024 also a NaN
    lane, and lane-shared params broadcast into the per-lane buffer against
    the build without it; timed (every case on the cooperative design, in
    turns with its thread-per-lane build). Returns the kernel record fields
    by name."""
    records, B0 = {}, B
    cases = (("chain-ground-12", lambda: chain_ground(12), B0, 8),
             ("chain-ground-12", lambda: chain_ground(12), B0 - 24, 8),
             ("chain-ground-12", lambda: chain_ground(12), B0 - 27, 8),
             ("spring-chain-12", lambda: scene_spring_chain(12), B0, 8),
             ("scene-13", scene_13_cables, B0, 8))
    for label, scene, B, nsteps in cases:
        sc = scene().compile(dtype=torch.float32, device=device)
        sc64 = scene().compile(dtype=torch.float64, device=device)
        draws = draws_extra(sc.params, sc.force_fns, B)
        s0 = cable_states0(sc, B, device, torch.float32) if label == "scene-13" else None
        states, params, kept = rollout_states(sc, B, device, nsteps=nsteps, s0=s0, base=draws)
        near = None
        if label == "scene-13":
            l, _ = cable_lengths(sc64, states[0].double())
            L = params["forces"]["f0"]["L"].double()
            near = (l - L).abs() <= 1e-6 * L
            print(f"per-lane {label} B {B}: taut {int((l > L).sum())}, slack "
                  f"{int((l <= L).sum())}, within 1e-6 L of the gate {int(near.sum())}")
        want = "cooperative"
        print(f"per-lane states {label} B {B}: {kept}/{B} lanes from the rollout "
              f"({design_of(sc, params)} design)")
        if design_of(sc, params) != want:
            raise AssertionError(f"per-lane {label}: not routed to the {want} design")
        err, x = compare_kernel(sc, sc64, params, states, f"per-lane {label} B {B}", exclude=near)
        if B != B0:
            continue
        check_nan_lane(sc, params, states, x)
        # lane-shared params through the per-lane buffer: the build without it
        shared = {**sc.params, "tau": params["tau"]}
        xb, hb = chord_kernel.chord_bdf2(sc.topo, CFG, {**shared, "h": shared["h"].expand(B)},
                                         *states, sc.force_fns)
        x0, h0 = chord_kernel.chord_bdf2(sc.topo, CFG, shared, *states, sc.force_fns)
        fin0 = torch.isfinite(x0).all(-1)
        dxb = float(((xb - x0).abs() / torch.clamp(x0.abs(), min=1.0))[fin0].max())
        dhb = float((hb - h0)[fin0].abs().max() / h0[fin0].abs().max())
        print(f"per-lane {label} B {B}: NaN lane kept, other lanes bit-equal; shared params "
              f"through the per-lane buffer vs the build without it on {int(fin0.sum())} finite "
              f"lanes: max|dx|/max(1,|x|) {dxb:.3e}, max|dHinv| {dhb:.3e} of scale")
        if not torch.equal(fin0, torch.isfinite(xb).all(-1)) or dxb > 5e-6 or dhb > 2e-5:
            raise AssertionError(f"per-lane {label}: broadcast params changed the result")
        records[label] = time_chord_kernel(sc, params, states, err, f"per-lane {label}")
    return records


def phase_perlane_rollout(label, scene, s0_of, design, device="cuda", B=1024, nsteps=50,
                          min_finite=0.95):
    """A BDF2 rollout on the kernel route under perlane_draws(extra=True), with
    the launch count of the chord kernel design it must run on (design, which
    design_of must give) read around it, none of the other; its final q
    against the float64 op-level rollout under the same draws (>= 95% of the
    lanes finite in both within 1e-3 of scale). Returns (launches,
    finite_frac)."""
    sc = scene().compile(dtype=torch.float32, device=device)
    sc64 = scene().compile(dtype=torch.float64, device=device)
    params = draws_extra(sc.params, sc.force_fns, B)
    if design_of(sc, params) != design:
        raise AssertionError(f"{label}: routed to the {design_of(sc, params)} design, want "
                             f"{design}")
    step = integrators.make_bdf2_step_batched(sc.topo, sc.force_fns, CFG, use_kernel=True)
    s0 = integrators.bdf2_init(s0_of(sc, B, device, torch.float32))
    reset_launches()
    final = integrators.make_simulate(step, nsteps)(params, s0)
    torch.cuda.synchronize()
    launches = launches_of(design)
    if launches != nsteps - 1 or launches_of() != launches:
        raise AssertionError(f"{label}: chord_bdf2 launched {launches} times on its {design} "
                             f"design ({launches_of()} in all), want {nsteps - 1}")
    finite_frac = float((torch.isfinite(final.q).all(-1) & torch.isfinite(final.qdot).all(-1))
                        .float().mean())
    sim64 = integrators.make_simulate(integrators.make_bdf2_step_batched(
        sc64.topo, sc64.force_fns, CFG, use_kernel=False), nsteps)
    _, lanes = integrators.split_batched_params(params)
    q64 = sim64(integrators.merge_batched_params(sc64.params, to64(lanes)),
                integrators.bdf2_init(s0_of(sc, B, device, torch.float64))).q
    err, both = lane_err(final.q, q64)
    within = float((err <= 1e-3).double().mean())
    print(f"{label}: {nsteps} steps, B {B}, launches {launches} ({design} design), "
          f"finite_frac {finite_frac:.4f}; "
          f"vs op-level f64 final q diff of scale max {float(err.max()):.3e}, {within:.4f} of "
          f"{int(both.sum())} lanes within 1e-3")
    if finite_frac < min_finite or within < 0.95:
        raise AssertionError(f"{label}: finite_frac {finite_frac} or agreement {within} too low")
    return launches, finite_frac


def spring_chain_states0(sc, B, device, dtype):
    """The spring chain at rest, B lanes."""
    return State(q=sc.state0.q.to(device, dtype).expand(B, -1).contiguous(),
                 qdot=sc.state0.qdot.to(device, dtype).expand(B, -1).contiguous())


def phase_sysid_grads(device="cuda", nlinks=12, horizon=5, B=1024):
    """System identification through the randomized contact path's solve at
    horizon 5: the cotangents of the summed objective into the per-lane I_i,
    h and every contact's kn, from the kernel route (its factor-reusing
    adjoint) against the op-level route, both in float32 on the card, lane
    by lane within 5e-4 of scale (the bound of tests/test_pallas_step.py:
    941-945; the scale is the lane's own for I_i and h, the contact's over
    the lanes for kn) on >= 99% of the lanes finite in both. Through 50
    float32 steps single lanes' cotangents grow by many decades and the two
    routes drift apart by float32 chaos (a CPU rehearsal): the short
    horizon holds the per-lane params' backward, not the rollout's chaos."""
    sc = chain_ground(nlinks).compile(dtype=torch.float32, device=device)
    params = perlane_draws(sc.params, sc.force_fns, B)
    p0, targets = bench_inputs(sc.topo.nr, B, device, torch.float32)
    s0 = State(q=sc.state0.q.expand(B, -1).contiguous(),
               qdot=sc.state0.qdot.expand(B, -1).contiguous())
    names = ["I_i", "h"] + [f"kn[{fn.key}]" for fn in sc.force_fns]
    grads, finite = {}, {}
    for use_kernel in (True, False):
        _, obj = mpc_solver(sc, horizon, use_kernel=use_kernel)
        leaves = [params["I_i"].clone().requires_grad_(True),
                  params["h"].clone().requires_grad_(True)]
        leaves += [params["forces"][fn.key]["kn"].clone().requires_grad_(True)
                   for fn in sc.force_fns]
        forces = {k: dict(v) for k, v in params["forces"].items()}
        for fn, kn in zip(sc.force_fns, leaves[2:]):
            forces[fn.key]["kn"] = kn
        p = {**params, "I_i": leaves[0], "h": leaves[1], "forces": forces}
        reset_launches()
        with torch.enable_grad():
            v = obj(p, p0, s0, targets)
            fin = torch.isfinite(v)
            g = torch.autograd.grad(torch.where(fin, v, torch.zeros_like(v)).sum(), leaves)
        torch.cuda.synchronize()
        if (launches_of() > 0) != use_kernel:
            raise AssertionError("sysid: the routes launched the kernel wrongly")
        grads[use_kernel] = [a.reshape(B, -1).double() for a in g]
        finite[use_kernel] = fin
    both = finite[True] & finite[False]
    worst_share = 1.0
    for name, gk, go in zip(names, grads[True], grads[False]):
        ok_lanes = both & torch.isfinite(gk).all(-1) & torch.isfinite(go).all(-1)
        # I_i and h: each lane's own scale; kn: the contact's largest over
        # the lanes (a lane whose contact barely engages has a kn cotangent
        # down to 1e-30, where a relative error is float32 cancellation)
        if name.startswith("kn"):
            scale = go[ok_lanes].abs().max().clamp(min=1e-30).expand(B)
        else:
            scale = go.abs().amax(-1).clamp(min=1e-30)
        e = (gk - go).abs().amax(-1) / scale
        share = float((e[ok_lanes] <= 5e-4).double().mean())
        worst_share = min(worst_share, share)
        p50, _, p99, mx = quantiles(e[ok_lanes])
        if name in ("I_i", "h", f"kn[{sc.force_fns[0].key}]", f"kn[{sc.force_fns[-1].key}]"):
            print(f"sysid cotangent {name}: scales {float(scale[ok_lanes].min()):.3e} to "
                  f"{float(scale[ok_lanes].max()):.3e}; kernel vs op-level of scale "
                  f"p50 {p50:.3e}, p99 {p99:.3e}, max {mx:.3e} (lane {int(e[ok_lanes].argmax())}); "
                  f"{share:.4f} of {int(ok_lanes.sum())} lanes within 5e-4")
    print(f"sysid: {len(names)} leaves, {int(both.sum())} lanes finite on both routes; the "
          f"smallest share of lanes within 5e-4 over the leaves {worst_share:.4f}")
    if worst_share < 0.99:
        raise AssertionError("sysid: kernel-route cotangents disagree with the op-level route")
    return worst_share


# ---------------------------------------------------------------------------
# The robust solve modes (K1g): the kernel against its plain version, the
# robust-mode MPC paths and the adjoint backward modes
# ---------------------------------------------------------------------------

ROBUST = {
    "guarded": dataclasses.replace(CFG, guarded=True),
    "guard_last": dataclasses.replace(CFG, guard_last=True),
    "rehess": dataclasses.replace(CFG, chord=False),
    "guarded_rehess": dataclasses.replace(CFG, guarded=True, chord=False),
}


def phase_robust_kernel_vs_plain(device="cuda", cases=((12, 1024), (12, 1000), (12, 997)),
                                 B_contact=1024):
    """The ROBUST builds (K1g) against chord_bdf2_reference in each of
    guarded, guard_last, chord=False and guarded chord=False: chain-12 on
    states 8 steps into a sigma = 6 rollout (cases: (links, B)) and
    chain-ground-12 on the contact rollout's states, by phase 3's
    tolerances on at least 99% of lanes, the finite masks equal on at least
    99%, and by compare_kernel's checks of the guard-branch lanes and of
    the chord=False H^-1; a census of full, half and stay-put steps from the plain version,
    each branch taken in every guarded mode; a NaN lane; the kernel timed
    with its bound on chain-12 (guarded, guard_last) and chain-ground-12
    (chord=False, guarded). Returns the kernel records by name."""
    t0 = time.perf_counter()
    inputs = []
    for nlinks, B in cases:
        sc = scene_chain(nlinks).compile(dtype=torch.float32, device=device)
        sc64 = scene_chain(nlinks).compile(dtype=torch.float64, device=device)
        states, params, kept = rollout_states(sc, B, device, sigma=6.0)
        print(f"robust states chain-{nlinks} B {B}: {kept}/{B} lanes from the sigma 6 rollout")
        inputs.append((f"chain-{nlinks} B {B}", sc, sc64, states, params))
    scg = chain_ground(12).compile(dtype=torch.float32, device=device)
    scg64 = chain_ground(12).compile(dtype=torch.float64, device=device)
    states, params, kept = rollout_states(scg, B_contact, device)
    print(f"robust states chain-ground-12 B {B_contact}: {kept}/{B_contact} lanes from the "
          "contact rollout")
    inputs.append((f"chain-ground-12 B {B_contact}", scg, scg64, states, params))
    timed = {("guarded", 0): "guarded", ("guard_last", 0): "guard_last",
             ("rehess", len(inputs) - 1): "rehess",
             ("guarded", len(inputs) - 1): "guarded_contacts"}
    records = {}
    for mode, cfg in ROBUST.items():
        census = {1.0: 0, 0.5: 0, 0.0: 0}
        seen = 0
        for i, (label, sc, sc64, states, params) in enumerate(inputs):
            info = {}
            err, x = compare_kernel(sc, sc64, params, states, f"{mode} {label}", cfg=cfg,
                                    mask_ok=0.99, info=info)
            if "steps" in info:
                for v in census:
                    census[v] += int((info["steps"] == v).sum())
                seen += info["guard_seen"]
            if i == 0:
                check_nan_lane(sc, params, states, x, cfg)
            if (mode, i) in timed:
                records[timed[mode, i]] = time_chord_kernel(sc, params, states, err, label, cfg)
        if mode != "rehess":
            print(f"{mode}: steps of the plain version over the cases: full {census[1.0]}, "
                  f"half {census[0.5]}, stay put {census[0.0]}")
            if min(census.values()) == 0 or seen == 0:
                raise AssertionError(f"{mode}: a branch of the guard is not taken, or moves no "
                                     f"lane: {census}, {seen} lanes moved")
        print(f"{mode}: NaN lane kept, other lanes bit-equal")
    print(f"robust kernel phase: {time.perf_counter() - t0:.1f} s")
    return records


def time_solves(sc, cfg, sigma, device="cuda", B=1024, horizon=50, reps=3, backward="reuse"):
    """reps MPC solves (one Adam step each) on the kernel route in the solve
    mode of cfg, backward as given (timed_solves): (launches, solves/s,
    finite_frac)."""
    solve, _ = mpc_solver(sc, horizon, cfg=cfg, backward=backward)
    p0, targets = bench_inputs(sc.topo.nr, B, device, torch.float32, sigma)
    s0 = State(q=sc.state0.q.expand(B, -1).contiguous(),
               qdot=sc.state0.qdot.expand(B, -1).contiguous())
    launches, dt, _, res = timed_solves(solve, (sc.params, p0, s0, targets), horizon, reps,
                                        design_of(sc, sc.params, cfg))
    finite = torch.isfinite(res.objective)
    if res.objective.shape != (B,) or not torch.isfinite(res.p[finite]).all():
        raise AssertionError("unexpected shapes, or a non-finite update on a finite lane")
    return launches, B / dt, float(finite.float().mean())


def phase_robust_paths(device="cuda", B=1024, horizon=50):
    """The robust-mode MPC solves of benchmarks/robust_mode.py:40-140 on the
    port: guard_last and guarded3 on chain-12 and on the contact scene at
    sigma = 3, and chord=False on the contact scene, each with the checks of
    phase 4 (the contact ones with their finite share held to the op-level
    routes', not to 0.95) and the small card-against-CPU solve; then chord3,
    guard_last and guarded3 on chain-12 at sigma = 6, rate and finite_frac.
    Returns {path: (launches, solves/s, finite_frac)}."""
    out = {}
    for name, scene, mode, floor in (("chain-12 guard_last", scene_chain, "guard_last", 0.95),
                                     ("chain-12 guarded3", scene_chain, "guarded", 0.95),
                                     ("contact guard_last", chain_ground, "guard_last", None),
                                     ("contact guarded3", chain_ground, "guarded", None),
                                     ("contact chord=False", chain_ground, "rehess", None)):
        t0 = time.perf_counter()
        out[name + " sigma 3"] = phase_mpc_path(f"robust path {name}", scene, device, B=B,
                                                horizon=horizon, cfg=ROBUST[mode],
                                                min_finite=floor, design="cooperative")
        phase_small_reference(f"robust path {name}", scene, device, nlinks=12, cfg=ROBUST[mode],
                              rejects_ok=floor is None)
        print(f"robust path {name}: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    sc = scene_chain(12).compile(dtype=torch.float32, device=device)
    for name, cfg in (("chord3", CFG), ("guard_last", ROBUST["guard_last"]),
                      ("guarded3", ROBUST["guarded"])):
        out[f"chain-12 {name} sigma 6"] = r = time_solves(sc, cfg, 6.0, device, B, horizon)
        print(f"robust path chain-12 {name} sigma 6: {r[1]:.2f} solves/s, finite_frac "
              f"{r[2]:.4f}, kernel launches {r[0] // 3} per solve")
    print(f"robust paths at sigma 6: {time.perf_counter() - t0:.1f} s")
    return out


def phase_backward_modes(device="cuda", B=1024, horizon=50, grad_horizon=5):
    """benchmarks/backward_ab.py:42-140 on the port: the chain-12 chord3 solve
    at sigma = 3 with backward = reuse, refresh and exact (horizon 50, B =
    1024; rate and finite_frac, "exact" on one timed solve); dObjective/dP at
    horizon grad_horizon (past about 5 steps the chain's gradients measure
    its chaos, backward_ab.py:118-125) on the lanes finite in every mode:
    cosine and norm ratio against "exact"; and refresh's against the
    op-level route with adjoint_reuse_factor=False (the same mathematics:
    the structured H at the solution, in the bootstrap too), within 1e-3 of
    each lane's scale on at least 99% of lanes. Returns {mode: fields}."""
    t0 = time.perf_counter()
    sc = scene_chain(12).compile(dtype=torch.float32, device=device)
    out = {}
    for mode in ("reuse", "refresh", "exact"):
        launches, rate, ff = time_solves(sc, CFG, 3.0, device, B, horizon, backward=mode,
                                         reps=1 if mode == "exact" else 3)
        out[mode] = {"solves_per_s": rate, "finite_frac": ff}
        print(f"backward {mode}: {rate:.2f} solves/s, finite_frac {ff:.4f}, kernel launches "
              f"{launches // (1 if mode == 'exact' else 3)} per solve")
    p0, targets = bench_inputs(sc.topo.nr, B, device, torch.float32)
    s0 = State(q=sc.state0.q.expand(B, -1).contiguous(),
               qdot=sc.state0.qdot.expand(B, -1).contiguous())

    def grad_of(cfg, backward, use_kernel):
        _, obj = mpc_solver(sc, grad_horizon, use_kernel=use_kernel, cfg=cfg, backward=backward)
        P = p0.clone().requires_grad_(True)
        v = obj(sc.params, P, s0, targets)
        (g,) = torch.autograd.grad(torch.where(torch.isfinite(v), v, 0.0).sum(), P)
        return torch.where(torch.isfinite(v)[:, None], g, float("nan")).double()

    grads = {mode: grad_of(CFG, mode, True) for mode in ("reuse", "refresh", "exact")}
    fin = torch.stack([torch.isfinite(g).all(-1) for g in grads.values()]).all(0)
    ge = grads["exact"][fin]
    for mode, g in grads.items():
        gm = g[fin]
        out[mode]["cos_vs_exact"] = float((gm * ge).sum() / (gm.norm() * ge.norm()))
        out[mode]["norm_ratio_vs_exact"] = float(gm.norm() / ge.norm())
        print(f"backward {mode}, horizon {grad_horizon}, {int(fin.sum())} lanes: cosine against "
              f"exact {out[mode]['cos_vs_exact']:.6f}, norm ratio "
              f"{out[mode]['norm_ratio_vs_exact']:.4f}")
    no_reuse = dataclasses.replace(CFG, adjoint_reuse_factor=False)
    gk, go = grad_of(no_reuse, "refresh", True), grad_of(no_reuse, "reuse", False)
    both = torch.isfinite(gk).all(-1) & torch.isfinite(go).all(-1)
    e = (gk - go).abs().amax(-1)[both] / go.abs().amax(-1)[both].clamp(min=1e-30)
    share = float((e <= 1e-3).double().mean())
    p50, _, p99, mx = quantiles(e)
    out["refresh_vs_oplevel_within_1e-3"] = share
    print(f"backward refresh vs op-level (no factor reuse), {int(both.sum())} lanes: of scale "
          f"p50 {p50:.3e}, p99 {p99:.3e}, max {mx:.3e}; {share:.4f} within 1e-3")
    if share < 0.99:
        raise AssertionError("backward refresh disagrees with the op-level route")
    print(f"backward modes phase: {time.perf_counter() - t0:.1f} s")
    return out


# ---------------------------------------------------------------------------
# The default route at the shapes and kind mixes no fixed library holds
# ---------------------------------------------------------------------------


def chain_ground_spring(n=6):
    """Ground contacts mixed with a spring: chain-ground-6 (chain_ground's
    contacts) with a spring-damper from a world point above the root to the
    tip."""
    b = scene_chain_ground(nlinks=n, kn=100.0, kt=0.1, kd=10.0, mu=0.5, h=1e-2, floor_z=-0.06)
    b.name = f"chain-ground-{n}-spring"
    b.force_spring_damper(-1, n - 1, [0.0, 0.0, 3.0], [0.5, 0.0, 0.0], k=200.0, d=2.0)
    return b


def universal_ground(n=3):
    """A q-dependent joint with a closure: the universal chain of
    scene_qdep_chain with chain_ground's contact on every link (the links'
    bottom faces 0.01 above the floor)."""
    b = scene_qdep_chain("universal", n)
    b.name = f"universal-{n}-ground"
    E_g = np.eye(4)
    E_g[2, 3] = -0.06
    for i in range(n):
        b.force_ground_cuboid(i, E_ground=E_g, kn=100.0, kt=0.1, kd=10.0, mu=0.5)
    return b


# (label, scene builder, solve mode, per-lane draws or None, the TPU kernel
# branch it runs) of the chord cases of phase 26: shapes and kind mixes
# that no fixed library holds, each on the build the shape rule picks
DEFAULT_ROUTE = (
    ("scene 0", scene_00_serial_chain, CFG, None, "redmax_tpu/pallas_step.py:689"),
    ("scene 12", scene_12_spring_damper, CFG, None, "redmax_tpu/pallas_step.py:401"),
    ("chain-8", lambda: scene_chain(8), CFG, None, "redmax_tpu/pallas_step.py:689"),
    ("per-lane chain-8", lambda: scene_chain(8), CFG, perlane_draws,
     "redmax_tpu/pallas_step.py:706"),
    ("chain-ground-6 + spring", chain_ground_spring, CFG, None,
     "redmax_tpu/pallas_step.py:237"),
    ("universal-3 + ground", universal_ground, CFG, None, "redmax_tpu/pallas_step.py:907"),
    ("randomized chain-ground-12 guarded3", lambda: chain_ground(12), ROBUST["guarded"],
     perlane_draws, "redmax_tpu/pallas_step.py:1226"),
)


def mscene6_states(sc, B, device, dtype, seed=5):
    """Reference case 6's lanes: the limited joint at U(-1.2, 1.2) (its
    limits are +-pi/4, so about a third of the lanes start past one), the
    root at N(0, 0.3), qdot N(0, 1)."""
    rng = np.random.default_rng(seed)
    q = np.stack([0.3 * rng.normal(size=B), rng.uniform(-1.2, 1.2, size=B)], axis=1)
    qd = rng.normal(size=(B, 2))
    return State(q=torch.tensor(q, dtype=dtype, device=device),
                 qdot=torch.tensor(qd, dtype=dtype, device=device))


def build_line(build) -> str:
    """The nvcc seconds of phase 2 and the ptxas line of a build."""
    regs = "; ".join(f"{k}: {r} registers, {fr}-byte frame, spill stores/loads {st}/{ld}"
                     for k, r, fr, st, ld in ptxas_kernels(build.ptxas_report or ""))
    return f"{build.name} (nvcc {NVCC_SECONDS.get(build.name, float('nan')):.1f} s; {regs})"


def phase_default_route(device="cuda", Bs=(1024, 1000), nsteps=4):
    """The default route (make_bdf2_step_batched and make_euler_step_batched
    with use_kernel=None) on the card at shapes and kind mixes no fixed
    library holds (DEFAULT_ROUTE, and reference case 6's QP on dual_pgs),
    at B = 1024 and a ragged 1000: the design each case takes (the shape
    rule, before any build), its build's nvcc seconds and ptxas line; an
    nsteps rollout through the default route, launching the routed design
    nsteps - 1 times and the other never; the kernel against its plain
    version by compare_kernel's tolerances and shares on states 8 steps
    into a rollout (the QP: x within 2e-5 and lambda within 2e-4 of scale
    of the plain version, and the rollout within 1e-3 of scale of the
    float64 op-level rollout on 95% of lanes); timed at B = 1024. Returns
    the kernel records by label (with launches: those of the B = 1024
    rollout)."""
    t0 = time.perf_counter()
    records = {}
    for label, make, cfg, draws, _ in DEFAULT_ROUTE:
        for B in Bs:
            sc = make().compile(dtype=torch.float32, device=device)
            sc64 = make().compile(dtype=torch.float64, device=device)
            base = None if draws is None else draws(sc.params, sc.force_fns, B)
            params0 = sc.params if base is None else base
            if not chord_kernel.supports(sc.topo, sc.force_fns, cfg):
                raise AssertionError(f"{label}: the default route does not take the kernel")
            routed = design_of(sc, params0, cfg)
            build = chord_kernel.scene_build(sc.topo, sc.force_fns, params0, cfg)
            if routed != "cooperative":  # every mix with N, nr <= 32 that fits a block
                raise AssertionError(f"{label}: the shape rule routes it to the {routed} design")
            states, params, kept = rollout_states(sc, B, device, base=base)
            step = integrators.make_bdf2_step_batched(sc.topo, sc.force_fns, cfg)
            s0 = integrators.bdf2_init(State(q=states[3], qdot=states[4]))
            reset_launches()
            final = integrators.make_simulate(step, nsteps)(params, s0)
            torch.cuda.synchronize()
            launches = launches_of(routed)
            finite = float((torch.isfinite(final.q).all(-1)).float().mean())
            print(f"default route {label} (N, nr) = {(sc.topo.njoints, sc.topo.nr)}, B {B}: "
                  f"{routed} design, {build_line(build)}; {kept}/{B} lanes from the rollout; "
                  f"{nsteps}-step rollout: {launches} launches, finite {finite:.4f}")
            if launches != nsteps - 1 or launches_of() != launches:
                raise AssertionError(f"{label}: {launches} launches of the {routed} design "
                                     f"({launches_of()} in all), want {nsteps - 1}")
            if finite < 0.9:
                raise AssertionError(f"{label}: the default-route rollout kept {finite} finite")
            robust = chord_kernel.is_robust(cfg)
            err, x = compare_kernel(sc, sc64, params, states, f"default route {label} B {B}",
                                    cfg=cfg, mask_ok=0.99 if robust else 1.0)
            if B == Bs[0]:
                records[label] = {**time_chord_kernel(sc, params, states, err, label, cfg),
                                  "launches": launches}

    # reference case 6: the joint-limit QP, (n, m) = (2, rows)
    for B in Bs:
        sc = build_mscene(6, dtype=torch.float32, device=device)
        sc64 = build_mscene(6, dtype=torch.float64, device=device)
        s0 = mscene6_states(sc, B, device, torch.float32)
        qps = contact_qps(sc, s0)
        n, m = qps[1].shape[1], qps[2].shape[1]
        build = qp_kernel.library_of(n, m)
        qp_design = "cooperative" if qp_kernel.is_coop(build) else "thread_per_lane"
        x, lam = qp_kernel.dual_pgs(*qps, iters=PGS_ITERS, reg=PGS_REG)
        x_ref, lam_ref = qp_kernel.dual_pgs_reference(*qps, iters=PGS_ITERS, reg=PGS_REG)
        torch.cuda.synchronize()
        active = float(torch.isinf(qps[5]).any(-1).float().mean())
        xs, ls = max(1.0, float(x_ref.abs().max())), max(1.0, float(lam_ref.abs().max()))
        dx, dl = float((x - x_ref).abs().max()), float((lam - lam_ref).abs().max())
        print(f"default route mscene 6 QP {(n, m)}, B {B}: {qp_design} design (the shape rule, "
              f"qp_kernel.takes_coop), {build_line(build)}; {active:.4f} of "
              f"lanes with an active limit; max|dx| {dx:.3e} of scale {xs:.3e}, max|dlam| "
              f"{dl:.3e} of scale {ls:.3e}")
        if not (torch.isfinite(x).all() and torch.isfinite(lam).all()) or active == 0:
            raise AssertionError("mscene 6 QP: non-finite output, or no active limit")
        if dx > 2e-5 * xs or dl > 2e-4 * ls:
            raise AssertionError("mscene 6 QP: kernel disagrees with its plain version")
        step = integrators.make_euler_step_batched(sc.topo, (), sc.constraint_fns)
        reset_qp_launches()
        q = integrators.make_simulate(step, 20)(sc.params, s0).q
        torch.cuda.synchronize()
        coop_launches, lane_launches = qp_launches()
        launches = coop_launches if qp_design == "cooperative" else lane_launches
        q64 = integrators.make_simulate(
            integrators.make_euler_step_batched(sc64.topo, (), sc64.constraint_fns,
                                                use_kernel=False), 20)(
            sc64.params, mscene6_states(sc64, B, device, torch.float64)).q
        errq, both = lane_err(q, q64)
        within = float((errq <= 1e-3).double().mean()) * float(both.double().mean())
        print(f"default route mscene 6 Euler rollout, B {B}: {launches} dual_pgs launches of "
              f"the {qp_design} design in 20 steps ({coop_launches + lane_launches} in all); "
              f"final q vs f64 op-level: {within:.4f} of lanes within 1e-3 of scale, "
              f"max {float(errq.max()):.3e}")
        if launches != 20 or coop_launches + lane_launches != 20 or within < 0.95:
            raise AssertionError("mscene 6 rollout: wrong launch count, or off the f64 rollout")
        if B == Bs[0]:
            records["mscene 6"] = {**time_qp_kernel(qps, dx, "mscene 6"), "launches": launches}
    print(f"default-route phase: {time.perf_counter() - t0:.1f} s")
    return records


# ---------------------------------------------------------------------------
# The scene zoo: every scene of the reference's zoo under BDF2 and BDF1
# ---------------------------------------------------------------------------


# (label, builder) of phase 27's scenes on the kernel route: scenes 1-5, 14,
# -2, -1 and 100 of scenes.SCENES and the procedural tree, bridge and
# umbrella. The bridge runs at h = 2.5e-3 for tEnd = 0.25 (100 steps): at
# its default h = 1e-2 the chord config diverges on every lane in both
# packages (the structured H lacks the light planks' geometric stiffness),
# and its free fall past about 0.35 s parts float32 from float64 on a few
# percent of lanes; the phase shows both (bridge_checks).
ZOO = tuple((f"scene {sid}", SCENES[sid]) for sid in (1, 2, 3, 4, 5, 14, -2, -1, 100)) + (
    ("tree", scene_tree), ("bridge", lambda: scene_bridge(h=2.5e-3, tEnd=0.25)),
    ("umbrella", scene_umbrella))
# scenes 7 and 9 on their Euler charts: the op-level route
ZOO_EULER = (("scene 7 euler", lambda: scene_07_spherical(exp_coords=False)),
             ("scene 9 euler", lambda: scene_09_free3d(exp_coords=False)))
# the zoo scenes timed beside their thread-per-lane build: the umbrella (six
# springs), the last zoo scene that build ran on the card before the
# cooperative body took every kind mix
ZOO_BOTH_DESIGNS = ("umbrella",)
# the certificates held on the card: BDF1 and BDF2, and BDF1 alone (the BDF2
# ones of these scenes are held per step by the CPU tests)
CERT_BOTH = (1, 2, 3, 4, 5, 14, 7, 9)
CERT_BDF1 = (0, 6, 8, 10, 12, 13)
# Processes that share the card for the certificates and the Euler-chart
# scenes' f64 references: each is host-bound small launches (a scene-7
# certificate takes about a minute alone).
ZOO_WORKERS = 6
# Phase 27 (2)'s BDF1 rollouts run min(nsteps, ZOO_BDF1_STEPS) steps: their
# host-bound launches (~20 ms a step) took 55 s of the script at full depth.
ZOO_BDF1_STEPS = 50


def zoo_state0(sc, B, device, dtype, seed=0):
    """B lanes at the scene's initial state with q + 1e-2 N(0, 1) (numpy
    seed 0), each with the initial charts of its Euler-chart joints."""
    rng = np.random.default_rng(seed)
    q = sc.state0.q.double().cpu().numpy() + 1e-2 * rng.normal(size=(B, sc.topo.nr))
    t = lambda a: torch.tensor(a, dtype=dtype, device=device)
    return State(q=t(q), qdot=t(np.broadcast_to(sc.state0.qdot.double().cpu().numpy(), q.shape)),
                 aux={k: v.to(device).expand(B, *v.shape).contiguous()
                      for k, v in sc.state0.aux.items()})


def timed_rollout(sim, params, s0, reps):
    """(final state, device seconds a rollout): CUDA events around reps
    rollouts."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        final = sim(params, s0)
    end.record()
    torch.cuda.synchronize()
    return final, start.elapsed_time(end) / 1e3 / reps


def against_f64(label, q, q64):
    """The share of lanes (of all) finite in both whose final q lies within
    1e-3 of scale of the float64 rollout's (PERF.md section 2); printed with
    the quantiles, held at 0.95."""
    both = torch.isfinite(q).all(-1) & torch.isfinite(q64).all(-1)
    if not both.any():
        raise AssertionError(f"{label}: no lane finite in both rollouts")
    err, both = lane_err(q, q64)
    within = float((err <= 1e-3).double().sum()) / q.shape[0]
    p50, _, p99, mx = quantiles(err)
    print(f"{label} vs f64: final q diff of scale median {p50:.3e}, p99 {p99:.3e}, max "
          f"{mx:.3e}; {within:.4f} of lanes within 1e-3 ({int(both.sum())} finite in both)")
    if within < 0.95:
        raise AssertionError(f"{label}: off the float64 rollout")
    return within


def limit_census(sc64, states, x):
    """Lanes of a scene with joint limits: past a limit at the predictor or
    at the kernel's solution, and within 1e-5 max(1, |limit|) of one there
    (where two float32 orders may take the limit's branch either way)."""
    lo, hi = sc64.params["qlimL"], sc64.params["qlimU"]
    out = {}
    for name, v in (("predictor", states[0]), ("solution", x)):
        v = v.double()
        near = torch.minimum((v - lo).abs() / lo.abs().clamp(min=1.0),
                             (v - hi).abs() / hi.abs().clamp(min=1.0)) <= 1e-5
        out[f"past_a_limit_at_{name}"] = int(((v < lo) | (v > hi)).any(-1).sum())
        out[f"within_1e-5_of_a_limit_at_{name}"] = int(near.any(-1).sum())
    return out


def next_step_states(final, params):
    """The chord solve of the step after a BDF2 rollout's last (history,
    quadratic predictor), lanes the rollout rejected replaced by lane 0's."""
    ok = (torch.isfinite(final.q) & torch.isfinite(final.qdot)).all(-1)
    fix = lambda a: torch.where(ok[:, None], a, a[ok][:1])
    q0, qd0, q1, qd1 = (fix(a) for a in (final.q_prev, final.qdot_prev, final.q, final.qdot))
    h = lanewise(params["h"], 2)
    return [q1 + h * qd1 + 0.5 * h * (qd1 - qd0), q0, qd0, q1, qd1]


def euler_rollout(k, integ, dtype, B, device):
    """(sim, params, state0) of ZOO_EULER[k]'s rollout under integ ("bdf2" on
    the default route, "bdf1"): B lanes from zoo_state0, its own nsteps."""
    sc = ZOO_EULER[k][1]().compile(dtype=dtype, device=device)
    if integ == "bdf2":
        step = integrators.make_bdf2_step_batched(sc.topo, sc.force_fns, CFG)
        s0 = integrators.bdf2_init(zoo_state0(sc, B, device, dtype))
    else:
        step = integrators.make_bdf1_step(sc.topo, sc.force_fns, CFG)
        s0 = zoo_state0(sc, B, device, dtype)
    return integrators.make_simulate(step, sc.nsteps), sc.params, s0


def zoo_job(job):
    """A worker of phase 27's pool: ("cert", sid, integrator, device) ->
    (job, (H, Hexpected, seconds)), one energy certificate of scene sid (7 and
    9 on Euler charts) in f64, one lane, the default NewtonConfig(): H = T +
    V - V0 after its nsteps; ("euler", k, integrator, B, device) -> (job,
    (final q, final charts)) of euler_rollout in f64, on the CPU."""
    torch.set_num_threads(1)   # a worker's host work is small launches
    t = time.perf_counter()
    if job[0] == "euler":
        _, k, integ, B, device = job
        sim, params, s0 = euler_rollout(k, integ, torch.float64, B, device)
        final = sim(params, s0)
        return job, (final.q.cpu(), final.aux["euler_chart"].cpu())
    _, sid, integ, device = job
    sc = build_scene(sid, device=device, **({"exp_coords": False} if sid in (7, 9) else {}))
    s0 = sc.initial_state(integ)
    T0, V0 = sc.energies(s0.q, s0.qdot, s0.aux)
    final = integrators.make_simulate(sc.make_step(integ), sc.nsteps)(sc.params, s0)
    T, V = sc.energies(final.q, final.qdot, final.aux)
    return job, (float(T + V - V0), sc.Hexpected[integ], time.perf_counter() - t)


def bridge_checks(device, B):
    """The bridge outside the zoo's cut, BDF2 at B = 1024 on the kernel route
    against the op-level route in float64: at its default h = 1e-2, where
    both diverge, the finite masks equal on 95% of lanes; over its full
    tEnd = 0.5 at h = 2.5e-3 the share within 1e-3 of scale, printed."""
    out = {}
    for key, make in (("h_1e-2", scene_bridge), ("tEnd_0.5", lambda: scene_bridge(h=2.5e-3))):
        finals = []
        for dtype, use in ((torch.float32, None), (torch.float64, False)):
            sc = make().compile(dtype=dtype, device=device)
            finals.append(integrators.make_simulate(integrators.make_bdf2_step_batched(
                sc.topo, sc.force_fns, CFG, use_kernel=use), sc.nsteps)(
                sc.params, integrators.bdf2_init(zoo_state0(sc, B, device, dtype))).q)
        fin = [torch.isfinite(q).all(-1) for q in finals]
        agree = float((fin[0] == fin[1]).double().mean())
        err, _ = lane_err(*finals) if (fin[0] & fin[1]).any() else (torch.ones(1), None)
        within = float((err <= 1e-3).double().sum()) / B
        print(f"zoo bridge {key} ({sc.nsteps} steps, BDF2, B {B}): finite_frac "
              f"{float(fin[0].double().mean()):.4f} on the kernel route, "
              f"{float(fin[1].double().mean()):.4f} on the f64 op-level route, masks equal on "
              f"{agree:.4f} of lanes; {within:.4f} of lanes within 1e-3 of scale")
        out[key] = {"finite_frac": float(fin[0].double().mean()),
                    "finite_frac_f64": float(fin[1].double().mean()), "masks_equal": agree,
                    "within_1e-3_of_f64": within}
    if out["h_1e-2"]["masks_equal"] < 0.95:
        raise AssertionError("zoo bridge at h = 1e-2: the kernel route and the f64 op-level "
                             "route diverge on different lanes")
    return out


def phase_scene_zoo(device="cuda", B=1024, reps=3):
    """Phase 27: every scene of redmax_tpu/scenes.py under BDF2 and BDF1
    (docstring of this script). Returns (kernel records by label with the
    zoo rollout's launches, the zoo's JSON line)."""
    t0 = time.perf_counter()
    records, line = {}, {"bdf2": {}, "bdf1": {}, "euler_charts": {}, "certificates": {},
                         "adjoint_mpc": {}}
    # 1. BDF2 on the default route; 2. BDF1 at op level
    for label, make in ZOO:
        sc = make().compile(dtype=torch.float32, device=device)
        sc64 = make().compile(dtype=torch.float64, device=device)
        nsteps = sc.nsteps
        if not chord_kernel.supports(sc.topo, sc.force_fns, CFG):
            raise AssertionError(f"zoo {label}: the default route does not take the kernel")
        routed = design_of(sc, sc.params)
        build = chord_kernel.scene_build(sc.topo, sc.force_fns, sc.params, CFG)
        if routed != "cooperative":
            raise AssertionError(f"zoo {label}: the shape rule routes it to the {routed} design")
        sim = integrators.make_simulate(
            integrators.make_bdf2_step_batched(sc.topo, sc.force_fns, CFG), nsteps)
        s0 = integrators.bdf2_init(zoo_state0(sc, B, device, torch.float32))
        sim(sc.params, s0)
        torch.cuda.synchronize()
        reset_launches()
        final, dt = timed_rollout(sim, sc.params, s0, reps)
        launches = launches_of(routed)
        finite = float((torch.isfinite(final.q) & torch.isfinite(final.qdot)).all(-1)
                       .float().mean())
        print(f"zoo {label} (N, nr) = {(sc.topo.njoints, sc.topo.nr)}, BDF2, B {B}, "
              f"{nsteps} steps: {routed} design, {build_line(build)}; "
              f"{B * nsteps / dt:.1f} steps/s ({dt * 1e3:.3f} ms a rollout), "
              f"{launches // reps} launches a rollout, finite_frac {finite:.4f}")
        if launches != (nsteps - 1) * reps or launches_of() != launches:
            raise AssertionError(f"zoo {label}: {launches} launches of the {routed} design "
                                 f"({launches_of()} in all) in {reps} rollouts, want "
                                 f"{nsteps - 1} a rollout")
        reset_launches()
        q64 = integrators.make_simulate(
            integrators.make_bdf2_step_batched(sc64.topo, sc64.force_fns, CFG, use_kernel=False),
            nsteps)(sc64.params, integrators.bdf2_init(
                zoo_state0(sc64, B, device, torch.float64))).q
        torch.cuda.synchronize()
        if launches_of() != 0:
            raise AssertionError("the op-level route launched the kernel")
        within = against_f64(f"zoo {label} BDF2", final.q, q64)
        states = next_step_states(final, sc.params)
        err, x = compare_kernel(sc, sc64, sc.params, states, f"zoo {label} B {B}",
                                plain_gap=True)
        if label == "scene 14":
            census = limit_census(sc64, states, x)
            print(f"zoo {label}: joint limits {json.dumps(census)}")
            if census["past_a_limit_at_solution"] == 0:
                raise AssertionError("zoo scene 14: no lane past a joint limit")
        records[label] = {**time_chord_kernel(sc, sc.params, states, err, f"zoo {label}",
                                              both_designs=label in ZOO_BOTH_DESIGNS),
                          "launches": launches // reps}
        line["bdf2"][label] = {"design": routed, "steps_per_s": B * nsteps / dt,
                               "finite_frac": finite, "within_1e-3_of_f64": within,
                               "launches_per_rollout": launches // reps}

        reset_launches()
        n1 = min(nsteps, ZOO_BDF1_STEPS)
        step1 = integrators.make_bdf1_step(sc.topo, sc.force_fns, CFG)
        final1, dt1 = timed_rollout(integrators.make_simulate(step1, n1), sc.params,
                                    zoo_state0(sc, B, device, torch.float32), 1)
        q64 = integrators.make_simulate(integrators.make_bdf1_step(sc64.topo, sc64.force_fns, CFG),
                                        n1)(sc64.params,
                                            zoo_state0(sc64, B, device, torch.float64)).q
        torch.cuda.synchronize()
        finite1 = float((torch.isfinite(final1.q) & torch.isfinite(final1.qdot)).all(-1)
                        .float().mean())
        if launches_of() != 0:
            raise AssertionError("the BDF1 step launched the chord kernel")
        print(f"zoo {label} BDF1 (op level), B {B}, {n1} steps: {B * n1 / dt1:.1f} steps/s "
              f"({dt1 * 1e3:.3f} ms, one rollout), finite_frac {finite1:.4f}")
        line["bdf1"][label] = {"steps_per_s": B * n1 / dt1, "steps": n1, "finite_frac": finite1,
                               "within_1e-3_of_f64": against_f64(f"zoo {label} BDF1",
                                                                 final1.q, q64)}

    line["bridge"] = bridge_checks(device, B)
    t1 = time.perf_counter()

    # 3.-5. in a pool of ZOO_WORKERS processes on the card (the longest
    # first): the certificates in f64, one lane each, and the Euler-chart
    # scenes' f64 references; meanwhile in this process the Euler-chart
    # scenes in f32 (their rates are taken with the pool on the card) and
    # the adjoint MPC of scene 100 (the reference's task) in f64 against the
    # same on the CPU
    jobs = ([("cert", 7, i, device) for i in ("bdf1", "bdf2")]
            + [("euler", k, i, B, device) for k in range(len(ZOO_EULER)) for i in ("bdf2", "bdf1")]
            + [("cert", s_, i, device) for s_ in CERT_BOTH if s_ != 7 for i in ("bdf1", "bdf2")]
            + [("cert", s_, "bdf1", device) for s_ in CERT_BDF1])
    with torch.multiprocessing.get_context("spawn").Pool(ZOO_WORKERS) as pool:
        # one job a task: map_async's default chunks of two put scene 7's two
        # certificates, the longest jobs, in one worker one after the other
        pending = pool.map_async(zoo_job, jobs, chunksize=1)
        finals = {}
        for k, (label, make) in enumerate(ZOO_EULER):
            sc = make().compile(dtype=torch.float32, device="cpu")
            if chord_kernel.supports(sc.topo, sc.force_fns, CFG):
                raise AssertionError(f"{label}: supports() admits an Euler-chart scene")
            for integ in ("bdf2", "bdf1"):
                reset_launches()
                finals[k, integ] = timed_rollout(*euler_rollout(k, integ, torch.float32, B,
                                                                device), 1)
                if launches_of() != 0:
                    raise AssertionError(f"{label}: the chord kernel was launched")
        t2 = time.perf_counter()
        task = mpc.PointPosTask(body=1, wp=1.0, wreg=1e-5, pscale=1e4)
        for integ in ("bdf1", "bdf2"):
            objs = {}
            for dev in (device, "cpu"):
                sc = build_scene(100, device=dev)
                objs[dev] = (sc, mpc.make_objective(sc.topo, sc.force_fns, task,
                                                    (5.0, 0.0, 0.0), 10, integ))
            p0 = np.random.default_rng(7).normal(size=2) * 0.3
            grads = {}
            for dev, (sc, obj) in objs.items():
                p = torch.tensor(p0, device=dev, requires_grad=True)
                v = obj(sc.params, p, sc.state0, torch.tensor([8.0, 0.0, 4.0], device=dev,
                                                               dtype=torch.float64))
                grads[dev] = (float(v.detach()), torch.autograd.grad(v, p)[0].cpu())
            sc, obj = objs[device]
            target = torch.tensor([8.0, 0.0, 4.0], device=device, dtype=torch.float64)
            res = mpc.make_mpc_solver(obj, iters=10, lr=0.05)(
                sc.params, torch.tensor(p0, device=device), sc.state0, target)
            v1 = float(obj(sc.params, res.p, sc.state0, target))
            g, g_cpu = grads[device][1], grads["cpu"][1]
            dg = float((g - g_cpu).abs().max()) / max(1.0, float(g_cpu.abs().max()))
            print(f"adjoint MPC scene 100 {integ} (f64, 10 steps): objective "
                  f"{grads[device][0]:.6e} -> {v1:.6e} after 10 Adam steps; gradient "
                  f"{g.tolist()} vs CPU {g_cpu.tolist()}: {dg:.3e} of scale")
            if not v1 < grads[device][0] or dg > 1e-6:
                raise AssertionError(f"adjoint MPC {integ}: the objective did not fall, or the "
                                     "gradient is off the CPU's")
            line["adjoint_mpc"][integ] = {"objective_0": grads[device][0], "objective_10": v1,
                                          "grad_diff_of_scale": dg}
        t3 = time.perf_counter()
        results = dict(pending.get(timeout=900))
    for k, (label, _) in enumerate(ZOO_EULER):
        for integ in ("bdf2", "bdf1"):
            (final, dt), (q64, ch64) = finals[k, integ], results["euler", k, integ, B, device]
            nsteps = ZOO_EULER[k][1]().compile(device="cpu").nsteps
            q, ch = final.q.cpu(), final.aux["euler_chart"].cpu()
            both = torch.isfinite(q).all(-1) & torch.isfinite(q64).all(-1)
            same = (ch == ch64).all(-1) & both
            share = float(same.double().mean())
            switched = int((ch != DEFAULT_CHART).any(-1).sum())
            err, _ = lane_err(q[same], q64[same])
            print(f"zoo {label} {integ.upper()} (op level: supports() False, 0 chord launches), "
                  f"B {B}, {nsteps} steps: {B * nsteps / dt:.1f} steps/s (with the pool on the "
                  f"card); final chart equal to the f64 run's on {share:.4f} of lanes; "
                  f"{switched} lanes off the initial chart at the end (f64: "
                  f"{int((ch64 != DEFAULT_CHART).any(-1).sum())}); on lanes of equal charts, "
                  f"{float((err <= 1e-3).double().mean()):.4f} within 1e-3 of scale (max "
                  f"{float(err.max()):.3e})")
            if share < 0.95:
                raise AssertionError(f"{label} {integ}: final charts off the float64 run's")
            line["euler_charts"][f"{label} {integ}"] = {
                "steps_per_s_shared_card": B * nsteps / dt, "chart_equal_to_f64": share,
                "lanes_off_initial_chart": switched, "chord_launches": 0}
    for job, out in results.items():
        if job[0] != "cert":
            continue
        (_, sid, integ, _), (H, expected, sec) = job, out
        dH = abs(H - expected)
        print(f"certificate scene {sid} {integ} (f64, one lane): H {H!r}, expected "
              f"{expected!r}, |dH| {dH:.3e} ({sec:.1f} s in its process)")
        line["certificates"][f"{sid} {integ}"] = dH
        if not dH <= 1e-2:
            raise AssertionError(f"certificate scene {sid} {integ}: |dH| {dH} > 1e-2")
    print("certificate scene 11 (1200 steps) left out")
    t4 = time.perf_counter()
    print(f"scene zoo phase: {t4 - t0:.1f} s (kernel-route and BDF1 rollouts {t1 - t0:.1f} s; "
          f"the pool of {ZOO_WORKERS} processes {t4 - t1:.1f} s, beside it the Euler charts in "
          f"f32 {t2 - t1:.1f} s and the adjoint MPC {t3 - t2:.1f} s)")
    return records, line


# ---------------------------------------------------------------------------
# The feature-rich scene zoo (scenes_matlab.py) under the Euler tier
# ---------------------------------------------------------------------------


# phase 28's cases: every case of scenes_matlab.M_SCENES but the friction
# ones (their step is euler_fric, which phase 30 runs) and the two that read
# the reference's OBJ meshes (not in this repository)
MZOO = tuple(sorted(set(scenes_matlab.M_SCENES) - set(scenes_matlab.FRICTION)
                    - set(scenes_matlab.OBJ_CASES)))
# f32 steps a case: min(nsteps, MZOO_F32_STEPS)
MZOO_F32_STEPS = 100


def mzoo_state0(sc, B, device, dtype, seed=0):
    """B lanes of a case: lane 0 at its initial state, lanes 1.. with
    qdot0 + 1e-3 N(0, 1) (numpy seed 0); q at q0 on every lane."""
    rng = np.random.default_rng(seed)
    q0 = sc.state0.q.double().cpu().numpy()
    qd = sc.state0.qdot.double().cpu().numpy()[None] + 1e-3 * rng.normal(size=(B, sc.topo.nr))
    qd[0] = sc.state0.qdot.double().cpu().numpy()
    t = lambda a: torch.tensor(a, dtype=dtype, device=device)
    return State(q=t(np.broadcast_to(q0, qd.shape).copy()), qdot=t(qd))


def per_step_share(sc, step, scene_fn, s0_64, hist64, K, fbm64=None):
    """(share of q, share of qdot): the worst over steps k < K of the share of
    lanes whose float32 step from the float64 run's state k lies within 1e-3
    of scale (the f64 state's largest magnitude at k + 1, at least 1) of the
    float64 state k + 1. The K steps' lanes go as one batch of K B lanes,
    each with the scene function's params at its own end time (k + 1) h;
    that batch (float32) is returned too. fbm64: the friction step's warm
    starts aux["fbm"] [nsteps, B, 6N] of the float64 run (after each step;
    zeros before the first), which the float32 step then starts from."""
    q64, qd64 = hist64
    B, nr = s0_64.q.shape
    qs = torch.cat([s0_64.q[None], q64[:K - 1]]).reshape(K * B, nr)
    qds = torch.cat([s0_64.qdot[None], qd64[:K - 1]]).reshape(K * B, nr)
    params = sc.params
    if scene_fn is not None:
        k = torch.arange(1, K + 1, device=qs.device, dtype=params["h"].dtype)
        params = scene_fn(params, (k * params["h"]).repeat_interleave(B))
    aux = {}
    if fbm64 is not None:
        fbm = torch.cat([torch.zeros_like(fbm64[:1]), fbm64[:K - 1]])
        aux = {"fbm": fbm.reshape(K * B, -1).float()}
    lanes = State(q=qs.float(), qdot=qds.float(), aux=aux)
    out = step(params, lanes)
    shares = []
    for got, want in ((out.q, q64[:K]), (out.qdot, qd64[:K])):
        got = got.reshape(K, B, nr).double()
        scale = want.abs().amax((1, 2)).clamp(min=1.0)
        err = (got - want).abs().amax(-1) / scale[:, None]
        ok = (err <= 1e-3) & torch.isfinite(err)
        shares.append(float(ok.double().mean(1).min()))
    return shares, lanes


def phase_mscene_zoo(device="cuda", B=1024):
    """Phase 28: the feature-rich zoo (scenes_matlab.py) under the linearly
    implicit Euler tier through make_euler_step_batched and make_simulate
    (with each case's scene function): per case (1) a float64 rollout of its
    full nsteps at B = 1024 (mzoo_state0), lane 0's certificate
    |H - Hexpected["euler"]| <= 1e-2; (2) float32 for min(nsteps, 100) steps
    from the same lanes on the default route, timed (CUDA events, one
    rollout after a warm step), with the chord kernel launched never and the QP kernel once a
    step where the case has inequality rows (mscene 6: (n, m) = (2, 1)) and
    never elsewhere; (3) per step against float64 (per_step_share: >= 95% of
    lanes within 1e-3 of scale at every step); (4) mscene 6: K2 against its
    plain version on the QPs of the states after the f32 rollout (x within
    2e-5, lambda within 2e-4 of scale), and on the QPs of the K B lanes of
    (3), which must hold an active limit; timed on the former. The float64
    runs take the op-level QP (K2 is float32). Returns (K2's record for
    mscene 6, the zoo's JSON line)."""
    t0 = time.perf_counter()
    line, record = {}, None
    for sid in MZOO:
        ts = time.perf_counter()
        sc64 = build_mscene(sid, dtype=torch.float64, device=device)
        sc = build_mscene(sid, dtype=torch.float32, device=device)
        fn = scenes_matlab.SCENE_FNS.get(sid)
        ineq = any(c.n_ineq_m or c.n_ineq_r for c in sc.constraint_fns)
        s64 = mzoo_state0(sc64, B, device, torch.float64)
        step64 = integrators.make_euler_step_batched(sc64.topo, sc64.force_fns,
                                                     sc64.constraint_fns,
                                                     use_kernel=False if ineq else None)
        final64, hist64 = integrators.make_simulate(step64, sc64.nsteps, record=True,
                                                    scene_fn=fn)(sc64.params, s64)
        _, V0 = sc64.energies(s64.q[:1], s64.qdot[:1])
        T1, V1 = sc64.energies(final64.q[:1], final64.qdot[:1])
        H = float(T1[0] + V1[0] - V0[0])
        dH = abs(H - sc64.Hexpected["euler"])
        t64 = time.perf_counter() - ts

        K = min(sc.nsteps, MZOO_F32_STEPS)
        step = integrators.make_euler_step_batched(sc.topo, sc.force_fns, sc.constraint_fns)
        s32 = mzoo_state0(sc, B, device, torch.float32)
        step(fn(sc.params, sc.params["h"]) if fn else sc.params, s32)   # warm: loads K2's build
        torch.cuda.synchronize()
        reset_launches()
        reset_qp_launches()
        final, dt = timed_rollout(integrators.make_simulate(step, K, scene_fn=fn), sc.params,
                                  s32, 1)
        coop, lane = qp_launches()
        chord = launches_of()
        (share_q, share_qd), lanes = per_step_share(sc, step, fn, s64, hist64, K)
        end = lane_err(final.q, hist64[0][K - 1])[0]
        finite = float((torch.isfinite(final.q) & torch.isfinite(final.qdot)).all(-1)
                       .double().mean())
        print(f"mscene {sid} ({sc.name}; N {sc.topo.njoints}, nr {sc.topo.nr}, "
              f"{len(sc.constraint_fns)} constraints, {len(sc.force_fns)} closures"
              f"{', scene_fn' if fn else ''}): f64 {sc64.nsteps} steps at B {B} "
              f"({'op-level QP' if ineq else 'default route'}) in {t64:.1f} s, lane 0 H {H!r} "
              f"vs {sc64.Hexpected['euler']!r}, |dH| {dH:.3e}; f32 {K} steps "
              f"{B * K / dt:.1f} steps/s ({dt * 1e3 / K:.3f} ms a step), finite {finite:.4f}, "
              f"per step vs f64: q {share_q:.4f}, qdot {share_qd:.4f} of lanes within 1e-3 "
              f"(worst step); after {K} steps {float((end <= 1e-3).double().mean()):.4f} "
              f"within 1e-3; launches: dual_pgs cooperative {coop}, thread per lane {lane}, "
              f"chord {chord}")
        if not dH <= 1e-2:
            raise AssertionError(f"mscene {sid}: certificate |dH| {dH} > 1e-2")
        if share_q < 0.95:
            raise AssertionError(f"mscene {sid}: f32 steps off the f64 run ({share_q})")
        if chord != 0 or lane != 0 or coop != (K if ineq else 0):
            raise AssertionError(f"mscene {sid}: launches chord {chord}, dual_pgs {coop} + "
                                 f"{lane}, want 0 and {K if ineq else 0} cooperative")
        if ineq:
            for where, states in (("after the rollout", final), ("at the rollout's steps", lanes)):
                qps = contact_qps(sc, states)
                x, lam = qp_kernel.dual_pgs(*qps, iters=PGS_ITERS, reg=PGS_REG)
                x_ref, lam_ref = qp_kernel.dual_pgs_reference(*qps, iters=PGS_ITERS, reg=PGS_REG)
                torch.cuda.synchronize()
                xs, ls = max(1.0, float(x_ref.abs().max())), max(1.0, float(lam_ref.abs().max()))
                dx, dl = float((x - x_ref).abs().max()), float((lam - lam_ref).abs().max())
                active = float(torch.isinf(qps[5]).any(-1).float().mean())
                print(f"mscene {sid} QP {(qps[1].shape[1], qps[2].shape[1])} {where} "
                      f"({qps[1].shape[0]} lanes): {active:.4f} of lanes with an active limit; "
                      f"max|dx| {dx:.3e} of scale {xs:.3e}, max|dlam| {dl:.3e} of scale {ls:.3e}")
                if dx > 2e-5 * xs or dl > 2e-4 * ls or not torch.isfinite(x).all():
                    raise AssertionError(f"mscene {sid}: K2 disagrees with its plain version")
            if active == 0:
                raise AssertionError(f"mscene {sid}: no active limit on the rollout's steps")
            qps = contact_qps(sc, final)
            dx = float((qp_kernel.dual_pgs(*qps, iters=PGS_ITERS, reg=PGS_REG)[0]
                        - qp_kernel.dual_pgs_reference(*qps, iters=PGS_ITERS, reg=PGS_REG)[0])
                       .abs().max())
            record = {**time_qp_kernel(qps, dx, f"mscene zoo {sid}"), "launches": coop}
        line[str(sid)] = {"dH": dH, "f32_per_step_share_q": share_q,
                          "f32_per_step_share_qdot": share_qd, "f32_steps_per_s": B * K / dt,
                          "f32_steps": K, "f64_steps": sc64.nsteps, "f64_seconds": t64,
                          "launches": {"dual_pgs_cooperative": coop, "dual_pgs_thread": lane,
                                       "chord": chord}}
    print(f"mscene zoo phase: {time.perf_counter() - t0:.1f} s")
    return record, line


# ---------------------------------------------------------------------------
# The explicit and O(n) tiers (explicit.py, recursive.py, pcg.py) and
# sampling MPC (mpc.make_mppi_solver_batched) on the chord kernel
# ---------------------------------------------------------------------------


# (recursive, dense) ode45 energy certificates of tests/test_ode45.py (the
# reference's RECURS_ODE45 and REDMAX_ODE45), every case but 26 and 34,
# whose OBJ files the repository lacks; mscene 12 has no recursive one. The
# order is the pool's, the longest first (as they ran on the CPU).
ODE45_CERTS = {
    12: (None, -0.0345395920267038),
    15: (2.5092171102578504, 2.5092171060550754),
    4: (4176.3993502426255873, 4176.3993502425073530),
    22: (-1.4604474130101153, -1.4604474127263529),
    23: (-0.2671194855411159, -0.2671194856266084),
    21: (-18.5261468157405034, -18.5261468464450445),
    0: (-3.0971281943493523, -3.0971281068341341),
    14: (-0.8577782593856682, -0.8577782794236555),
    -1: (-5.6531026717020723, -5.6531026765951538),
    1: (-1.9548841516880202, -1.9548841526830074),
    2: (-3.2850447686942061, -3.2850447782984702),
    11: (2898.56113448227, 2898.56113448227),
    16: (-5.7644270883174613, -5.7644270894088550),
    10: (1210.7099042740396726, 1210.7099042740403547),
    19: (-8.7962825142149086, -8.7962825142917609),
    35: (167.0835245643339135, 167.0835245643319240),
    25: (-11.2086902929768257, -11.2086902930313954),
    17: (835.418079875333, 835.418079875333),
    18: (4.5466342688068826, 4.5466342688068924),
}
# the two cases whose accept/reject sequences are ulp-sensitive: band 5e-2,
# and their dense-against-recursive share reported, not gated
ODE45_LOOSE = {19: 5e-2, 21: 5e-2}
# cases also run in float32: the final state within 1e-3 of scale of the
# float64 run's on >= 95% of lanes, except on ODE45_CHAOTIC, where that
# share is printed: mscene 0's chain parts its float32 lanes from float64
# over its span
ODE45_F32 = (0, 15, 22)
ODE45_CHAOTIC = (0,)
# scene 5's sceneFcn05 torque schedule through ode45: lane 0's H
ODE45_SCENE5 = 160.820781710469
# Processes that share the card for the ode45 cases: each is host-bound
# small launches, a derivative call at a time.
ODE45_WORKERS = 6
# The PCG tier in float32: an absolute tolerance on ||r|| that float32
# reaches (|frtilde| is about 80 on chain-30, 2500 on chain-120) and the
# iteration cap.
PCG_F32_TOL = 1e-4
PCG_MAXIT = 100
# MPPI's noise in p (torques pscale p = 1e3 p): sigma 3 N m, the main
# path's torque scale (bench.py's p0 = 3/1e3 N(0, 1)); at sigma 0.3 every
# candidate diverges (the phase shows it)
MPPI_SIGMA = 3e-3


def ode45_job(job):
    """A worker of phase 29's pool: ("ode45", sid, method, dtype name, B,
    device) -> (job, result): explicit.simulate_ode45 of mscene sid
    ("dense" or "recursive") from mzoo_state0's B lanes, scene 5 with its
    scene function; result: lane 0's H = T + V - V0, the final y [B, 2 nr]
    (float64, on the CPU), the loop's iterations, the largest step count of
    a lane, the accepted steps summed over lanes and the run's seconds."""
    torch.set_num_threads(1)   # a worker's host work is small launches
    _, sid, method, dt, B, device = job
    dtype = getattr(torch, dt)
    sc = build_mscene(sid, dtype=dtype, device=device)
    s0 = mzoo_state0(sc, B, device, dtype)
    fn = scenes_matlab.scene_fn_05 if sid == 5 else None
    sync = torch.cuda.synchronize if device != "cpu" else (lambda: None)
    sync()
    t = time.perf_counter()
    fin = explicit.simulate_ode45(sc, method, state0=s0, scene_fn=fn)
    sync()
    sec = time.perf_counter() - t
    st = explicit.ode45_stats
    _, V0 = sc.energies(s0.q[:1], s0.qdot[:1])
    T, V = sc.energies(fin.q[:1], fin.qdot[:1])
    return job, {"H": float(T[0] + V[0] - V0[0]),
                 "y": torch.cat([fin.q, fin.qdot], -1).double().cpu(),
                 "iterations": st["iterations"], "steps_max": int(st["steps"].max()),
                 "accepted": int(st["accepted"].sum()), "seconds": sec}


def ode45_jobs(B, device):
    """Phase 29's ode45 jobs, the longest first: every certificate case
    dense and recursive in float64, scene 5 and the float32 cases."""
    jobs = []
    for sid, (rec, _) in ODE45_CERTS.items():
        jobs.append(("ode45", sid, "dense", "float64", B, device))
        if rec is not None:
            jobs.append(("ode45", sid, "recursive", "float64", B, device))
        if sid in ODE45_F32:
            jobs.append(("ode45", sid, "dense", "float32", B, device))
        if sid == 23:
            jobs.append(("ode45", 5, "dense", "float64", B, device))
    return jobs


def ode45_checks(results, B, device):
    """Phase 29 (1)'s gates and readings from the pool's results."""
    line = {}
    for job, out in results.items():
        _, sid, method, dt, _, _ = job
        rate = out["accepted"] / out["seconds"]
        label = f"mscene {sid} {method} {dt}"
        entry = {"iterations": out["iterations"], "steps_max": out["steps_max"],
                 "accepted_lane_steps": out["accepted"], "seconds": out["seconds"],
                 "accepted_lane_steps_per_s": rate}
        msg = (f"ode45 {label}, B {B}: {out['iterations']} controller iterations (a lane at most "
               f"{out['steps_max']} steps), {out['accepted']} accepted lane-steps in "
               f"{out['seconds']:.2f} s ({rate:.1f} lane-steps/s, in a pool of {ODE45_WORKERS})")
        if dt == "float64":
            cert = ODE45_SCENE5 if sid == 5 else ODE45_CERTS[sid][0 if method == "recursive"
                                                                  else 1]
            dH = abs(out["H"] - cert)
            band = ODE45_LOOSE.get(sid, 1e-2)
            entry["dH"] = dH
            msg += f"; lane 0 H {out['H']!r} vs {cert!r}, |dH| {dH:.3e} (band {band})"
            if not dH <= band:
                raise AssertionError(f"ode45 {label}: certificate |dH| {dH} > {band}")
        print(msg)
        line[label] = entry
    for sid in ODE45_CERTS:
        run = lambda method, dt: results["ode45", sid, method, dt, B, device]["y"]
        y, entry = run("dense", "float64"), line[f"mscene {sid} dense float64"]
        pairs = []
        if ODE45_CERTS[sid][0] is not None:
            pairs.append(("recursive float64", run("recursive", "float64"), 1e-6,
                          sid not in ODE45_LOOSE))
        if sid in ODE45_F32:
            pairs.append(("dense float32", run("dense", "float32"), 1e-3,
                          sid not in ODE45_CHAOTIC))
        for name, other, tol, gated in pairs:
            err, _ = lane_err(other, y)
            share = float((err <= tol).double().sum()) / B
            p50, _, p99, mx = quantiles(err)
            print(f"ode45 mscene {sid} {name} vs dense float64: final y diff of scale median "
                  f"{p50:.3e}, p99 {p99:.3e}, max {mx:.3e}; {share:.4f} of lanes within {tol}"
                  + (" (gated at 0.95)" if gated else " (reported)"))
            entry[f"{name}_share_within_{tol}"] = share
            if gated and share < 0.95:
                raise AssertionError(f"ode45 mscene {sid}: {name} off the dense float64 run")
    return line


def pcg_per_step(label, sc, tol, gate, B, nsteps, device, scale_gate=False):
    """The PCG tier in float64 against the dense Euler step, one step from
    each state of the dense run (mzoo_state0's B lanes, nsteps): qdot equal
    within gate (of the dense qdot's scale with scale_gate) on every lane
    and step; returns the CG iterations' (max, mean) and the worst error."""
    s0 = mzoo_state0(sc, B, device, torch.float64)
    dense = integrators.make_euler_step(sc.topo, sc.force_fns, sc.constraint_fns)
    tier = pcg.make_euler_pcg_step(sc.topo, sc.force_fns, sc.constraint_fns, tol=tol)
    s, worst, its = s0, 0.0, []
    for _ in range(nsteps):
        want = dense(sc.params, s)
        got = tier(sc.params, s)
        its.append(pcg.pcg_stats["iters"])
        scale = max(1.0, float(want.qdot.abs().max())) if scale_gate else 1.0
        worst = max(worst, float((got.qdot - want.qdot).abs().max()) / scale)
        s = want
    its = torch.stack(its).double()
    print(f"pcg {label} f64 (tol {tol}), B {B}, {nsteps} steps, one PCG step from each dense "
          f"state: max |qdot - dense| {worst:.3e}{' of scale' if scale_gate else ''} (gate "
          f"{gate}); CG iterations max {int(its.max())}, mean {float(its.mean()):.2f}")
    if not worst <= gate:
        raise AssertionError(f"pcg {label}: off the dense Euler step ({worst})")
    return int(its.max()), float(its.mean()), worst


def pcg_f32(label, make, B, nsteps, device, gate_f64):
    """The PCG tier in float32 (PCG_F32_TOL, PCG_MAXIT) beside the dense
    Euler step in float32, each a timed rollout of nsteps (CUDA events,
    after a warm step), both against the float64 dense rollout; returns the
    line's entry. gate_f64: hold the PCG rollout within 1e-3 of scale of
    float64 on 95% of lanes (against_f64), else report both tiers' shares."""
    sc64 = make().compile(dtype=torch.float64, device=device)
    sc = make().compile(dtype=torch.float32, device=device)
    s64 = mzoo_state0(sc64, B, device, torch.float64)
    s32 = mzoo_state0(sc, B, device, torch.float32)
    q64 = integrators.make_simulate(integrators.make_euler_step(sc64.topo, sc64.force_fns),
                                    nsteps)(sc64.params, s64).q
    dense = integrators.make_euler_step(sc.topo, sc.force_fns)
    tier = pcg.make_euler_pcg_step(sc.topo, sc.force_fns, tol=PCG_F32_TOL, maxit=PCG_MAXIT)
    dense(sc.params, s32)
    tier(sc.params, s32)
    torch.cuda.synchronize()
    final_d, dt_d = timed_rollout(integrators.make_simulate(dense, nsteps), sc.params, s32, 1)
    its = []

    def rollout(params, s):
        for _ in range(nsteps):
            s = tier(params, s)
            its.append(pcg.pcg_stats["iters"])
        return s

    final, dt = timed_rollout(rollout, sc.params, s32, 1)
    its = torch.stack(its)
    at_max = int((its >= PCG_MAXIT).sum())
    finite = float((torch.isfinite(final.q) & torch.isfinite(final.qdot)).all(-1)
                   .double().mean())
    rates = B * nsteps / dt, B * nsteps / dt_d
    print(f"pcg {label} f32 (tol {PCG_F32_TOL} on ||r||, maxit {PCG_MAXIT}), B {B}, {nsteps} "
          f"steps: PCG {rates[0]:.1f} steps/s ({dt * 1e3 / nsteps:.3f} ms a step), dense Euler "
          f"{rates[1]:.1f} steps/s ({dt_d * 1e3 / nsteps:.3f} ms a step); CG iterations max "
          f"{int(its.max())}, mean {float(its.double().mean()):.2f}; {at_max} lane-steps at "
          f"maxit; finite {finite:.4f}")
    entry = {"pcg_steps_per_s": rates[0], "dense_steps_per_s": rates[1],
             "cg_iters_max": int(its.max()), "cg_iters_mean": float(its.double().mean()),
             "lane_steps_at_maxit": at_max, "finite_frac": finite}
    if gate_f64:
        entry["within_1e-3_of_f64"] = against_f64(f"pcg {label} f32", final.q, q64)
    else:
        for name, q in (("pcg", final.q), ("dense", final_d.q)):
            err, _ = lane_err(q, q64)
            share = float((err <= 1e-3).double().sum()) / B
            p50, _, p99, mx = quantiles(err)
            print(f"pcg {label} f32 {name} tier vs dense f64 (reported: float32 is off the "
                  f"float64 run in both tiers): final q diff of scale median {p50:.3e}, p99 "
                  f"{p99:.3e}, max {mx:.3e}; {share:.4f} of lanes within 1e-3")
            entry[f"{name}_within_1e-3_of_f64"] = share
    if finite < 1.0 or at_max:
        raise AssertionError(f"pcg {label} f32: non-finite lanes or lanes at maxit")
    return entry


def pcg_f64_checks(device="cuda", B=1024, nsteps=20):
    """Phase 29 (2), float64: the matrix-free PCG tier
    (pcg.make_euler_pcg_step) one step from each state of the dense Euler
    run (pcg_per_step)."""
    line = {}
    for label, make, tol, gate, of_scale in (
            ("chain-30", lambda: scene_chain(30, damping=0.0).compile(device=device), 1e-6,
             1e-8, False),
            ("mscene 15", lambda: build_mscene(15, device=device), 1e-12, 1e-8, False),
            ("chain-120", lambda: scene_chain(120).compile(device=device), 1e-6, 1e-6, True)):
        # chain-120 in float64: 5 steps (its CG runs ~21 iterations a step)
        its_max, its_mean, worst = pcg_per_step(label, make(), tol, gate, B,
                                                5 if label == "chain-120" else nsteps, device,
                                                of_scale)
        if label == "chain-30" and its_max > 3:
            raise AssertionError(f"pcg chain-30: {its_max} CG iterations, want <= 3 (the "
                                 "preconditioner is exact for its pure-inertia LHS)")
        line[f"{label} f64"] = {"max_qdot_diff": worst, "cg_iters_max": its_max,
                                "cg_iters_mean": its_mean, "tol": tol}
    return line


def pcg_f32_rates(device="cuda", B=1024, nsteps=20):
    """Phase 29 (2), float32: the PCG tier timed beside the dense Euler step
    on chain-30 and chain-120 (pcg_f32)."""
    return {f"{label} f32": pcg_f32(label, lambda: scene_chain(n), B, nsteps, device, gate_f64)
            for label, n, gate_f64 in (("chain-30", 30, True), ("chain-120", 120, False))}


def phase_mppi(device="cuda", S=1024, horizon=50, reps=3):
    """Phase 29 (3): sampling MPC (mpc.make_mppi_solver_batched) at the main
    path's configuration, the candidates as lanes of make_objective_batched
    (the chord kernel, K1a); returns (launches of the timed solves, the
    line's entry)."""
    sc = scene_chain(12).compile(dtype=torch.float32, device=device)
    task = mpc.PointPosTask(body=sc.topo.njoints - 1, wp=1.0, wreg=1e-6, pscale=1e3)
    obj, obj_plain = (mpc.make_objective_batched(sc.topo, sc.force_fns, task, (0.5, 0.0, 0.0),
                                                 horizon, CFG, use_kernel=uk)
                      for uk in (None, False))
    p0, targets = bench_inputs(sc.topo.nr, 1, device, torch.float32)
    p0, tgt = p0[0], targets[0]
    s0 = State(q=sc.state0.q, qdot=sc.state0.qdot)
    solve = mpc.make_mppi_solver_batched(obj, n_samples=S, sigma=MPPI_SIGMA)
    gen = lambda seed: torch.Generator(device=device).manual_seed(seed)
    design = design_of(sc, sc.params)
    solve(gen(0), sc.params, p0, s0, tgt)    # warm
    torch.cuda.synchronize()
    reset_launches()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for r in range(reps):
        p_new, mean_cost = solve(gen(r), sc.params, p0, s0, tgt)
    end.record()
    torch.cuda.synchronize()
    dt = start.elapsed_time(end) / 1e3 / reps
    launches, other = launches_of(design), launches_of() - launches_of(design)
    print(f"mppi chain-12 (sigma {MPPI_SIGMA}, {S} candidates, horizon {horizon}, f32): "
          f"{1 / dt:.2f} MPPI solves/s ({dt * 1e3:.3f} ms a solve, {S / dt:.1f} rollouts/s); "
          f"chord kernel launches {launches // reps} a solve on the {design} design, {other} on "
          "the other")
    if launches != (horizon - 1) * reps or other != 0:
        raise AssertionError(f"mppi: {launches} launches of the {design} design in {reps} "
                             f"solves and {other} of the other, want {horizon - 1} a solve")

    # the same candidates through the kernel route and the op-level route
    cand = mpc._candidates(gen(1), p0, S, MPPI_SIGMA)
    lanes = lambda v: v.expand(S, *v.shape).contiguous()
    s0b = State(q=lanes(s0.q), qdot=lanes(s0.qdot))
    with torch.no_grad():
        costs = obj(sc.params, cand, s0b, lanes(tgt))
        reset_launches()
        costs_plain = obj_plain(sc.params, cand, s0b, lanes(tgt))
        plain_launches = launches_of()
        cost_p0 = obj_plain(sc.params, p0[None], State(q=s0.q[None], qdot=s0.qdot[None]),
                            tgt[None])[0]
    fin, fin_p = torch.isfinite(costs), torch.isfinite(costs_plain)
    both = fin & fin_p
    rel = (costs.double() - costs_plain.double()).abs() / costs_plain.double().abs()
    same = (both & (rel <= 1e-3)) | (~fin & ~fin_p)
    agree = float(same.double().mean())
    p_k, m_k = mpc._mppi_combine(costs, cand, p0, 1.0)
    p_p, m_p = mpc._mppi_combine(costs_plain, cand, p0, 1.0)
    dp_all = float((p_k - p_p).abs().max()) / max(1.0, float(p_p.abs().max()))
    # At temperature 1 the weights follow exp(-cost) over costs tens apart,
    # so the best few candidates carry the update, and the best are often
    # the lanes a float32 rollout is most sensitive on (a lane off by rtol
    # 1e-3 between two float32 orders can hold most of the weight): the
    # update is held over the candidates whose costs agree, the full
    # update's difference printed.
    inf = torch.full_like(costs, float("inf"))
    p_ks, _ = mpc._mppi_combine(torch.where(same, costs, inf), cand, p0, 1.0)
    p_ps, _ = mpc._mppi_combine(torch.where(same, costs_plain, inf), cand, p0, 1.0)
    dp = float((p_ks - p_ps).abs().max()) / max(1.0, float(p_ps.abs().max()))
    rank = torch.argsort(torch.where(fin, costs, inf))
    off = (~same[rank]).nonzero()
    print(f"mppi same candidates: finite {float(fin.double().mean()):.4f} (op level "
          f"{float(fin_p.double().mean()):.4f}); kernel-route cost within rtol 1e-3 of the "
          f"op-level route's on {agree:.4f} of candidates (max rel {float(rel[both].max()):.3e}; "
          f"the best-ranked of those off at rank {int(off[0]) if len(off) else None}); p_new "
          f"diff {dp:.3e} of scale over the candidates that agree (gated at 1e-3), {dp_all:.3e} "
          f"over all; mean cost {float(m_k):.6f} (op level {float(m_p):.6f}) vs cost of p0 "
          f"{float(cost_p0):.6f}; op-level launches {plain_launches}")
    if agree < 0.99 or dp > 1e-3 or plain_launches:
        raise AssertionError("mppi: the kernel route's costs or update are off the op-level "
                             "route's")
    if not float(m_k) <= float(cost_p0):
        raise AssertionError(f"mppi: mean cost {float(m_k)} above the cost of p0 "
                             f"{float(cost_p0)}")

    # the solvers' default sigma 0.3 (torques 300 N m): the failure masking on the card
    wide = mpc._candidates(gen(2), p0, S, 0.3)
    with torch.no_grad():
        c_wide = obj(sc.params, wide, s0b, lanes(tgt))
    p_w, m_w = mpc._mppi_combine(c_wide, wide, p0, 1.0)
    fin_w = float(torch.isfinite(c_wide).double().mean())
    print(f"mppi sigma 0.3: finite {fin_w:.4f} of candidates; mean cost {float(m_w)}; p_new "
          f"{'= p0' if torch.allclose(p_w, p0, atol=1e-6) else 'moved'}")
    if torch.isnan(p_w).any() or torch.isnan(m_w) or (fin_w == 0 and not (
            torch.isinf(m_w) and torch.allclose(p_w, p0, atol=1e-6))):
        raise AssertionError("mppi sigma 0.3: NaN, or all candidates diverged and the result "
                             "is not p0 with an inf cost")
    return launches, {"solves_per_s": 1 / dt, "candidates": S, "sigma": MPPI_SIGMA,
                      "launches_per_solve": launches // reps, "design": design,
                      "finite_frac": float(fin.double().mean()), "cost_agree_share": agree,
                      "p_new_diff_of_scale": dp, "p_new_diff_of_scale_all": dp_all,
                      "mean_cost": float(m_k),
                      "cost_p0": float(cost_p0), "sigma_0.3_finite_frac": fin_w}


def phase_explicit_tiers(device="cuda", B=1024, workers=ODE45_WORKERS):
    """Phase 29: (3) MPPI on the chord kernel and (2) the PCG tier's float32
    rates, each alone on the card; then (1) the ode45 certificates at B
    lanes in a pool of workers processes on the card (inline with
    workers = 0), beside it (2) the PCG tier's float64 checks; returns
    (MPPI's kernel launches, the phase's JSON line)."""
    t0 = time.perf_counter()
    launches, mppi_line = phase_mppi(device)
    t1 = time.perf_counter()
    pcg_line = pcg_f32_rates(device, B)
    t2 = time.perf_counter()
    jobs = ode45_jobs(B, device)
    if workers:
        with torch.multiprocessing.get_context("spawn").Pool(workers) as pool:
            pending = pool.map_async(ode45_job, jobs, chunksize=1)   # the longest first
            pcg_line.update(pcg_f64_checks(device, B))
            t3 = time.perf_counter()
            results = dict(pending.get(timeout=1000))
    else:
        pcg_line.update(pcg_f64_checks(device, B))
        t3 = time.perf_counter()
        results = dict(map(ode45_job, jobs))
    ode45_line = ode45_checks(results, B, device)
    t4 = time.perf_counter()
    print(f"explicit tiers phase: {t4 - t0:.1f} s (MPPI {t1 - t0:.1f} s, the PCG tier's f32 "
          f"rates {t2 - t1:.1f} s, then the ode45 pool of {workers} processes {t4 - t2:.1f} s, "
          f"beside it the PCG tier's f64 checks {t3 - t2:.1f} s)")
    return launches, {"ode45": ode45_line, "pcg": pcg_line, "mppi": mppi_line,
                      "seconds": t4 - t0}


# ---------------------------------------------------------------------------
# Staggered-projections friction (friction.py) and its sweeps kernel (K3)
# ---------------------------------------------------------------------------


# phase 30's cases, each with the band of tests/test_friction.py that lane
# 0's certificate keeps: ("abs", |H - Hexpected|) or ("rel", |H / Hexpected - 1|)
FRIC_BANDS = {27: ("rel", 0.07), 28: ("abs", 1e-2), 29: ("abs", 1e-2), 30: ("rel", 0.15),
              31: ("abs", 1e-2), 33: ("rel", 0.03)}
# lanes of each case's float64 certificate rollout: 1024 (the 4-bars' K3
# friction solves, m = 80 and 72, keep one triangle of their symmetric D
# (pgs_kernel.warp_store): 8 lanes an SM, one wave at 1024 lanes)
FRIC_B64 = {27: 1024, 28: 1024, 29: 1024, 30: 1024, 31: 1024, 33: 1024}
# the cases whose float64 rollouts run in a pool of processes on the card,
# beside the rest of the phase (the two longest)
FRIC_POOLED = (33, 30)
# float32 steps of each case (min(nsteps, 50) at FRIC_B32 lanes), shorter
# for the 4-bars, whose float32 staggered projections run sp_iter_max = 100
# iterations at most steps (3.9 and 4.1 s a step), as JAX's own float32 step
# does (scripts/f32_departures.py friction 30); and the lanes of the
# float64 run whose steps the per-step share re-runs in float32
FRIC_F32_STEPS = {27: 50, 28: 50, 29: 50, 30: 2, 31: 50, 33: 2}
FRIC_B32 = 1024
FRIC_SHARE_LANES = 128
# cases whose float32 step cannot hold 95% of lanes within 1e-3 of scale of
# the float64 step, or whose float32 lanes go NaN: held on the printed
# shares (ROADMAP.md queue 3 item 3). The JAX package's own float32 step
# departs from its float64 one as far and loses lanes too
# (scripts/f32_departures.py friction, friction_finite).
FRIC_F32_HELD = (27, 28, 29, 30, 33)
# K3 against its plain version: (label, case, which solve of a step),
# "friction" the first friction pass, "qp" the first dual QP
K3_CASES = (("friction mscene 27", 27, "friction"), ("friction mscene 30", 30, "friction"),
            ("qp mscene 33", 33, "qp"))
# lanes and sweeps of phase 30's K3 checks
K3_B, K3_ITERS = 1024, 3000
# phase 30's check of K3 past the zoo's widths: m (a -DPGS_K unit built at
# first launch; in float64 D transposed does not fit a block's shared
# memory, 232,992 bytes against an H100's 232,448) and sweeps
K3_WIDE_M, K3_WIDE_ITERS = 200, 100
# H100 SXM peak float64 rate outside the tensor cores (NVIDIA data sheet)
PEAK_F64_FLOPS = 34e12


def fric_rollout(sc, step, fn, s0, nsteps):
    """make_simulate of the euler_fric step for nsteps from s0, recording
    each step's q, qdot and aux["fbm"]; returns (final, (q [nsteps, B, nr],
    qdot), fbm [nsteps, B, 6N], per-step staggered-projections iterations
    [nsteps, B], the K3 sweep solves the rollout asked for)."""
    fbms, its, solves = [], [], [0]

    def rec(params, s):
        out = step(params, s)
        fbms.append(out.aux["fbm"])
        its.append(step.stats["sp_iters"])
        solves[0] += step.stats["sweep_solves"]
        return out

    final, hist = integrators.make_simulate(rec, nsteps, record=True, scene_fn=fn)(sc.params, s0)
    return final, hist, torch.stack(fbms), torch.stack(its), solves[0]


def fric_H(sc, s0, final):
    """Lane 0's H = T + V - V0 after the rollout."""
    _, V0 = sc.energies(s0.q[:1], s0.qdot[:1])
    T1, V1 = sc.energies(final.q[:1], final.qdot[:1])
    return float(T1[0] + V1[0] - V0[0])


def band_ok(sid, H, expected):
    kind, tol = FRIC_BANDS[sid]
    err = abs(H - expected) if kind == "abs" else abs(H - expected) / abs(expected)
    return err, err <= tol


def k3_flops(m, iters):
    """Floating-point operations of one lane of K3, counted from its loop: a
    row update is a dot of m (2m), the residual (3), the division and the
    clip's two compares (3)."""
    return iters * m * (2 * m + 6)


def k3_inputs(sc, step, params, state, kind):
    """K3's inputs (D, r, lo, hi, reg) of the first solve of `kind` in one
    step from state, with what turns its lambda into the output that
    matters: ("friction", T [B, nt, 6N]) for the friction pass (its wrench
    is T^T b), ("qp", (Hf, HinvAT)) for a dual QP (x = Hf - HinvAT lam)."""
    caps, duals = [], []
    k3, solve = pgs_kernel.pgs_sweeps, friction._Dual.solve

    def spy_k3(D, r, lo, hi, iters, reg, active=None):
        caps.append((D, r, lo, hi, reg))
        return k3(D, r, lo, hi, iters, reg, active)

    def spy_solve(self, f, active=None):
        duals.append((self, f, len(caps)))
        return solve(self, f, active)

    pgs_kernel.pgs_sweeps, friction._Dual.solve = spy_k3, spy_solve
    try:
        step(params, state)
    finally:
        pgs_kernel.pgs_sweeps, friction._Dual.solve = k3, solve
    if kind == "qp":
        dual, f, at = duals[0]
        Hf = torch.linalg.lu_solve(*dual.lu, f[..., None])[..., 0]
        return caps[at], ("qp", (Hf, dual.HinvAT))
    first = next(c for c in caps if c[4] == friction.FRICTION_REG)
    kin = model.forward_kinematics(sc.topo, params, state.q, state.qdot, state.aux)
    T = friction.tangent_matrix(sc.friction_model, sc.topo, kin, params, state.q, state.qdot)
    return first, ("friction", T)


def k3_output(how, lam):
    kind, data = how
    if kind == "lam":
        return lam
    if kind == "friction":
        return (data.transpose(-1, -2) @ lam[..., None])[..., 0]
    Hf, HinvAT = data
    return Hf - (HinvAT @ lam[..., None])[..., 0]


# K3's designs (pgs_kernel.DESIGNS) by the names of the kernel records
K3_DESIGN_NAMES = {"thread": "thread_per_lane", "warp": "warp_per_lane",
                   "warp_div": "warp_per_lane_div"}


def k3_ptxas(report):
    """{(design, dtype, size, flag): (registers, spill store bytes, spill
    load bytes)} of K3's kernels in an nvcc -Xptxas -v report:
    thread_kernel<T, M> as ("thread", dtype, M, 0), warp_kernel<T, K,
    store> as ("warp", dtype, K, store: pgs_kernel.STORES), div_kernel<T,
    K, shared_d> as ("warp_div", dtype, K, shared_d)."""
    out, key, frame = {}, None, (0, 0)
    names = {"thread": "thread", "warp": "warp", "div": "warp_div"}
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '[^']*?(thread|warp|div)_kernelI([fd])Li(\d+)E"
                      r"(?:L[bi](\d)E)?E", line)
        if m:
            key = (names[m.group(1)], "float32" if m.group(2) == "f" else "float64",
                   int(m.group(3)), int(m.group(4) or 0))
            frame = (0, 0)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            frame = tuple(int(v) for v in m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m and key is not None:
            out[key] = (int(m.group(1)), *frame)
            key = None
    return out


def sm_clock_mhz(fn, seconds=1.0):
    """(median SM clock in MHz, samples) that nvidia-smi reads every 50 ms
    while fn() runs back to back for `seconds` (NaN where it read none);
    the sampler is stopped before this returns."""
    proc = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits",
                             "-lms", "50"], stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
                            text=True)
    try:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            fn()
            torch.cuda.synchronize()
    finally:
        proc.terminate()
        out = proc.communicate(timeout=30)[0]
    vals = sorted(float(v) for v in out.split() if re.fullmatch(r"\d+(\.\d+)?", v))
    return (vals[len(vals) // 2] if vals else float("nan")), len(vals)


def k3_layout_fields(m, dtype, design, store, B=1024):
    """The launch's shared memory, lanes an SM and waves at B lanes
    (pgs_kernel.layout; store: the warp design's; K3's records and phase 30
    use B = 1024), and its ptxas registers and spills."""
    lay = pgs_kernel.layout(m, dtype, design, store)
    size = m if design == "thread" else -(-m // 32)
    flag = pgs_kernel.STORES[store] if design == "warp" else int(lay["shared_d"]) \
        if design == "warp_div" else 0
    regs, st, ld = k3_ptxas(pgs_kernel.build_for(m).ptxas_report or "").get(
        (design, str(dtype)[6:], size, flag), (None, None, None))
    return {"smem_bytes_a_block": lay["smem"], "lanes_a_block": lay["lanes"],
            "lanes_per_sm": lay["lanes_per_sm"], "waves": -(-B // lay["lanes_at_once"]),
            "shared_d": lay["shared_d"], "registers": regs, "spill_store_bytes": st,
            "spill_load_bytes": ld}


def k3_variants(m, dtype, symmetric, B):
    """The K3 launches phase 30 holds and times at (m, dtype, B lanes;
    symmetric: D equals its transpose): the one pgs_sweeps routes to
    (design_of, and the warp design's warp_store, or warp_div where no store
    fits), the warp design's other stores that fit in shared memory (the
    triangle only for a symmetric D), the warp design's store beside the
    thread design, and the earlier warp design (warp_div). (design, store)
    pairs, the routed one first."""
    routed = pgs_kernel.design_of(m, dtype)
    store = pgs_kernel._store_on_card(m, dtype, B, symmetric)
    if routed == "thread":
        return [("thread", "full"), ("warp", store), ("warp_div", "full")]
    limit = pgs_kernel.layout(m, dtype, "warp_div")["max_smem"]
    others = [("warp", st) for st in ("full", "triangle") if st != store
              and (symmetric or st != "triangle")
              and pgs_kernel.smem_bytes(m, dtype, st) <= limit]
    if store is None:
        return [("warp_div", "full")] + others
    return [("warp", store)] + others + [("warp_div", "full")]


# K3's stores of D (pgs_kernel.STORES) as the records name them
K3_STORE_NAMES = {"full": "full transpose", "triangle": "lower triangle"}


def k3_time_design(label, D, r, lo, hi, iters, reg, active, design, store, routed, how, ref,
                   keep, ok_in, bound, clock, smi, reps=None):
    """One K3 launch variant on a case's inputs (store: the warp design's):
    its output held against the plain version's (ref) within 1e-10 of
    scale in float64 and 2e-4 in float32 on the lanes `keep`, the inactive
    lane 1 at 0 and NaN where the plain version is; then timed (graph,
    events; reps launches, by default 50 at m <= 8 and 5 above) and laid
    out. The routed variant (design and store: those pgs_sweeps takes) is
    held through pgs_sweeps as the friction step calls it, the others
    through pgs_kernel.launch; each is timed through pgs_kernel.launch
    (pgs_sweeps reads D's symmetry on the host, which a CUDA graph cannot
    capture), and the routed one through pgs_sweeps too (CUDA events:
    "wrapper_ms", that read included). Returns the variant's fields."""
    B, m = r.shape
    launch = lambda act: pgs_kernel.launch(D, r, lo, hi, iters, reg, act, design=design,
                                           store=store)
    run = (lambda act: pgs_kernel.pgs_sweeps(D, r, lo, hi, iters, reg, act)) if routed \
        else launch
    lam = run(active)
    out = k3_output(how, lam)
    name = (f"K3 {label} {str(D.dtype)[6:]} {design}"
            f"{f' ({K3_STORE_NAMES[store]})' if design == 'warp' else ''}")
    if (torch.isnan(out) != torch.isnan(ref))[active].any():
        raise AssertionError(f"{name}: NaN where the plain version has none")
    scale = max(1.0, float(ref[keep].abs().max()))
    err = float((out[keep] - ref[keep]).abs().max())
    tol = 1e-10 if D.dtype == torch.float64 else 2e-4
    if not err <= tol * scale:
        raise AssertionError(f"{name}: max |d out| {err} of scale {scale}")
    if lam[1].abs().max() != 0:
        raise AssertionError(f"{name}: the inactive lane was swept")
    if torch.isfinite(lam[2]).any():
        raise AssertionError(f"{name}: the NaN lane came out finite")
    reps = reps or (50 if m <= 8 else 5)
    ms = graph_ms(lambda: launch(None), reps=reps)
    events_ms = cuda_ms(lambda: launch(None), reps=reps)
    wrapper = {"wrapper_ms": cuda_ms(lambda: run(None), reps=reps)} if routed else {}
    through = f", through pgs_sweeps {wrapper['wrapper_ms']:.4f} ms" if routed else ""
    ns = ms * 1e6 / (iters * m)
    lay = k3_layout_fields(m, D.dtype, design, store, B)
    rec = {"design": K3_DESIGN_NAMES[design],
           "store": K3_STORE_NAMES[store] if design == "warp" else "per-lane block"
           if design == "thread" else "full transpose" if lay["shared_d"] else "device memory",
           "max_abs_err": err, "ms": ms, "events_ms": events_ms,
           "reps": reps, "ns_per_row": ns, "cycles_per_row": ns * clock / 1e3,
           "share_of_bound": bound / ms, **wrapper, **lay}
    print(f"{name} (m {m}, B {B}, {iters} sweeps, reg {reg:g}): max |d out| {err:.3e} of scale "
          f"{scale:.3e} (tol {tol:g}) on {int(keep.sum())} lanes, the inactive lane 1 at 0 and "
          f"the {int((~ok_in).sum())} lanes with NaN inputs NaN; {ms:.4f} ms ({reps} launches in "
          f"a CUDA graph), {events_ms:.4f} ms (CUDA events){through}; {ns:.1f} ns, "
          f"{rec['cycles_per_row']:.0f} cycles a row update at {clock:.0f} MHz; {bound / ms:.2%} "
          f"of the bound; {rec['smem_bytes_a_block']} bytes of shared memory a block of "
          f"{rec['lanes_a_block']} lanes (D {'in shared memory' if rec['shared_d'] else 'read from device memory'}), "
          f"{rec['lanes_per_sm']} lanes an SM, {rec['waves']} wave(s) at B = {B}; ptxas "
          f"{rec['registers']} registers, spill stores/loads {rec['spill_store_bytes']}/"
          f"{rec['spill_load_bytes']} bytes; card {smi}")
    return rec


def k3_check(label, sc, step, params, state, kind, smi, iters=K3_ITERS):
    """K3 against its plain version (qp.pgs_sweeps) on the inputs of a real
    solve of the step at state's lanes (K3_B of them), at iters
    sweeps (the plain version replayed from a CUDA graph of one sweep, held
    bit for bit against its launched run at m <= 8), with lane 1 not active
    and lane 2 NaN (r[2, 0]): each of k3_variants (k3_time_design) on the
    output that matters (k3_inputs), the routed one on pgs_sweeps's route;
    the SM clock read while the routed variant runs. Returns the routed
    variant's kernel record fields, the others under "also_timed"."""
    (D, r, lo, hi, reg), how = k3_inputs(sc, step, params, state, kind)
    B, m = r.shape
    r = r.clone()
    r[2, 0] = float("nan")
    active = torch.ones(B, dtype=torch.bool, device=r.device)
    active[1] = False
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    lam_ref = qp.pgs_sweeps(D, r, lo, hi, iters, reg, active, graph=True)
    end.record()
    torch.cuda.synchronize()
    plain_ms = start.elapsed_time(end)
    if m <= 8:   # the graph replays the plain version's own kernels: bit for bit
        again = qp.pgs_sweeps(D, r, lo, hi, iters, reg, active)
        if not ((again == lam_ref) | (again.isnan() & lam_ref.isnan())).all():
            raise AssertionError(f"K3 {label}: the plain version's graph replay differs")
    if lam_ref[1].abs().max() != 0 or torch.isfinite(lam_ref[2]).any():
        raise AssertionError(f"K3 {label}: the plain version swept the inactive lane or kept the "
                             "NaN lane finite")
    ref = k3_output(how, lam_ref)
    # lanes held to the tolerance: every active one whose inputs hold no NaN
    # (a float32 rollout's diverged lanes come NaN; they and lane 2 must come
    # out NaN in both)
    ok_in = ~(D.isnan().flatten(1).any(1) | r.isnan().any(1) | lo.isnan().any(1)
              | hi.isnan().any(1))
    keep = ok_in & active
    flops = k3_flops(m, iters) * B
    nbytes = D.element_size() * B * (m * m + 4 * m)
    peak = PEAK_F64_FLOPS if D.dtype == torch.float64 else PEAK_F32_FLOPS
    t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
    bound = max(t_ops, t_bytes)
    variants = k3_variants(m, D.dtype, torch.equal(D, D.mT), B)
    clock, samples = sm_clock_mhz(lambda: pgs_kernel.pgs_sweeps(D, r, lo, hi, iters, reg),
                                  seconds=0.5)
    recs = [k3_time_design(label, D, r, lo, hi, iters, reg, active, d, s, k == 0, how, ref,
                           keep, ok_in, bound, clock, smi)
            for k, (d, s) in enumerate(variants)]
    print(f"K3 {label} {str(D.dtype)[6:]}: plain {plain_ms:.1f} ms (one sweep's CUDA graph, "
          f"replayed); bound {bound:.4f} ms ({'operations' if t_ops >= t_bytes else 'bytes'}: "
          f"{flops:.3e} flops, {nbytes} bytes); SM clock {clock:.0f} MHz ({samples} samples of "
          f"nvidia-smi under the routed launch); routed {recs[0]['design']} "
          f"{recs[0]['ms']:.4f} ms against " + ", ".join(
              f"{r_['design']} ({r_['store']}) {r_['ms']:.4f} ms: {r_['ms'] / recs[0]['ms']:.2f}x"
              for r_ in recs[1:]))
    return {**recs[0], "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes", "m": m, "B": B,
            "dtype": str(D.dtype)[6:], "sm_clock_mhz": clock, "also_timed": recs[1:]}


def k3_wide(smi, device="cuda", seed=0):
    """K3 at m = K3_WIDE_M on K3_B lanes of a synthetic dual made on the card
    from a seed (D = A A^T / k + 1e-3 I, A [m, k] ~ N(0, 1), k = m / 2, made
    symmetric bit for bit; r ~ N(0, 1); boxes -U(0.1, 1), U(0.1, 1)), and on
    the same D with a skew part (a dual QP's D is not symmetric), in
    float64 and float32: each of k3_variants held against qp.pgs_sweeps at
    K3_WIDE_ITERS sweeps on lam itself (1e-10 / 2e-4 of scale), with lane 1
    not active and lane 2 NaN, and timed (2 launches) as k3_check's are.
    Returns {"<dtype> <symmetric|unsymmetric>": [records, routed first]}."""
    m, B, iters, reg = K3_WIDE_M, K3_B, K3_WIDE_ITERS, 1e-12
    gen = torch.Generator(device=device).manual_seed(seed)
    rand = lambda *shape: torch.rand(*shape, generator=gen, device=device, dtype=torch.float64)
    A = torch.randn(B, m, m // 2, generator=gen, device=device, dtype=torch.float64)
    D = A @ A.mT / (m // 2) + 1e-3 * torch.eye(m, device=device, dtype=torch.float64)
    D = 0.5 * (D + D.mT)
    S = torch.randn(B, m, m, generator=gen, device=device, dtype=torch.float64)
    r = torch.randn(B, m, generator=gen, device=device, dtype=torch.float64)
    lo, hi = -(0.1 + 0.9 * rand(B, m)), 0.1 + 0.9 * rand(B, m)
    r[2, 0] = float("nan")
    active = torch.ones(B, dtype=torch.bool, device=device)
    active[1] = False
    keep, ok_in = active.clone(), torch.ones_like(active)
    keep[2] = ok_in[2] = False
    out = {}
    for dtype in (torch.float64, torch.float32):
        for sym, Dx in (("symmetric", D), ("unsymmetric", D + 0.05 * (S - S.mT))):
            Dc, rc, loc, hic = (a.to(dtype) for a in (Dx, r, lo, hi))
            ref = qp.pgs_sweeps(Dc, rc, loc, hic, iters, reg, active, graph=True)
            peak = PEAK_F64_FLOPS if dtype == torch.float64 else PEAK_F32_FLOPS
            bound = max(k3_flops(m, iters) * B / peak,
                        Dc.element_size() * B * (m * m + 4 * m) / PEAK_BYTES_PER_S) * 1e3
            clock, _ = sm_clock_mhz(lambda: pgs_kernel.pgs_sweeps(Dc, rc, loc, hic, iters, reg),
                                    seconds=0.3)
            label = f"wide {sym}"
            out[f"{str(dtype)[6:]} {sym}"] = [
                k3_time_design(label, Dc, rc, loc, hic, iters, reg, active, d, st, k == 0,
                               ("lam", None), ref, keep, ok_in, bound, clock, smi, reps=2)
                for k, (d, st) in enumerate(k3_variants(m, dtype, sym == "symmetric", B))]
    return out


def k3_counts():
    """K3's counters: (launches on the card, CPU runs, launches by design)."""
    by = dict(pgs_kernel.design_launches)
    return sum(by.values()), pgs_kernel.pgs_sweeps_host_runs, by


def k3_reset():
    pgs_kernel.pgs_sweeps_host_runs = 0
    pgs_kernel.design_launches.update({d: 0 for d in pgs_kernel.design_launches})


def k3_launches_ok(device, counts, n):
    """Every one of n sweep solves launched on the card (a CPU rehearsal's
    on the g++ build), by the routed designs only (none by warp_div)."""
    launches, host, by = counts
    return (launches, host) == fric_want(device, n) and by["warp_div"] == 0


def fric64(sid, device):
    """The float64 certificate rollout of friction case sid at FRIC_B64 lanes
    (mzoo_state0) for its full nsteps: a dict of its readings, the first
    FRIC_SHARE_LANES lanes' history (q, qdot, fbm after each step) and the
    final state, on the CPU."""
    ts = time.perf_counter()
    fn = scenes_matlab.SCENE_FNS.get(sid)
    sc64 = build_mscene(sid, dtype=torch.float64, device=device)
    s64 = mzoo_state0(sc64, FRIC_B64[sid], device, torch.float64)
    step64 = sc64.make_step("euler_fric")
    k3_reset()
    final64, hist64, fbm64, its64, solves64 = fric_rollout(sc64, step64, fn, s64, sc64.nsteps)
    if device != "cpu":
        torch.cuda.synchronize()
    n, cpu = FRIC_SHARE_LANES, lambda a: a.detach().cpu()
    H = fric_H(sc64, s64, final64)
    return {"H": H, "seconds": time.perf_counter() - ts,
            "launches": k3_counts(), "solves": solves64, "its_max": its64.amax(1).tolist(),
            "its_mean": [round(float(v), 2) for v in its64.double().mean(1)],
            "hist": (cpu(hist64[0][:, :n]), cpu(hist64[1][:, :n])), "fbm": cpu(fbm64[:, :n]),
            "final": (cpu(final64.q), cpu(final64.qdot), cpu(final64.aux["fbm"]))}


def fric64_job(job):
    """A worker of phase 30's pool: ("fric64", sid, device) -> (sid, fric64)."""
    torch.set_num_threads(1)   # a worker's host work is small launches
    return job[1], fric64(job[1], job[2])


def fric_want(device, n):
    """K3's (launches, CPU runs) for n sweep solves: every one on the card (a
    CPU rehearsal's on the g++ build)."""
    return (n, 0) if device != "cpu" else (0, n)


def fric32(sid, device):
    """The float32 rollout of friction case sid at FRIC_B32 lanes for
    min(nsteps, FRIC_F32_STEPS[sid]) steps, timed by CUDA events after a
    warm step on 8 lanes: a dict of the scene, its step, the final state and
    the readings; K3 launched once for each sweep solve and no CPU run."""
    fn = scenes_matlab.SCENE_FNS.get(sid)
    sc = build_mscene(sid, dtype=torch.float32, device=device)
    K = min(sc.nsteps, FRIC_F32_STEPS[sid])
    step = sc.make_step("euler_fric")
    s32 = mzoo_state0(sc, FRIC_B32, device, torch.float32)
    warm = State(q=s32.q[:8], qdot=s32.qdot[:8])
    step(fn(sc.params, sc.params["h"]) if fn else sc.params, warm)
    torch.cuda.synchronize()
    k3_reset()
    solves = [0]

    def counted(params, s):
        out = step(params, s)
        solves[0] += step.stats["sweep_solves"]
        return out

    final, dt = timed_rollout(integrators.make_simulate(counted, K, scene_fn=fn), sc.params,
                              s32, 1)
    l32 = k3_counts()
    finite = float((torch.isfinite(final.q) & torch.isfinite(final.qdot)).all(-1)
                   .double().mean())
    if not k3_launches_ok(device, l32, solves[0]) or solves[0] == 0:
        raise AssertionError(f"mscene {sid} f32: K3 launches {l32}, want "
                             f"{fric_want(device, solves[0])} by the routed designs")
    return {"sc": sc, "step": step, "final": final, "K": K, "dt": dt, "finite": finite,
            "launches": l32[0] + l32[1], "by_design": l32[2], "solves": solves[0]}


def fric_case(sid, device, smi, res, r32, line):
    """Phase 30's checks of friction case sid: its float64 certificate
    rollout res (fric64) and float32 rollout r32 (fric32), and the float32
    step against float64 per step (per_step_share); fills line[sid] and
    returns the float64 scene, step and final state for the K3 checks."""
    fn = scenes_matlab.SCENE_FNS.get(sid)
    sc64 = build_mscene(sid, dtype=torch.float64, device=device)
    step64 = sc64.make_step("euler_fric")
    B64, t64, H = FRIC_B64[sid], res["seconds"], res["H"]
    l64, solves64 = res["launches"], res["solves"]
    its_max, its_mean = res["its_max"], res["its_mean"]
    dev = lambda a: a.to(device)
    hist64, fbm64 = tuple(map(dev, res["hist"])), dev(res["fbm"])
    fq, fqd, ffbm = map(dev, res["final"])
    final64 = State(q=fq, qdot=fqd, aux={"fbm": ffbm})
    s64 = mzoo_state0(sc64, FRIC_SHARE_LANES, device, torch.float64)
    err, ok = band_ok(sid, H, sc64.Hexpected["euler_fric"])
    counts = friction.row_counts(sc64.friction_model)
    print(f"mscene {sid} ({sc64.name}; N {sc64.topo.njoints}, nr {sc64.topo.nr}, {counts}"
          f"{', scene_fn' if fn else ''}): f64 {sc64.nsteps} steps at B {B64} in {t64:.1f} s"
          f"{' (in the pool)' if sid in FRIC_POOLED else ''}, lane 0 H {H!r} vs "
          f"{sc64.Hexpected['euler_fric']!r}, {FRIC_BANDS[sid][0]} err {err:.3e} (band "
          f"{FRIC_BANDS[sid][1]:g}); K3 launches {l64[0]} for {solves64} sweep solves (by "
          f"design {l64[2]}), CPU runs {l64[1]}")
    print(f"mscene {sid} f64 staggered-projections iterations a step, max over lanes: "
          f"{its_max}")
    print(f"mscene {sid} f64 staggered-projections iterations a step, mean over lanes: "
          f"{its_mean}")
    if not ok:
        raise AssertionError(f"mscene {sid}: certificate off its band ({H} vs "
                             f"{sc64.Hexpected['euler_fric']})")
    if not k3_launches_ok(device, l64, solves64):
        raise AssertionError(f"mscene {sid} f64: K3 launches {l64}, want "
                             f"{fric_want(device, solves64)} by the routed designs")

    sc, step, K, dt, finite = r32["sc"], r32["step"], r32["K"], r32["dt"], r32["finite"]
    n = FRIC_SHARE_LANES
    (share_q, share_qd), lanes = per_step_share(sc, step, fn, s64, hist64, K, fbm64=fbm64)
    q1 = step(sc.params if fn is None else fn(sc.params, sc.params["h"] * torch.arange(
        1, K + 1, device=device, dtype=sc.params["h"].dtype).repeat_interleave(n)), lanes).q
    err_q = (q1.reshape(K, n, -1).double() - hist64[0][:K, :n]).abs().amax(-1) / \
        hist64[0][:K, :n].abs().amax((1, 2)).clamp(min=1.0)[:, None]
    q_p50, _, q_p99, q_max = quantiles(err_q.flatten())
    share_q2 = float((err_q <= 1e-2).double().mean(1).min())
    print(f"mscene {sid} f32 {K} steps at B {FRIC_B32}: {FRIC_B32 * K / dt:.1f} steps/s "
          f"({dt * 1e3 / K:.3f} ms a step), finite {finite:.4f}; K3 launches {r32['launches']} "
          f"for {r32['solves']} sweep solves (by design {r32['by_design']}); per step vs f64 ({n} lanes): q {share_q:.4f}, qdot "
          f"{share_qd:.4f} of lanes within 1e-3 (worst step); q within 1e-2 {share_q2:.4f}; q "
          f"off of scale median {q_p50:.3e}, p99 {q_p99:.3e}, max {q_max:.3e}"
          f"{' (held on the printed share)' if sid in FRIC_F32_HELD else ''}; card {smi}")
    if sid not in FRIC_F32_HELD and (share_q < 0.95 or finite < 0.95):
        raise AssertionError(f"mscene {sid}: f32 steps off the f64 run ({share_q}) or "
                             f"finite share {finite}")
    line[str(sid)] = {
        "H": H, "band_err": err, "f64_B": B64, "f64_steps": sc64.nsteps,
        "f64_seconds": t64, "sp_iters_max": its_max, "sp_iters_mean": its_mean,
        "f32_steps": K, "f32_steps_per_s": FRIC_B32 * K / dt, "f32_finite_frac": finite,
        "f32_per_step_share_q": share_q, "f32_per_step_share_qdot": share_qd,
        "f32_per_step_share_q_1e-2": share_q2, "f32_q_err_median": q_p50,
        "f32_q_err_max": q_max, "f32_held": sid in FRIC_F32_HELD,
        "k3_launches": {"float64": l64[0] + l64[1], "float32": r32["launches"]},
        "k3_launches_by_design": {"float64": l64[2], "float32": r32["by_design"]},
        "rows": counts}
    return sc64, step64, final64


def phase_friction_zoo(device="cuda", smi=""):
    """Phase 30: the friction zoo (mscenes 27-31 and 33) through
    make_step("euler_fric") and make_simulate (scene_fn_33 for mscene 33),
    in three parts. (1) Alone on the card, each case in float32 at FRIC_B32
    = 1024 lanes for min(nsteps, FRIC_F32_STEPS[sid]) steps (fric32): timed
    by CUDA events after a warm step, finite_frac, K3 launched once for
    each sweep solve and never on the CPU. (2) Each case's float64
    certificate rollout at FRIC_B64 lanes (mzoo_state0, fric64; the cases of
    FRIC_POOLED in a pool of processes on the card beside the others): lane
    0's certificate in its band of tests/test_friction.py, the
    staggered-projections iterations of each step (max and mean over the
    lanes), and the float32 step against it per step (per_step_share on
    FRIC_SHARE_LANES lanes, warm-started from its fbm), held at >= 0.95 with
    finite_frac, printed only for the cases in FRIC_F32_HELD (fric_case).
    (3) Alone on the card, K3 against its plain version on the solves of
    K3_CASES in float64 and float32, timed (k3_check), and at m = K3_WIDE_M
    on a synthetic dual (k3_wide). Returns (the K3
    records by (label, dtype), with their launches; the phase's JSON
    line)."""
    t0 = time.perf_counter()
    line, records, finals = {}, {}, {}
    r32 = {sid: fric32(sid, device) for sid in FRIC_BANDS}
    t1 = time.perf_counter()
    pool = (torch.multiprocessing.get_context("spawn").Pool(len(FRIC_POOLED))
            if FRIC_POOLED else None)
    pending = {sid: pool.apply_async(fric64_job, (("fric64", sid, device),))
               for sid in FRIC_POOLED} if pool else {}
    try:
        for sid in sorted(FRIC_BANDS, key=lambda sid: sid in pending):   # pooled ones last
            res = pending[sid].get(timeout=1000)[1] if sid in pending else fric64(sid, device)
            finals[sid] = fric_case(sid, device, smi, res, r32[sid], line)
    finally:
        if pool:
            pool.close()
            pool.join()
    t2 = time.perf_counter()
    for label, sid, kind in K3_CASES:
        fn = scenes_matlab.SCENE_FNS.get(sid)
        at = lambda s: fn(s.params, s.params["h"] * s.nsteps) if fn else s.params
        for dtype, (scx, stepx, fin) in (("float64", finals[sid]),
                                         ("float32", (r32[sid]["sc"], r32[sid]["step"],
                                                      r32[sid]["final"]))):
            lanes = State(q=fin.q[:K3_B], qdot=fin.qdot[:K3_B],
                          aux={"fbm": fin.aux["fbm"][:K3_B]})
            rec = k3_check(label, scx, stepx, at(scx), lanes, kind, smi)
            # launches: the routed design's in that case's rollout in that dtype
            by = line[str(sid)]["k3_launches_by_design"][dtype]
            routed = pgs_kernel.design_of(rec["m"], getattr(torch, dtype))
            records[(label, dtype)] = {**rec, "launches": by[routed]}
    line["k3"] = {f"{label} {dtype}": rec for (label, dtype), rec in records.items()}
    line["k3_wide"] = k3_wide(smi, device)
    t3 = time.perf_counter()
    line["seconds"] = t3 - t0
    print(f"friction zoo phase: {t3 - t0:.1f} s (float32 rollouts {t1 - t0:.1f} s; float64 "
          f"rollouts and per-step shares {t2 - t1:.1f} s, those of {list(FRIC_POOLED)} in a "
          f"pool of {len(FRIC_POOLED)} processes; K3 against its plain version {t3 - t2:.1f} s)")
    return records, line


# ---------------------------------------------------------------------------
# Phase 31: the last modules (L-BFGS MPC, parallel.py, checkpoint, metrics,
# sceneio, export)
# ---------------------------------------------------------------------------

LBFGS_ITERS = 3
# tests/test_io.py:16's scene: two hinge links joined by a spring-damper
TEXT_SCENE = """#options
simt redCGnomat
#link
name top
dens 3
size 3 0.8 0.5
ppos 0 0 0
cpos -1.4 0 0
angl 0.25
type hinge 0 0 1
#link
name middle
dens 3
size 3 0.8 0.5
prnt top
ppos 1.4 0 0
cpos -1.4 0 0
angl 0
type hinge 0 0 1
#spring
lnka top
lnkb middle
posa 1 0 0
posb -1 0 0
stif 100
damp 1
"""


def text_scene():
    """TEXT_SCENE through sceneio.load_scene_text (a SceneBuilder)."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "scene.txt")
        with open(path, "w") as fh:
            fh.write(TEXT_SCENE)
        return sceneio.load_scene_text(path)


def bit_equal(a, b) -> bool:
    """Equal bit for bit as values, a NaN (a diverged lane) equal to a NaN."""
    if isinstance(a, torch.Tensor):
        return (a.shape == b.shape and a.dtype == b.dtype
                and bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all()))
    return type(a) is type(b) and a == b


class Counted:
    """An objective that counts its evaluations (each with its gradient in
    the solvers)."""

    def __init__(self, fn):
        self.fn, self.calls = fn, 0

    def __call__(self, *args):
        self.calls += 1
        return self.fn(*args)


def main_path_problem(device, nlinks=12, horizon=50, B=1024, dtype=torch.float32, use_kernel=None):
    """bench.py's batched MPC problem on the port: (scene, objective
    (make_objective_batched on the route use_kernel picks), p0, state0,
    targets)."""
    sc = scene_chain(nlinks).compile(dtype=dtype, device=device)
    task = mpc.PointPosTask(body=sc.topo.njoints - 1, wp=1.0, wreg=1e-6, pscale=1e3)
    obj = mpc.make_objective_batched(sc.topo, sc.force_fns, task, (0.5, 0.0, 0.0), horizon, CFG,
                                     use_kernel=use_kernel)
    p0, targets = bench_inputs(sc.topo.nr, B, device, dtype)
    s0 = State(q=sc.state0.q.expand(B, -1).contiguous(),
               qdot=sc.state0.qdot.expand(B, -1).contiguous())
    return sc, obj, p0, s0, targets


def phase_lbfgs(device="cuda", B=1024, horizon=50, iters=LBFGS_ITERS):
    """Phase 31 (1): the L-BFGS MPC solve (mpc.make_mpc_solver(method=
    "lbfgs"): optax.lbfgs(memory_size=8) with its zoom line search, every
    lane its own) at bench.py's scale on the kernel route (K1a), timed by
    metrics.bench_throughput; 49 launches of the cooperative design an
    evaluation and none of the other; the objective at the returned P (the
    same P) held against the float64 op-level route as closely as the
    float32 op-level route is; and the optimizer alone on the card against
    the CPU (Rosenbrock, f64, 1e-10). No small-size solve is held: which
    trial each lane's search accepts turns on rounding (its first trial is
    a step of length 1 in p, a torque of 1000, and later ones land where 3
    chord iterations do not converge), so at chain-4, horizon 5, B = 64
    the kernel route's solve and the op-level route's agree on 0.05 of
    lanes, and on the CPU the float64 solve against itself from
    p0 (1 + 1e-7) on 0.11 (tests/test_torch_lbfgs.py holds the solver to
    optax's). Returns (launches, the lbfgs_path line)."""
    sc, obj, p0, s0, targets = main_path_problem(device, B=B, horizon=horizon)
    design = design_of(sc, sc.params)
    counted = Counted(obj)
    solve = mpc.make_mpc_solver(counted, iters=iters, method="lbfgs")
    last = {}

    def run(*args):
        last["res"] = solve(*args)
        return last["res"]

    args = (sc.params, p0, s0, targets)
    reset_launches()
    dt, _ = metrics.bench_throughput(run, args, n_warmup=0, n_reps=1)
    launches, other = launches_of(design), launches_of() - launches_of(design)
    evals = counted.calls
    res = last["res"]
    with torch.no_grad():
        before, after = obj(sc.params, p0, s0, targets), obj(sc.params, res.p, s0, targets)
    fin = torch.isfinite(before) & torch.isfinite(after)
    fell = float((after[fin] < before[fin]).double().mean())
    finite_frac = float(torch.isfinite(after).double().mean())
    med = lambda v: float(v[torch.isfinite(v)].median())
    line = {"B": B, "horizon": horizon, "iters": iters, "seconds_per_solve": dt,
            "evals_per_iter": evals / iters, "launches": launches,
            "launches_per_eval": launches / evals, "design": design,
            "median_objective_before": med(before), "median_objective_after": med(after),
            "fell_share_of_finite": fell, "finite_frac": finite_frac}
    print(f"lbfgs chain-12 (B = {B}, horizon {horizon}, {iters} iterations, f32): "
          f"{dt:.3f} s a solve (metrics.bench_throughput), {evals / iters:.1f} value-and-gradient "
          f"evaluations an iteration, chord kernel launches {launches} ({launches / evals:.1f} "
          f"an evaluation) on the {design} design, {other} on the other; median objective "
          f"{med(before):.6f} -> {med(after):.6f}, fell on {fell:.4f} of the finite lanes, "
          f"finite_frac {finite_frac:.4f}")
    if launches != (horizon - 1) * evals or other:
        raise AssertionError(f"lbfgs: {launches} launches of the {design} design and {other} of "
                             f"the other in {evals} evaluations, want {horizon - 1} each")
    if res.p.shape != p0.shape or not torch.isfinite(res.p[torch.isfinite(after)]).all():
        raise AssertionError("lbfgs: unexpected shape, or a non-finite P on a finite lane")
    if not med(after) < med(before) or fell < 0.5:
        raise AssertionError("lbfgs: the objective did not fall")

    # The objective at the returned P (the same P) on the op-level route in
    # float32 and in float64. Some lanes' returned P lies where the rollout
    # is rounding-sensitive (the search accepts large torques), so the
    # kernel route is held to the float64 values on as many lanes as the
    # float32 op-level route is, less 1%, and to its finite mask.
    sc64, obj64, _, s64, t64 = main_path_problem(device, B=B, horizon=horizon,
                                                 dtype=torch.float64, use_kernel=False)
    _, obj_plain, _, _, _ = main_path_problem(device, B=B, horizon=horizon, use_kernel=False)
    with torch.no_grad():
        plain = obj_plain(sc.params, res.p, s0, targets).double()
        ref64 = obj64(sc64.params, res.p.double(), s64, t64)
    after = after.double()
    masks = float((torch.isfinite(after) == torch.isfinite(plain)).double().mean())

    def share(v):
        both = torch.isfinite(v) & torch.isfinite(ref64)
        return float(((v - ref64).abs() <= 1e-3 * ref64.abs())[both].double().mean())

    within, within_plain, kernel_vs_plain = share(after), share(plain), float(
        ((after - plain).abs() <= 1e-3 * plain.abs()).double().mean())
    print(f"lbfgs: the objective at the returned P, float32 against the float64 op-level route: "
          f"within rtol 1e-3 on {within:.4f} of lanes finite in both on the kernel route, "
          f"{within_plain:.4f} on the float32 op-level route; kernel route against the float32 "
          f"op-level route {kernel_vs_plain:.4f}, finite masks agree on {masks:.4f}")
    if masks < 0.99 or within < within_plain - 0.01:
        raise AssertionError("lbfgs: the kernel route's objective at the returned P is off the "
                             "op-level route's")

    # the optimizer alone on the card: tests/test_torch_lbfgs.py's Rosenbrock
    # function (f64, 8 iterations) against the same solve on the CPU
    rosen = lambda _, p, s, t: (100.0 * (p[..., 1:] - p[..., :-1] ** 2) ** 2
                                + (1.0 - p[..., :-1]) ** 2).sum(-1)
    start = torch.tensor([-1.2, 1.0, -0.5, 0.8], dtype=torch.float64)
    card, cpu = (mpc.make_mpc_solver(rosen, iters=8, method="lbfgs")(None, start.to(d), None,
                                                                      None).p.cpu()
                 for d in (device, "cpu"))
    rosen_err = float((card - cpu).abs().max() / cpu.abs().max())
    print(f"lbfgs Rosenbrock (f64, 8 iterations): card against CPU {rosen_err:.3e} of scale")
    if rosen_err > 1e-10:
        raise AssertionError("lbfgs: the optimizer's iterates on the card are off the CPU's")

    line["rosenbrock_card_vs_cpu"] = rosen_err
    line["returned_p_kernel_vs_op_level_f32"] = kernel_vs_plain
    line["returned_p_within_1e-3_of_f64"] = within
    line["returned_p_within_1e-3_of_f64_op_level_f32"] = within_plain
    return launches, line


def graft_leg(mesh, nlinks, horizon, use_kernel, device):
    """One leg of __graft_entry__.py's dryrun_multichip (:60-104) on the
    port: the sharded batched MPC training step (forward, adjoint, one Adam
    step) of the nlinks chain at 2 lanes a rank, p0 = 0.003 N(0, 1) and
    targets N(0, 1) (seed 0), its NewtonConfig (tol 1e-6); the mean must be
    finite."""
    sc = scene_chain(nlinks).compile(dtype=torch.float32, device=device)
    cfg = dataclasses.replace(CFG, tol=1e-6)
    task = mpc.PointPosTask(body=nlinks - 1, wp=1.0, wreg=1e-6, pscale=1e3)
    obj = mpc.make_objective_batched(sc.topo, sc.force_fns, task, (0.5, 0.0, 0.0), horizon, cfg,
                                     use_kernel=use_kernel)
    run = parallel.sharded_mpc_batched(mpc.make_mpc_solver_batched(obj, iters=1, lr=0.05), mesh)
    B = 2 * mesh.size()
    rng = np.random.default_rng(0)
    t = lambda a: torch.tensor(a, dtype=torch.float32, device=device)
    p0 = t(0.003 * rng.normal(size=(B, sc.topo.nr)))
    s0 = State(q=sc.state0.q.expand(B, -1).contiguous(),
               qdot=sc.state0.qdot.expand(B, -1).contiguous())
    res, mean = run(sc.params, p0, s0, t(rng.normal(size=(B, 3))))
    if not torch.isfinite(mean):
        raise AssertionError(f"graft leg ({nlinks} links, horizon {horizon}): mean {mean}")
    return float(mean)


def phase_sharded(device="cuda", B=1024, horizon=50):
    """Phase 31 (2): parallel.py on a world of one (NCCL on the card, gloo
    in a CPU rehearsal; a FileStore in a temp dir): sharded_mpc_batched
    over the main path's Adam solve at B = 1024 (49 launches of the
    cooperative design), P bit for bit the unsharded solve's in this
    process (a NaN lane equal to a NaN), the mean the finite-lane mean; then
    __graft_entry__.py's two legs at world size 1 (12 links, horizon 25,
    op level; 2 links, horizon 3, kernel route). Returns (launches, the
    sharded_path line)."""
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
        dist.init_process_group(backend, store=dist.FileStore(os.path.join(tmp, "store"), 1),
                                rank=0, world_size=1)
        try:
            mesh = parallel.make_mesh(model=1)
            setup = time.perf_counter() - t0
            if mesh.device_type != torch.device(device).type or dist.get_backend() != backend:
                raise AssertionError(f"sharded: a {mesh.device_type} mesh on "
                                     f"{dist.get_backend()}")
            sc, obj, p0, s0, targets = main_path_problem(device, B=B, horizon=horizon)
            design = design_of(sc, sc.params)
            solve = mpc.make_mpc_solver_batched(obj, iters=1, lr=0.05)
            ref = solve(sc.params, p0, s0, targets)
            torch.cuda.synchronize()
            reset_launches()
            res, mean = parallel.sharded_mpc_batched(solve, mesh)(sc.params, p0, s0, targets)
            torch.cuda.synchronize()
            launches, other = launches_of(design), launches_of() - launches_of(design)
            same = all(bit_equal(getattr(res, f), getattr(ref, f))
                       for f in ("p", "objective", "grad_norm"))
            fin = torch.isfinite(ref.objective)
            want = float(ref.objective[fin].double().sum() / fin.sum())
            graft = [graft_leg(mesh, 12, 25, False, device), graft_leg(mesh, 2, 3, True, device)]
        finally:
            dist.destroy_process_group()
    print(f"sharded (world of one, {backend}; setup {setup:.2f} s): sharded_mpc_batched over the "
          f"main path's solve (B = {B}) {'equals' if same else 'differs from'} the unsharded "
          f"solve bit for bit; mean {float(mean):.6f} (finite-lane mean {want:.6f}); chord "
          f"kernel launches {launches} on the {design} design, {other} on the other; __graft_entry__ legs' means "
          f"{graft[0]:.6f} (12 links, horizon 25) and {graft[1]:.6f} (2 links, horizon 3, kernel "
          "route)")
    if not same:
        raise AssertionError("sharded: the sharded solve differs from the unsharded one")
    if abs(float(mean) - want) > 1e-5 * abs(want):
        raise AssertionError(f"sharded: mean {float(mean)} is not the finite-lane mean {want}")
    if launches != horizon - 1 or other:
        raise AssertionError(f"sharded: {launches} launches of the {design} design, {other} of "
                             f"the other, want {horizon - 1}")
    return launches, {"B": B, "world_size": 1, "backend": backend, "bit_equal": same,
                      "mean": float(mean), "finite_lane_mean": want, "launches": launches,
                      "design": design, "graft_means": graft, "setup_s": setup}


def phase_checkpoint(device="cuda", B=1024, horizon=50, n=6):
    """Phase 31 (3): n Adam iterations of the main path's objective through
    checkpoint.checkpointed_run (a snapshot every 2), stopped after 3 and
    resumed: P and the Adam moments bit for bit the uninterrupted run's.
    Returns the seconds of the three runs."""
    sc, obj, p0, s0, targets = main_path_problem(device, B=B, horizon=horizon)
    init, update = mpc._adam(0.05)

    def iterate(carry, _i):
        P, opt_state = carry
        Pg = P.detach().requires_grad_(True)
        (g,) = torch.autograd.grad(obj(sc.params, Pg, s0, targets).sum(), Pg)
        step, opt_state = update(g, opt_state)
        return P + step, opt_state

    t0 = time.perf_counter()
    carry0 = (p0, init(p0))
    ref = carry0
    for i in range(n):
        ref = iterate(ref, i)
    with tempfile.TemporaryDirectory() as tmp:
        checkpoint.checkpointed_run(iterate, carry0, n // 2, tmp, every=2)
        full = checkpoint.checkpointed_run(iterate, carry0, n, tmp, every=2)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    a, b = checkpoint.tree_flatten(full), checkpoint.tree_flatten(ref)
    same = len(a) == len(b) and all(bit_equal(x, y) for x, y in zip(a, b))
    print(f"checkpoint: {n} Adam iterations of the main path (B = {B}) stopped after {n // 2} and "
          f"resumed {'equal' if same else 'differ from'} the uninterrupted run bit for bit "
          f"(P, both moments, count {full[1][2]}); {dt:.1f} s for the three runs")
    if not same or type(full[1][2]) is not int:
        raise AssertionError("checkpoint: the resumed run differs from the uninterrupted one")
    return dt


def phase_text_scene(device="cuda", B=1024, nsteps=50):
    """Phase 31 (4): TEXT_SCENE through sceneio.load_scene_text, compiled
    on the card in float32, nsteps BDF2 steps at B lanes (zoo_state0)
    through make_simulate on the default route (the chord kernel built for
    its shape, in phase 2), every step finite; lane 0's energy drift
    (metrics.energy_drift); export_objs, export_html and FrameExporter of
    lane 0's trajectory into a temp dir. Returns the line's entry."""
    sc = text_scene().compile(dtype=torch.float32, device=device)
    design = design_of(sc, sc.params)
    step = integrators.make_bdf2_step_batched(sc.topo, sc.force_fns, CFG)
    s0 = integrators.bdf2_init(zoo_state0(sc, B, device, torch.float32))
    reset_launches()
    final, (hq, hqd) = integrators.make_simulate(step, nsteps, record=True)(sc.params, s0)
    torch.cuda.synchronize()
    launches = launches_of(design)
    finite = bool(torch.isfinite(hq).all() and torch.isfinite(hqd).all())
    drift = metrics.energy_drift(sc, State(q=final.q[0], qdot=final.qdot[0]))
    with tempfile.TemporaryDirectory() as tmp:
        traj = hq[:, 0]
        n_obj = export.export_objs(sc, traj, os.path.join(tmp, "objs"))
        export.export_html(sc, traj, os.path.join(tmp, "viewer.html"))
        ex = export.FrameExporter(sc, os.path.join(tmp, "frames"))
        for k in range(nsteps):
            kin = model.forward_kinematics(sc.topo, sc.params, hq[k, :1], hqd[k, :1])
            ex.add_frame((k + 1) * sc.h, kin)
        with open(ex.write()) as fh:
            n_frames = len(json.load(fh)["frames"])
        sizes = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(tmp) for f in fs)
    print(f"text scene (tests/test_io.py:16's, {sc.topo.njoints} links and a spring, B = {B}, "
          f"f32): {nsteps} BDF2 steps on the default route, {launches} launches of the {design} "
          f"design, every step finite: {finite}; lane 0's energy drift {drift:.6e}; exported "
          f"{n_obj} OBJ frames, a viewer and {n_frames} JSON frames ({sizes} bytes)")
    if not finite or n_obj != nsteps or n_frames != nsteps:
        raise AssertionError("text scene: a non-finite step or a missing export")
    if launches != nsteps - 1:
        raise AssertionError(f"text scene: {launches} launches, want {nsteps - 1}")
    return {"steps": nsteps, "launches": launches, "design": design,
            "energy_drift_lane0": drift, "obj_frames": n_obj}


def phase_last_modules(device="cuda"):
    """Phase 31: the L-BFGS MPC, the sharded solve, checkpoint and resume,
    and the text scene (each above). Returns (L-BFGS launches, sharded
    launches, lbfgs_path, sharded_path)."""
    t0 = time.perf_counter()
    lbfgs_launches, lbfgs_line = phase_lbfgs(device)
    sharded_launches, sharded_line = phase_sharded(device)
    sharded_line["checkpoint_s"] = phase_checkpoint(device)
    sharded_line["text_scene"] = phase_text_scene(device)
    print(f"phase 31: {time.perf_counter() - t0:.1f} s")
    return lbfgs_launches, sharded_launches, lbfgs_line, sharded_line


def ptxas_kernels(report: str):
    """(kernel, registers, frame bytes, spill store bytes, spill load bytes)
    of each kernel in an nvcc -Xptxas -v report, the kernel named by its
    template arguments (<N,NR,FEAT>, <N,M>)."""
    out, name, frame = [], None, (0, 0, 0)
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '([^']*)'", line)
        if m:
            name = "<" + ",".join(re.findall(r"Li(\d+)E", m.group(1))) + ">"
            frame = (0, 0, 0)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill "
                      r"loads", line)
        if m:
            frame = tuple(int(v) for v in m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m and name is not None:
            out.append((name, int(m.group(1)), *frame))
            name = None
    return out


@functools.lru_cache(maxsize=None)
def probe_build(build):
    """The cooperative build `build` again with its phase probe
    (-DCHORD_COOP_PROBE): COOP_PROBE for the fixed library."""
    if build is chord_kernel.BUILD_COOP:
        return COOP_PROBE
    return KernelBuild(build.name + "_probe", build.sources,
                       defines=build.defines + ("-DCHORD_COOP_PROBE",))


# The K1b paths' scenes (uni6, sph4 and scene 9's FREE3D body)
QDEP_SCENES = (("universal-6", lambda: uni6()), ("spherical-4", lambda: sph4()),
               ("free3d scene 9", lambda: free3d()))
# nvcc seconds of each library of phase 2, by name
NVCC_SECONDS = {}


def on_demand_builds():
    """The builds made for one scene (chord_kernel.build_for,
    qp_kernel.coop_build_for and build_for) that the phases launch, by the
    shape rule on each case's scene, params and solve mode (nothing is built
    to decide): the K1b paths' and the default-route cases' (phase 26; the
    QP's in both designs, the thread-per-lane one its yardstick); and the
    cooperative probe build of uni6 (phase 25); the scene zoo's (phase
    27); the text scene's and the 2-link chain's of phase 31; and the
    thread-per-lane builds that phase 26's chord cases and the umbrella
    are timed against."""
    out = []
    both = [c[1:4] for c in DEFAULT_ROUTE] + [(make, CFG, None) for label, make in ZOO
                                              if label in ZOO_BOTH_DESIGNS]
    cases = ([(make, CFG, None) for _, make in QDEP_SCENES] + [c[1:4] for c in DEFAULT_ROUTE]
             + [(make, CFG, None) for _, make in ZOO]
             + [(text_scene, CFG, None), (lambda: scene_chain(2), CFG, None)])
    for make, cfg, draws, lane in [(*c, False) for c in cases] + [(*c, True) for c in both]:
        sc = make().compile(dtype=torch.float32, device="cpu")
        params = sc.params if draws is None else draws(sc.params, sc.force_fns, 4)
        out.append(chord_kernel.scene_build(sc.topo, sc.force_fns, params, cfg,
                                            thread_per_lane=lane))
    out.append(probe_build(out[0]))
    sc = build_mscene(6, dtype=torch.float32, device="cpu")
    n, m = contact_qps(sc, mscene6_states(sc, 1, "cpu", torch.float32))[2].shape[1:][::-1]
    out += [qp_kernel.library_of(n, m), qp_kernel.build_for(n, m)]
    fixed = set(chord_kernel.BUILDS) | {qp_kernel.BUILD, qp_kernel.BUILD_COOP, COOP_PROBE}
    return tuple(dict.fromkeys(b for b in out if b not in fixed))


def phase_build():
    """Build every kernel library, one nvcc each, side by side: the fixed
    libraries and the builds that the phases make for one scene; print
    their ptxas reports and the cooperative design's layout."""
    t0 = time.perf_counter()
    fixed = chord_kernel.BUILDS + (qp_kernel.BUILD, qp_kernel.BUILD_COOP, COOP_PROBE,
                                   pgs_kernel.BUILD, pgs_kernel.build_for(K3_WIDE_M))
    builds = fixed + on_demand_builds()
    for build in builds:  # one nvcc per library, side by side
        build.start()
    done = {}
    while len(done) < len(builds):  # each nvcc's time, read to 0.1 s
        done.update({b.name: time.perf_counter() - t0 for b in builds
                     if b.name not in done and not b.compiling()})
        time.sleep(0.1)
    NVCC_SECONDS.update(done)
    coop_builds, qp_coop_builds = [], []
    for build in builds:
        if build.sources[0].startswith("dual_pgs"):
            qp_kernel._build_lib(build)
            if qp_kernel.is_coop(build):
                qp_coop_builds.append(build)
        elif build.name.endswith("_probe"):
            build.load()
        elif build.sources == pgs_kernel.BUILD.sources:
            pgs_kernel._lib(build)
        else:
            chord_kernel._build_lib(build)
            if chord_kernel.is_coop(build):
                coop_builds.append(build)
    print(f"build: {time.perf_counter() - t0:.1f} s; nvcc of each library (side by side, s): "
          + ", ".join(f"{n} {s:.1f}" for n, s in done.items()))
    for build in builds:
        if build.sources == pgs_kernel.BUILD.sources:
            for key, (regs, stores, loads) in sorted(k3_ptxas(build.ptxas_report).items()):
                print(f"ptxas {build.name} {key}: {regs} registers, spill stores/loads "
                      f"{stores}/{loads}")
            continue
        for kernel, regs, frame, stores, loads in ptxas_kernels(build.ptxas_report):
            print(f"ptxas {build.name} {kernel}: {regs} registers, {frame}-byte frame, "
                  f"spill stores/loads {stores}/{loads}")
    for build in coop_builds:
        keys = chord_kernel.COOP_INSTANTIATED if build is chord_kernel.BUILD_COOP else [
            tuple(int(d.split("=")[1]) for d in build.defines[1:4])]
        print(f"{build.name} layout: lanes (warps) a block and dynamic shared memory a block: "
              + ", ".join(f"{key} {build.lib.chord_bdf2_coop_lanes_per_block(*key)} lanes, "
                          f"{build.lib.chord_bdf2_coop_smem_bytes(*key)} bytes" for key in keys))
    for build in qp_coop_builds:
        keys = qp_kernel.INSTANTIATED if build is qp_kernel.BUILD_COOP else [
            tuple(int(d.split("=")[1]) for d in build.defines)]
        print(f"{build.name} layout: threads a lane, lanes a block and dynamic shared memory a "
              "block: " + ", ".join(
                  f"{key} {build.lib.dual_pgs_coop_layout(*key, 0)} threads, "
                  f"{build.lib.dual_pgs_coop_layout(*key, 1)} lanes, "
                  f"{build.lib.dual_pgs_coop_layout(*key, 2)} bytes" for key in keys))


def phase_coop_probe(device="cuda", B=1024):
    """Where the cooperative kernel's time goes: its probe build on phase 3's
    chain-12 inputs, phase 8's chain-ground-12 ones, phase 22's
    chain-ground-12 ones in the guarded mode, phase 18's per-lane
    chain-ground-12 ones, phase 10's spring-chain ones, phase 18's
    per-lane spring-chain ones, the universal-6 chain's (the K1b build,
    its probe built for it) and phase 11's and phase 18's scene-13 ones (the
    cable builds, lane-shared and per-lane), the cycles of the last of 52
    launches (two
    warm, 50 timed); returns {case: {"total_cycles", "probe_ms", phase: mean
    cycles a lane}}. The probe's clock reads cost time of their own, so its
    ms is printed, to be read beside the kernel's of phases 3, 8, 10, 11,
    18 and 22."""
    i = ctypes.c_int

    def probe_lib(scene, params, cfg):
        lib = probe_build(chord_kernel.scene_build(scene.topo, scene.force_fns, params,
                                                   cfg)).load()
        chord_kernel.set_coop_argtypes(lib)
        lib.chord_bdf2_coop_phases.restype = i
        lib.chord_bdf2_coop_phase_name.argtypes = [i]
        lib.chord_bdf2_coop_phase_name.restype = ctypes.c_char_p
        return lib, [lib.chord_bdf2_coop_phase_name(k).decode()
                     for k in range(lib.chord_bdf2_coop_phases())]

    sc = scene_chain(12).compile(dtype=torch.float32, device=device)
    states, tau = rand_states(sc.topo.nr, B, seed=1, device=device)
    scg = chain_ground(12).compile(dtype=torch.float32, device=device)
    gstates, gparams, _ = rollout_states(scg, B, device)
    pstates, pparams, _ = rollout_states(scg, B, device, base=draws_extra(scg.params,
                                                                          scg.force_fns, B))
    scs = scene_spring_chain(12).compile(dtype=torch.float32, device=device)
    sstates, sparams, _ = rollout_states(scs, B, device)
    spstates, spparams, _ = rollout_states(scs, B, device, base=draws_extra(scs.params,
                                                                            scs.force_fns, B))
    scu = uni6().compile(dtype=torch.float32, device=device)
    ustates, uparams, _ = rollout_states(scu, B, device)
    scc = scene_13_cables().compile(dtype=torch.float32, device=device)
    cstates, cparams, _ = rollout_states(scc, B, device,
                                         s0=cable_states0(scc, B, device, torch.float32))
    cpstates, cpparams, _ = rollout_states(scc, B, device,
                                           s0=cable_states0(scc, B, device, torch.float32),
                                           base=draws_extra(scc.params, scc.force_fns, B))
    out = {}
    for label, scene, params, st, cfg in (
            ("chain-12", sc, {**sc.params, "tau": tau}, states, CFG),
            ("chain-ground-12", scg, gparams, gstates, CFG),
            ("chain-ground-12 guarded", scg, gparams, gstates, ROBUST["guarded"]),
            ("chain-ground-12 per-lane", scg, pparams, pstates, CFG),
            ("spring-chain-12", scs, sparams, sstates, CFG),
            ("spring-chain-12 per-lane", scs, spparams, spstates, CFG),
            ("universal-6", scu, uparams, ustates, CFG),
            ("scene-13", scc, cparams, cstates, CFG),
            ("scene-13 per-lane", scc, cpparams, cpstates, CFG)):
        if design_of(scene, params, cfg) != "cooperative":
            raise AssertionError(f"coop probe {label}: not a build of the cooperative design")
        lib, names = probe_lib(scene, params, cfg)
        args = chord_kernel.pack(scene.topo, params, *st, scene.force_fns)
        nr = scene.topo.nr
        x_out = torch.empty(nr, B, device=device)
        h_out = torch.empty(nr * nr, B, device=device)
        probe = torch.zeros(B, len(names), dtype=torch.int64, device=device)

        kinds = chord_kernel.kinds_of(scene.topo, args[8], args[9] is not None,
                                      chord_kernel.is_robust(cfg))

        def launch():
            lane_f = args[9]
            err = lib.chord_bdf2_coop_launch(
                scene.topo.njoints, nr, kinds, *args[8], B,
                *(a.data_ptr() for a in args[:8]), None if lane_f is None else lane_f.data_ptr(),
                cfg.fixed_iters, cfg.growth_reject, cfg.tol_reject, cfg.dx_clamp,
                int(cfg.guarded), int(cfg.guard_last), int(cfg.chord),
                x_out.data_ptr(), h_out.data_ptr(), probe.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
            if err != 0:
                raise RuntimeError(f"chord_bdf2_coop_probe launch failed: error {err}")

        probe_ms = cuda_ms(launch, reps=50)
        torch.cuda.synchronize()
        cycles = probe.double().mean(0).tolist()
        total = sum(cycles)
        out[label] = {"total_cycles": total, "probe_ms": probe_ms,
                      **{n: c for n, c in zip(names, cycles)}}
        top = sorted(zip(names, cycles), key=lambda nc: -nc[1])
        print(f"coop probe {label}, B {B}: {total:.0f} cycles a lane (probe build {probe_ms:.4f} "
              "ms); by phase: " + ", ".join(f"{n} {c:.0f} ({c / total:.1%})" for n, c in top))
    return out


def source_of(record) -> str:
    """The source file of a chord kernel record's design."""
    return "redmax_tpu_torch/csrc/" + (
        "chord_bdf2_coop.cu" if record["design"] == "warp_per_lane" else "chord_bdf2.cu")


def qp_source_of(record) -> str:
    """The source file of a dual-PGS kernel record's design."""
    return "redmax_tpu_torch/csrc/" + (
        "dual_pgs_coop.cu" if record["design"] == "group_per_lane" else "dual_pgs.cu")


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

    phase_build()

    record = phase_kernel_vs_plain()
    launches, rate, finite_frac = phase_mpc_path("main path", scene_chain, design="cooperative")
    phase_small_reference("main path", scene_chain)
    qp_record = phase_qp_kernel_vs_plain()
    qp_launches, step_rate, euler_finite = phase_euler_path()
    phase_small_euler()
    contact_record = phase_contact_kernel_vs_plain()
    contact_launches, contact_rate, contact_finite = phase_mpc_path("contact path", chain_ground,
                                                                    design="cooperative")
    phase_small_reference("contact path", chain_ground)
    spring_record = phase_spring_kernel_vs_plain()
    cable_record = phase_cable_kernel_vs_plain()
    spring_launches, spring_rate, spring_finite = phase_mpc_path("spring path",
                                                                 scene_spring_chain,
                                                                 design="cooperative")
    phase_small_reference("spring path", scene_spring_chain, nlinks=12)
    cable_launches, cable_rate, cable_finite = phase_cable_path()
    qdep_records = phase_qdep_kernel_vs_plain()
    uni_launches, uni_rate, uni_finite = phase_mpc_path("uni6 path", uni6, nlinks=6,
                                                        design="cooperative")
    phase_small_reference("uni6 path", uni6, nlinks=6)
    sph_launches, sph_rate, sph_finite = phase_mpc_path("sph4 path", sph4, nlinks=4,
                                                        design="cooperative")
    phase_small_reference("sph4 path", sph4, nlinks=4)
    free_launches, free_rate, free_finite = phase_free3d_path()
    perlane_records = phase_perlane_kernel_vs_plain()
    rand_launches, rand_rate, rand_finite = phase_mpc_path(
        "randomized contact path", chain_ground, draws=perlane_draws, design="cooperative")
    phase_small_reference("randomized contact path", chain_ground, nlinks=12,
                          draws=perlane_draws)
    sysid_share = phase_sysid_grads()
    pl_spring_launches, pl_spring_finite = phase_perlane_rollout(
        "per-lane spring rollout", lambda: scene_spring_chain(12), spring_chain_states0,
        "cooperative")
    pl_cable_launches, pl_cable_finite = phase_perlane_rollout(
        "per-lane cable rollout", scene_13_cables, cable_states0, "cooperative")
    robust_records = phase_robust_kernel_vs_plain()
    robust_paths = phase_robust_paths()
    backward_modes = phase_backward_modes()
    coop_phases = phase_coop_probe()
    default_records = phase_default_route()
    zoo_records, zoo_line = phase_scene_zoo()
    mzoo_record, mzoo_line = phase_mscene_zoo()
    mppi_launches, tiers_line = phase_explicit_tiers()
    k3_records, fric_line = phase_friction_zoo(smi=smi)
    lbfgs_launches, sharded_launches, lbfgs_line, sharded_line = phase_last_modules()

    kernels = [{
        # the cooperative design (a warp a lane), on the main path; the
        # thread-per-lane build of the same shape timed in turns with it
        "name": "chord_bdf2", "route": "cuda",
        "source": "redmax_tpu_torch/csrc/chord_bdf2_coop.cu",
        "replaces": "redmax_tpu/pallas_step.py:689",
        "launches": launches, **record, "library_ms": None,
    }, {
        # the same design with 12 ground contacts, on the contact path
        "name": "chord_bdf2[ground_contact]", "route": "cuda",
        "source": "redmax_tpu_torch/csrc/chord_bdf2_coop.cu",
        "replaces": "redmax_tpu/pallas_step.py:237",
        "launches": contact_launches, **contact_record, "library_ms": None,
    }, {
        # the same design with the spring chain's three springs, on the
        # spring path (the thread-per-lane build timed in turns with it)
        "name": "chord_bdf2[springs]", "route": "cuda",
        "source": "redmax_tpu_torch/csrc/chord_bdf2_coop.cu",
        "replaces": "redmax_tpu/pallas_step.py:401",
        "launches": spring_launches, **spring_record, "library_ms": None,
    }, {
        # the same design with scene 13's cable (4, 3), on the cable rollout
        # (the thread-per-lane build timed in turns with it)
        "name": "chord_bdf2[cable]", "route": "cuda",
        "source": source_of(cable_record),
        "replaces": "redmax_tpu/pallas_step.py:561",
        "launches": cable_launches, **cable_record, "library_ms": None,
    }, {
        # the QDEP build (K1b), cooperative (a build made for the shape; the
        # thread-per-lane QDEP build timed in turns with it): universal-6
        # (6, 12), on the uni6 path
        "name": "chord_bdf2[universal]", "route": "cuda",
        "source": source_of(qdep_records["universal-6"]),
        "replaces": "redmax_tpu/pallas_step.py:907",
        "launches": uni_launches, **qdep_records["universal-6"], "library_ms": None,
    }, {
        # spherical-4 (4, 12), so3_exp_S, on the sph4 path
        "name": "chord_bdf2[spherical]", "route": "cuda",
        "source": source_of(qdep_records["spherical-4"]),
        "replaces": "redmax_tpu/pallas_step.py:925",
        "launches": sph_launches, **qdep_records["spherical-4"], "library_ms": None,
    }, {
        # scene 9's FREE3D body (1, 6), on the FREE3D rollout
        "name": "chord_bdf2[free3d]", "route": "cuda",
        "source": source_of(qdep_records["free3d scene 9"]),
        "replaces": "redmax_tpu/pallas_step.py:942",
        "launches": free_launches, **qdep_records["free3d scene 9"], "library_ms": None,
    }, {
        # the per-lane params (K1f): chain-ground-12 (12, 12) with per-lane
        # I_i, g, h, body damping and contact coefficients, on the randomized
        # contact path (the cooperative design; the thread-per-lane PERLANE
        # build timed in turns with it)
        "name": "chord_bdf2[perlane_contacts]", "route": "cuda",
        "source": "redmax_tpu_torch/csrc/chord_bdf2_coop.cu",
        "replaces": "redmax_tpu/pallas_step.py:706",
        "launches": rand_launches, **perlane_records["chain-ground-12"], "library_ms": None,
    }, {
        # the spring chain (12, 12) with per-lane params and spring
        # coefficients, on the per-lane spring rollout (the cooperative
        # design; the thread-per-lane PERLANE build timed in turns with it)
        "name": "chord_bdf2[perlane_springs]", "route": "cuda",
        "source": "redmax_tpu_torch/csrc/chord_bdf2_coop.cu",
        "replaces": "redmax_tpu/pallas_step.py:706",
        "launches": pl_spring_launches, **perlane_records["spring-chain-12"],
        "library_ms": None,
    }, {
        # scene 13 (4, 3) with per-lane cable coefficients, on the per-lane
        # cable rollout (the cooperative design; the thread-per-lane PERLANE
        # build timed in turns with it)
        "name": "chord_bdf2[perlane_cable]", "route": "cuda",
        "source": source_of(perlane_records["scene-13"]),
        "replaces": "redmax_tpu/pallas_step.py:706",
        "launches": pl_cable_launches, **perlane_records["scene-13"], "library_ms": None,
    }, {
        # the robust modes (K1g), on the cooperative design (the
        # thread-per-lane ROBUST builds timed in turns with it): chain-12
        # (12, 12) in the guarded mode (full, half and stay-put trials at
        # every iteration), on the guarded3 path
        "name": "chord_bdf2[guarded]", "route": "cuda",
        "source": "redmax_tpu_torch/csrc/chord_bdf2_coop.cu",
        "replaces": "redmax_tpu/pallas_step.py:1226",
        "launches": robust_paths["chain-12 guarded3 sigma 3"][0], **robust_records["guarded"],
        "library_ms": None,
    }, {
        # chain-12 with one guarded last iteration, on the guard_last path
        "name": "chord_bdf2[guard_last]", "route": "cuda",
        "source": "redmax_tpu_torch/csrc/chord_bdf2_coop.cu",
        "replaces": "redmax_tpu/pallas_step.py:1276",
        "launches": robust_paths["chain-12 guard_last sigma 3"][0],
        **robust_records["guard_last"], "library_ms": None,
    }, {
        # chain-ground-12 (12, 12, contacts) with H re-built at every iterate,
        # on the contact chord=False path
        "name": "chord_bdf2[rehess]", "route": "cuda",
        "source": "redmax_tpu_torch/csrc/chord_bdf2_coop.cu",
        "replaces": "redmax_tpu/pallas_step.py:1264",
        "launches": robust_paths["contact chord=False sigma 3"][0], **robust_records["rehess"],
        "library_ms": None,
    }, {
        # chain-ground-12 in the guarded mode, on the contact guarded3 path
        "name": "chord_bdf2[guarded_contacts]", "route": "cuda",
        "source": "redmax_tpu_torch/csrc/chord_bdf2_coop.cu",
        "replaces": "redmax_tpu/pallas_step.py:1226",
        "launches": robust_paths["contact guarded3 sigma 3"][0],
        **robust_records["guarded_contacts"], "library_ms": None,
    }, {
        # library_ms: no single PyTorch call computes a dual-PGS solve; the
        # cooperative design (a group of threads a lane), the thread-per-lane
        # build timed in turns with it
        "name": "dual_pgs", "route": "cuda",
        "source": qp_source_of(qp_record),
        "replaces": "redmax_tpu/pallas_qp.py:40",
        "launches": qp_launches, **qp_record, "library_ms": None,
    }] + [{
        # the default route at shapes and kind mixes no fixed library holds
        # (phase 26), each on the cooperative build made for it (timed beside
        # its thread-per-lane build); launches: its rollout's
        "name": f"chord_bdf2[default_route {label}]", "route": "cuda",
        "source": source_of(default_records[label]), "replaces": replaces,
        **default_records[label], "library_ms": None,
    } for label, _, _, _, replaces in DEFAULT_ROUTE] + [{
        "name": "dual_pgs[default_route mscene 6]", "route": "cuda",
        "source": qp_source_of(default_records["mscene 6"]),
        "replaces": "redmax_tpu/pallas_qp.py:40",
        **default_records["mscene 6"], "library_ms": None,
    }] + [{
        # the scene zoo's BDF2 rollouts (phase 27), each scene on the
        # cooperative build made for its shape (scene 2: the fixed library;
        # the umbrella's timed beside its thread-per-lane build); launches:
        # a rollout's nsteps - 1; replaces: the branch of _build_kernel the
        # scene runs (the umbrella's springs)
        "name": f"chord_bdf2[zoo {label}]", "route": "cuda",
        "source": source_of(zoo_records[label]),
        "replaces": "redmax_tpu/pallas_step.py:" + ("401" if label == "umbrella" else "689"),
        **zoo_records[label], "library_ms": None,
    } for label, _ in ZOO] + [{
        # phase 28: mscene 6's joint limit on the zoo's f32 rollout (the
        # cooperative QP at (2, 1)); launches: that rollout's
        "name": "dual_pgs[mscene zoo 6]", "route": "cuda",
        "source": qp_source_of(mzoo_record), "replaces": "redmax_tpu/pallas_qp.py:40",
        **mzoo_record, "library_ms": None,
    }, {
        # phase 29: the main path's build (K1a, chain-12) under sampling MPC,
        # 1024 candidates as its lanes; its times are phase 3's (the same
        # build at the same shape); launches: the timed MPPI solves'
        "name": "chord_bdf2[mppi]", "route": "cuda",
        "source": "redmax_tpu_torch/csrc/chord_bdf2_coop.cu",
        "replaces": "redmax_tpu/pallas_step.py:689",
        **record, "launches": mppi_launches, "library_ms": None,
    }, {
        # phase 31: the same build (K1a, chain-12, B = 1024) under the L-BFGS
        # MPC solve; its times are phase 3's; launches: the timed solve's
        # (49 an evaluation)
        "name": "chord_bdf2[lbfgs]", "route": "cuda",
        "source": "redmax_tpu_torch/csrc/chord_bdf2_coop.cu",
        "replaces": "redmax_tpu/pallas_step.py:689",
        **record, "launches": lbfgs_launches, "library_ms": None,
    }, {
        # phase 31: the same build under parallel.sharded_mpc_batched on a
        # world of one (NCCL); its times are phase 3's; launches: the
        # sharded solve's
        "name": "chord_bdf2[sharded]", "route": "cuda",
        "source": "redmax_tpu_torch/csrc/chord_bdf2_coop.cu",
        "replaces": "redmax_tpu/pallas_step.py:689",
        **record, "launches": sharded_launches, "library_ms": None,
    }] + [{
        # phase 30: the port's own kernel K3 (no TPU kernel: the op-level
        # lax.scan sweeps of the friction step), on real solves of the
        # friction zoo's rollouts: each record the design pgs_kernel.design_of
        # routes the case to ("design": thread_per_lane for the dual QPs,
        # warp_per_lane for the friction passes), with the other launches
        # timed in the same run under "also_timed" (the earlier warp design,
        # warp_per_lane_div, which no route takes, among them); launches:
        # that design's in that case's rollout in that dtype (float64 the
        # certificate, float32 the timed one); library_ms: no PyTorch call
        # runs projected Gauss-Seidel sweeps
        "name": f"pgs_sweeps[{label} {dtype}]", "route": "cuda",
        "source": "redmax_tpu_torch/csrc/pgs_sweeps.cu",
        "replaces": "redmax_tpu/friction.py:633" if label.startswith("friction")
        else "redmax_tpu/qp.py:77",
        "replaces_pallas_kernel": False, **rec, "library_ms": None,
    } for (label, dtype), rec in k3_records.items()]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"main_path": {"solves_per_s": rate, "finite_frac": finite_frac,
                                    "card": smi}}))
    print(json.dumps({"euler_path": {"steps_per_s": step_rate, "finite_frac": euler_finite,
                                     "card": smi}}))
    print(json.dumps({"contact_path": {"solves_per_s": contact_rate, "finite_frac": contact_finite,
                                       "launches": contact_launches, "card": smi}}))
    print(json.dumps({"spring_path": {"solves_per_s": spring_rate, "finite_frac": spring_finite,
                                      "launches": spring_launches, "card": smi}}))
    print(json.dumps({"cable_path": {"steps_per_s": cable_rate, "finite_frac": cable_finite,
                                     "launches": cable_launches, "card": smi}}))
    print(json.dumps({"uni6_path": {"solves_per_s": uni_rate, "finite_frac": uni_finite,
                                    "launches": uni_launches, "card": smi}}))
    print(json.dumps({"sph4_path": {"solves_per_s": sph_rate, "finite_frac": sph_finite,
                                    "launches": sph_launches, "card": smi}}))
    print(json.dumps({"free3d_path": {"steps_per_s": free_rate, "finite_frac": free_finite,
                                      "launches": free_launches, "card": smi}}))
    print(json.dumps({"randomized_contact_path": {
        "solves_per_s": rand_rate, "finite_frac": rand_finite, "launches": rand_launches,
        "sysid_share_within_5e-4": sysid_share, "card": smi}}))
    print(json.dumps({"perlane_rollouts": {
        "spring": {"launches": pl_spring_launches, "finite_frac": pl_spring_finite},
        "cable": {"launches": pl_cable_launches, "finite_frac": pl_cable_finite}, "card": smi}}))
    print(json.dumps({"robust_path": {
        **{name: {"launches": l, "solves_per_s": r, "finite_frac": f}
           for name, (l, r, f) in robust_paths.items()}, "card": smi}}))
    print(json.dumps({"backward_modes": {**backward_modes, "card": smi}}))
    print(json.dumps({"coop_phases": {**coop_phases, "card": smi}}))
    print(json.dumps({"scene_zoo": {**zoo_line, "card": smi}}))
    print(json.dumps({"mscene_zoo": {**mzoo_line, "card": smi}}))
    print(json.dumps({"explicit_tiers": {**tiers_line, "card": smi}}))
    print(json.dumps({"friction_zoo": {**fric_line, "card": smi}}))
    print(json.dumps({"lbfgs_path": {**lbfgs_line, "card": smi}}))
    print(json.dumps({"sharded_path": {**sharded_line, "card": smi}}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
