"""Fused BDF2 chord-Newton solve: the CUDA kernel, its plain PyTorch
version, its build and its launch counter.

The kernel (in two designs, below) replaces
redmax_tpu/pallas_step.py::_build_kernel of the JAX package, on its K1a,
K1b, K1c, K1d, K1e, K1f and K1g branches: constant-S joints and the
q-dependent UNIVERSAL, exp-map SPHERICAL and FREE3D joints (S and Sdot per
lane, pallas_step._so3_exp_S); penalty ground contact (ForceGroundCuboid,
pallas_step._ground_contact); two-point springs (ForcePointPoint,
ForceSpringDamper with tension_only, _spring_force) and tension-only cables
(ForceCable, _cable_force); every fixed-iteration solve mode (unguarded
chord, and K1g, the robust modes: H re-built at every iterate with
chord=False, the full / half / stay-put guard at every iteration or on the
last one only); physical params lane-shared or per lane (I_i,
body_damping, g, h and the closures' coefficients, the
`perlane` reads of _build_kernel: each lane copies its own record of a
lane-major [P, B] buffer and runs the same arithmetic on it). The
exp-map rescale after each step runs outside the kernel
(model.reparam_all), as in the JAX package. FREE2D stays off the kernel (op
level only). Per lane it runs FK with the world-column J and Jdot, the
joint and maximal forces with the closures' wrenches, the BDF2 residual, the
structured Newton matrix H = M + cK K~ + cD D~ with the closures'
closed-form K/D blocks (per contact body, and per pair of spring or cable
points, the blocks coupling two bodies included), an unpivoted Gauss-Jordan
H^-1 and `fixed_iters` Newton steps with growth/tol/stall rejection, and
writes x [B, nr] (NaN on rejected lanes) and the last H^-1 built [B, nr, nr].

What bounds it on an H100: per-lane f32 arithmetic. It moves
4 * B * (6 nr + nr + nr^2) bytes (about 0.93 MB at B = 1024, nr = 12), plus
4 * B * P with per-lane params (1.0 MB more for a contact on each of 12
links), and does on the order of 1e5 flops per lane (about twice that with
a contact on every link), so the operation count, not the bytes, sets the
least time. Two designs, chosen by a rule on the shape and kinds before
anything is built (takes_coop):
- cooperative (csrc/chord_bdf2_coop.cu, body csrc/chord_bdf2_coop.cuh), on
  every build of any kind mix with N, nr <= 32 whose lane record fits a
  block's shared memory (coop_record_bytes, each kind's fields after the
  last's; its springs, cables and cable points sized from the scene in a
  build made for it). One warp per lane, COOP_LANES lanes a block or fewer
  where the record is larger (coop_lanes), the lane's frames, J, Jdot, the
  per-body K/D blocks, H, the Gauss-Jordan rows and H^-1 (and, where the
  kinds have them, the guard's trials, the springs' endpoint states and
  pair blocks, the cables' point and segment states and pair blocks, the
  q-dependent columns' time derivatives and the lane's params) in shared
  memory, each phase of the solve split over the warp's 32 threads;
- thread per lane (csrc/chord_bdf2.cu, body csrc/chord_bdf2_lane.cuh), on
  every other build (N or nr above 32, or a record that fits no block):
  one thread per lane in blocks of 32, the arithmetic in order on that
  thread, J, Jdot, H and the Gauss-Jordan rows in local memory. Its
  builds at the cooperative shapes and kinds stay to be timed against the
  cooperative design (launch(..., thread_per_lane=True)).

The closure code is compiled in only where a scene has that kind of closure,
the q-dependent joint code only where a scene has such a joint, the
per-lane record only where a param is per lane and the robust modes only
where the config asks for one (a template bitmask: contacts, springs,
cables, QDEP, PERLANE, ROBUST). The (N, nr, kinds) the paths run are
instantiated up front (INSTANTIATED, COOP_INSTANTIATED) in five fixed
libraries built side by side (BUILD, BUILD_QDEP with QDEP, BUILD_PERLANE
with PERLANE, BUILD_ROBUST with ROBUST, and the cooperative BUILD_COOP);
any other (N, nr, kinds) that supports() admits is built for its scene at
its first launch (build_for: one nvcc unit of that one build, its per-lane
record, springs and cables sized from the scene, cached under _build/ by a
hash of its sources and defines), as the JAX package builds a kernel per
scene.

On a CUDA tensor chord_bdf2 launches the kernel of its design (and raises if
it cannot build or launch it, with the key in the message and no fallback
to the other design); on a CPU tensor it runs chord_bdf2_reference.
"""

import ctypes
from functools import lru_cache
from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch

from redmax_tpu_torch import integrators, model
from redmax_tpu_torch.forces import ForceCable, ForceGroundCuboid, ForcePointPoint, ForceSpringDamper
from redmax_tpu_torch.joints import CONSTANT_S_TYPES
from redmax_tpu_torch.kernel_build import KernelBuild
from redmax_tpu_torch.types import JointType, Topology

# Launches of the CUDA kernel since the counter was last set to 0: the
# thread-per-lane design, and the cooperative one.
chord_bdf2_launches = 0
chord_bdf2_coop_launches = 0

_SOURCES = ("chord_bdf2.cu", "chord_bdf2_lane.cuh")
BUILD = KernelBuild("chord_bdf2", _SOURCES)
BUILD_QDEP = KernelBuild("chord_bdf2_qdep", _SOURCES, defines=("-DCHORD_QDEP_UNIT",))
BUILD_PERLANE = KernelBuild("chord_bdf2_perlane", _SOURCES, defines=("-DCHORD_PERLANE_UNIT",))
BUILD_ROBUST = KernelBuild("chord_bdf2_robust", _SOURCES, defines=("-DCHORD_ROBUST_UNIT",))
BUILD_COOP = KernelBuild("chord_bdf2_coop", ("chord_bdf2_coop.cu", "chord_bdf2_coop.cuh",
                                              "chord_bdf2_lane.cuh"))
BUILDS = (BUILD, BUILD_QDEP, BUILD_PERLANE, BUILD_ROBUST, BUILD_COOP)
# The kinds a build compiles in (the FEAT template bitmask of chord_bdf2.cu:
# closure kinds, the q-dependent joints, per-lane params, the robust solve
# modes) and the (N, nr, kinds) with an explicit instantiation there.
CONTACTS, SPRINGS, CABLES, QDEP, PERLANE, ROBUST = 1, 2, 4, 8, 16, 32
INSTANTIATED = ((12, 12, 0), (12, 12, CONTACTS), (4, 4, 0), (4, 4, CONTACTS),
                (12, 12, SPRINGS), (4, 3, CABLES),
                (6, 12, QDEP), (4, 12, QDEP), (1, 6, QDEP),
                (12, 12, CONTACTS | PERLANE), (12, 12, SPRINGS | PERLANE),
                (4, 3, CABLES | PERLANE),
                (12, 12, ROBUST), (12, 12, CONTACTS | ROBUST))
# The (N, nr, kinds) of the cooperative design's fixed library (BUILD_COOP).
COOP_INSTANTIATED = ((12, 12, 0), (12, 12, CONTACTS), (4, 4, 0), (4, 4, CONTACTS),
                     (12, 12, ROBUST), (12, 12, CONTACTS | ROBUST),
                     (12, 12, CONTACTS | PERLANE), (12, 12, SPRINGS), (12, 12, SPRINGS | PERLANE),
                     (4, 3, CABLES), (4, 3, CABLES | PERLANE))
# The springs and cables the fixed cooperative library's spring and cable
# builds hold (kCoopSprings, kCoopCables of csrc/chord_bdf2_coop.cuh; its
# cable builds hold MAX_CABLE_POINTS points in all); a scene with more runs
# a build made for it, its stores sized from the scene.
COOP_LIBRARY_SPRINGS = 3
COOP_LIBRARY_CABLES = 2
# Lanes (warps) a block of the cooperative design where the record fits
# (the fixed library's), and the dynamic shared memory a block may have
# on sm_90. setup gives a body or a column a thread without a stride and a
# column mask is one 32-bit word, so the design takes N, nr <= 32.
COOP_LANES = 8
SMEM_PER_BLOCK = 232_448
MAX_COOP_WIDTH = 32
# Joint types the kernel covers: FREE2D has no branch there (op level only).
QDEP_KERNEL_TYPES = (JointType.UNIVERSAL, JointType.SPHERICAL, JointType.FREE3D)
KERNEL_TYPES = CONSTANT_S_TYPES + QDEP_KERNEL_TYPES
# kMaxCablePoints and kMaxLaneRecord (floats of one lane's per-lane record)
# of the fixed libraries (chord_bdf2_lane.cuh); a build made for one scene
# sizes them from the scene.
MAX_CABLE_POINTS = 8
MAX_LANE_RECORD = 512
_CLOSURES = (ForceGroundCuboid, ForcePointPoint, ForceSpringDamper, ForceCable)


class Closures(NamedTuple):
    """The closure counts that the packed buffers hold (topo_i carries them
    too, for the kernel)."""

    contacts: int
    springs: int
    cables: int
    cable_points: int

    @property
    def kinds(self) -> int:
        return ((CONTACTS if self.contacts else 0) | (SPRINGS if self.springs else 0)
                | (CABLES if self.cables else 0))


def supports(topo: Topology, force_fns: Tuple, cfg) -> bool:
    """True when the kernel covers this scene's inner step exactly, and so
    runs it on the card: ground contacts, springs and cables, constant-S,
    UNIVERSAL, SPHERICAL and FREE3D joints, any fixed-iteration config with
    the structured matrix and the GJ solver (the JAX package's `qualifies`:
    chord or not, guarded, guard_last), any shape (a build made for the
    scene at its first launch where no fixed library has it)."""
    return (
        all(type(fn) in _CLOSURES for fn in force_fns)
        and all(JointType(t) in KERNEL_TYPES for t in topo.jtype)
        and cfg.fixed_iters > 0
        and cfg.hessian == "structured" and cfg.linsolve == "gj"
    )


def is_robust(cfg) -> bool:
    """True for a config that needs the ROBUST build: a guard, or H
    re-built at every iterate."""
    return bool(cfg.guarded or cfg.guard_last or not cfg.chord)


def chord_bdf2_reference(topo: Topology, cfg, params: Dict, x0, q0, qd0, q1, qd1,
                         force_fns: Tuple = (), info: Dict = None):
    """The kernel's function in plain batched PyTorch: (x [B,nr], Hinv [B,nr,nr]).

    The op-level fixed-iteration solve (integrators.newton on residual_bdf2
    with the structured Newton matrix and the GJ inverse): same residual,
    same matrix, same iterations, guards and rejection as the kernel, up to
    f32 reassociation. info, where given, receives newton's info (with a
    guard, "steps": each lane's guarded steps, 1 full, 0.5 half, 0 stay put).
    """
    theta = (params, q0, qd0, q1, qd1)
    hess = integrators._hess_bdf2(topo, force_fns)
    x, out = integrators.newton(
        lambda x: integrators.residual_bdf2(topo, force_fns, params, x, q0, qd0, q1, qd1),
        x0, cfg, jac_fn=lambda x: hess(theta, x),
    )
    if info is not None:
        info.update(out)
    return x, out["factor"]


def has_qdep(topo: Topology) -> bool:
    """True when a joint of the scene has a q-dependent S (the QDEP build)."""
    return any(JointType(t) in QDEP_KERNEL_TYPES for t in topo.jtype)


def has_perlane(params: Dict) -> bool:
    """True when a physical param (anything but tau) is per lane: the
    PERLANE build, which reads each lane's own record."""
    return bool(set(integrators.split_batched_params(params)[1]) - {"tau"})


def kinds_of(topo: Topology, counts: Closures, perlane: bool = False,
             robust: bool = False) -> int:
    """The FEAT bitmask of the build that runs this scene (robust: a config
    for which is_robust holds)."""
    return (counts.kinds | (QDEP if has_qdep(topo) else 0) | (PERLANE if perlane else 0)
            | (ROBUST if robust else 0))


def build_of(kinds: int) -> KernelBuild:
    """The fixed thread-per-lane library that holds the builds of these
    kinds."""
    if kinds & QDEP:
        return BUILD_QDEP
    if kinds & PERLANE:
        return BUILD_PERLANE
    return BUILD_ROBUST if kinds & ROBUST else BUILD


def record_floats(counts: Closures, N: int) -> int:
    """Floats of one lane's per-lane record (pack's lane buffer rows)."""
    C, S, ncab, npts = counts
    return 7 * N + 4 + 13 * C + 9 * S + 3 * npts + 3 * ncab


def coop_record_floats(N: int, kinds: int, record: int = MAX_LANE_RECORD,
                       cable_points: int = MAX_CABLE_POINTS, springs: int = COOP_LIBRARY_SPRINGS,
                       cables: int = COOP_LIBRARY_CABLES) -> int:
    """Floats of the per-lane record a cooperative PERLANE build holds
    (coop_record_floats of chord_bdf2_coop.cuh): with ground contacts,
    record (the build's kMaxLaneRecord); else the record_floats fields of
    the closures the build holds (springs springs, cables cables of
    cable_points points in all), to a multiple of 4."""
    if kinds & CONTACTS:
        return record
    p = 7 * N + 4
    if kinds & SPRINGS:
        p += 9 * springs
    if kinds & CABLES:
        p += 3 * cable_points + 3 * cables
    return -(-p // 4) * 4


def _layout(fields) -> int:
    """sizeof a struct of (bytes, alignment) fields in order, aligned to
    16 (the cooperative records are alignas(16))."""
    at = 0
    for size, align in fields:
        at = -(-at // align) * align + size
    return -(-at // 16) * 16


def coop_record_bytes(N: int, nr: int, kinds: int, record: int = MAX_LANE_RECORD,
                      cable_points: int = MAX_CABLE_POINTS, springs: int = COOP_LIBRARY_SPRINGS,
                      cables: int = COOP_LIBRARY_CABLES) -> int:
    """sizeof(coop::LaneOf<N, nr, kinds>) of csrc/chord_bdf2_coop.cuh with
    the build's kMaxLaneRecord `record`, springs springs and cables cables
    of cable_points points in all: one lane's share of a block's shared
    memory. Each field as (bytes, alignment); each kind's fields after the
    record before it (whose size is a multiple of 16), in the order QDEP,
    SPRINGS, CABLES, ROBUST, PERLANE."""
    f, a = 4, 16
    frames = [(48 * N, a)] * 3
    union = max(2 * N * 36, (12 * N // nr) * nr * 6) * f
    rec = _layout(frames + [(36 * N * f, a), (union, a), (4 * nr * nr * f, a)]
                  + [(6 * N * nr * f, a)] * 4 + [(6 * nr * f, a)] * 3
                  + [(6 * N * f, a)] * 2 + [(nr * f, a)] + [(nr * f, f)] * 10
                  + [(f, f)] * 2 + [(N * f, f), (nr * f, f)] + [(N * f, f)] * 2
                  + [(N * nr * f, f), (f, f)])
    point = 13 * f  # int b, float r[3], x[3], v[3], u[3]
    if kinds & QDEP:
        rec = _layout([(rec, a), (6 * nr * f, a)])
    if kinds & SPRINGS:
        S, blocks = springs, 4 * springs
        rec = _layout([(rec, a), (blocks * 36 * f, a), (S * 6 * f, f), (S * 9 * f, f),
                       (S * 9 * f, f), (S * 2 * point, f), (blocks * f, f),
                       (2 * blocks * f, f), (f, f)])
        if blocks * nr > 2 * N * 6:  # G J_s in a store of their own (springs_in_kd)
            rec = _layout([(rec, a), (blocks * nr * 6 * f, a)])
    if kinds & CABLES:
        T, C = cable_points, cables
        K = T * T
        rec = _layout([(rec, a), (K * 36 * f, a), (K * nr * 6 * f, a)]
                      + [(T * 3 * f, f)] * 6 + [(T * f, f)] * 3 + [(C * f, f)] * 2
                      + [(T * point, f)] + [(T * f, f)] * 3 + [(C * f, f)] * 3
                      + [(K * 2 * f, f)] * 2 + [(f, f)] * 2)
    if kinds & ROBUST:
        rec = _layout([(rec, a), (2 * nr * f, a), (2 * nr * f, a), (2 * f, f), (f, f)])
    if kinds & PERLANE:
        floats = coop_record_floats(N, kinds, record, cable_points, springs, cables)
        rec = _layout([(rec, a), (floats * f, a)])
    return rec


def coop_lanes(N: int, nr: int, kinds: int, record: int = MAX_LANE_RECORD,
               cable_points: int = MAX_CABLE_POINTS, springs: int = COOP_LIBRARY_SPRINGS,
               cables: int = COOP_LIBRARY_CABLES) -> int:
    """Lanes a block of a cooperative build: the most of COOP_LANES, 4, 2,
    1 whose records fit SMEM_PER_BLOCK (0: not even one)."""
    size = coop_record_bytes(N, nr, kinds, record, cable_points, springs, cables)
    return next((n for n in (COOP_LANES, 4, 2, 1) if n * size <= SMEM_PER_BLOCK), 0)


def _round4(record: int) -> int:
    return max(4, -(-record // 4) * 4)


def _points(cable_points: int) -> int:
    """kMaxCablePoints of a build made for a scene with this many cable
    points in all."""
    return max(2, cable_points)


def takes_coop(N: int, nr: int, kinds: int, springs: int = 0, record: int = 0,
               cables: int = 0, cable_points: int = 0) -> bool:
    """The shape rule: True when the cooperative design runs (N, nr,
    kinds) with this many springs, a per-lane record of this many floats
    (0 without) and this many cables of cable_points points in all: N and
    nr are at most MAX_COOP_WIDTH and one lane's record, sized for these
    closures as a build made for them sizes it, fits a block. Any kind mix
    goes; the width and the room decide."""
    if max(N, nr) > MAX_COOP_WIDTH:
        return False
    return coop_lanes(N, nr, kinds, _round4(record), _points(cable_points), max(1, springs),
                      max(1, cables)) > 0


def is_coop(build: KernelBuild) -> bool:
    """True for a build of the cooperative design."""
    return build.sources[0] == "chord_bdf2_coop.cu"


_COOP_SOURCES = ("chord_bdf2_coop.cu", "chord_bdf2_coop.cuh", "chord_bdf2_lane.cuh")


def build_for(coop: bool, N: int, nr: int, kinds: int, record: int = 0,
              cable_points: int = 0, springs: int = 0, cables: int = 0) -> KernelBuild:
    """The build of one (N, nr, kinds) made for a scene: one nvcc unit
    (-DCHORD_ONE) of the cooperative design (coop, with coop_lanes lanes a
    block) or of the thread-per-lane one, its per-lane record (PERLANE) of
    `record` floats and its cables (CABLES) of `cable_points` points in
    all; a cooperative build's record holds `springs` springs (SPRINGS) and
    `cables` cables (CABLES), at least one. One KernelBuild a key, compiled
    at its first launch into _build/ and cached there by a hash of its
    sources and defines."""
    coop = bool(coop)
    springs = max(1, springs) if coop and kinds & SPRINGS else 0
    cables = max(1, cables) if coop and kinds & CABLES else 0
    return _build_for(coop, N, nr, kinds, record, cable_points, springs, cables)


@lru_cache(maxsize=None)
def _build_for(coop, N, nr, kinds, record, cable_points, springs, cables) -> KernelBuild:
    defines = [f"-DCHORD_ONE", f"-DCHORD_N={N}", f"-DCHORD_NR={nr}", f"-DCHORD_FEAT={kinds}"]
    name = f"chord_bdf2_{'coop' if coop else 'lane'}_{N}_{nr}_{kinds}"
    if kinds & PERLANE:
        defines.append(f"-DCHORD_MAX_RECORD={record}")
        name += f"_r{record}"
    if kinds & CABLES:
        defines.append(f"-DCHORD_MAX_CABLE_POINTS={cable_points}")
        name += f"_c{cable_points}"
    if springs:
        defines.append(f"-DCHORD_MAX_SPRINGS={springs}")
        name += f"_s{springs}"
    if cables:
        defines.append(f"-DCHORD_MAX_CABLES={cables}")
        name += f"_k{cables}"
    if coop:
        lanes = coop_lanes(N, nr, kinds, record, _points(cable_points), springs, cables)
        defines.append(f"-DCOOP_LANES={lanes}")
    return KernelBuild(name, _COOP_SOURCES if coop else _SOURCES, defines)


def library_of(N: int, nr: int, kinds: int, thread_per_lane: bool = False,
               springs: int = 0, record: int = 0, cable_points: int = 0,
               cables: int = 0) -> KernelBuild:
    """The build that launches (N, nr, kinds) with this many springs, a
    per-lane record of this many floats (0 without) and this many cables of
    cable_points points in all: the cooperative design where takes_coop
    holds, else the thread-per-lane one (thread_per_lane: that one in any
    case, to time it against the other); in either, its fixed library where
    that holds the key and the closures, else the build made for it
    (build_for)."""
    points = _points(cable_points) if kinds & CABLES else 0
    rec = _round4(record) if kinds & PERLANE else 0
    if not thread_per_lane and takes_coop(N, nr, kinds, springs, record, cables, cable_points):
        if (N, nr, kinds) in COOP_INSTANTIATED and record <= coop_record_floats(N, kinds) \
                and cable_points <= MAX_CABLE_POINTS and springs <= COOP_LIBRARY_SPRINGS \
                and cables <= COOP_LIBRARY_CABLES:
            return BUILD_COOP
        return build_for(True, N, nr, kinds, rec, points, springs, cables)
    if (N, nr, kinds) in INSTANTIATED and record <= MAX_LANE_RECORD \
            and cable_points <= MAX_CABLE_POINTS:
        return build_of(kinds)
    return build_for(False, N, nr, kinds, rec, points)


def scene_build(topo: Topology, force_fns: Tuple, params: Dict, cfg,
                thread_per_lane: bool = False) -> KernelBuild:
    """The build that chord_bdf2 launches for this scene, params and
    config on the card (library_of's), decided before anything is built."""
    counts = counts_of(closure_spec(topo, force_fns))
    perlane = has_perlane(params)
    kinds = kinds_of(topo, counts, perlane, is_robust(cfg))
    return library_of(topo.njoints, topo.nr, kinds, thread_per_lane, counts.springs,
                      record_floats(counts, topo.njoints) if perlane else 0, counts.cable_points,
                      counts.cables)


def _build_lib(build: KernelBuild):
    """The kernel library of build, compiled with nvcc at first use (see
    kernel_build). Raises when nvcc is missing or the build fails."""
    first = build.lib is None
    lib = build.load()
    if first:
        p, i, fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        if is_coop(build):
            set_coop_argtypes(lib)
            for fn in (lib.chord_bdf2_coop_lanes_per_block, lib.chord_bdf2_coop_smem_bytes):
                fn.argtypes = [i, i, i]
            lib.chord_bdf2_coop_lanes_per_block.restype = i
            lib.chord_bdf2_coop_smem_bytes.restype = ctypes.c_long
        else:
            lib.chord_bdf2_launch.argtypes = ([i] * 9 + [p] * 6 + [p, p, p] + [i, fl, fl, fl]
                                              + [i, i, i] + [p, p, p])
            lib.chord_bdf2_launch.restype = i
    return lib


def set_coop_argtypes(lib) -> None:
    """The argument types of chord_bdf2_coop_launch in lib (the cooperative
    library, or its probe build)."""
    p, i, fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.chord_bdf2_coop_launch.argtypes = ([i] * 8 + [p] * 9 + [i, fl, fl, fl, i, i, i]
                                           + [p] * 4)
    lib.chord_bdf2_coop_launch.restype = i


def _split(force_fns: Tuple):
    """(contacts, springs, cables), each in force_fns order (the order of
    pallas_step._split_forces)."""
    gnd = tuple(fn for fn in force_fns if isinstance(fn, ForceGroundCuboid))
    spr = tuple(fn for fn in force_fns if isinstance(fn, (ForcePointPoint, ForceSpringDamper)))
    cab = tuple(fn for fn in force_fns if isinstance(fn, ForceCable))
    return gnd, spr, cab


def closure_spec(topo: Topology, force_fns: Tuple) -> Tuple:
    """The static closure spec: (contact bodies, springs as (kind, b1, b2,
    tension) with kind 0 = point-point, 1 = spring-damper, cables as body
    tuples). Raises on a body outside the scene or a cable the kernel cannot
    hold."""
    gnd, spr, cab = _split(force_fns)
    N = topo.njoints
    contacts = tuple(int(fn.body) for fn in gnd)
    springs = tuple((int(isinstance(fn, ForceSpringDamper)), int(fn.body1), int(fn.body2),
                     int(getattr(fn, "tension_only", False))) for fn in spr)
    cables = tuple(tuple(int(b) for b in fn.bodies) for fn in cab)
    if any(not 0 <= b < N for b in contacts):
        raise ValueError(f"chord_bdf2: contact bodies {contacts} outside 0..{N - 1}")
    if any(not -1 <= b < N for sp in springs for b in sp[1:3]) or \
            any(not -1 <= b < N for c in cables for b in c):
        raise ValueError(f"chord_bdf2: spring or cable bodies outside -1..{N - 1}")
    if any(len(c) < 2 for c in cables):
        raise ValueError("chord_bdf2: a cable needs at least 2 points")
    return contacts, springs, cables


def counts_of(spec: Tuple) -> Closures:
    contacts, springs, cables = spec
    return Closures(len(contacts), len(springs), len(cables), sum(len(c) for c in cables))


@lru_cache(maxsize=None)
def _topology_buffer(topo: Topology, spec: Tuple, device: torch.device):
    """int32 [parent(N), jtype(N), doffs(N+1), dofj(nr), anc(N*N),
    C, S, ncables, ncable_points, contact bodies(C), springs(4S: kind, b1,
    b2, tension), cables(per cable P, bodies(P))] on device."""
    contacts, springs, cables = spec
    doffs = np.concatenate([[0], np.cumsum(topo.ndof)])
    buf = np.concatenate([
        np.asarray(topo.parent), np.asarray(topo.jtype), doffs,
        topo.dof_joint(), topo.ancestor_mask().reshape(-1),
        np.asarray(counts_of(spec)), np.asarray(contacts, dtype=np.int64),
        np.asarray(springs, dtype=np.int64).reshape(-1),
        np.asarray([v for c in cables for v in (len(c),) + c], dtype=np.int64),
    ]).astype(np.int32)
    return torch.as_tensor(buf, device=device)


def _record_parts(topo: Topology, params: Dict, force_fns: Tuple):
    """The params that may be per lane, in the order of the per-lane record,
    each as (tensor, floats per lane): I_i (6N), bd (N), g (3), h (1), then
    per contact sides[3], kn, kt, kd, mu, xg[3], ng[3] (the floor's origin and
    normal), per spring xl1[3], xl2[3], k, d, L (L = 0 for a point-point
    spring), per cable xls[3P], k, d, L (pallas_step._pack_contacts /
    _pack_springs / _pack_cables and their _lane packers). A tensor is its
    lane-shared value or carries a leading [B]."""
    N = topo.njoints
    parts = [(params["I_i"], 6 * N), (params["body_damping"], N), (params["g"], 3),
             (params["h"], 1)]
    gnd, spr, cab = _split(force_fns)
    for fn in gnd:
        fp = fn.p(params)
        parts += [(fp["sides"], 3), (fp["kn"], 1), (fp["kt"], 1), (fp["kd"], 1), (fp["mu"], 1),
                  (fp["E"][:3, 3], 3), (fp["E"][:3, 2], 3)]
    for fn in spr:
        fp = fn.p(params)
        L = fp["L"] if "L" in fp else fp["k"] * 0
        parts += [(fp["xl1"], 3), (fp["xl2"], 3), (fp["k"], 1), (fp["d"], 1), (L, 1)]
    for fn in cab:
        fp = fn.p(params)
        parts += [(fp["xls"], fp["xls"].numel()), (fp["k"], 1), (fp["d"], 1), (fp["L"], 1)]
    return parts


def _lane_buffer(topo: Topology, params: Dict, force_fns: Tuple, B: int):
    """f32 [P, B]: every lane's record (_record_parts), lane-major, so that
    neighbouring threads read neighbouring floats; lane-shared values are
    broadcast into it (pallas_step._pack_*_lane)."""
    cols = [v.reshape(-1, n).expand(B, n) for v, n in _record_parts(topo, params, force_fns)]
    return torch.cat(cols, dim=1).float().t().contiguous()


def _static_buffer(topo: Topology, params: Dict, force_fns: Tuple = ()):
    """f32 [E0_pj (16N), E0_ji (16N), I_i (6N), axes (9N), jsf (7 nr), bd (N),
    g (3), h (1), contacts (13 C), springs (9 S), cables (3 P + 3 each)] on
    the params' device (the record fields in _record_parts' layout; of a
    per-lane param, lane 0's value, which a PERLANE build does not read).
    axes[j][:, d] is the d-th DOF's axis (rotation axis for REVOLUTE,
    translation direction otherwise)."""
    N = topo.njoints
    dev = params["I_i"].device
    axes = torch.zeros(N, 3, 3, dtype=torch.float32, device=dev)
    for jt, mem, _ in model._index_tensors(topo, dev).groups:
        jp = params["joint"].get(str(jt), {})
        if "axis" in jp:
            axes[mem, :, 0] = jp["axis"].float()
        elif "plane" in jp:
            axes[mem, :, :2] = jp["plane"].float()
        elif JointType(jt) == JointType.TRANSLATIONAL:
            axes[mem] = torch.eye(3, device=dev)
    jsf = torch.stack([params[k] for k in ("stiffness", "damping", "qrest", "qlimL",
                                           "qlimU", "qlimK", "qlimD")])
    rec = [v.reshape(-1, n)[0] for v, n in _record_parts(topo, params, force_fns)]
    parts = [params["E0_pj"], params["E0_ji"], rec[0], axes, jsf, *rec[1:]]
    return torch.cat([p.reshape(-1).float() for p in parts])


def chord_bdf2(topo: Topology, cfg, params: Dict, x0, q0, qd0, q1, qd1,
               force_fns: Tuple = ()):
    """Batched fused BDF2 chord solve: (x [B,nr], Hinv [B,nr,nr]).

    All state args are [B, nr]; params["tau"] may be [B, nr] or [nr], and
    I_i, body_damping, g, h and the closures' kn, kt, kd, mu, k, d, L may
    be per lane (integrators.split_batched_params). force_fns are the
    scene's force closures (ground contacts, springs, cables). A CUDA tensor
    goes to the kernel (f32, a scene the kernel covers, else it raises; a
    shape no fixed library holds is built at its first launch; the wrapper
    makes the contiguous [nr, B] copies the kernel reads, and with per-lane
    params the [P, B] record buffer); a CPU tensor goes to
    chord_bdf2_reference.
    """
    if x0.device.type == "cpu":
        return chord_bdf2_reference(topo, cfg, params, x0, q0, qd0, q1, qd1, force_fns)
    if x0.device.type != "cuda":
        raise ValueError(f"chord_bdf2: unsupported device {x0.device}")
    if not supports(topo, force_fns, cfg):
        raise ValueError("chord_bdf2: scene/config not covered by the kernel")
    if cfg.guard_last and (not cfg.chord or cfg.guarded):
        raise ValueError("guard_last requires chord=True, guarded=False")
    nr = topo.nr
    B = x0.shape[0]
    tau = params["tau"]
    states = (x0, q0, qd0, q1, qd1)
    for a in states + (tau,):
        if a.device != x0.device or a.dtype != torch.float32:
            raise ValueError("chord_bdf2: every input must be float32 on one CUDA device")
    for a in states:
        if a.shape != (B, nr):
            raise ValueError(f"chord_bdf2: state of shape {tuple(a.shape)}, want {(B, nr)}")
    if tau.shape not in ((B, nr), (nr,)):
        raise ValueError(f"chord_bdf2: tau of shape {tuple(tau.shape)}")
    if params["I_i"].device != x0.device:
        raise ValueError("chord_bdf2: params and states must lie on one device")
    args = pack(topo, params, x0, q0, qd0, q1, qd1, force_fns)
    x_out, h_out = launch(topo, cfg, *args)
    return x_out.t(), h_out.reshape(nr, nr, B).permute(2, 0, 1)


def pack(topo: Topology, params: Dict, x0, q0, qd0, q1, qd1, force_fns: Tuple = ()):
    """The kernel's inputs: the six per-lane tensors as contiguous
    struct-of-arrays [nr, B] (neighbouring threads read neighbouring floats),
    the topology and lane-shared parameter buffers, each with the closures
    of force_fns at its end, their counts (Closures), and the per-lane
    record buffer [P, B] (None when every physical param is lane-shared)."""
    B, nr = x0.shape
    tau = params["tau"].expand(B, nr)
    soa = [a.t().contiguous() for a in (x0, q0, qd0, q1, qd1, tau)]
    spec = closure_spec(topo, force_fns)
    lane_f = _lane_buffer(topo, params, force_fns, B) if has_perlane(params) else None
    return (*soa, _topology_buffer(topo, spec, x0.device),
            _static_buffer(topo, params, force_fns), counts_of(spec), lane_f)


def check_buffers(topo: Topology, topo_i, stat_f, counts: Closures, lane_f=None) -> None:
    """Raises unless the buffers have the sizes that the topology and the
    closure counts give (pack's layouts): lane_f, where given, [P, B]."""
    N, nr = topo.njoints, topo.nr
    C, S, ncab, npts = counts
    n_topo = 3 * N + 1 + nr + N * N + 4 + C + 4 * S + ncab + npts
    n_rec = record_floats(counts, N)
    n_stat = 41 * N + 7 * nr + n_rec
    if min(counts) < 0 or topo_i.numel() != n_topo or stat_f.numel() != n_stat:
        raise ValueError(f"chord_bdf2: buffers of {topo_i.numel()} ints and {stat_f.numel()} "
                         f"floats do not hold {counts} (want {n_topo} and {n_stat})")
    if lane_f is not None and (lane_f.dim() != 2 or lane_f.shape[0] != n_rec):
        raise ValueError(f"chord_bdf2: a per-lane buffer of shape {tuple(lane_f.shape)} does not "
                         f"hold {counts} (want {n_rec} rows)")


# chord_bdf2_launch's and chord_bdf2_coop_launch's own error codes (any
# other is a cudaError_t)
_LAUNCH_ERRORS = {-1: "no instantiation of (N, nr, kinds) in this library",
                  -2: "per-lane record longer than the build's",
                  -3: "a robust solve mode in a build without kRobust",
                  -4: "fixed_iters < 1",
                  -5: "more springs than the cooperative build's record holds",
                  -6: "more cables or cable points than the cooperative build's record holds"}


def launch(topo: Topology, cfg, x0, q0, qd0, q1, qd1, tau, topo_i, stat_f, counts: Closures,
           lane_f=None, thread_per_lane: bool = False):
    """Launch the kernel on the current stream on packed inputs (see pack);
    returns (x [nr, B], Hinv [nr*nr, B]) and counts the launch on its
    design's counter. The design and build are library_of's: thread_per_lane
    runs the thread-per-lane build even where the cooperative design takes
    the shape (only to time the two against each other)."""
    global chord_bdf2_launches, chord_bdf2_coop_launches
    check_buffers(topo, topo_i, stat_f, counts, lane_f)
    nr, B = x0.shape
    if lane_f is not None and lane_f.shape[1] != B:
        raise ValueError(f"chord_bdf2: a per-lane buffer of {lane_f.shape[1]} lanes for {B}")
    kinds = kinds_of(topo, counts, lane_f is not None, is_robust(cfg))
    key = (topo.njoints, nr, kinds)
    build = library_of(*key, thread_per_lane, counts.springs,
                       0 if lane_f is None else lane_f.shape[0], counts.cable_points,
                       counts.cables)
    coop = is_coop(build)
    lib = _build_lib(build)
    x_out = torch.empty(nr, B, dtype=torch.float32, device=x0.device)
    h_out = torch.empty(nr * nr, B, dtype=torch.float32, device=x0.device)
    stream = torch.cuda.current_stream(x0.device).cuda_stream
    states = tuple(a.data_ptr() for a in (x0, q0, qd0, q1, qd1, tau))
    lane_ptr = None if lane_f is None else lane_f.data_ptr()
    solver = (cfg.fixed_iters, cfg.growth_reject, cfg.tol_reject, cfg.dx_clamp,
              int(cfg.guarded), int(cfg.guard_last), int(cfg.chord))
    if coop:
        err = lib.chord_bdf2_coop_launch(
            topo.njoints, nr, kinds, *counts, B, *states,
            topo_i.data_ptr(), stat_f.data_ptr(), lane_ptr, *solver,
            x_out.data_ptr(), h_out.data_ptr(), None, stream,
        )
    else:
        err = lib.chord_bdf2_launch(
            topo.njoints, nr, int(bool(kinds & QDEP)), int(lane_f is not None), *counts, B,
            *states, topo_i.data_ptr(), stat_f.data_ptr(), lane_ptr, *solver,
            x_out.data_ptr(), h_out.data_ptr(), stream,
        )
    if err != 0:
        why = _LAUNCH_ERRORS.get(err, "CUDA error")
        raise RuntimeError(f"{build.name} kernel launch failed for (N, nr, kinds) = {key}: "
                           f"error {err} ({why})")
    if coop:
        chord_bdf2_coop_launches += 1
    else:
        chord_bdf2_launches += 1
    return x_out, h_out
