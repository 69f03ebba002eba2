"""The residual VJP of the chord route's adjoint backward: the CUDA kernel,
its plain PyTorch version and its build.

At an inner BDF2 step's solution q2 the adjoint needs the VJP of
integrators.residual_bdf2 in (tau, q0, qd0, q1, qd1) at the cotangent
w = -z, z = H^-T xbar. The kinematics depend on q2 alone, so no cotangent
passes through them, and with v the BDF2 velocity at q2, c = 4/9 h^2,
a = M(q2) w and b = (df/dv)^T w at (q2, v):

    tau_bar = -c w,  q0_bar = a/3 - 2/9 h b,  qd0_bar = 2/9 h a,
    q1_bar = -4/3 a + 8/9 h b,  qd1_bar = -8/9 h a.

b needs the exact df/dv: the Newton matrix's D~ (model.structured_hessian)
approximates the quadratic-velocity term and adds the contacts' proximity
margin, so it is not that derivative.

The kernel (csrc/residual_vjp.cu, body csrc/residual_vjp.cuh) replaces no
TPU kernel: the JAX package takes this VJP with jax.vjp of the op-level
residual (redmax_tpu/integrators.py:867). One warp a lane, 8 lanes a block,
the chord kernel's cooperative phases (setup, the kinematics) at q2, then a
reverse pass per body and per column; on the "reuse" backward it also solves
z = H^-T xbar with the forward's H^-1. It reads the states and xbar with
their own strides, as autograd holds them. One build a (N, nr, kinds), made
at its first launch (or started early by prepare) and cached in _build/.

It serves a step where the joints are constant-S, the closures are none or
ground contacts and N and nr are at most 32 (takes, decided once a step
function), the params are lane-shared but tau (takes_params) and no params
leaf but tau requires grad (both decided in each step's backward,
adjoint.ResidualVJP); every other step keeps the VJP through autograd. On a
CUDA tensor residual_vjp launches the kernel (and raises where it cannot),
each launch counted on residual_vjp.launch; on a CPU tensor it runs
residual_vjp_reference.
"""

import ctypes
from functools import lru_cache
from typing import Dict, Tuple

import numpy as np
import torch

from redmax_tpu_torch import chord_kernel, metrics, model
from redmax_tpu_torch.forces import ForceGroundCuboid
from redmax_tpu_torch.joints import CONSTANT_S_TYPES
from redmax_tpu_torch.kernel_build import KernelBuild
from redmax_tpu_torch.linalg import make_solver
from redmax_tpu_torch.types import JointType, Topology

_SOURCES = ("residual_vjp.cu", "residual_vjp.cuh", "chord_bdf2_coop.cuh", "chord_bdf2_lane.cuh")
_solve_T = make_solver("gj")[2]


def kinds_of(force_fns: Tuple) -> int:
    return chord_kernel.CONTACTS if force_fns else 0


@lru_cache(maxsize=None)
def takes(topo: Topology, force_fns: Tuple) -> bool:
    """True where the kernel covers the scene: constant-S joints, no closure
    but ground contacts, N and nr at most 32 (where a lane's record fits a
    block whatever the shape: 147,344 bytes at (32, 32))."""
    return (all(JointType(t) in CONSTANT_S_TYPES for t in topo.jtype)
            and all(type(fn) is ForceGroundCuboid for fn in force_fns)
            and max(topo.njoints, topo.nr) <= chord_kernel.MAX_COOP_WIDTH)


def takes_params(params: Dict) -> bool:
    """True for params the kernel takes: every physical param lane-shared
    (tau may be per lane). Which leaves require grad is the adjoint's to
    check (implicit_solve_custom)."""
    return not chord_kernel.has_perlane(params)


def residual_vjp_reference(topo: Topology, force_fns: Tuple, params: Dict, q0, qd0, q1, qd1,
                           q2, w):
    """The kernel's function in plain batched PyTorch: the cotangents (tau,
    q0, qd0, q1, qd1) [B, nr] of residual_bdf2 at q2 with the cotangent w:
    a = M(q2) w, b from one autograd.grad of (w . f(q2, v)) in v alone, and
    the chain rule of the module docstring."""
    h = params["h"]
    v = (3 / (2 * h)) * (q2 - (4 / 3) * q1 + (1 / 3) * q0)
    with torch.enable_grad():
        vg = v.detach().requires_grad_(True)
        M, f, _ = model.assemble(topo, params, q2.detach(), vg, force_fns)
        (b,) = torch.autograd.grad((w * f).sum(), vg)
    a = (M.detach() @ w[..., None])[..., 0]
    c = (4 / 9) * h * h
    return (-c * w, a / 3 - (2 / 9) * h * b, (2 / 9) * h * a, -(4 / 3) * a + (8 / 9) * h * b,
            -(8 / 9) * h * a)


def residual_vjp(topo: Topology, force_fns: Tuple, params: Dict, q0, qd0, q1, qd1, q2, xbar,
                 hinv=None):
    """(tau_bar, q0_bar, qd0_bar, q1_bar, qd1_bar): the VJP of residual_bdf2
    at the solution q2 with the cotangent -z, z = H^-T xbar by the forward's
    H^-1 hinv [B, nr, nr] where it is given, else z = xbar. tau_bar has
    params["tau"]'s shape, the rest [B, nr]. A CUDA tensor goes to the kernel
    (f32, a step that takes and takes_params admit, else it raises), a CPU tensor to
    residual_vjp_reference."""
    if q2.device.type == "cpu":
        z = xbar if hinv is None else _solve_T(hinv, xbar)
        tau_bar, *rest = residual_vjp_reference(topo, force_fns, params, q0, qd0, q1, qd1, q2,
                                                -z)
    elif q2.device.type == "cuda":
        tau_bar, *rest = launch(topo, force_fns, params, q0, qd0, q1, qd1, q2, xbar, hinv)
    else:
        raise ValueError(f"residual_vjp: unsupported device {q2.device}")
    return (tau_bar.sum_to_size(params["tau"].shape), *rest)


@lru_cache(maxsize=None)
def build_for(N: int, nr: int, kinds: int) -> KernelBuild:
    """The build of one (N, nr, kinds): one nvcc unit, compiled at its first
    launch into _build/ and cached there by a hash of its sources and
    defines."""
    return KernelBuild(f"residual_vjp_{N}_{nr}_{kinds}", _SOURCES,
                       (f"-DVJP_N={N}", f"-DVJP_NR={nr}", f"-DVJP_FEAT={kinds}"))


def prepare(topo: Topology, force_fns: Tuple) -> None:
    """Start the build of a scene that takes holds (nvcc, not waited for) so
    that it compiles beside the forward's; its first launch loads it. Once
    loaded, nothing: start() makes system calls (a stat, the process id),
    which no forward step needs to pay for."""
    build = build_for(topo.njoints, topo.nr, kinds_of(force_fns))
    if build.lib is None:
        build.start()


def _lib(build: KernelBuild):
    first = build.lib is None
    lib = build.load()
    if first:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.residual_vjp_launch.argtypes = [i] * 5 + [p] * 7 + [p, p, p, p, p]
        lib.residual_vjp_launch.restype = i
    return lib


@lru_cache(maxsize=None)
def _scene(topo: Topology, force_fns: Tuple):
    """(kinds, build, closure counts, closure spec) of a scene."""
    kinds = kinds_of(force_fns)
    spec = chord_kernel.closure_spec(topo, force_fns)
    return kinds, build_for(topo.njoints, topo.nr, kinds), chord_kernel.counts_of(spec), spec


# residual_vjp_launch's own error codes (any other is a cudaError_t)
_LAUNCH_ERRORS = {-1: "no build of (N, nr, kinds) in this library",
                  -2: "ground contacts in a build without them"}


def launch(topo: Topology, force_fns: Tuple, params: Dict, q0, qd0, q1, qd1, q2, xbar,
           hinv=None):
    """Launch the kernel on the current stream: the five cotangents [B, nr]
    (views of one [5, B, nr] buffer); counts the launch on
    residual_vjp.launch. Raises on inputs it does not take or a failed build
    or launch, with the key."""
    N, nr = topo.njoints, topo.nr
    B = q2.shape[0]
    if not takes(topo, force_fns) or chord_kernel.has_perlane(params):
        raise ValueError("residual_vjp: scene/params not covered by the kernel")
    ins = (q0, qd0, q1, qd1, q2, xbar)
    for a in ins + (() if hinv is None else (hinv,)):
        if a.device != q2.device or a.dtype != torch.float32:
            raise ValueError("residual_vjp: every input must be float32 on one CUDA device")
    for a in ins:
        if a.shape != (B, nr):
            raise ValueError(f"residual_vjp: state of shape {tuple(a.shape)}, want {(B, nr)}")
    if hinv is not None and hinv.shape != (B, nr, nr):
        raise ValueError(f"residual_vjp: H^-1 of shape {tuple(hinv.shape)}")
    kinds, build, counts, spec = _scene(topo, force_fns)
    lib = _lib(build)
    topo_i = chord_kernel._topology_buffer(topo, spec, q2.device)
    stat_f = chord_kernel.static_buffer(topo, params, force_fns)
    chord_kernel.check_buffers(topo, topo_i, stat_f, counts)
    strides = [s for a in ins for s in a.stride()]
    strides += [0, 0, 0] if hinv is None else list(hinv.stride())
    strides = np.asarray(strides, dtype=np.int64)
    out = torch.empty(5, B, nr, dtype=torch.float32, device=q2.device)
    stream = torch.cuda.current_stream(q2.device).cuda_stream
    err = lib.residual_vjp_launch(
        N, nr, kinds, counts.contacts, B, *(a.data_ptr() for a in ins),
        None if hinv is None else hinv.data_ptr(), strides.ctypes.data_as(ctypes.c_void_p),
        topo_i.data_ptr(), stat_f.data_ptr(), out.data_ptr(), stream)
    if err != 0:
        why = _LAUNCH_ERRORS.get(err, "CUDA error")
        raise RuntimeError(f"{build.name} kernel launch failed for (N, nr, kinds) = "
                           f"{(N, nr, kinds)}: error {err} ({why})")
    metrics.count("residual_vjp.launch")
    return tuple(out)
