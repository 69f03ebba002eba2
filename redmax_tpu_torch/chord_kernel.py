"""Fused BDF2 chord-Newton solve: the CUDA kernel, its plain PyTorch
version, its build and its launch counter.

The kernel (csrc/chord_bdf2.cu, per-lane body in csrc/chord_bdf2_lane.cuh)
replaces redmax_tpu/pallas_step.py::_build_kernel of the JAX package, on its
K1a and K1c branches: constant-S joints, penalty ground contact
(ForceGroundCuboid, pallas_step._ground_contact) as the only force closure,
unguarded chord, shared physical params. Per lane it runs FK with the
world-column J and Jdot, the joint and maximal forces with the contact
wrenches, the BDF2 residual, the structured Newton matrix
H = M + cK K~ + cD D~ with the contacts' closed-form K/D blocks under the
proximity-margin activation, an unpivoted Gauss-Jordan H^-1 and
`fixed_iters` chord steps with growth/tol rejection, and writes x [B, nr]
(NaN on rejected lanes) and H^-1 [B, nr, nr].

What bounds it on an H100: per-lane f32 arithmetic. It moves
4 * B * (6 nr + nr + nr^2) bytes (about 0.93 MB at B = 1024, nr = 12) and
does on the order of 1e5 flops per lane (about twice that with a contact on
every link), so the operation count, not the bytes, sets the least time. The
first-cut design gives one thread to each lane, so the arithmetic runs
without any cross-thread traffic and the struct-of-arrays [nr, B] layout
makes every state read and write coalesced.
What it leaves for later: at B = 1024 only 1024 threads run (a few dozen of
the 132 SMs), and the per-lane J, Jdot, H and Gauss-Jordan rows (a few
thousand floats) live in local memory rather than registers. A warp per lane
or a thread per (lane, column) with shared memory is the next design.

On a CUDA tensor chord_bdf2 launches the kernel (and raises if it cannot);
on a CPU tensor it runs chord_bdf2_reference.
"""

import ctypes
from functools import lru_cache
from typing import Dict, Tuple

import numpy as np
import torch

from redmax_tpu_torch import integrators, model
from redmax_tpu_torch.forces import ForceGroundCuboid
from redmax_tpu_torch.joints import CONSTANT_S_TYPES
from redmax_tpu_torch.kernel_build import KernelBuild
from redmax_tpu_torch.types import JointType, Topology

# Launches of the CUDA kernel since the counter was last set to 0.
chord_bdf2_launches = 0

BUILD = KernelBuild("chord_bdf2", ("chord_bdf2.cu", "chord_bdf2_lane.cuh"))
# (N, nr) shapes with an explicit template instantiation in chord_bdf2.cu.
INSTANTIATED = ((12, 12), (4, 4))


def supports(topo: Topology, force_fns: Tuple, cfg) -> bool:
    """True when the kernel covers this scene's inner step exactly."""
    return (
        all(isinstance(fn, ForceGroundCuboid) for fn in force_fns)
        and all(JointType(t) in CONSTANT_S_TYPES for t in topo.jtype)
        and cfg.fixed_iters > 0 and cfg.chord
        and not cfg.guarded and not cfg.guard_last
        and cfg.hessian == "structured" and cfg.linsolve == "gj"
    )


def chord_bdf2_reference(topo: Topology, cfg, params: Dict, x0, q0, qd0, q1, qd1,
                         force_fns: Tuple = ()):
    """The kernel's function in plain batched PyTorch: (x [B,nr], Hinv [B,nr,nr]).

    The op-level chord solve (integrators.newton on residual_bdf2 with the
    structured Newton matrix and the GJ inverse): same residual, same
    matrix, same chord loop and rejection as the kernel, up to f32
    reassociation.
    """
    theta = (params, q0, qd0, q1, qd1)
    hess = integrators._hess_bdf2(topo, force_fns)
    x, info = integrators.newton(
        lambda x: integrators.residual_bdf2(topo, force_fns, params, x, q0, qd0, q1, qd1),
        x0, cfg, jac_fn=lambda x: hess(theta, x),
    )
    return x, info["factor"]


def _build_lib():
    """The kernel library, compiled with nvcc at first use (see kernel_build).
    Raises when nvcc is missing or the build fails."""
    first = BUILD.lib is None
    lib = BUILD.load()
    if first:
        p, i, fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.chord_bdf2_launch.argtypes = ([i, i, i, i] + [p] * 6 + [p, p] + [i, fl, fl, fl]
                                          + [p, p, p])
        lib.chord_bdf2_launch.restype = i
    return lib


@lru_cache(maxsize=None)
def _topology_buffer(topo: Topology, contact_bodies: Tuple[int, ...], device: torch.device):
    """int32 [parent(N), jtype(N), doffs(N+1), dofj(nr), anc(N*N), C,
    contact_bodies(C)] on device."""
    doffs = np.concatenate([[0], np.cumsum(topo.ndof)])
    buf = np.concatenate([
        np.asarray(topo.parent), np.asarray(topo.jtype), doffs,
        topo.dof_joint(), topo.ancestor_mask().reshape(-1),
        [len(contact_bodies)], np.asarray(contact_bodies, dtype=np.int64),
    ]).astype(np.int32)
    return torch.as_tensor(buf, device=device)


def _static_buffer(topo: Topology, params: Dict, force_fns: Tuple = ()):
    """f32 [E0_pj (16N), E0_ji (16N), I_i (6N), axes (9N), jsf (7 nr), bd (N),
    g (3), h (1), cp (13 C)] on the params' device. axes[j][:, d] is the d-th
    DOF's axis (rotation axis for REVOLUTE, translation direction otherwise).
    cp holds one row per ground contact, in force_fns order: sides[3], kn, kt,
    kd, mu, xg[3], ng[3] (the floor's origin and normal)."""
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
    parts = [params["E0_pj"], params["E0_ji"], params["I_i"], axes, jsf,
             params["body_damping"], params["g"], params["h"].reshape(1)]
    for fn in force_fns:
        fp = fn.p(params)
        parts += [fp["sides"], fp["kn"], fp["kt"], fp["kd"], fp["mu"],
                  fp["E"][:3, 3], fp["E"][:3, 2]]
    return torch.cat([p.reshape(-1).float() for p in parts])


def chord_bdf2(topo: Topology, cfg, params: Dict, x0, q0, qd0, q1, qd1,
               force_fns: Tuple = ()):
    """Batched fused BDF2 chord solve: (x [B,nr], Hinv [B,nr,nr]).

    All state args are [B, nr]; params["tau"] may be [B, nr] or [nr]; every
    other param is lane-shared. force_fns are the scene's force closures
    (ground contacts only). A CUDA tensor goes to the kernel (f32, an
    instantiated (N, nr), a scene the kernel covers, else it raises; the
    wrapper makes the contiguous [nr, B] copies the kernel reads); a CPU
    tensor goes to chord_bdf2_reference.
    """
    integrators.split_batched_params(params)  # only tau may be per-lane
    if x0.device.type == "cpu":
        return chord_bdf2_reference(topo, cfg, params, x0, q0, qd0, q1, qd1, force_fns)
    if x0.device.type != "cuda":
        raise ValueError(f"chord_bdf2: unsupported device {x0.device}")
    if not supports(topo, force_fns, cfg):
        raise ValueError("chord_bdf2: scene/config not covered by the kernel")
    N, nr = topo.njoints, topo.nr
    if (N, nr) not in INSTANTIATED:
        raise ValueError(f"chord_bdf2: no kernel instantiation for (N, nr) = {(N, nr)}")
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
    then the topology and lane-shared parameter buffers, each with the
    ground contacts of force_fns at its end."""
    B, nr = x0.shape
    tau = params["tau"].expand(B, nr)
    soa = [a.t().contiguous() for a in (x0, q0, qd0, q1, qd1, tau)]
    bodies = tuple(int(fn.body) for fn in force_fns)
    if any(not 0 <= b < topo.njoints for b in bodies):
        raise ValueError(f"chord_bdf2: contact bodies {bodies} outside 0..{topo.njoints - 1}")
    return (*soa, _topology_buffer(topo, bodies, x0.device),
            _static_buffer(topo, params, force_fns))


def launch(topo: Topology, cfg, x0, q0, qd0, q1, qd1, tau, topo_i, stat_f):
    """Launch the kernel on the current stream on packed inputs (see pack);
    returns (x [nr, B], Hinv [nr*nr, B]) and counts the launch."""
    global chord_bdf2_launches
    lib = _build_lib()
    nr, B = x0.shape
    N = topo.njoints
    ncontacts = topo_i.numel() - (3 * N + 2 + nr + N * N)
    if ncontacts < 0 or stat_f.numel() != 48 * N + 7 * nr + 4 + 13 * ncontacts:
        raise ValueError("chord_bdf2: topology and parameter buffers do not match the scene")
    x_out = torch.empty(nr, B, dtype=torch.float32, device=x0.device)
    h_out = torch.empty(nr * nr, B, dtype=torch.float32, device=x0.device)
    stream = torch.cuda.current_stream(x0.device).cuda_stream
    err = lib.chord_bdf2_launch(
        N, nr, ncontacts, B, *(a.data_ptr() for a in (x0, q0, qd0, q1, qd1, tau)),
        topo_i.data_ptr(), stat_f.data_ptr(),
        cfg.fixed_iters, cfg.growth_reject, cfg.tol_reject, cfg.dx_clamp,
        x_out.data_ptr(), h_out.data_ptr(), stream,
    )
    if err != 0:
        raise RuntimeError(f"chord_bdf2 kernel launch failed: CUDA error {err}")
    chord_bdf2_launches += 1
    return x_out, h_out
