"""Batched projected Gauss-Seidel sweeps on a given dual (K3): the CUDA
kernel, its CPU build, its plain PyTorch version and its launch counter.

pgs_sweeps(D [B, m, m], r, lo, hi [B, m], iters, reg, active=None) ->
lam [B, m]: `iters` Gauss-Seidel sweeps over the rows in order, each row
clipped to [lo, hi] (+-inf allowed, a NaN kept), the diagonal guarded
(|D_ii| < reg -> 1), in float32 and float64; a lane that active [B] (bool)
marks False is not swept and comes out 0. The plain version is
qp.pgs_sweeps.

The kernel replaces no Pallas kernel of the JAX package: it is the op-level
lax.scan of redmax_tpu/friction.py:633-642 and redmax_tpu/qp.py:77-86, the
3000 float64 sweeps of the staggered-projections friction step
(friction.py), which the port's plain double loop cannot run in time.
What bounds it on an H100: a dependent chain of iters * m row updates a
lane, so latency, not the rate of operations or bytes; csrc/pgs_sweeps.cu
says what its design (a warp a lane, the residual r - D lambda kept and
updated by each row's change, one shuffle a row, D in shared memory where it
fits) does about that. BUILD takes every m <= 128 (MAX_FIXED_M); a wider m
is built at its first launch (build_for).

Routes, by the device of D:
- CUDA: the kernel (csrc/pgs_sweeps.cu, body csrc/pgs_sweeps_lane.cuh), built
  with nvcc at first use into _build/ (kernel_build); a failure to build or
  launch raises, nothing falls back. Counter pgs_sweeps_launches.
- CPU: the same lane header compiled by g++ (csrc/pgs_sweeps_host.cpp, a
  host build of kernel_build at first use into _build/), not the plain
  version, whose Python double loop takes seconds a solve at 3000 sweeps;
  without g++ it raises. Counter pgs_sweeps_host_runs.
"""

import ctypes
from functools import lru_cache

import torch

from redmax_tpu_torch.kernel_build import KernelBuild

# Launches of the CUDA kernel, and runs of the CPU build, since the counter
# was last set to 0.
pgs_sweeps_launches = 0
pgs_sweeps_host_runs = 0

_SOURCES = ("pgs_sweeps.cu", "pgs_sweeps_lane.cuh")
BUILD = KernelBuild("pgs_sweeps", _SOURCES)
# The widest m BUILD holds: K = ceil(m / 32) rows a thread, K = 1..4.
MAX_FIXED_M = 128
HOST_BUILD = KernelBuild("pgs_sweeps_host", ("pgs_sweeps_host.cpp", "pgs_sweeps_lane.cuh"),
                         host=True)
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
_CTYPE = {torch.float32: ctypes.c_float, torch.float64: ctypes.c_double}


def _lib(build: KernelBuild):
    """The library of build, compiled at first use (see kernel_build), with
    its functions' argument types set. Raises when the compiler is missing
    or the build fails."""
    first = build.lib is None
    lib = build.load()
    if first:
        p, i = ctypes.c_void_p, ctypes.c_int
        for dtype, suffix in _SUFFIX.items():
            fn = getattr(lib, f"pgs_sweeps_{'host' if build.host else 'launch'}_{suffix}")
            fn.argtypes = [i, i] + [p] * 5 + [i, _CTYPE[dtype], p] + ([] if build.host else [p])
            fn.restype = i
        if not build.host:
            lib.pgs_sweeps_layout.argtypes = [i, i, i]
            lib.pgs_sweeps_layout.restype = ctypes.c_long
    return lib


@lru_cache(maxsize=None)
def build_for(m: int) -> KernelBuild:
    """The CUDA library that launches m: BUILD up to MAX_FIXED_M, else a unit
    of that K = ceil(m / 32) (-DPGS_K), one KernelBuild a K."""
    if m <= MAX_FIXED_M:
        return BUILD
    k = -(-m // 32)
    return KernelBuild(f"pgs_sweeps_k{k}", _SOURCES, defines=(f"-DPGS_K={k}",))


def layout(m: int, dtype=torch.float64):
    """(dynamic shared memory a block in bytes, D in shared memory) of a
    launch at m on this card (its CUDA build, built first if need be)."""
    lib = _lib(build_for(m))
    size = torch.empty((), dtype=dtype).element_size()
    return int(lib.pgs_sweeps_layout(m, size, 0)), bool(lib.pgs_sweeps_layout(m, size, 1))


def pgs_sweeps(D, r, lo, hi, iters: int, reg: float, active=None):
    """K3 on D [B, m, m], r, lo, hi [B, m] of one dtype (float32 or float64)
    on one device; active: None or [B] bool. Returns lam [B, m]. A CUDA
    tensor launches the kernel, a CPU tensor runs the g++ build of its lane
    body (see the module docstring); either raises on any failure."""
    global pgs_sweeps_launches, pgs_sweeps_host_runs
    B, m = r.shape
    if D.dtype not in _SUFFIX:
        raise ValueError(f"pgs_sweeps: dtype {D.dtype}, want float32 or float64")
    for name, a, shape in (("D", D, (B, m, m)), ("r", r, (B, m)), ("lo", lo, (B, m)),
                           ("hi", hi, (B, m))):
        if a.dtype != D.dtype or a.device != D.device:
            raise ValueError("pgs_sweeps: D, r, lo, hi must share one dtype and device")
        if tuple(a.shape) != shape:
            raise ValueError(f"pgs_sweeps: {name} of shape {tuple(a.shape)}, want {shape}")
    if m == 0 or B == 0:
        return torch.zeros_like(r)
    if D.device.type not in ("cpu", "cuda"):
        raise ValueError(f"pgs_sweeps: unsupported device {D.device}")
    host = D.device.type == "cpu"
    lib = _lib(HOST_BUILD if host else build_for(m))
    ins = [a.contiguous() for a in (D, r, lo, hi)]
    act = None
    if active is not None:
        if tuple(active.shape) != (B,) or active.device != D.device:
            raise ValueError(f"pgs_sweeps: active must be [B] = [{B}] on {D.device}")
        act = active.to(torch.uint8).contiguous()
    lam = torch.empty_like(ins[1])
    suffix = _SUFFIX[D.dtype]
    args = [m, B, *(a.data_ptr() for a in ins), None if act is None else act.data_ptr(),
            iters, reg, lam.data_ptr()]
    if host:
        err = getattr(lib, f"pgs_sweeps_host_{suffix}")(*args)
    else:
        stream = torch.cuda.current_stream(D.device).cuda_stream
        err = getattr(lib, f"pgs_sweeps_launch_{suffix}")(*args, stream)
    if err != 0:
        raise RuntimeError(f"{'pgs_sweeps_host' if host else 'pgs_sweeps'} failed at m = {m}, "
                           f"B = {B}, {D.dtype}: error {err}")
    if host:
        pgs_sweeps_host_runs += 1
    else:
        pgs_sweeps_launches += 1
    return lam
