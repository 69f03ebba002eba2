"""Fused dual projected Gauss-Seidel QP solve: the CUDA kernel, its plain
PyTorch version, its build and its launch counters.

The kernel replaces redmax_tpu/pallas_qp.py::_build_kernel of the JAX
package. Per lane it solves  min 1/2 x^T H x - f^T x  with rows A x (<=|=) b
encoded by their projection boxes (see qp.qp_pgs_batched): an unpivoted
Gauss-Jordan H^-1, the dual setup D = A H^-1 A^T and r = A H^-1 f - b,
`iters` Gauss-Seidel sweeps over the m rows in order with clipping to
[lo, hi], and the primal recovery x = H^-1 (f - A^T lam). It writes x [B, n]
and lam [B, m].

What bounds it on an H100: inside a lane the iters * m row updates form one
dependent chain (each a dot of m, a division and a clip), so latency rather
than throughput sets the time; the operation count (about 1.7e4 flops per
lane at n = 6, m = 12, iters = 40, against 4 * (n^2 + n + m n + 3 m + n + m)
= 672 bytes per lane) is far below what that chain allows. Two designs,
chosen by a rule on the shape before anything is built (takes_coop):
- cooperative (csrc/dual_pgs_coop.cu, body csrc/dual_pgs_coop.cuh), on every
  (n, m) with max(n, m) <= 32: a group of threads a lane (the smallest
  power of two at or above max(n, m)), the lane's record
  in shared memory, the setup split over the group, each sweep's row i on
  thread i with lambda in shared memory. It reads the inputs as the callers
  hold them, [B, P] row-major, and writes [B, n] and [B, m]: no copy.
  Counter dual_pgs_coop_launches.
- thread per lane (csrc/dual_pgs.cu, body csrc/dual_pgs_lane.cuh), on any
  wider (n, m): one thread a lane in blocks of 32, on struct-of-arrays
  [P, B] copies of the inputs (pack). Counter dual_pgs_launches. Its builds
  at the cooperative shapes are reached by launch(..., thread_per_lane=True)
  only, to time it against the other design.

The shapes the paths run, (6, 12) and (6, 8), are instantiated in one
library of each design built up front (BUILD_COOP, BUILD); any other
(n, m) is built for it at its first launch (coop_build_for, build_for: one
nvcc unit of that shape, cached under _build/ by a hash of its sources and
defines), as the JAX package builds a kernel per (n, m).

On a CUDA tensor dual_pgs launches the kernel of its design (and raises,
with the shape, if it cannot build or launch it; nothing falls back to the
other design); on a CPU tensor it runs dual_pgs_reference.
"""

import ctypes
from functools import lru_cache

import torch

from redmax_tpu_torch.kernel_build import KernelBuild
from redmax_tpu_torch.linalg import gj_inverse
from redmax_tpu_torch.qp import pgs_sweeps

# Launches of the CUDA kernel since the counter was last set to 0: the
# thread-per-lane design, and the cooperative one.
dual_pgs_launches = 0
dual_pgs_coop_launches = 0

_SOURCES = ("dual_pgs.cu", "dual_pgs_lane.cuh")
_COOP_SOURCES = ("dual_pgs_coop.cu", "dual_pgs_coop.cuh", "dual_pgs_lane.cuh")
BUILD = KernelBuild("dual_pgs", _SOURCES)
BUILD_COOP = KernelBuild("dual_pgs_coop", _COOP_SOURCES)
# (n, m) shapes with an explicit template instantiation in BUILD and
# BUILD_COOP.
INSTANTIATED = ((6, 12), (6, 8))
# The widest n, m the cooperative design takes: a lane's group is at most a
# warp.
MAX_COOP_WIDTH = 32


def takes_coop(n: int, m: int) -> bool:
    """The shape rule: True when the cooperative design runs (n, m), that
    is when max(n, m) <= MAX_COOP_WIDTH."""
    return 1 <= min(n, m) and max(n, m) <= MAX_COOP_WIDTH


@lru_cache(maxsize=None)
def build_for(n: int, m: int) -> KernelBuild:
    """The thread-per-lane library that launches (n, m): BUILD where it has
    the shape, else a unit of that one shape (-DPGS_N, -DPGS_M), one
    KernelBuild a shape."""
    if (n, m) in INSTANTIATED:
        return BUILD
    return KernelBuild(f"dual_pgs_{n}_{m}", _SOURCES, defines=(f"-DPGS_N={n}", f"-DPGS_M={m}"))


@lru_cache(maxsize=None)
def coop_build_for(n: int, m: int) -> KernelBuild:
    """The cooperative library that launches (n, m): BUILD_COOP where it has
    the shape, else a unit of that one shape."""
    if (n, m) in INSTANTIATED:
        return BUILD_COOP
    return KernelBuild(f"dual_pgs_coop_{n}_{m}", _COOP_SOURCES,
                       defines=(f"-DPGS_N={n}", f"-DPGS_M={m}"))


def library_of(n: int, m: int, thread_per_lane: bool = False) -> KernelBuild:
    """The build that launches (n, m): the cooperative design where
    takes_coop holds, else the thread-per-lane one (thread_per_lane: that
    one in any case, to time it against the other)."""
    if not thread_per_lane and takes_coop(n, m):
        return coop_build_for(n, m)
    return build_for(n, m)


def is_coop(build: KernelBuild) -> bool:
    """True for a build of the cooperative design."""
    return build.sources[0] == "dual_pgs_coop.cu"


def dual_pgs_reference(H, f, A, b, lo, hi, iters: int = 40, reg: float = 1e-10):
    """The kernel's function in plain batched PyTorch: (x [B,n], lam [B,m]).

    Step by step what the kernel does: the unpivoted GJ inverse
    (linalg.gj_inverse, not a pivoted solve), the same dual setup, the same
    ordered sweeps and clip, the same recovery, up to f32 reassociation.
    """
    Hinv = gj_inverse(H)
    Hf = torch.einsum("bij,bj->bi", Hinv, f)
    HinvAT = Hinv @ A.transpose(-1, -2)                          # [B,n,m]
    D = A @ HinvAT
    r = torch.einsum("bmn,bn->bm", A, Hf) - b
    lam = pgs_sweeps(D, r, lo, hi, iters, reg)
    x = Hf - torch.einsum("bnm,bm->bn", HinvAT, lam)
    return x, lam


def _build_lib(build: KernelBuild = BUILD):
    """The kernel library of build, compiled with nvcc at first use (see
    kernel_build). Raises when nvcc is missing or the build fails."""
    first = build.lib is None
    lib = build.load()
    if first:
        p, i = ctypes.c_void_p, ctypes.c_int
        if is_coop(build):
            lib.dual_pgs_coop_launch.argtypes = [i, i, i] + [p] * 6 + [i, ctypes.c_float] + [p] * 3
            lib.dual_pgs_coop_launch.restype = i
            lib.dual_pgs_coop_layout.argtypes = [i, i, i]
            lib.dual_pgs_coop_layout.restype = ctypes.c_long
        else:
            lib.dual_pgs_launch.argtypes = [i, i, i] + [p] * 6 + [i, ctypes.c_float] + [p, p, p]
            lib.dual_pgs_launch.restype = i
    return lib


def coop_layout(n: int, m: int):
    """(threads a lane, lanes a block, shared memory a block in bytes) of
    the cooperative build of (n, m), as that build reports them (built
    first if need be)."""
    lib = _build_lib(coop_build_for(n, m))
    return tuple(int(lib.dual_pgs_coop_layout(n, m, k)) for k in range(3))


def dual_pgs(H, f, A, b, lo, hi, iters: int = 40, reg: float = 1e-10):
    """Batched fused dual-PGS solve: (x [B,n], lam [B,m]).

    H [B,n,n], f [B,n], A [B,m,n], b, lo, hi [B,m], n, m >= 1. A CUDA
    tensor goes to the kernel of the design library_of picks (f32, else it
    raises; a shape outside INSTANTIATED is built at its first launch; the
    cooperative design reads the inputs as they are, the thread-per-lane one
    on the [P, B] copies of pack); a CPU tensor goes to dual_pgs_reference.
    """
    if H.device.type == "cpu":
        return dual_pgs_reference(H, f, A, b, lo, hi, iters, reg)
    if H.device.type != "cuda":
        raise ValueError(f"dual_pgs: unsupported device {H.device}")
    B, n = f.shape
    m = A.shape[1]
    if n < 1 or m < 1:
        raise ValueError(f"dual_pgs: (n, m) = {(n, m)}, want both >= 1")
    want = {"H": (B, n, n), "f": (B, n), "A": (B, m, n), "b": (B, m), "lo": (B, m), "hi": (B, m)}
    for (name, shape), a in zip(want.items(), (H, f, A, b, lo, hi)):
        if a.device != H.device or a.dtype != torch.float32:
            raise ValueError("dual_pgs: every input must be float32 on one CUDA device")
        if a.shape != shape:
            raise ValueError(f"dual_pgs: {name} of shape {tuple(a.shape)}, want {shape}")
    if takes_coop(n, m):
        return launch(H, f, A, b, lo, hi, iters, reg)
    x_out, lam_out = launch(*pack(H, f, A, b, lo, hi), iters, reg, thread_per_lane=True)
    return x_out.t(), lam_out.t()


def pack(H, f, A, b, lo, hi):
    """The thread-per-lane kernel's inputs as contiguous struct-of-arrays
    [P, B], so that neighbouring threads read neighbouring floats."""
    B = f.shape[0]
    return tuple(a.reshape(B, -1).t().contiguous() for a in (H, f, A, b, lo, hi))


def _aligned(a):
    """a contiguous and 16-byte aligned (the cooperative kernel reads a
    lane's floats as 16- and 8-byte accesses): a itself where it is."""
    a = a.contiguous()
    return a if a.data_ptr() % 16 == 0 else a.clone()


# dual_pgs_launch's and dual_pgs_coop_launch's own error codes (any other is
# a cudaError_t)
_LAUNCH_ERRORS = {-1: "no instantiation of (n, m) in this library",
                  -6: "an input or output not 16-byte aligned"}


def launch(H, f, A, b, lo, hi, iters: int, reg: float, thread_per_lane: bool = False):
    """Launch the kernel on the current stream and count the launch on its
    design's counter. The cooperative design (the default; the shape must
    take it, takes_coop) reads the inputs as the callers hold them (H
    [B, n, n], f [B, n], A [B, m, n], b, lo, hi [B, m]) and returns x [B, n],
    lam [B, m]. thread_per_lane runs the thread-per-lane build on packed
    inputs (see pack) and returns x [n, B], lam [m, B]: the route of a
    shape the cooperative design does not take, and at the others only a
    yardstick to time the two against each other."""
    global dual_pgs_launches, dual_pgs_coop_launches
    coop = not thread_per_lane
    if coop:
        B, n = f.shape
        m = A.shape[1]
        if not takes_coop(n, m):
            raise ValueError(f"dual_pgs: the cooperative design does not take (n, m) = "
                             f"{(n, m)}; launch it thread_per_lane on packed inputs")
    else:
        n, B = f.shape
        m = b.shape[0]
    build = library_of(n, m, thread_per_lane)
    lib = _build_lib(build)
    stream = torch.cuda.current_stream(f.device).cuda_stream
    if coop:
        ins = [_aligned(a) for a in (H, f, A, b, lo, hi)]
        x_out = torch.empty(B, n, dtype=torch.float32, device=f.device)
        lam_out = torch.empty(B, m, dtype=torch.float32, device=f.device)
        err = lib.dual_pgs_coop_launch(n, m, B, *(a.data_ptr() for a in ins), iters, reg,
                                       x_out.data_ptr(), lam_out.data_ptr(), stream)
    else:
        x_out = torch.empty(n, B, dtype=torch.float32, device=f.device)
        lam_out = torch.empty(m, B, dtype=torch.float32, device=f.device)
        err = lib.dual_pgs_launch(n, m, B, *(a.data_ptr() for a in (H, f, A, b, lo, hi)), iters,
                                  reg, x_out.data_ptr(), lam_out.data_ptr(), stream)
    if err != 0:
        why = _LAUNCH_ERRORS.get(err, "CUDA error")
        raise RuntimeError(f"{build.name} kernel launch failed for (n, m) = {(n, m)}: "
                           f"error {err} ({why})")
    if coop:
        dual_pgs_coop_launches += 1
    else:
        dual_pgs_launches += 1
    return x_out, lam_out
