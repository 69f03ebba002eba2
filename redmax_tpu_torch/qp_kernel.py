"""Fused dual projected Gauss-Seidel QP solve: the CUDA kernel, its plain
PyTorch version, its build and its launch counter.

The kernel (csrc/dual_pgs.cu, per-lane body in csrc/dual_pgs_lane.cuh)
replaces redmax_tpu/pallas_qp.py::_build_kernel of the JAX package. Per
lane it solves  min 1/2 x^T H x - f^T x  with rows A x (<=|=) b encoded by
their projection boxes (see qp.qp_pgs_batched): an unpivoted Gauss-Jordan
H^-1, the dual setup D = A H^-1 A^T and r = A H^-1 f - b, `iters`
Gauss-Seidel sweeps over the m rows in order with clipping to [lo, hi], and
the primal recovery x = H^-1 (f - A^T lam). It writes x [B, n] and
lam [B, m].

What bounds it on an H100: per-lane f32 arithmetic, by the operation count
(about 1.7e4 flops per lane at n = 6, m = 12, iters = 40, against
4 * (n^2 + n + m n + 3 m + n + m) = 672 bytes per lane), and inside a lane the
iters * m row updates form one dependent chain, so latency rather than
throughput sets the time of a thread. The first-cut design gives one thread
to each lane: the sequential recurrence runs in registers and local memory
with no cross-thread traffic, and the struct-of-arrays [P, B] layout makes
every read and write coalesced. What it leaves for later: at B = 1024 only
32 blocks of 32 threads run on 132 SMs, and the wrapper's [B, P] -> [P, B]
copies are separate launches.

The shapes the paths run, (6, 12) and (6, 8), are instantiated in one
library built up front (BUILD); any other (n, m) is built for it at its
first launch (build_for: one nvcc unit of that shape, cached under _build/
by a hash of its sources and defines), as the JAX package builds a kernel
per (n, m).

On a CUDA tensor dual_pgs launches the kernel (and raises if it cannot build
or launch it); on a CPU tensor it runs dual_pgs_reference.
"""

import ctypes
from functools import lru_cache

import torch

from redmax_tpu_torch.kernel_build import KernelBuild
from redmax_tpu_torch.linalg import gj_inverse
from redmax_tpu_torch.qp import pgs_sweeps

# Launches of the CUDA kernel since the counter was last set to 0.
dual_pgs_launches = 0

_SOURCES = ("dual_pgs.cu", "dual_pgs_lane.cuh")
BUILD = KernelBuild("dual_pgs", _SOURCES)
# (n, m) shapes with an explicit template instantiation in BUILD.
INSTANTIATED = ((6, 12), (6, 8))


@lru_cache(maxsize=None)
def build_for(n: int, m: int) -> KernelBuild:
    """The library that launches (n, m): BUILD where it has the shape, else
    a unit of that one shape (-DPGS_N, -DPGS_M), one KernelBuild a shape."""
    if (n, m) in INSTANTIATED:
        return BUILD
    return KernelBuild(f"dual_pgs_{n}_{m}", _SOURCES, defines=(f"-DPGS_N={n}", f"-DPGS_M={m}"))


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
        lib.dual_pgs_launch.argtypes = [i, i, i] + [p] * 6 + [i, ctypes.c_float] + [p, p, p]
        lib.dual_pgs_launch.restype = i
    return lib


def dual_pgs(H, f, A, b, lo, hi, iters: int = 40, reg: float = 1e-10):
    """Batched fused dual-PGS solve: (x [B,n], lam [B,m]).

    H [B,n,n], f [B,n], A [B,m,n], b, lo, hi [B,m], n, m >= 1. A CUDA
    tensor goes to the kernel (f32, else it raises; a shape outside
    INSTANTIATED is built at its first launch; the wrapper makes the
    contiguous [P, B] copies the kernel reads); a CPU tensor goes to
    dual_pgs_reference.
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
    x_out, lam_out = launch(*pack(H, f, A, b, lo, hi), iters, reg)
    return x_out.t(), lam_out.t()


def pack(H, f, A, b, lo, hi):
    """The kernel's inputs as contiguous struct-of-arrays [P, B], so that
    neighbouring threads read neighbouring floats."""
    B = f.shape[0]
    return tuple(a.reshape(B, -1).t().contiguous() for a in (H, f, A, b, lo, hi))


def launch(H, f, A, b, lo, hi, iters: int, reg: float):
    """Launch the kernel on the current stream on packed inputs (see pack);
    returns (x [n, B], lam [m, B]) and counts the launch."""
    global dual_pgs_launches
    n, B = f.shape
    m = b.shape[0]
    lib = _build_lib(build_for(n, m))
    x_out = torch.empty(n, B, dtype=torch.float32, device=f.device)
    lam_out = torch.empty(m, B, dtype=torch.float32, device=f.device)
    stream = torch.cuda.current_stream(f.device).cuda_stream
    err = lib.dual_pgs_launch(
        n, m, B, *(a.data_ptr() for a in (H, f, A, b, lo, hi)), iters, reg,
        x_out.data_ptr(), lam_out.data_ptr(), stream,
    )
    if err != 0:
        raise RuntimeError(f"dual_pgs kernel launch failed for (n, m) = {(n, m)}: error {err}")
    dual_pgs_launches += 1
    return x_out, lam_out
