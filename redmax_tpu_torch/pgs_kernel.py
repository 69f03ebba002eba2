"""Batched projected Gauss-Seidel sweeps on a given dual (K3): the CUDA
kernel, its CPU build, the rule that picks its design, and its launch
counters.

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
lane, so the latency of one row update, not the rate of operations or
bytes. csrc/pgs_sweeps_lane.cuh keeps that chain short (the residual
r - D lambda kept and updated by each row's change, the reciprocal of the
diagonal taken once a lane, no branch on it); design_of picks between its
two designs (one thread a lane, a warp a lane) by m and dtype, and
warp_store how the warp design keeps D in shared memory: transposed, or
one triangle of a symmetric D (pgs_sweeps finds D symmetric bit for bit
itself, on the card, where the triangle would be taken).
csrc/pgs_sweeps.cu also holds the earlier warp design ("warp_div": a
division a row, the owner's step a branch, D read from device memory where
its transpose does not fit). pgs_sweeps takes it only where no store of the
warp design fits a block's shared memory (warp_store: double m >= 170 for
an unsymmetric D, m > 192 for any); launch() reaches it at any m, to time
it beside the others in one run. BUILD takes every m <= 128 (MAX_FIXED_M);
a wider m is built at its first launch (build_for).

Routes, by the device of D:
- CUDA: the kernel (csrc/pgs_sweeps.cu, body csrc/pgs_sweeps_lane.cuh), built
  with nvcc at first use into _build/ (kernel_build); a failure to build or
  launch raises, nothing falls back. Counters (metrics.counters()):
  pgs_kernel.launch.<design> (each launch, through pgs_sweeps or launch).
- CPU: the same lane header compiled by g++ (csrc/pgs_sweeps_host.cpp, a
  host build of kernel_build at first use into _build/), which computes
  the card designs' arithmetic in their order (their results bit for bit),
  not the plain version, whose Python double loop takes seconds a solve at
  3000 sweeps; without g++, or on an x86-64 CPU without FMA, it raises.
  Counter pgs_kernel.host_runs.
"""

import ctypes
from functools import lru_cache

import torch

from redmax_tpu_torch import metrics
from redmax_tpu_torch.kernel_build import KernelBuild

# The widest m that design_of sends to the thread design, by dtype: where
# it stops being the faster design (scripts/k3_designs.py on an H100). BUILD
# holds the thread design at these widths and no wider.
THREAD_UP_TO = {torch.float32: 14, torch.float64: 9}
_SOURCES = ("pgs_sweeps.cu", "pgs_sweeps_lane.cuh")
BUILD = KernelBuild("pgs_sweeps", _SOURCES,
                    defines=(f"-DPGS_THREAD_UP_TO_F32={THREAD_UP_TO[torch.float32]}",
                             f"-DPGS_THREAD_UP_TO_F64={THREAD_UP_TO[torch.float64]}"))
# The widest m BUILD holds in the warp designs: K = ceil(m / 32) rows a
# thread, K = 1..4.
MAX_FIXED_M = 128
HOST_BUILD = KernelBuild("pgs_sweeps_host", ("pgs_sweeps_host.cpp", "pgs_sweeps_lane.cuh"),
                         host=True)
DESIGNS = {"thread": 0, "warp": 1, "warp_div": 2}
# The warp design's store of a lane's D in shared memory (pgs_sweeps.cu's
# kFullStore, kTriStore).
STORES = {"full": 0, "triangle": 1}
# The widest m the warp design takes, for a dtype with a limit besides its
# store's fit (warp_store).
WARP_UP_TO = {torch.float64: 192}
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
_CTYPE = {torch.float32: ctypes.c_float, torch.float64: ctypes.c_double}


def design_of(m: int, dtype) -> str:
    """The design that pgs_sweeps launches at m: "thread" (one thread a
    lane) up to THREAD_UP_TO[dtype], else "warp" (a warp a lane).

    Why: a row's chain on one thread has no exchange (on the warp design a
    shuffle a row hands the owner's change to the warp), so it is the
    shorter chain: about 90 cycles a row in float64 and 51 in float32 on
    an H100 against the warp design's 150-160 and 110-120. But the thread
    keeps its rows' state and the unrolled row loop's operands in
    registers, which run out as m grows: past m = 8 in float64 and m = 12
    in float32 they spill, and past THREAD_UP_TO the spills cost more than
    the exchange saves (BUILD holds the thread design up to it). The friction
    zoo's dual QPs (m = 1, 2, 7) take the thread design, its friction
    passes (m = 24-80) the warp design."""
    return "thread" if m <= THREAD_UP_TO[dtype] else "warp"


def smem_bytes(m: int, dtype, store: str) -> int:
    """The shared memory of a block (one lane) of the warp design with D's
    store: lambda's 32 K slots and D transposed ("full", m^2) or its lower
    triangle ("triangle", m (m + 1) / 2), with a pad of 32."""
    size = torch.empty((), dtype=dtype).element_size()
    elems = {"full": m * m + 32, "triangle": m * (m + 1) // 2 + 32}[store]
    return size * (32 * -(-m // 32) + elems)


def warp_store(m: int, dtype, symmetric: bool, limit: int, waves):
    """How the warp design keeps D [B, m, m] in a block's shared memory
    (limit bytes, the card's opt-in): "triangle" (its lower triangle;
    symmetric: D is symmetric bit for bit) where that fits and either the
    transpose does not or the triangle runs the B lanes in fewer waves
    (waves(store): the waves of B lanes with that store); else "full" (the
    transpose) where it fits; else, or past WARP_UP_TO[dtype], None:
    pgs_sweeps then takes the earlier warp design, which reads D from
    device memory where its transpose does not fit.

    Why: a lane's chain does not shorten with more lanes, so B lanes take
    one chain's time a wave; the triangle halves a lane's shared memory
    (double m = 80: 26,944 bytes instead of 52,224, 8 lanes an SM instead
    of 4, B = 1024 in one wave instead of two) but costs a row update more
    than the transpose does where both take one wave (its refresh reads
    above the diagonal are scattered: float32 m = 80 107.6 ns a row against
    66.3, double m = 32 76.3 against 69.7 on an H100), so among the shared
    stores it is taken only where it saves a wave. Where neither fits, the
    warp design would have to read D from device memory, and with its K
    slots unrolled it runs out of registers there (double m = 200, D's
    transpose in device memory: 255 registers, spills, 2,249 ns a row
    against the earlier design's 1,592 on an H100, scripts/k3_designs.py),
    so the earlier design takes those widths; and in double the triangle
    alone spills too from K = 7 (m = 185: 1,471 ns against the earlier
    design's 1,702; m = 200: 1,916 against 1,585), hence WARP_UP_TO. In
    float the triangle stays faster (m = 300: 1,547 against 2,572)."""
    fits = lambda store: smem_bytes(m, dtype, store) <= limit
    if m > WARP_UP_TO.get(dtype, m):
        return None
    if symmetric and fits("triangle") and (not fits("full")
                                           or waves("triangle") < waves("full")):
        return "triangle"
    return "full" if fits("full") else None


@lru_cache(maxsize=None)
def _store_on_card(m: int, dtype, B: int, symmetric: bool):
    """warp_store on this card (layout's opt-in limit and waves)."""
    limit = layout(m, dtype, "warp_div")["max_smem"]
    waves = lambda store: -(-B // layout(m, dtype, "warp", store)["lanes_at_once"])
    return warp_store(m, dtype, symmetric, limit, waves)


def _lib(build: KernelBuild):
    """The library of build, compiled at first use (see kernel_build), with
    its functions' argument types set. Raises when the compiler is missing
    or the build fails."""
    first = build.lib is None
    lib = build.load()
    if first:
        p, i = ctypes.c_void_p, ctypes.c_int
        for dtype, suffix in _SUFFIX.items():
            if build.host:
                fn = getattr(lib, f"pgs_sweeps_host_{suffix}")
                fn.argtypes = [i, i] + [p] * 5 + [i, _CTYPE[dtype], p]
            else:
                fn = getattr(lib, f"pgs_sweeps_launch_{suffix}")
                fn.argtypes = [i, i, i, i] + [p] * 5 + [i, _CTYPE[dtype], p, p]
            fn.restype = i
        if not build.host:
            lib.pgs_sweeps_layout.argtypes = [i, i, i, i, i]
            lib.pgs_sweeps_layout.restype = ctypes.c_long
    return lib


def build_for(m: int) -> KernelBuild:
    """The CUDA library that launches m: BUILD up to MAX_FIXED_M, else the
    unit of its K = ceil(m / 32) (-DPGS_K), one KernelBuild a K, which holds
    the warp designs only."""
    return BUILD if m <= MAX_FIXED_M else _build_k(-(-m // 32))


@lru_cache(maxsize=None)
def _build_k(k: int) -> KernelBuild:
    return KernelBuild(f"pgs_sweeps_k{k}", _SOURCES, defines=(f"-DPGS_K={k}",))


def layout(m: int, dtype=torch.float64, design: str = "warp", store: str = "full"):
    """The launch of design at m on this card (its CUDA build, built first
    if need be; store: the warp design's, STORES): {"smem": dynamic shared
    memory a block in bytes, "lanes": lanes a block, "blocks_per_sm": blocks
    an SM holds (the occupancy calculator), "shared_d": D in shared memory
    (else read from device memory), "sms": the card's SMs, "max_smem": the
    shared memory a block may opt in to, "lanes_per_sm", "lanes_at_once"};
    waves(B) = ceil(B / lanes_at_once). Raises where the launch does not
    fit."""
    lib = _lib(build_for(m))
    size = torch.empty((), dtype=dtype).element_size()
    q = lambda which: int(lib.pgs_sweeps_layout(DESIGNS[design], STORES[store], m, size, which))
    out = {k: q(w) for w, k in enumerate(("smem", "lanes", "blocks_per_sm", "shared_d", "sms",
                                          "max_smem"))}
    if min(out.values()) < 0:
        raise RuntimeError(f"pgs_sweeps_layout: no {design} launch at m = {m}, {dtype}: {out}")
    out["shared_d"] = bool(out["shared_d"])
    out["lanes_per_sm"] = out["blocks_per_sm"] * out["lanes"]
    out["lanes_at_once"] = out["lanes_per_sm"] * out["sms"]
    return out


def _checked(D, r, lo, hi, active):
    """The inputs made contiguous, active as [B] bytes (or None); raises on
    a dtype, device or shape the kernel does not take."""
    B, m = r.shape
    if D.dtype not in _SUFFIX:
        raise ValueError(f"pgs_sweeps: dtype {D.dtype}, want float32 or float64")
    for name, a, shape in (("D", D, (B, m, m)), ("r", r, (B, m)), ("lo", lo, (B, m)),
                           ("hi", hi, (B, m))):
        if a.dtype != D.dtype or a.device != D.device:
            raise ValueError("pgs_sweeps: D, r, lo, hi must share one dtype and device")
        if tuple(a.shape) != shape:
            raise ValueError(f"pgs_sweeps: {name} of shape {tuple(a.shape)}, want {shape}")
    if D.device.type not in ("cpu", "cuda"):
        raise ValueError(f"pgs_sweeps: unsupported device {D.device}")
    act = None
    if active is not None:
        if tuple(active.shape) != (B,) or active.device != D.device:
            raise ValueError(f"pgs_sweeps: active must be [B] = [{B}] on {D.device}")
        act = active.to(torch.uint8).contiguous()
    return [a.contiguous() for a in (D, r, lo, hi)], act


def _launch(ins, act, iters, reg, design, store):
    """design's kernel on CUDA inputs (store: the warp design's, STORES;
    "triangle" for a D symmetric bit for bit only); lam [B, m]. Raises on
    any failure."""
    D, r = ins[0], ins[1]
    B, m = r.shape
    lam = torch.empty_like(r)
    lib = _lib(build_for(m))
    stream = torch.cuda.current_stream(D.device).cuda_stream
    err = getattr(lib, f"pgs_sweeps_launch_{_SUFFIX[D.dtype]}")(
        DESIGNS[design], STORES[store], m, B, *(a.data_ptr() for a in ins),
        None if act is None else act.data_ptr(), iters, reg, lam.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"pgs_sweeps ({design}) failed at m = {m}, B = {B}, {D.dtype}: "
                           f"error {err}")
    metrics.count(f"pgs_kernel.launch.{design}")
    return lam


def pgs_sweeps(D, r, lo, hi, iters: int, reg: float, active=None):
    """K3 on D [B, m, m], r, lo, hi [B, m] of one dtype (float32 or float64)
    on one device; active: None or [B] bool. Returns lam [B, m]. A CUDA
    tensor launches the kernel's design_of design (the warp design with the
    store warp_store picks, D's lower triangle only where it would be taken
    and D equals its transpose, which is then compared on the card, a wait
    for the card; under CUDA graph capture, where D cannot be read, the
    store of an unsymmetric D, which is right for any D; the earlier warp
    design where no store fits), a CPU tensor runs the g++ build of its lane
    body (see the module docstring); either raises on any failure."""
    ins, act = _checked(D, r, lo, hi, active)
    B, m = r.shape
    if m == 0 or B == 0:
        return torch.zeros_like(r)
    if D.device.type == "cuda":
        design, store = design_of(m, D.dtype), "full"
        if design == "warp":
            store = _store_on_card(m, D.dtype, B, True)
            if store == "triangle" and (torch.cuda.is_current_stream_capturing()
                                        or not torch.equal(ins[0], ins[0].mT)):
                store = _store_on_card(m, D.dtype, B, False)
            if store is None:
                design, store = "warp_div", "full"
        return _launch(ins, act, iters, reg, design, store)
    lam = torch.empty_like(ins[1])
    err = getattr(_lib(HOST_BUILD), f"pgs_sweeps_host_{_SUFFIX[D.dtype]}")(
        m, B, *(a.data_ptr() for a in ins), None if act is None else act.data_ptr(), iters, reg,
        lam.data_ptr())
    if err != 0:
        raise RuntimeError(f"pgs_sweeps_host failed at m = {m}, B = {B}, {D.dtype}: error {err}"
                           + (" (this CPU has no FMA instruction)" if err == -2 else ""))
    metrics.count("pgs_kernel.host_runs")
    return lam


def launch(D, r, lo, hi, iters: int, reg: float, active=None, design: str = "warp",
           store: str = "full"):
    """pgs_sweeps on the card through the named design ("thread", "warp" or
    "warp_div", the earlier warp design), whatever design_of says, and for
    the warp design the named store (STORES) whatever warp_store says
    ("triangle" takes a D equal to its transpose: raises otherwise, outside
    CUDA graph capture, where D can be read): to hold and time each launch
    in one run. CUDA tensors only; raises where
    the build holds no such launch (the thread design past THREAD_UP_TO) or
    it does not fit."""
    if design not in DESIGNS or store not in STORES:
        raise ValueError(f"pgs_sweeps: design {design!r} and store {store!r}, want one of "
                         f"{sorted(DESIGNS)} and of {sorted(STORES)}")
    ins, act = _checked(D, r, lo, hi, active)
    if D.device.type != "cuda":
        raise ValueError("pgs_kernel.launch takes CUDA tensors (pgs_sweeps runs CPU tensors)")
    if r.shape[0] == 0 or r.shape[1] == 0:
        return torch.zeros_like(r)
    if (design == "warp" and store == "triangle" and not torch.cuda.is_current_stream_capturing()
            and not torch.equal(ins[0], ins[0].mT)):
        raise ValueError("pgs_kernel.launch: store=\"triangle\" takes a D equal to its "
                         "transpose")
    return _launch(ins, act, iters, reg, design, store if design == "warp" else "full")
