"""Performance and correctness counters (the JAX package's metrics.py; the
reference's ChronoTimer.h:28-40, SolverDataTracker and batchTest
aggregation, Scene.cpp:248-287):

  * span: a named interval where the port's work happens (an MPC solve, its
    forward and gradient, the BDF2 bootstrap and inner steps, the adjoint's
    backsolve and VJP, the chord kernel's pack and launch, a kernel
    library's load). A span records inside tracing() and while a torch.profiler
    session is active, and nowhere else; off, span() tests two flags and
    returns one shared do-nothing object. A recording span keeps its
    parent, its call (the root span it descends from), its host interval
    (time.perf_counter_ns), where CUDA is initialised a pair of CUDA events
    on the current stream (its device time), under the profiler a
    record_function of its name (so a profiler trace shows it on the
    device operations' clock), and at a root the counters' deltas over it.
    spans() reads the bounded buffer, clear_spans() empties it;
  * count / counters: named counters, always on (kernel launches by design,
    the adjoint's VJPs by route, kernel builds' compiles, loads and seconds);
  * bench_throughput: seconds per call and calls/s, the warm-up excluded,
    the device of the outputs synchronized before each clock read;
  * energy_drift: the certificate quantity H_end = T_end + V_end - V_0.
"""

import contextlib
import itertools
import threading
import time
from typing import Callable, Dict, List, NamedTuple, Optional

import torch
from torch.autograd import profiler as _profiler

from redmax_tpu_torch.checkpoint import tree_flatten

SPAN_CAP = 1 << 16   # spans the buffer holds; later ones are dropped and counted

_counts: Dict[str, float] = {}
_counts_lock = threading.Lock()


def count(name: str, n: float = 1) -> None:
    """Add n to the counter name (created at 0)."""
    with _counts_lock:
        _counts[name] = _counts.get(name, 0) + n


def counters() -> Dict[str, float]:
    """A copy of every counter."""
    with _counts_lock:
        return dict(_counts)


class SpanRecord(NamedTuple):
    id: int
    name: str
    parent: Optional[int]        # the enclosing span's id; None at a root
    call: int                    # the id of the root the span descends from
    start_ns: int                # host clock, time.perf_counter_ns
    end_ns: Optional[int]        # None while the span is open
    device_ms: Optional[float]   # CUDA events; None without CUDA or while open
    counts: Optional[Dict[str, float]]   # a root's counter deltas; None below a root


_switch = False        # inside tracing()
_buffer: List["Span"] = []
_ids = itertools.count()
_local = threading.local()   # .stack: the spans open on this thread, innermost last
_root_stack: Optional[list] = None   # the stack of the thread that opened the last root
_events: list = []     # a pool of free CUDA events
# record_function's C++ form where this torch has it (a tenth of the cost)
_annotation = getattr(torch._C._profiler, "_RecordFunctionFast", _profiler.record_function)


class _Off:
    """The span returned while spans do not record: does nothing."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def span(name: str):
    """A context manager around the work of one named span: a Span that
    records inside tracing() or under a torch.profiler session, else the
    shared do-nothing object."""
    if _switch or _profiler._is_profiler_enabled:
        return Span(name)
    return _OFF


@contextlib.contextmanager
def tracing():
    """Spans record inside this context (besides under the profiler)."""
    global _switch
    before, _switch = _switch, True
    try:
        yield
    finally:
        _switch = before


def _event():
    return _events.pop() if _events else torch.cuda.Event(enable_timing=True)


class Span:
    """One recording span (span() hands these out while spans record). A
    span opened on a thread with no open span of its own hangs under the
    innermost span open on the thread that opened the last root (autograd's
    device thread runs the adjoint under mpc.gradient that way), else it is
    a root."""
    __slots__ = ("name", "id", "parent", "call", "start_ns", "end_ns", "device_ms",
                 "ev", "stream", "rf", "base", "counts", "stack")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        global _root_stack
        self.id = None
        if len(_buffer) >= SPAN_CAP:
            count("metrics.spans_dropped")
            return self
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        tail = stack[-1:] or (_root_stack[-1:] if _root_stack is not None else [])
        self.id = next(_ids)
        if tail:
            self.parent, self.call, self.base = tail[0].id, tail[0].call, None
        else:
            self.parent, self.call, self.base = None, self.id, counters()
            _root_stack = stack
        self.end_ns = self.device_ms = self.counts = None
        self.stack = stack
        stack.append(self)
        _buffer.append(self)
        self.ev = None
        if torch.cuda.is_initialized():
            # both events on the stream current at the start, queried once
            # (a query costs several microseconds of host time)
            self.ev, self.stream = (_event(), _event()), torch.cuda.current_stream()
            self.ev[0].record(self.stream)
        self.start_ns = time.perf_counter_ns()
        self.rf = None
        if _profiler._is_profiler_enabled:
            self.rf = _annotation(self.name)
            self.rf.__enter__()
        return self

    def __exit__(self, *exc):
        if self.id is None:
            return False
        if self.rf is not None:
            self.rf.__exit__(*exc)
        self.end_ns = time.perf_counter_ns()
        if self.ev is not None:
            self.ev[1].record(self.stream)
        self.stack.pop()
        if self.base is not None:
            now = counters()
            self.counts = {k: v - self.base.get(k, 0) for k, v in now.items()
                           if v != self.base.get(k, 0)}
        return False


def spans() -> List[SpanRecord]:
    """The recorded spans in the order they opened, device times resolved
    (this waits for the device work of each closed span)."""
    out = []
    for s in list(_buffer):
        if s.device_ms is None and s.ev is not None and s.end_ns is not None:
            s.ev[1].synchronize()
            s.device_ms = s.ev[0].elapsed_time(s.ev[1])
        out.append(SpanRecord(s.id, s.name, s.parent, s.call, s.start_ns, s.end_ns,
                              s.device_ms, s.counts))
    return out


def clear_spans() -> None:
    """Empty the buffer; the closed spans' events go back to the pool."""
    for s in _buffer:
        if s.ev is not None and s.end_ns is not None:
            _events.extend(s.ev)
    _buffer.clear()


def _synchronize(out) -> None:
    """Wait for the device work behind every CUDA tensor of out."""
    for dev in {x.device for x in tree_flatten(out)
                if isinstance(x, torch.Tensor) and x.device.type == "cuda"}:
        torch.cuda.synchronize(dev)


def bench_throughput(fn: Callable, args, n_warmup: int = 1, n_reps: int = 3):
    """(seconds per call, calls/s) of fn(*args) over n_reps calls after
    n_warmup (the kernels' builds and the allocator's first growth fall
    there; 0 where nothing is left to build); the host clock starts once the
    device of the arguments and of the warm-up's outputs is idle and is read
    once the outputs' device has finished."""
    out = None
    for _ in range(n_warmup):
        out = fn(*args)
    _synchronize((args, out))
    t0 = time.perf_counter()
    for _ in range(n_reps):
        out = fn(*args)
    _synchronize(out)
    dt = (time.perf_counter() - t0) / n_reps
    return dt, 1.0 / dt


def energy_drift(scene, state_final):
    """H_end = T_end + (V_end - V_0), the certificate quantity
    (Scene.plotEnergies, matlab-diff/+redmax/Scene.m:164-191), against the
    scene's initial state: a float for an unbatched state (q [nr]), a
    tensor [B] for a batched one (q [B, nr])."""
    s0 = scene.state0
    _, V0 = scene.energies(s0.q[None], s0.qdot[None])
    if state_final.q.dim() == 1:
        aux = {k: v[None] for k, v in state_final.aux.items()}
        T, V = scene.energies(state_final.q[None], state_final.qdot[None], aux)
        return float(T[0]) + float(V[0]) - float(V0[0])
    T, V = scene.energies(state_final.q, state_final.qdot, state_final.aux)
    return T + V - V0[0]
