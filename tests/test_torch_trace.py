"""The port's spans and counters (redmax_tpu_torch.metrics): the span tree
of a batched Adam MPC solve and of a rollout, spans off (one shared object,
nothing recorded, allocated or created), spans under the profiler against
its record_function events, a root's counter deltas, a span on another
thread, the buffer's cap, and a kernel library's build counters. No JAX:
the card case runs on the card with

    python -m pytest tests/test_torch_trace.py --noconftest -o addopts="" -p no:cacheprovider -q
"""

import itertools
import threading
import time
import tracemalloc
from collections import Counter

import pytest
import torch

from redmax_tpu_torch import export, integrators, kernel_build, metrics, mpc
from redmax_tpu_torch.scenes import scene_chain
from redmax_tpu_torch.types import State

HORIZON = 5
CFG = integrators.NewtonConfig(fixed_iters=3, predictor="quadratic", chord=True,
                               hessian="structured", linsolve="gj")


@pytest.fixture(autouse=True)
def empty_buffer():
    metrics.clear_spans()
    yield
    metrics.clear_spans()


@pytest.fixture
def card():
    """Skips the test where no CUDA card is present."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA); run on the card with "
                    "python -m pytest tests/test_torch_trace.py --noconftest -o addopts=''")
    return "cuda"


def chain(device, dtype, nlinks=3, B=4):
    sc = scene_chain(nlinks).compile(dtype=dtype, device=device)
    s0 = State(q=sc.state0.q.expand(B, -1).contiguous(),
               qdot=sc.state0.qdot.expand(B, -1).contiguous())
    return sc, s0


def adam_solve(device="cpu", dtype=torch.float64, nlinks=3, B=4):
    """A batched one-iteration Adam MPC solve of the chain, horizon HORIZON:
    (solve, its arguments)."""
    sc, s0 = chain(device, dtype, nlinks, B)
    obj = mpc.make_objective_batched(sc.topo, sc.force_fns,
                                     mpc.PointPosTask(body=nlinks - 1, pscale=1e3),
                                     (0.5, 0.0, 0.0), HORIZON, CFG)
    gen = torch.Generator().manual_seed(0)
    P0 = 3e-3 * torch.randn(B, sc.topo.nr, generator=gen, dtype=dtype).to(device)
    targets = torch.rand(B, 3, generator=gen, dtype=dtype).to(device)
    return mpc.make_mpc_solver_batched(obj, iters=1, lr=0.05), (sc.params, P0, s0, targets)


def rollout(device="cpu", dtype=torch.float64, B=4):
    """A HORIZON-step BDF2 rollout of the chain under no_grad."""
    sc, s0 = chain(device, dtype, B=B)
    sim = integrators.make_simulate(
        integrators.make_bdf2_step_batched(sc.topo, sc.force_fns, CFG), HORIZON)

    def run():
        with torch.no_grad():
            return sim(sc.params, integrators.bdf2_init(s0))
    return run


def tree(spans):
    """{id: span}, and the names of each span's children in order."""
    by_id = {s.id: s for s in spans}
    kids = {s.id: [] for s in spans}
    for s in spans:
        if s.parent is not None:
            kids[s.parent].append(s.name)
    return by_id, kids


def check_nested(spans):
    """Every span closed, inside its parent's host interval, in its call."""
    by_id = {s.id: s for s in spans}
    for s in spans:
        assert s.end_ns is not None and s.start_ns <= s.end_ns, s
        if s.parent is not None:
            p = by_id[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns, (s, p)
            assert s.call == p.call, (s, p)


def test_span_tree_of_an_adam_solve():
    """One mpc.solve root; under it mpc.forward (integrators.simulate: one
    bootstrap, HORIZON - 1 inner steps) and mpc.gradient, which holds one
    adjoint.backward for each implicit solve (2 in the SDIRK2 bootstrap,
    one an inner step): the bootstrap's each with its backsolve and VJP,
    an inner step's with its VJP alone (the residual VJP kernel's route,
    whose launch solves for z too); one call identifier for the whole
    call."""
    solve, args = adam_solve()
    solve(*args)
    assert metrics.spans() == []
    with metrics.tracing():
        solve(*args)
    spans = metrics.spans()
    (root,) = [s for s in spans if s.parent is None]
    assert root.name == "mpc.solve" and {s.call for s in spans} == {root.id}
    by_id, kids = tree(spans)
    assert kids[root.id] == ["mpc.forward", "mpc.gradient"]
    forward, gradient = (s for s in spans if s.parent == root.id)
    (sim,) = [s for s in spans if s.parent == forward.id]
    assert sim.name == "integrators.simulate"
    assert kids[sim.id] == ["integrators.bootstrap"] + ["integrators.inner"] * (HORIZON - 1)
    solves = 2 + (HORIZON - 1)
    assert kids[gradient.id] == ["adjoint.backward"] * solves
    backward = [kids[s.id] for s in spans if s.name == "adjoint.backward"]
    assert backward == [["adjoint.vjp"]] * (HORIZON - 1) + [["adjoint.backsolve", "adjoint.vjp"]] * 2
    assert Counter(s.name for s in spans) == Counter({
        "mpc.solve": 1, "mpc.forward": 1, "mpc.gradient": 1, "integrators.simulate": 1,
        "integrators.bootstrap": 1, "integrators.inner": HORIZON - 1,
        "adjoint.backward": solves, "adjoint.backsolve": 2, "adjoint.vjp": solves})
    check_nested(spans)
    assert all(s.device_ms is None for s in spans)  # CPU tensors: no CUDA events
    assert root.counts is not None and all(s.counts is None for s in spans if s is not root)


def test_rollout_root():
    """A rollout with nothing open is its own root: integrators.simulate with
    one bootstrap and HORIZON - 1 inner steps, and no adjoint span."""
    run = rollout()
    with metrics.tracing():
        run()
    spans = metrics.spans()
    assert spans[0].name == "integrators.simulate" and spans[0].parent is None
    _, kids = tree(spans)
    assert kids[spans[0].id] == ["integrators.bootstrap"] + ["integrators.inner"] * (HORIZON - 1)
    assert len(spans) == HORIZON + 1 and {s.call for s in spans} == {spans[0].id}
    check_nested(spans)


def test_spans_off(monkeypatch):
    """Off (no tracing(), no profiler), span() hands out one shared object
    for any name, calls no record_function, creates no CUDA event,
    allocates nothing, and the buffer stays empty through a rollout."""
    def refused(*a, **k):
        raise AssertionError("called while spans are off")

    monkeypatch.setattr(metrics, "_annotation", refused)
    monkeypatch.setattr(metrics, "_event", refused)
    monkeypatch.setattr(torch.cuda, "Event", refused)
    assert metrics.span("mpc.solve") is metrics.span("chord_kernel.launch")
    rollout()()
    assert metrics.spans() == []

    span, repeat = metrics.span, itertools.repeat(None, 10_000)
    tracemalloc.start()
    try:
        tracemalloc.reset_peak()
        before = tracemalloc.get_traced_memory()[0]
        for _ in repeat:
            span("integrators.inner")
        now, peak = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    # the only allocation is get_traced_memory's own result tuple
    assert now == before and peak - before <= 64, (before, now, peak)


def test_spans_under_the_profiler_match_its_events():
    """Under torch.profiler (no tracing()), spans record, each as a
    record_function event of its name whose host interval lies within
    50 us of the span's (the profiler's clock is the epoch's: the offset
    between the two clocks is read beside the run). A loaded host can
    preempt the thread between the two clock reads of one span, so up to
    three profiled runs are made and one must hold every span."""
    from torch.profiler import ProfilerActivity, profile

    run = rollout()
    with profile(activities=[ProfilerActivity.CPU]):
        run()                                  # the annotations' first use
    worst = []
    for _ in range(3):
        metrics.clear_spans()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with metrics.span("warm"):         # the session's first annotation
                pass
            metrics.clear_spans()
            offset = time.time_ns() - time.perf_counter_ns()
            run()
        spans = metrics.spans()
        assert len(spans) == HORIZON + 1
        names = {s.name for s in spans}
        events = sorted((e.start_ns(), e.end_ns(), e.name())
                        for e in prof.profiler.kineto_results.events() if e.name() in names)
        assert [e[2] for e in events] == [s.name for s in spans]
        worst.append(max(max(abs(start - s.start_ns - offset), abs(end - s.end_ns - offset))
                         for s, (start, end, _) in zip(spans, events)))
        if worst[-1] < 50_000:
            break
    assert worst[-1] < 50_000, worst


def test_root_counter_deltas():
    """A root records how far each counter moved while it was open (and
    only those that moved); spans below it record none; counters are
    always on."""
    metrics.count("test_trace.outside", 2)
    with metrics.tracing():
        with metrics.span("root"):
            metrics.count("test_trace.a", 2)
            with metrics.span("child"):
                metrics.count("test_trace.a")
                metrics.count("test_trace.seconds", 0.25)
    root, child = metrics.spans()
    assert root.counts == {"test_trace.a": 3, "test_trace.seconds": 0.25}
    assert child.counts is None and child.parent == root.id
    metrics.count("test_trace.outside")
    assert metrics.counters()["test_trace.outside"] == 3


def test_span_on_another_thread_hangs_under_the_roots_innermost():
    """A span opened on a thread with no open span of its own takes the
    innermost span open on the root's thread as its parent (as the
    adjoint's spans do in autograd's device thread), and the root's call."""
    with metrics.tracing():
        with metrics.span("root"):
            with metrics.span("gradient"):
                worker = threading.Thread(target=lambda: metrics.span("backward").__enter__()
                                          .__exit__(None, None, None))
                worker.start()
                worker.join(timeout=10)
                assert not worker.is_alive()
        with metrics.span("later"):
            pass
    root, gradient, backward, later = metrics.spans()
    assert (backward.parent, backward.call) == (gradient.id, root.id)
    assert later.parent is None and later.call == later.id


def test_cap_and_dropped_spans(monkeypatch):
    """Past SPAN_CAP spans the buffer drops new ones and counts them."""
    monkeypatch.setattr(metrics, "SPAN_CAP", 3)
    before = metrics.counters().get("metrics.spans_dropped", 0)
    with metrics.tracing():
        for i in range(5):
            with metrics.span(f"s{i}"):
                pass
    assert [s.name for s in metrics.spans()] == ["s0", "s1", "s2"]
    assert metrics.counters()["metrics.spans_dropped"] - before == 2
    metrics.clear_spans()
    with metrics.tracing():
        with metrics.span("after"):
            pass
    assert [s.name for s in metrics.spans()] == ["after"]


def test_kernel_build_counters(tmp_path, monkeypatch):
    """A library compiled in this process moves kernel_build.compile.<name>
    and kernel_build.load.<name> by one and kernel_build.seconds by its
    load; a second load() of it moves nothing; a new KernelBuild of the same
    sources finds it built and loads it without a compile; the load is a
    span kernel_build.load.<name> only while spans record."""
    monkeypatch.setattr(kernel_build, "BUILD", str(tmp_path))
    name = "trace_counters"

    def moved(before):
        now = metrics.counters()
        return {k: v - before.get(k, 0) for k, v in now.items() if v != before.get(k, 0)}

    before = metrics.counters()
    build = kernel_build.KernelBuild(name, export.EXPORT_BUILD.sources, host=True)
    with metrics.tracing():
        build.load()
    build.load()
    delta = moved(before)
    assert delta.pop("kernel_build.seconds") > 0
    assert delta == {f"kernel_build.compile.{name}": 1, f"kernel_build.load.{name}": 1}
    assert [s.name for s in metrics.spans()] == [f"kernel_build.load.{name}"]

    before = metrics.counters()
    kernel_build.KernelBuild(name, export.EXPORT_BUILD.sources, host=True).load()
    delta = moved(before)
    assert delta.pop("kernel_build.seconds") > 0
    assert delta == {f"kernel_build.load.{name}": 1}
    assert len(metrics.spans()) == 1


@pytest.mark.card
def test_chord_spans_on_the_card(card):
    """On the card, an MPC solve of chain-12 at 1024 lanes: HORIZON - 1
    chord_kernel.pack and .launch spans, one under each inner step, each
    with a device time; the root's delta of chord launches is HORIZON - 1;
    the adjoint's spans (autograd's device thread) hang under mpc.gradient."""
    solve, args = adam_solve(card, torch.float32, nlinks=12, B=1024)
    solve(*args)                               # builds and loads the kernel
    torch.cuda.synchronize()
    with metrics.tracing():
        solve(*args)
    spans = metrics.spans()
    roots = [s for s in spans if s.parent is None]
    assert [s.name for s in roots] == ["mpc.solve"], [s.name for s in roots]
    root = roots[0]
    by_id, _ = tree(spans)
    names = Counter(s.name for s in spans)
    assert names["chord_kernel.pack"] == names["chord_kernel.launch"] == HORIZON - 1
    for s in spans:
        assert s.device_ms is not None and s.device_ms >= 0.0, s
        if s.name.startswith("chord_kernel."):
            assert by_id[s.parent].name == "integrators.inner"
        if s.name == "adjoint.backward":
            assert by_id[s.parent].name == "mpc.gradient"
    launches = sum(v for k, v in root.counts.items() if k.startswith("chord_kernel.launch."))
    assert launches == HORIZON - 1
    assert names["adjoint.backward"] == 2 + (HORIZON - 1)
    check_nested(spans)
