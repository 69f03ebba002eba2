"""The span and counter readers (layer_metrics/*_span_ms.py,
chord_launches.py, kernel_load_s.py) on synthetic recorded span trees: what
each reads from its mode's first root, and None where the root of its mode
is absent or the program records no spans or counters."""

import pytest

from portbench.harness import spec
from redmax_tpu_torch import metrics

SPAN_METRICS = ["forward_span_ms", "gradient_span_ms", "vjp_span_ms", "backsolve_span_ms",
                "bootstrap_span_ms.mpc", "bootstrap_span_ms.rollout", "pack_span_ms.mpc",
                "pack_span_ms.rollout", "launch_span_ms.mpc", "launch_span_ms.rollout",
                "chord_launches.mpc", "chord_launches.rollout"]


class Tree:
    """Builds SpanRecords with ids in opening order."""

    def __init__(self):
        self.spans = []

    def add(self, name, parent=None, ms=1.0, counts=None):
        sid = len(self.spans)
        call = sid if parent is None else self.spans[parent].call
        self.spans.append(metrics.SpanRecord(sid, name, parent, call, sid, sid + 1, ms, counts))
        return sid


def mpc_call(t, inner=3, scale=1.0):
    """An MPC solve's tree: inner steps of pack 0.25 and launch 0.5 ms, and
    a backward of inner + 2 implicit solves (backsolve 0.1, VJP 2 ms)."""
    root = t.add("mpc.solve", ms=100.0 * scale,
                 counts={"chord_kernel.launch.coop": inner, "kernel_build.seconds": 0.5})
    fwd = t.add("mpc.forward", root, ms=30.0 * scale)
    sim = t.add("integrators.simulate", fwd, ms=29.0 * scale)
    t.add("integrators.bootstrap", sim, ms=10.0 * scale)
    for _ in range(inner):
        step = t.add("integrators.inner", sim, ms=1.0 * scale)
        t.add("chord_kernel.pack", step, ms=0.25 * scale)
        t.add("chord_kernel.launch", step, ms=0.5 * scale)
    grad = t.add("mpc.gradient", root, ms=60.0 * scale)
    for _ in range(inner + 2):
        bwd = t.add("adjoint.backward", grad, ms=2.5 * scale)
        t.add("adjoint.backsolve", bwd, ms=0.1 * scale)
        t.add("adjoint.vjp", bwd, ms=2.0 * scale)


def rollout_call(t, inner=4):
    root = t.add("integrators.simulate", ms=50.0,
                 counts={"chord_kernel.launch.coop": inner - 1, "chord_kernel.launch.thread": 1})
    t.add("integrators.bootstrap", root, ms=7.0)
    for _ in range(inner):
        step = t.add("integrators.inner", root, ms=2.0)
        t.add("chord_kernel.pack", step, ms=0.5)
        t.add("chord_kernel.launch", step, ms=1.0)


def split_pass(t, inner=2):
    """The split pass's profiled inner steps: roots of their own."""
    for _ in range(inner):
        step = t.add("integrators.inner", ms=9.0, counts={"chord_kernel.launch.coop": 1})
        t.add("chord_kernel.pack", step, ms=9.0)
        t.add("chord_kernel.launch", step, ms=9.0)


def read(name, mode):
    fn, variant = spec.reader(name)
    return fn({"mode": mode}, variant)


@pytest.fixture
def recorded(monkeypatch):
    def use(tree, counters=None):
        monkeypatch.setattr(metrics, "spans", lambda: list(tree.spans))
        monkeypatch.setattr(metrics, "counters", lambda: dict(counters or {}))
    return use


def test_mpc_readers(recorded):
    t = Tree()
    t.add("kernel_build.load.chord_bdf2_coop", ms=None)   # a load: a root of another name
    mpc_call(t)
    mpc_call(t, scale=2.0)                    # a later call: not read
    split_pass(t)
    recorded(t, {"kernel_build.seconds": 41.5})
    assert read("forward_span_ms", "mpc") == 30.0
    assert read("gradient_span_ms", "mpc") == 60.0
    assert read("vjp_span_ms", "mpc") == pytest.approx(5 * 2.0)
    assert read("backsolve_span_ms", "mpc") == pytest.approx(5 * 0.1)
    assert read("bootstrap_span_ms.mpc", "mpc") == 10.0
    assert read("pack_span_ms.mpc", "mpc") == pytest.approx(0.25)
    assert read("launch_span_ms.mpc", "mpc") == pytest.approx(0.5)
    assert read("chord_launches.mpc", "mpc") == 3
    assert read("kernel_load_s", "mpc") == 41.5
    for name in ("bootstrap_span_ms.rollout", "pack_span_ms.rollout", "launch_span_ms.rollout",
                 "chord_launches.rollout"):
        assert read(name, "mpc") is None, name


def test_rollout_readers(recorded):
    t = Tree()
    rollout_call(t)
    split_pass(t)
    recorded(t, {"kernel_build.seconds": 0.25})
    assert read("bootstrap_span_ms.rollout", "rollout") == 7.0
    assert read("pack_span_ms.rollout", "rollout") == pytest.approx(0.5)
    assert read("launch_span_ms.rollout", "rollout") == pytest.approx(1.0)
    assert read("chord_launches.rollout", "rollout") == 4
    assert read("kernel_load_s", "rollout") == 0.25
    for name in ("forward_span_ms", "gradient_span_ms", "vjp_span_ms", "backsolve_span_ms",
                 "bootstrap_span_ms.mpc", "pack_span_ms.mpc", "chord_launches.mpc"):
        assert read(name, "rollout") is None, name


def test_an_mpc_simulate_is_no_rollout_root(recorded):
    """The integrators.simulate inside an MPC solve is not a root: a
    rollout reader finds nothing there."""
    t = Tree()
    mpc_call(t)
    recorded(t)
    assert read("bootstrap_span_ms.rollout", "rollout") is None
    assert read("kernel_load_s", "mpc") is None       # no kernel_build.seconds counted


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_none_without_the_modes_root(recorded, name):
    t = Tree()
    split_pass(t)                             # only roots of other names
    recorded(t)
    mode = "rollout" if name.endswith(".rollout") else "mpc"
    assert read(name, mode) is None


@pytest.mark.parametrize("name", SPAN_METRICS + ["kernel_load_s"])
def test_none_on_a_program_without_spans(monkeypatch, name):
    """A program whose metrics module has neither spans nor counters (the
    commit before them) gives None, and no reader raises."""
    monkeypatch.delattr(metrics, "spans")
    monkeypatch.delattr(metrics, "counters")
    mode = "rollout" if name.endswith(".rollout") else "mpc"
    assert read(name, mode) is None


def test_none_without_device_times(recorded):
    """Spans recorded without CUDA events (no card) give no device time."""
    t = Tree()
    root = t.add("integrators.simulate", ms=None, counts={})
    t.add("integrators.bootstrap", root, ms=None)
    step = t.add("integrators.inner", root, ms=None)
    t.add("chord_kernel.pack", step, ms=None)
    recorded(t)
    assert read("bootstrap_span_ms.rollout", "rollout") is None
    assert read("pack_span_ms.rollout", "rollout") is None
    assert read("launch_span_ms.rollout", "rollout") is None
    assert read("chord_launches.rollout", "rollout") == 0


def test_every_new_metric_has_its_entry():
    entries = {m["name"]: m for m in spec.benchmark()["per_layer"]}
    for name in SPAN_METRICS + ["kernel_load_s"]:
        assert name in entries, name
        want = "program_counter" if name.startswith(("chord_launches", "kernel_load")) \
            else "program_span"
        assert entries[name]["source"] == want, name
