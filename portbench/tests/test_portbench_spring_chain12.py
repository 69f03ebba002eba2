"""The spring_chain12.mpc cell's own pieces: its two readers
(layer_metrics/closure_vjps.py, pair_closure_span_ms.py) on synthetic
recorded span trees, as test_portbench_span_readers.py holds the others
(the value, and None without the mode's root, the span or the counter, or on
a program without spans); every piece of the cell found by name; its
metrics' entries; and its limits file's schema, each limit between its two
readings. The tiny CPU run against the reference and the card's control
test pick the cell up from BENCHMARK.json (test_portbench_runs.py,
test_portbench_control.py)."""

import pytest

from portbench.harness import spec
from portbench.tests.test_portbench_span_readers import Tree, mpc_call, read, rollout_call
from redmax_tpu_torch import metrics

CELL = "spring_chain12.mpc"
NEW = ("closure_vjps.mpc", "pair_closure_span_ms")


@pytest.fixture
def recorded(monkeypatch):
    def use(tree, counters=None):
        monkeypatch.setattr(metrics, "spans", lambda: list(tree.spans))
        monkeypatch.setattr(metrics, "counters", lambda: dict(counters or {}))
    return use


def with_counts(tree, root, counts):
    s = tree.spans[root]
    tree.spans[root] = s._replace(counts={**s.counts, **counts})


def spring_call(t, inner=3, scale=1.0, span_ms=0.5):
    """mpc_call with the spring closures' spans: 2 in the bootstrap's
    forward, one in each implicit solve's backward; the root's deltas count
    the solves by reason."""
    root = len(t.spans)
    mpc_call(t, inner, scale)
    with_counts(t, root, {"adjoint.vjp.oplevel": inner + 2,
                          "adjoint.vjp.oplevel.closures": inner,
                          "adjoint.vjp.oplevel.bootstrap": 2})
    ms = None if span_ms is None else span_ms * scale
    boot = next(i for i in range(root, len(t.spans)) if t.spans[i].name == "integrators.bootstrap")
    for _ in range(2):
        t.add("forces.pair_closures", boot, ms=ms)
    for i in [i for i in range(root, len(t.spans)) if t.spans[i].name == "adjoint.backward"]:
        t.add("forces.pair_closures", i, ms=ms)
    return root


def test_the_spring_readers(recorded):
    t = Tree()
    spring_call(t)
    spring_call(t, inner=5, scale=2.0)          # a later call: not read
    recorded(t)
    assert read("closure_vjps.mpc", "mpc") == 3
    assert read("pair_closure_span_ms", "mpc") == pytest.approx((2 + 5) * 0.5)


def test_zero_closure_vjps_where_the_program_counts_reasons(recorded):
    """A program that counts reasons but ran no closure VJP (every inner step
    on the kernel) reads 0, not None."""
    t = Tree()
    root = len(t.spans)
    mpc_call(t)
    with_counts(t, root, {"adjoint.vjp.kernel": 3, "adjoint.vjp.oplevel": 2,
                          "adjoint.vjp.oplevel.bootstrap": 2})
    recorded(t)
    assert read("closure_vjps.mpc", "mpc") == 0


def test_none_without_the_counter_or_the_span(recorded):
    """The parent commit counts no reasons and opens no forces.pair_closures
    span: both readers give None, as on a scene without springs."""
    t = Tree()
    root = len(t.spans)
    mpc_call(t)
    with_counts(t, root, {"adjoint.vjp.kernel": 3, "adjoint.vjp.oplevel": 2})
    recorded(t)
    for name in NEW:
        assert read(name, "mpc") is None, name


@pytest.mark.parametrize("name", NEW)
def test_none_without_the_modes_root(recorded, name):
    t = Tree()
    rollout_call(t)
    recorded(t)
    assert read(name, "mpc") is None
    assert spec.reader(name)[0]({"mode": "rollout"}, spec.reader(name)[1]) is None


@pytest.mark.parametrize("name", NEW)
def test_none_on_a_program_without_spans(monkeypatch, name):
    monkeypatch.delattr(metrics, "spans")
    monkeypatch.delattr(metrics, "counters")
    assert read(name, "mpc") is None


def test_none_without_device_times(recorded):
    t = Tree()
    spring_call(t, span_ms=None)
    recorded(t)
    assert read("pair_closure_span_ms", "mpc") is None


def test_every_piece_of_the_cell_is_found():
    wl, entry, config, traffic, e2e, layer = spec.cell(CELL)
    assert (wl["config"], wl["traffic"], wl["chips"]) == ("spring_chain12", "mpc_b32768_h50", 1)
    assert entry["file"] == "portbench/configs/spring_chain12.json" and entry["reduced"] == []
    assert config["scene"] == "scene_spring_chain" and config["args"] == {"nlinks": 12, "h": 0.01}
    assert config["dtype"] == "float32" and config["tf32"] is False
    chain12 = spec.cell("chain12.mpc")[2]
    assert config["newton"] == chain12["newton"] and config["task"] == chain12["task"]
    assert [m["name"] for m in e2e] == ["solves_per_s", "setup_s"]
    names = {m["name"] for m in layer}
    assert set(NEW) <= names
    assert {m["name"] for m in spec.cell("chain12.mpc")[5]} | set(NEW) == names
    assert callable(spec.reference_scene(config["scene"]).build)
    for m in layer:
        assert callable(spec.reader(m["name"])[0])


def test_the_new_metrics_entries():
    entries = {m["name"]: m for m in spec.benchmark()["per_layer"]}
    want = {"closure_vjps.mpc": ("VJPs", "program_counter", "adjoint"),
            "pair_closure_span_ms": ("ms", "program_span", "forces")}
    for name, (unit, source, layer) in want.items():
        m = entries[name]
        assert (m["unit"], m["source"], m["layer"]) == (unit, source, layer)
        assert m["better"] == "lower" and m["moves"] == "solves_per_s"
        assert CELL in m["workloads"]


def test_the_limits_file():
    lim = spec.limits(CELL)
    assert set(lim) == {"numbers", "readings"}
    outputs = {"objective", "grad_norm", "p"}
    for name, n in lim["numbers"].items():
        assert n["output"] in outputs and n["limit"] > 0
        assert set(n) == {"output", "q", "limit"} and 0 < n["q"] <= 1 \
            or set(n) == {"output", "stat", "limit"} and n["stat"] == "finite_mismatch"
        r = lim["readings"][name]
        assert r["lower"] < n["limit"] < r["upper"], name
        want = min(r["lower"] ** 0.4 * r["upper"] ** 0.6, 30 * r["lower"])
        assert n["limit"] == float(f"{want:.1e}"), name
    assert {"lower", "upper", "limit"} <= set(lim["readings"])
    assert {"objective_rel_p50", "grad_norm_rel_p50", "objective_finite_mismatch"} <= \
        set(lim["numbers"])
