"""The reader of vjp_kernel_pct (the share of an MPC solve's implicit solves
whose residual VJP ran on the residual VJP kernel) on synthetic recorded
span trees, as test_portbench_span_readers.py holds the chord_launches
reader: what it reads from the mode's first root's counter deltas, and None
where the root is absent, the program counts neither counter, or records no
spans or counters."""

import pytest

from portbench.harness import spec
from portbench.tests.test_portbench_span_readers import (Tree, mpc_call, read, rollout_call,
                                                         split_pass)
from redmax_tpu_torch import metrics

NAME = "vjp_kernel_pct.mpc"


@pytest.fixture
def recorded(monkeypatch):
    def use(tree, counters=None):
        monkeypatch.setattr(metrics, "spans", lambda: list(tree.spans))
        monkeypatch.setattr(metrics, "counters", lambda: dict(counters or {}))
    return use


def with_counts(tree, root, **counts):
    """The tree's span `root` with these counter deltas added to its own."""
    s = tree.spans[root]
    tree.spans[root] = s._replace(counts={**s.counts, **{k.replace("_", "."): v
                                                          for k, v in counts.items()}})


@pytest.mark.parametrize("kernel,oplevel,want", [(49, 2, 100 * 49 / 51), (0, 51, 0.0),
                                                 (3, 0, 100.0)])
def test_the_share_of_the_first_mpc_root(recorded, kernel, oplevel, want):
    t = Tree()
    mpc_call(t)
    with_counts(t, 0, adjoint_vjp_kernel=kernel, adjoint_vjp_oplevel=oplevel)
    later = len(t.spans)
    mpc_call(t, scale=2.0)                          # a later call: not read
    with_counts(t, later, adjoint_vjp_kernel=1, adjoint_vjp_oplevel=50)
    split_pass(t)
    recorded(t)
    assert read(NAME, "mpc") == pytest.approx(want)


def test_a_counter_missing_from_the_deltas_reads_as_zero(recorded):
    """A root's deltas hold only the counters that moved."""
    t = Tree()
    mpc_call(t)
    with_counts(t, 0, adjoint_vjp_oplevel=11)
    recorded(t)
    assert read(NAME, "mpc") == 0.0


def test_none_where_neither_counter_moved(recorded):
    """The commit before the kernel counts neither: its solves read None,
    not 0%."""
    t = Tree()
    mpc_call(t)
    recorded(t)
    assert read(NAME, "mpc") is None


def test_none_in_a_rollout_and_without_the_modes_root(recorded):
    t = Tree()
    rollout_call(t)
    split_pass(t)
    recorded(t)
    assert read(NAME, "mpc") is None
    assert spec.reader(NAME)[0]({"mode": "rollout"}, "mpc") is None


def test_none_on_a_program_without_spans(monkeypatch):
    monkeypatch.delattr(metrics, "spans")
    monkeypatch.delattr(metrics, "counters")
    assert read(NAME, "mpc") is None


def test_its_entry():
    (entry,) = [m for m in spec.benchmark()["per_layer"] if m["name"] == NAME]
    assert entry == {"name": NAME, "unit": "%", "better": "higher", "source": "program_counter",
                     "layer": "adjoint", "moves": "solves_per_s",
                     "workloads": ["chain12.mpc", "chain_ground12.mpc"]}
