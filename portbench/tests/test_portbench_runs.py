"""Whole runs on the CPU at a tiny size (the port's plain kernel route):
every cell agrees with the reference; the last line's schema; and with the
timed path broken underneath, `correct` comes out false for each fault a
cell can have."""

import json
import subprocess
import sys

import pytest
import torch

from portbench.harness import cell, spec
from portbench.tests import TINY
from redmax_tpu_torch import chord_kernel, integrators

CELLS = [w["name"] for w in spec.benchmark()["workloads"]]
SEED = 2**31 + 7


def tiny_run(name, seed=SEED):
    return cell.run(name, seed, 0.3, False, "cpu", overrides=TINY)


@pytest.mark.parametrize("name", CELLS)
def test_cell_agrees_with_reference(name):
    r = tiny_run(name)
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0


def test_last_line_schema():
    r = tiny_run(CELLS[0])
    assert list(r) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    names = {m["name"] for m in spec.cell(CELLS[0])[4]}
    assert set(r["metrics"]) == names
    for m in r["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(r["device"])
    assert all(set(c) == {"value", "limit"} for c in r["checks"].values())
    json.loads(json.dumps(r))


def _unchanged_step(monkeypatch):
    real = integrators.make_bdf2_step_batched

    def fake(*a, **k):
        step = real(*a, **k)
        step.inner = lambda params, s: s
        return step

    monkeypatch.setattr(integrators, "make_bdf2_step_batched", fake)


def _half_batch(monkeypatch):
    real = chord_kernel.chord_bdf2

    def fake(topo, cfg, params, x0, *rest, **k):
        h = x0.shape[0] // 2
        sub = lambda t: t[:h] if torch.is_tensor(t) and t.dim() >= 1 and t.shape[0] == x0.shape[0] else t
        p = {**params, "tau": sub(params["tau"])}
        x, hinv = real(topo, cfg, p, x0[:h], *(sub(t) for t in rest), **k)
        fill = lambda t: torch.cat([t, t.nanmean(0, keepdim=True).expand(x0.shape[0] - h, *t.shape[1:])])
        return fill(x), fill(hinv)

    monkeypatch.setattr(chord_kernel, "chord_bdf2", fake)


def _answer_altered(monkeypatch):
    real = chord_kernel.chord_bdf2

    def fake(*a, **k):
        x, hinv = real(*a, **k)
        return x * (1 + 1e-3), hinv

    monkeypatch.setattr(chord_kernel, "chord_bdf2", fake)


@pytest.mark.parametrize("fault", [_unchanged_step, _half_batch, _answer_altered],
                         ids=["state_unchanged", "half_batch", "answer_altered"])
@pytest.mark.parametrize("name", CELLS)
def test_fault_is_not_correct(name, fault, monkeypatch):
    fault(monkeypatch)
    r = tiny_run(name)
    assert not r["correct"], r["checks"]


def test_no_forbidden_module_in_a_run():
    """A CPU rehearsal of every mode in a fresh process loads no module whose
    top-level name is jax, jaxlib, flax or redmax_tpu."""
    code = ("import sys; sys.path.insert(0, '.'); from portbench.harness import cell, spec; "
            "from portbench.tests import TINY; "
            "[cell.run(w['name'], 3, 0.1, False, 'cpu', overrides=TINY) "
            "for w in spec.benchmark()['workloads']]; print(cell.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
