"""Import hygiene, the frozen operation count, and the per-layer readers."""

import ast
import glob
import os

import pytest

from portbench.harness import flops, spec

BENCH = spec.BENCH
FORBIDDEN = ("jax", "jaxlib", "flax", "redmax_tpu")


def imports(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


FILES = sorted(glob.glob(os.path.join(BENCH, "**", "*.py"), recursive=True))


@pytest.mark.parametrize("path", FILES, ids=lambda p: os.path.relpath(p, BENCH))
def test_no_jax_import(path):
    for mod in imports(path):
        assert mod.split(".")[0] not in FORBIDDEN, f"{path} imports {mod}"


def test_reference_imports_nothing_of_the_port():
    ref = glob.glob(os.path.join(BENCH, "reference", "**", "*.py"), recursive=True)
    assert len(ref) >= 8
    for path in ref:
        for mod in imports(path):
            top = mod.split(".")[0]
            assert top in ("torch", "math", "dataclasses", "typing", "portbench"), (path, mod)
            assert not mod.startswith("portbench.") or mod.startswith("portbench.reference"), \
                (path, mod)


@pytest.mark.parametrize("cfg_name", ["chain12", "chain_ground12"])
def test_frozen_flops_equal_chip_smoke(cfg_name):
    import chip_smoke
    from portbench.harness import cell
    from portbench.harness.program import Program
    config = spec.load_json(os.path.join(BENCH, "configs", cfg_name + ".json"))
    prog = Program(config, "cpu")
    from redmax_tpu_torch import chord_kernel
    contacts, springs, cables = chord_kernel.closure_spec(prog.topo, prog.force_fns)
    want = chip_smoke.lane_flops(prog.topo, prog.cfg.fixed_iters, len(contacts), springs,
                                 cables, chip_smoke.mode_of(prog.cfg))
    assert cell.chord_flops_per_lane(config) == want
    assert want == {"chain12": 140977, "chain_ground12": 242497}[cfg_name]


def _ctx(mode):
    return {"mode": mode, "call_s": [1.0, 2.0, 3.0, 4.0], "B": 8192, "nr": 12,
            "split": {"bootstrap_ms": 50.0, "inner_ms": 98.0, "backward_ms": 400.0},
            "busy_s": 0.25, "window_s": 1.0, "trace_calls": 1, "inner_device_s": 0.049,
            "inner_steps": 49, "chord_flops_per_lane": 140977}


def test_readers():
    read = lambda name, mode: spec.reader(name)[0](_ctx(mode), spec.reader(name)[1])
    assert read("solve_ms.p90", "mpc") == pytest.approx(3700.0)
    assert read("solve_ms.p90", "rollout") is None
    assert read("backward_ms", "mpc") == 400.0 and read("backward_ms", "rollout") is None
    assert read("bootstrap_ms.mpc", "mpc") == 50.0 and read("bootstrap_ms.mpc", "rollout") is None
    assert read("inner_step_ms.rollout", "rollout") == pytest.approx(2.0)
    assert read("device_idle_pct.mpc", "mpc") == pytest.approx(100 * (1 - 0.25 / 2.5))
    bound = 49 * max(140977 * 8192 / 67e12, 4 * 8192 * (7 * 12 + 144) / 3.35e12)
    assert read("chord_roofline.mpc", "mpc") == pytest.approx(100 * bound / 0.049)
    ctx = {**_ctx("mpc"), "busy_s": 0.0, "inner_device_s": 0.0}
    assert spec.reader("device_idle_pct.mpc")[0](ctx, "mpc") is None
    assert spec.reader("chord_roofline.mpc")[0](ctx, "mpc") is None
