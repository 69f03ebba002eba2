"""Find every piece of a cell by name: the cell and metrics in
BENCHMARK.json, its configuration and traffic files, the program's mode
runner, the reference's scene function and mode, the per-layer readers and
the cell's limits. Adding a configuration, a mix, a mode or a metric adds
files here and entries in BENCHMARK.json; no file that is there changes."""

import importlib
import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)                 # portbench/
ROOT = os.path.dirname(BENCH)                 # the checkout's root


def load_json(path):
    with open(path) as f:
        return json.load(f)


def benchmark(path=None):
    return load_json(path or os.path.join(ROOT, "BENCHMARK.json"))


def _named(entries, name, what):
    found = [e for e in entries if e["name"] == name]
    if len(found) != 1:
        raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")
    return found[0]


def cell(name, bench=None):
    """(cell, config entry, config file, traffic file, e2e metrics, per-layer
    metrics) of a workload; a metric belongs to the cell when its
    `workloads` names it or it has none."""
    bench = bench or benchmark()
    wl = _named(bench["workloads"], name, "workload")
    cfg_entry = _named(bench["configs"], wl["config"], "config")
    config = load_json(os.path.join(ROOT, cfg_entry["file"]))
    traffic = load_json(os.path.join(BENCH, "traffic", wl["traffic"] + ".json"))
    mine = lambda ms: [m for m in ms if name in m.get("workloads", [name])]
    return wl, cfg_entry, config, traffic, mine(bench["end_to_end"]), mine(bench["per_layer"])


def _module(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def mode_runner(mode):
    """The program's runner of a traffic mode: portbench/modes/<mode>.py."""
    return importlib.import_module(f"portbench.modes.{mode}")


def reference_mode(mode):
    return importlib.import_module(f"portbench.reference.modes.{mode}")


def reference_scene(name):
    return importlib.import_module(f"portbench.reference.scenes.{name}")


def reader(metric):
    """(read, variant) of a per-layer metric: layer_metrics/<name>.py, else
    layer_metrics/<base>.py for a name <base>.<variant>, whose read(ctx,
    variant) serves every variant."""
    base, _, variant = metric.partition(".")
    for fname, var in ((metric, None), (base, variant or None)):
        path = os.path.join(BENCH, "layer_metrics", fname + ".py")
        if os.path.exists(path):
            return _module(path, "portbench_metric_" + fname.replace(".", "_")).read, var
    raise KeyError(f"no reader for the per-layer metric {metric!r} in portbench/layer_metrics")


def limits(cell_name):
    """The cell's comparison limits: portbench/limits/<cell>.json."""
    return load_json(os.path.join(BENCH, "limits", cell_name + ".json"))
