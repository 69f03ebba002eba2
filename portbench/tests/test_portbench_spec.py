"""BENCHMARK.json against the contract's shape, and every piece of every cell
found by name."""

import json
import os
import re

import pytest

from portbench.harness import spec

B = spec.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in B["workloads"]]


def test_keys_and_sizes():
    assert set(B) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert 1 <= len(B["paths"]) <= 16 and 1 <= len(B["command"]) <= 32
    assert 1 <= B["run_seconds"] <= 51 and isinstance(B["run_seconds"], int)
    assert 1 <= len(B["configs"]) <= 24 and 1 <= len(B["workloads"]) <= 24
    assert 1 <= len(B["end_to_end"]) <= 16 and 1 <= len(B["per_layer"]) <= 128
    assert os.path.getsize(os.path.join(spec.ROOT, "BENCHMARK.json")) <= 64 * 1024
    for e in B["configs"]:
        assert set(e) == {"name", "source", "file", "reduced", "why"}
    for e in B["workloads"]:
        assert set(e) == {"name", "config", "traffic", "chips", "why"} and e["chips"] in (1, 4)
    for m in B["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in B["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


def test_names_and_units():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in B[group]:
            assert NAME.match(e["name"]), e["name"]
            names.append((group in ("end_to_end", "per_layer"), e["name"]))
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
    for e in B["workloads"]:
        assert NAME.match(e["config"]) and NAME.match(e["traffic"])
    for e in B["configs"]:
        assert all(NAME.match(k) for k in e["reduced"]) and len(e["reduced"]) <= 16
    assert len(names) == len(set(names))
    for text in [e["why"] for g in ("configs", "workloads") for e in B[g]] + \
            [e["source"] for e in B["configs"]] + [m["layer"] for m in B["per_layer"]] + B["command"]:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text
    assert all(re.match(r"^[A-Za-z0-9_./-]{1,200}$", p) and not p.startswith("/") and ".." not in p
               for p in B["paths"])


def test_pairs_and_metrics_per_cell():
    pairs = [(w["config"], w["traffic"]) for w in B["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert {c["name"] for c in B["configs"]} == {w["config"] for w in B["workloads"]}
    e2e_names = {m["name"] for m in B["end_to_end"]}
    assert "setup_s" in e2e_names
    for c in CELLS:
        e2e = [m["name"] for m in spec.cell(c)[4]]
        assert "setup_s" in e2e and len(e2e) >= 2
        layer = spec.cell(c)[5]
        assert layer
        for m in layer:
            assert m["moves"] in e2e, (c, m["name"])


def test_files_under_paths():
    for e in B["configs"]:
        assert e["file"].startswith("portbench/configs/")
        cfg = spec.load_json(os.path.join(spec.ROOT, e["file"]))
        assert cfg["name"] == e["name"] and cfg["reduced"] == e["reduced"]
    files = [e["file"] for e in B["configs"]]
    assert len(files) == len(set(files))


@pytest.mark.parametrize("name", CELLS)
def test_every_piece_found_by_name(name):
    wl, entry, config, traffic, e2e, layer = spec.cell(name)
    assert hasattr(spec.mode_runner(traffic["mode"]), "Runner")
    assert callable(spec.reference_mode(traffic["mode"]).run)
    assert callable(spec.reference_scene(config["scene"]).build)
    lim = spec.limits(name)["numbers"]
    assert lim and all(n["limit"] > 0 for n in lim.values())
    assert traffic["rate_metric"] in [m["name"] for m in e2e]
    for m in layer:
        read, _ = spec.reader(m["name"])
        assert callable(read)
