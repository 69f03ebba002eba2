"""Readings that a cell's comparison limits are set from, on the card at the
cell's own size:

    python3 portbench/calibrate.py --workload <name> --seeds 1,2,... \
        [--control-seeds 1,2,3] [--out FILE]

For each seed: the traffic's input sets, one call of the program on each,
the float64 reference on all of them, and every candidate number (lane
error quantiles of every output) of the program against it; on the control
seeds also the control, the reference itself in float32 with TF32 matrix
products (harness/tf32.py; the next precision below the configuration's
float32 with TF32 off), and the reference in plain float32 beside it. One JSON line a
seed on standard output (and appended to FILE).
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from portbench.harness.tf32 import Tf32Products  # noqa: E402

QUANTILES = {"p50": 0.5, "p90": 0.9, "p99": 0.99, "max": 1.0}


def candidates(outputs):
    out = {f"{o}_rel_{q}": {"output": o, "q": v} for o in outputs for q, v in QUANTILES.items()}
    out.update({f"{o}_finite_mismatch": {"output": o, "stat": "finite_mismatch"} for o in outputs})
    return out


def readings(cell_name, seed, control, device="cuda", runner=None, overrides=None):
    """{"program": numbers, "control": numbers, "ref32": numbers, ...} of one seed."""
    from portbench.harness import cell, compare, spec
    from portbench.harness.traffic import make_inputs
    _, _, config, traffic, _, _ = spec.cell(cell_name)
    traffic = {**traffic, **(overrides or {})}
    dtype = getattr(torch, config["dtype"])
    if runner is None:
        runner = spec.mode_runner(traffic["mode"]).Runner(config, traffic, device)
    sets = make_inputs(traffic, {"B": traffic["B"], "nr": runner.nr}, seed, device, dtype)
    out = {"cell": cell_name, "seed": seed}
    t = time.perf_counter()
    kept = {}
    for k, inputs in enumerate(sets):
        kept[k] = runner.call(inputs)
        out.setdefault("finite", []).append(runner.finite(kept[k]))
    out["program_s"] = time.perf_counter() - t
    inputs, outputs = cell.joined(sets, kept, traffic.get("check_lanes"), seed)
    t = time.perf_counter()
    ref = cell.reference_outputs(config, traffic, inputs, device)
    out["reference_s"] = time.perf_counter() - t
    spec_n = candidates(outputs)
    out["program"] = compare.numbers(cell.errors_of(outputs, ref), spec_n)
    if control:
        for name, mode in (("ref32", contextlib.nullcontext), ("control", Tf32Products)):
            t = time.perf_counter()
            with mode():
                low = cell.reference_outputs(config, traffic, inputs, device, torch.float32)
            out[name + "_s"] = time.perf_counter() - t
            out[name] = compare.numbers(cell.errors_of(low, ref), spec_n)
    return out, runner


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("calibrate: needs a CUDA device")
    torch.set_num_threads(1)
    seeds = [int(s) for s in args.seeds.split(",")]
    ctl = {int(s) for s in args.control_seeds.split(",") if s}
    runner = None
    for seed in seeds + sorted(ctl - set(seeds)):
        rec, runner = readings(args.workload, seed, seed in ctl, runner=runner)
        rec["card"] = torch.cuda.get_device_name(0)
        line = json.dumps(rec)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")


if __name__ == "__main__":
    main()
