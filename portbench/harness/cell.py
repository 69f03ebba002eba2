"""One run of one cell: set-up, the closed-loop window, with --trace 1 the
traced readings, then the check against the reference and the result line.

A window is a closed loop of back-to-back batched calls that cycle through
the traffic's input sets; every call started in the window is finished and
counted. The end-to-end rate is units_per_call x calls completed over the
seconds from the window's start to the end of its last call. A call
`failed` when it raised or its finite share of lanes fell under the mix's
finite_floor.
"""

import gc
import statistics
import sys
import time
import traceback

import torch

from portbench.harness import compare, flops, spec, trace
from portbench.harness.traffic import make_inputs
from portbench.reference.bdf2 import Solver

FORBIDDEN = ("jax", "jaxlib", "flax", "redmax_tpu")
SPLIT_PASSES = 5     # a traced run's split metrics are the medians of these passes


def forbidden_modules():
    """Modules loaded in this process whose top-level name is forbidden."""
    return sorted({m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def reference_outputs(config, traffic, inputs, device, dtype=torch.float64):
    """The reference's outputs on inputs {name: [lanes, ...]}, in dtype (float64;
    a lower precision only for the control), in blocks of traffic["ref_lanes"]
    lanes."""
    sc = spec.reference_scene(config["scene"]).build(config["args"], dtype, device)
    solver = Solver(sc, config["newton"])
    run = spec.reference_mode(traffic["mode"]).run
    B = next(iter(inputs.values())).shape[0]
    step = int(traffic.get("ref_lanes", B))
    parts = []
    for i in range(0, B, step):
        parts.append(run(solver, config, traffic,
                         {k: v[i:i + step].to(dtype) for k, v in inputs.items()}))
    return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}


def joined(sets, kept, lanes=None, seed=0):
    """The inputs and the program's outputs of the kept sets, lanes joined:
    all of them, or `lanes` of each set drawn from the seed."""
    ks = sorted(kept)
    if lanes is not None:
        B = next(iter(sets[0].values())).shape[0]
        gen = torch.Generator().manual_seed(int(seed) % (1 << 63))
        pick = [torch.randperm(B, generator=gen)[:int(lanes)].sort().values for _ in ks]
    else:
        pick = [slice(None)] * len(ks)
    cat = lambda ds: {n: torch.cat([d[n][i] for d, i in zip(ds, pick)]) for n in ds[0]}
    return cat([sets[k] for k in ks]), cat([kept[k] for k in ks])


def errors_of(outputs, ref):
    return {name: compare.lane_errors(x, ref[name]) for name, x in outputs.items()}


def check(config, traffic, limits, sets, kept, device, seed):
    """(correct, checks): the kept window outputs of each input set (or
    traffic["check_lanes"] lanes of each, drawn from the seed) against the
    reference's, all sets in one pass."""
    if not kept:
        return compare.judge({n: float("inf") for n in limits["numbers"]}, limits["numbers"])
    inputs, outputs = joined(sets, kept, traffic.get("check_lanes"), seed)
    errors = errors_of(outputs, reference_outputs(config, traffic, inputs, device))
    values = compare.numbers(errors, limits["numbers"])
    return compare.judge(values, limits["numbers"])


def quartiles(values):
    return [round(v, 4) for v in statistics.quantiles(values, n=4)] if len(values) > 1 else []


def chord_flops_per_lane(config):
    """The frozen operation count of one lane's chord solve at this cell's
    topology, contacts and Newton mode (from the reference's scene)."""
    sc = spec.reference_scene(config["scene"]).build(config["args"], torch.float64, "cpu")
    w = sc.chord_work()
    return flops.lane_flops(flops.Topo(w["parent"], w["jtype"], w["ndof"]),
                            config["newton"]["fixed_iters"], w["contacts"], w["springs"],
                            w["cables"], flops.mode_of(config["newton"]))


def run(cell_name, seed, seconds, trace_on, device="cuda", t0=None, overrides=None,
        bench=None):
    """One run; returns the result dict (the last line's object)."""
    t0 = time.perf_counter() if t0 is None else t0
    _, _, config, traffic, e2e, per_layer = spec.cell(cell_name, bench)
    traffic = {**traffic, **(overrides or {})}
    limits = spec.limits(cell_name)
    allow = bool(config.get("tf32", False))
    torch.backends.cuda.matmul.allow_tf32 = allow
    torch.backends.cudnn.allow_tf32 = allow
    dtype = getattr(torch, config["dtype"])

    runner = spec.mode_runner(traffic["mode"]).Runner(config, traffic, device)
    sets = make_inputs(traffic, {"B": traffic["B"], "nr": runner.nr}, seed, device, dtype)
    for inputs in sets:                      # warm every shape the window uses
        runner.finite(runner.call(inputs))
    _sync(device)
    setup_s = time.perf_counter() - t0

    attempted = failed = 0
    call_s, kept = [], {}
    start = end = time.perf_counter()
    while end - start < seconds:
        k = attempted % len(sets)
        attempted += 1
        c0 = time.perf_counter()
        try:
            out = runner.call(sets[k])
            share = runner.finite(out)
        except Exception:
            failed += 1
            log(traceback.format_exc())
            end = time.perf_counter()
            continue
        end = time.perf_counter()
        call_s.append(end - c0)
        kept[k] = out
        if share < float(traffic["finite_floor"]):
            failed += 1
            log(f"call {attempted}: finite share {share:.4f} under {traffic['finite_floor']}")
    span = end - start
    cuda = torch.device(device).type == "cuda"
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    log(f"window: {len(call_s)} calls of {attempted} completed in {span:.3f} s "
        f"(set-up {setup_s:.3f} s); call s min {min(call_s, default=0):.4f} "
        f"quartiles {quartiles(call_s)} max {max(call_s, default=0):.4f}")
    log("call s: " + " ".join(f"{c:.4f}" for c in call_s))

    metrics, dev_extra, breakdown = {}, {}, None
    if not trace_on:
        values = {"setup_s": setup_s, traffic["rate_metric"]:
                  runner.units_per_call * len(call_s) / span if call_s else 0.0}
        for m in e2e:
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    else:
        if not cuda:
            raise RuntimeError("a traced run reads the card's trace: it needs CUDA")
        with trace.Profile() as prof:       # a sub-window of the window's own calls
            for i in range(int(traffic["trace_calls"])):
                runner.finite(runner.call(sets[(attempted + i) % len(sets)]))
        ops = trace.device_ops(prof.events)
        busy = trace.busy_s(ops)
        dev_extra = {"busy_s": busy, "window_s": prof.window_s}
        if busy > 0:
            breakdown = {"device_ops": trace.top_ops(ops),
                         "idle_gaps": trace.idle_gaps(prof.events, ops)}
        del prof, ops
        runner.split(sets[0])                # warm the split pass
        passes = [runner.split(sets[0]) for _ in range(SPLIT_PASSES)]
        split = {k: statistics.median(p[k] for p in passes) for k in passes[0]}
        inner = trace.Profile()
        runner.split(sets[0], around_inner=lambda: inner)
        inner_busy = trace.busy_s(trace.device_ops(inner.events))
        del inner
        ctx = {"mode": traffic["mode"], "runner": runner, "call_s": call_s, "split": split,
               "busy_s": busy, "window_s": dev_extra["window_s"],
               "trace_calls": int(traffic["trace_calls"]),
               "inner_device_s": inner_busy, "B": traffic["B"], "nr": runner.nr,
               "inner_steps": runner.inner_steps,
               "chord_flops_per_lane": chord_flops_per_lane(config)}
        log(f"split passes {passes}; traced call: device busy {busy:.6f} s of "
            f"{dev_extra['window_s']:.6f} s; inner steps' device time {inner_busy:.6f} s")
        for m in per_layer:
            read, variant = spec.reader(m["name"])
            v = read(ctx, variant)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    del runner
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    correct, checks = check(config, traffic, limits, sets, kept, device, seed)
    for name, c in checks.items():
        log(f"check {name}: {c['value']!r} (limit {c['limit']!r})")
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                   "count": 1 if cuda else 0, "memory_peak_bytes": peak, **dev_extra}
    result = {"correct": bool(correct), "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    found = forbidden_modules()
    if found:
        raise SystemExit(f"forbidden modules loaded: {', '.join(found)}")
    return result

