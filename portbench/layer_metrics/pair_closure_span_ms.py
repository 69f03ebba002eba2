"""The op-level evaluations of springs and cables in one MPC solve (their
wrenches in each residual, their K/D blocks in each Newton matrix: the
SDIRK2 bootstrap's, and the residual that each op-level VJP evaluates
again in the backward), the summed forces.pair_closures spans of the
traced call, device time, in ms. Read in the profiled call, it carries the
profiler's host cost (_call_spans): it may not decide a perf_opt."""

from portbench.layer_metrics import _call_spans


def read(ctx, variant):
    found = _call_spans.call(ctx, "mpc")
    return None if found is None else _call_spans.device_ms(found[1], "forces.pair_closures")
