"""The op-level SDIRK2 bootstrap step of one call as the call runs it, the
integrators.bootstrap span of the traced call, device time, in ms; the
variant names the mode it reads. Read in the profiled call, it carries the
profiler's host cost (_call_spans): it may not decide a perf_opt."""

from portbench.layer_metrics import _call_spans


def read(ctx, variant):
    found = _call_spans.call(ctx, variant)
    return None if found is None else _call_spans.device_ms(found[1], "integrators.bootstrap")
