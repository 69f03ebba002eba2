"""The device's idle share of a call: 1 - (device busy time of one call, the
union of its operations' intervals in the profiler's trace) / (the median
window call, host clock), in %. The busy time repeats from call to call;
the window's own calls run without the profiler, whose host cost would
lengthen a traced call. The variant names the mode it reads."""

import statistics


def read(ctx, variant):
    if variant != ctx["mode"] or not ctx["busy_s"] or not ctx["call_s"]:
        return None
    busy = ctx["busy_s"] / ctx["trace_calls"]
    return 100.0 * (1.0 - busy / statistics.median(ctx["call_s"]))
