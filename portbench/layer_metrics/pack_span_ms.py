"""The chord wrapper's packing of one inner step (chord_kernel.pack: the [nr,
B] copies and the topology and parameter buffers), the traced call's
chord_kernel.pack spans over its inner steps, device time, in ms; the
variant names the mode it reads. Read in the profiled call, it carries the
profiler's host cost (_call_spans): it may not decide a perf_opt."""

from portbench.layer_metrics import _call_spans


def read(ctx, variant):
    return _call_spans.per_inner_step_ms(ctx, variant, "chord_kernel.pack")
