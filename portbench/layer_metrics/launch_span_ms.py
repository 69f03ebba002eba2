"""The chord kernel's launch in one inner step (chord_kernel.launch: the
output buffers and the kernel), the traced call's chord_kernel.launch spans
over its inner steps, device time, in ms; the variant names the mode it
reads. Read in the profiled call, it carries the profiler's host cost
(_call_spans): it may not decide a perf_opt."""

from portbench.layer_metrics import _call_spans


def read(ctx, variant):
    return _call_spans.per_inner_step_ms(ctx, variant, "chord_kernel.launch")
