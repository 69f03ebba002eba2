"""The transposed solves of one MPC solve's backward (z = H^-T xbar at each
implicit solve), the summed adjoint.backsolve spans of the traced call,
device time, in ms. Read in the profiled call, it carries the profiler's
host cost (_call_spans): it may not decide a perf_opt."""

from portbench.layer_metrics import _call_spans


def read(ctx, variant):
    found = _call_spans.call(ctx, "mpc")
    return None if found is None else _call_spans.device_ms(found[1], "adjoint.backsolve")
