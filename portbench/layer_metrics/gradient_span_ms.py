"""The adjoint backward of one MPC solve as the call runs it
(torch.autograd.grad of the objective), the mpc.gradient span of the traced
call, device time by its CUDA events, in ms. Read in the profiled call, it
carries the profiler's host cost (_call_spans): it may not decide a
perf_opt."""

from portbench.layer_metrics import _call_spans


def read(ctx, variant):
    found = _call_spans.call(ctx, "mpc")
    return None if found is None else _call_spans.device_ms(found[1], "mpc.gradient")
