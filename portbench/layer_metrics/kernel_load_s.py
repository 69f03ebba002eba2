"""Seconds the process spent loading kernel libraries (KernelBuild.load,
waits for nvcc included): the program's kernel_build.seconds counter after
the run, all of it in set-up."""


def read(ctx, variant):
    from redmax_tpu_torch import metrics
    counters = getattr(metrics, "counters", None)
    return None if counters is None else counters().get("kernel_build.seconds")
