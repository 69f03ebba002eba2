"""The chord solves' share of their roofline: the least time of the split
pass's inner chord solves (the frozen operation count x B against the
card's published peaks, harness/flops.py) over the device time of every
operation the inner steps ran (profiler), in %. It never matches a kernel by
name, so it reads the same work where a later change fuses or renames the
kernel; the wrapper's copies count in the time."""

from portbench.harness import flops


def read(ctx, variant):
    if variant != ctx["mode"] or not ctx["inner_device_s"]:
        return None
    bound = ctx["inner_steps"] * flops.chord_bound_s(ctx["chord_flops_per_lane"], ctx["nr"],
                                                     ctx["B"])
    return 100.0 * bound / ctx["inner_device_s"]
