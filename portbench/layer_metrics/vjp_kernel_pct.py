"""Share of one MPC solve's implicit solves whose residual VJP ran on the
residual VJP kernel, in %: the root span's deltas of the
adjoint.vjp.kernel and adjoint.vjp.oplevel counters while the traced call
was open, kernel over kernel plus op-level (49 of 51 where every inner step
takes the kernel: the SDIRK2 bootstrap's two solves stay op-level). None
where the program counts neither (a program without those counters); the
variant names the mode it reads."""

from portbench.layer_metrics import _call_spans


def read(ctx, variant):
    found = _call_spans.call(ctx, variant)
    if found is None or found[0].counts is None:
        return None
    counts = found[0].counts
    kernel = counts.get("adjoint.vjp.kernel", 0)
    solves = kernel + counts.get("adjoint.vjp.oplevel", 0)
    return None if not solves else 100.0 * kernel / solves
