"""The spans of one traced call, as redmax_tpu_torch.metrics records them
inside the program: the first recorded root of a mode (mpc.solve for MPC,
integrators.simulate for a rollout; harness/cell.py's profiled call, under
which spans record) and the spans of its call. Every span reader goes
through here, and gets None where the program records no spans or the run
holds no root of the mode.

That call runs under torch.profiler, whose host cost slows the host's
launches until the card idles inside host-heavy spans, and by how much
varies with the host: the mpc.gradient span of a chain_ground12.mpc call
read 3.9% over the split pass's backward_ms on one H100 host and 33% on
another (PERF.md section 6). So a *_span_ms metric splits a traced call
but may not decide a perf_opt; the split pass's metrics, or spans read from
a window call inside metrics.tracing() alone, do that."""

ROOTS = {"mpc": "mpc.solve", "rollout": "integrators.simulate"}


def call(ctx, mode):
    """(root, spans of its call) of the mode's first root in this run, or
    None (another mode's cell, a program without spans, no such root)."""
    if ctx["mode"] != mode:
        return None
    from redmax_tpu_torch import metrics
    spans = getattr(metrics, "spans", None)
    if spans is None:
        return None
    recorded = spans()
    root = next((s for s in recorded if s.parent is None and s.name == ROOTS[mode]), None)
    if root is None:
        return None
    return root, [s for s in recorded if s.call == root.id]


def device_ms(spans, name):
    """The summed device time of the call's spans of one name, in ms; None
    where there is none or one lacks a device time."""
    ms = [s.device_ms for s in spans if s.name == name]
    return None if not ms or None in ms else sum(ms)


def per_inner_step_ms(ctx, mode, name):
    """The call's device time in spans of one name over its inner steps."""
    found = call(ctx, mode)
    if found is None:
        return None
    total = device_ms(found[1], name)
    steps = sum(s.name == "integrators.inner" for s in found[1])
    return None if total is None or not steps else total / steps
