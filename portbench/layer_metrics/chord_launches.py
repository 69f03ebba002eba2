"""Chord kernel launches in one call, either design: how far the
chord_kernel.launch.* counters moved while the traced call's root span was
open; the variant names the mode it reads."""

from portbench.layer_metrics import _call_spans


def read(ctx, variant):
    found = _call_spans.call(ctx, variant)
    if found is None or found[0].counts is None:
        return None
    return sum(v for k, v in found[0].counts.items() if k.startswith("chord_kernel.launch."))
