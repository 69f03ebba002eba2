"""One BDF2 step on the chord kernel route (chord_kernel.chord_bdf2: pack,
buffers, launch): CUDA events around the split pass's inner steps over
their number, in ms; the variant names the mode it reads."""


def read(ctx, variant):
    if variant != ctx["mode"]:
        return None
    return ctx["split"]["inner_ms"] / ctx["inner_steps"]
