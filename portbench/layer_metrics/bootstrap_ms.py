"""The op-level SDIRK2 bootstrap step of one call (CUDA events, split
pass), in ms; the variant names the mode it reads."""


def read(ctx, variant):
    return ctx["split"]["bootstrap_ms"] if variant == ctx["mode"] else None
