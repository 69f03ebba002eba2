"""One reader a per-layer metric: read(ctx, variant) -> a number, or None
where the run has nothing for it to read (the harness then leaves the metric
out of the line). A file <base>.py serves every <base>.<variant> name; ctx
is harness/cell.py's dict of the traced run's readings, with the mode's
runner under "runner" for a reader that needs more of the program (its
counters)."""
