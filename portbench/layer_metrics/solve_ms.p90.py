"""The 90th percentile of the window's MPC calls (host clock around each
call, which ends in the read of its finite share), in ms."""

import statistics


def read(ctx, variant):
    s = ctx["call_s"]
    if ctx["mode"] != "mpc" or len(s) < 2:
        return None
    return 1e3 * statistics.quantiles(s, n=10, method="inclusive")[-1]
