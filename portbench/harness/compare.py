"""The comparison that decides `correct`.

Every lane checked of every output is judged against the reference: a
lane's error is |x - r| / |r| (a vector output: the norms), and infinite
where exactly one side is finite; lanes that both sides set to NaN (rejected
by the solver on both) agree and are left out. The lanes checked are the
last call the window completed on each input set, or a sample of them drawn
from the seed. Each number compared is a quantile of the errors of the lanes
finite on both sides, or the share of lanes finite on one side only, with its
limit from the cell's limits file; the run is correct when every number is
at or under its limit (a window that completed no call reads infinite).
"""

import torch


def lane_errors(x, ref):
    """Per-lane relative errors [lanes] of an output against the reference's."""
    x, ref = x.double(), ref.double().to(x.device)
    fx = torch.isfinite(x.reshape(x.shape[0], -1)).all(-1)
    fr = torch.isfinite(ref.reshape(ref.shape[0], -1)).all(-1)
    if x.dim() == 1:
        err = (x - ref).abs() / ref.abs().clamp(min=1e-300)
    else:
        err = torch.linalg.vector_norm(x - ref, dim=-1) / torch.linalg.vector_norm(
            ref, dim=-1).clamp(min=1e-300)
    err = torch.where(fx == fr, err, torch.full_like(err, float("inf")))
    return err[fx | fr]


def numbers(errors, spec):
    """{name: value} of the limits file's numbers over errors {output: [lanes]}:
    with "q", the q-quantile of the errors of the lanes finite on both sides,
    taken as the next error at or above it (no interpolation; none finite:
    infinite); with "finite_mismatch", the share of lanes finite on one
    side only."""
    out = {}
    for name, n in spec.items():
        e = errors[n["output"]]
        if n.get("stat") == "finite_mismatch":
            out[name] = float(torch.isinf(e).double().mean()) if e.numel() else 1.0
            continue
        e = e[torch.isfinite(e)]
        out[name] = float(torch.quantile(e, float(n["q"]), interpolation="higher")) \
            if e.numel() else float("inf")
    return out


def judge(values, spec):
    """(correct, {name: {"value", "limit"}}): every number at or under its limit."""
    checks = {name: {"value": values[name], "limit": spec[name]["limit"]} for name in spec}
    ok = all(c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
