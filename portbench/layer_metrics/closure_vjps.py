"""Implicit solves of one MPC solve whose residual VJP ran through autograd
because of the scene's closures (a closure other than ground contact, which
the residual VJP kernel does not take): the root span's delta of the
adjoint.vjp.oplevel.closures counter while the traced call was open (49 in
an MPC solve of horizon 50 on a spring scene: every inner step; 0 once the
kernel takes the scene). A root whose deltas hold no
adjoint.vjp.oplevel.<reason> counter at all (a program that counts no
reasons: the SDIRK2 bootstrap's two solves move .bootstrap in every MPC
solve of one that does) gives None; the variant names the mode it reads."""

from portbench.layer_metrics import _call_spans

REASON = "adjoint.vjp.oplevel."


def read(ctx, variant):
    found = _call_spans.call(ctx, variant)
    if found is None or found[0].counts is None:
        return None
    counts = found[0].counts
    if not any(k.startswith(REASON) for k in counts):
        return None
    return counts.get(REASON + "closures", 0)
