"""The adjoint backward of one MPC solve (torch.autograd.grad through the
implicit-function VJPs of every step), CUDA events, in the split pass."""


def read(ctx, variant):
    return ctx["split"].get("backward_ms") if ctx["mode"] == "mpc" else None
