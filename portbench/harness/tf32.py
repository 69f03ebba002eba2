"""The control's precision: float32 with every matrix product taking TF32
operands, as the tensor cores read them with TF32 on (10 explicit mantissa
bits, rounded to nearest even; products summed in float32).

Setting torch.backends.cuda.matmul.allow_tf32 changes nothing in the
reference: its products are batches of 3x3 to 12x12 matrices, which cuBLAS
runs without tensor cores (the control then read bit for bit what plain
float32 reads). This mode rounds the operands of every matmul, bmm, mm and
einsum itself, so the control computes what TF32 products would give. The
products autograd takes in a backward pass keep float32 operands; the
rounding passes gradients straight through.
"""

import torch
from torch.overrides import TorchFunctionMode

_PRODUCTS = {torch.matmul, torch.bmm, torch.mm, torch.einsum, torch.Tensor.matmul,
             torch.Tensor.__matmul__, torch.Tensor.__rmatmul__, torch.Tensor.bmm,
             torch.Tensor.mm}


def to_tf32(x):
    """A float32 tensor rounded to TF32's 10-bit mantissa (nearest, ties to even)."""
    i = x.view(torch.int32)
    i = (i + 0x0FFF + ((i >> 13) & 1)) & ~0x1FFF
    return torch.where(torch.isfinite(x), i.view(torch.float32), x)


def _round(a):
    if torch.is_tensor(a) and a.dtype == torch.float32:
        # the rounded value, with the gradient passing straight through
        return a + (to_tf32(a) - a).detach() if a.requires_grad else to_tf32(a)
    if isinstance(a, (list, tuple)):
        return type(a)(_round(b) for b in a)
    return a


class Tf32Products(TorchFunctionMode):
    """Inside it, every float32 matrix product rounds its operands to TF32."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func in _PRODUCTS:
            args = _round(args)
        return func(*args, **(kwargs or {}))
