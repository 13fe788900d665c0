"""The precision the reference computes in.

The reference is plain float32 with TF32 off (`F32`). The control of the
output check is the same reference computed in float8 e4m3 (`FP8`), the
nearest precision below the bfloat16 that the configurations state: every
product's operands and result, every norm, activation, residual sum,
lookup, encoding and stored feature map rounded to e4m3 (compositing and
the loss stay float32, as they do in the program). The rounding saturates
at e4m3's largest finite value (448), as a scaled fp8 product would, and
passes gradients straight through, so the control's backward runs in
float32 on rounded forward values.
"""
from __future__ import annotations

import contextlib

import torch

E4M3_MAX = 448.0


class _RoundFP8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.clamp(-E4M3_MAX, E4M3_MAX).to(torch.float8_e4m3fn).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g


class _RoundBF16(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.to(torch.bfloat16).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g


class Precision:
    """`q(x)` rounds a product operand or a stored map; f32 leaves it."""

    def __init__(self, name: str):
        if name not in ("f32", "bf16", "fp8"):
            raise ValueError(f"unknown reference precision {name!r}")
        self.name = name

    def q(self, x):
        if self.name == "f32":
            return x
        return (_RoundFP8 if self.name == "fp8" else _RoundBF16).apply(x)


F32 = Precision("f32")
BF16 = Precision("bf16")
FP8 = Precision("fp8")


@contextlib.contextmanager
def no_tf32():
    """Full float32 products and convolutions for the body."""
    was = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = was
