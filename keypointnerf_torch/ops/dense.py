"""The dense-layer numerics the model's layers and the fused geometry
MLP's plain versions share: softplus with beta 100 and the product of
operands rounded to the compute dtype with its sum kept in f32; and
`autograd_records`, the one test of whether a call may take an
inference-only kernel.

They sit in `ops/` so that the kernel modules import nothing of
`models/`: an exported program's consumer loads the ops alone.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def autograd_records(*tensors, module=None) -> bool:
    """Whether autograd records through these tensors or `module`'s
    parameters: the test every inference-only kernel route takes (it runs
    only where this is False), and the fixed-order pad's
    (`models/cnn.py:ReplicationPad2d`)."""
    return torch.is_grad_enabled() and (
        any(t.requires_grad for t in tensors)
        or (module is not None and any(p.requires_grad for p in module.parameters())))


def softplus100(x):
    """Softplus with beta=100 in the overflow-safe form
    max(y, 0) + log1p(exp(-|y|)), y = 100 x, scaled back by 0.01.

    The gradient at y == 0 is JAX's, 0: there `jnp.maximum` passes 0.5 and
    `jnp.abs` +1, so the two terms' 0.5 and -0.5 cancel; torch's `relu`
    and `abs` each pass 0. With zero biases at init, y == 0 does occur."""
    y = 100.0 * x
    return (torch.relu(y) + torch.log1p(torch.exp(-y.abs()))) * 0.01


def dot_f32(x, w, dtype):
    """x @ w.T with x and w rounded to `dtype` and the sum kept in f32.

    The JAX layer contracts in `dtype` with `preferred_element_type=f32`.
    The product of two bf16 values is exact in f32, so the f32 product of
    the bf16-rounded operands is the same sum (to summation order). Its
    gradients round like JAX's too: each operand's gradient is the f32
    product rounded once to `dtype` by the cast's backward. Without
    autograd on a CUDA tensor (inference), the same sum comes from the
    bf16 matmul with an f32 output (`torch.mm(..., out_dtype=float32)`),
    ~6x faster on an H100 (PERF.md).
    """
    if dtype == torch.bfloat16 and x.is_cuda and not autograd_records(x, w):
        a = x.to(dtype).reshape(-1, x.shape[-1])
        out = torch.mm(a, w.to(dtype).T, out_dtype=torch.float32)
        return out.reshape(x.shape[:-1] + (w.shape[0],))
    return F.linear(x.to(dtype).float(), w.to(dtype).float())


def linear_blocks(xs, w, bias, dtype):
    """A dense layer over input blocks side by side (a skip concat folded
    into the product): each block's `dot_f32` with its columns of w, the
    partial products summed in order, then the f32 bias."""
    out, off = None, 0
    for a in xs:
        d = dot_f32(a, w[:, off : off + a.shape[-1]], dtype)
        off += a.shape[-1]
        out = d if out is None else out + d
    return out + bias
