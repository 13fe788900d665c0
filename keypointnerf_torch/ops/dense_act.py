"""One dense layer of the geometry MLP at inference as one launch: the bf16
product with its bias, softplus100 and the store in the epilogue.

Replaces no Pallas kernel: it is the counterpart of XLA's fusion of the JAX
model's module path, where each dense layer's dot and its elementwise
epilogue form one fusion. `models/mlp.py` (`MLPUNet`, `MLP`) calls it
(`fused_dense_act`) for every layer when no gradient is needed, the compute
dtype is bf16, the nonlinearity is softplus100 (or none) and `takes` the
widths; otherwise it composes `dot_f32` and `softplus100` layer by layer,
as it always has.

    out = act(sum_b dot_f32(x_b, w[:, block_b], bf16) + bias)

The input blocks `xs` (a skip: up to two) are contracted side by side in
the order given, each against its columns of `w` (n_out, sum of widths,
f32, weight norm already folded in); `act` is softplus100 or nothing;
the result is stored in `out_dtype`: bf16 for a hidden layer (its
consumer, the next layer, rounds it to bf16 first, so storing bf16 changes
no bit), f32 for a stack's last layer.

The wrapper `fused_dense_act` calls the registered op `kpnerf::dense_act`:
on CUDA tensors it launches the hand-written kernel (csrc/dense_act.cu,
counted in `fused_dense_act.launches`) or raises; on CPU tensors it runs
`dense_act_plain`, the module path's composition as it was, so that on
the CPU every bit is unchanged; under a trace (`torch.export`) the fake
implementation gives the output's shape and dtype.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import torch

from .dense import linear_blocks, softplus100

DTYPES = (torch.bfloat16, torch.float32)    # of the input blocks and the output
# The kernel's limits, mirrored from csrc/dense_act.cu (`kMaxK`, `kMaxOut`)
# so that `takes` decides the route on any device before any build: at most
# two input blocks, each a multiple of 8 wide, at most 256 wide together; at
# most 128 outputs. Within them the kernel's shared-memory plan always fits
# (one warpgroup with two stages at the largest shapes).
MAX_BLOCKS = 2
MAX_K = 256
MAX_OUT = 128


def takes(widths: Sequence[int], n_out: int, out_dtype: torch.dtype) -> bool:
    """Whether the kernel takes a layer with input blocks of these widths,
    n_out outputs and this output dtype."""
    return (1 <= len(widths) <= MAX_BLOCKS and all(k > 0 and k % 8 == 0 for k in widths)
            and sum(widths) <= MAX_K and 1 <= n_out <= MAX_OUT and out_dtype in DTYPES)


def dense_act_plain(xs: Sequence[torch.Tensor], w: torch.Tensor, bias: torch.Tensor,
                    softplus: bool, out_dtype: torch.dtype) -> torch.Tensor:
    """The plain PyTorch version: the layer and `softplus100` as the module
    path composes them (`linear_blocks` in bf16: each block's bf16 product
    with an f32 sum, the partial products summed in order, the f32 bias; the
    activation in f32), rounded to `out_dtype` at the end."""
    out = linear_blocks(xs, w, bias, torch.bfloat16)
    if softplus:
        out = softplus100(out)
    return out.to(out_dtype)


def _check(xs, w, bias, out_dtype):
    if not 1 <= len(xs) <= MAX_BLOCKS:
        raise ValueError(f"dense_act takes 1..{MAX_BLOCKS} input blocks, got {len(xs)}")
    lead = xs[0].shape[:-1]
    for x in xs:
        if x.shape[:-1] != lead or x.dtype not in DTYPES or x.device != w.device:
            raise ValueError(f"input blocks must share their leading shape {tuple(lead)}, be "
                             f"bf16 or f32 and lie on {w.device}; got {tuple(x.shape)} "
                             f"{x.dtype} on {x.device}")
    widths = [x.shape[-1] for x in xs]
    if w.dim() != 2 or w.shape[1] != sum(widths) or bias.shape != (w.shape[0],):
        raise ValueError(f"expected w ({w.shape[0] if w.dim() else '?'}, {sum(widths)}) and "
                         f"bias (n_out,), got {tuple(w.shape)} and {tuple(bias.shape)}")
    if w.dtype != torch.float32 or bias.dtype != torch.float32:
        raise TypeError(f"w and bias must be float32, got {w.dtype} and {bias.dtype}")
    if out_dtype not in DTYPES:
        raise TypeError(f"out_dtype must be bfloat16 or float32, got {out_dtype}")


def _rows(x: torch.Tensor):
    """x as bf16 rows (M, k) with unit column stride (a view where it can
    be), and the row stride in elements: rows 16- or 8-byte aligned."""
    a = x.to(torch.bfloat16).reshape(-1, x.shape[-1])
    if a.stride(1) != 1 and a.shape[1] > 1:
        a = a.contiguous()
    lda = a.stride(0) if a.shape[0] > 1 else a.shape[1]
    if a.data_ptr() % 8 or lda % 4:
        a, lda = a.contiguous(), a.shape[1]
    return a, lda


@functools.cache
def _kernel():
    from ._build import load

    fn = load("dense_act").kpn_dense_act
    fn.argtypes = [ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_longlong),
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(xs, w, bias, softplus, out_dtype):
    widths = [x.shape[-1] for x in xs]
    n_out = w.shape[0]
    if not takes(widths, n_out, out_dtype):
        raise ValueError(f"the dense_act kernel does not take input widths {widths}, "
                         f"{n_out} outputs and {out_dtype} (see ops.dense_act.takes)")
    lead = xs[0].shape[:-1]
    out = torch.empty((*lead, n_out), dtype=out_dtype, device=w.device)
    if out.numel() == 0:
        return out
    rows = [_rows(x) for x in xs]
    w, bias = w.contiguous(), bias.contiguous()
    M = rows[0][0].shape[0]
    k1, lda1 = (widths[1], rows[1][1]) if len(xs) > 1 else (0, 0)
    ptrs = [rows[0][0].data_ptr(), rows[1][0].data_ptr() if len(xs) > 1 else None,
            w.data_ptr(), bias.data_ptr(), out.data_ptr()]
    dims = (M, widths[0], k1, rows[0][1], lda1, n_out)
    flags = int(softplus) | (2 if out_dtype == torch.bfloat16 else 0)
    with torch.cuda.device(w.device):
        stream = torch.cuda.current_stream(w.device).cuda_stream
        err = _kernel()((ctypes.c_void_p * 5)(*ptrs), (ctypes.c_longlong * 6)(*dims), flags,
                        stream)
    if err != 0:
        raise RuntimeError(f"dense_act kernel launch failed: CUDA error {err}")
    fused_dense_act.launches += 1
    return out


# The registered op, defined through `torch.library.Library` rather than
# `custom_op`: a `custom_op` backend is wrapped to keep dynamo out, and its
# first call imports torch._dynamo (~840 modules, seconds of a process's
# set-up) where no other registered op runs, as in the fast render. The
# kernel on CUDA, the plain version on the CPU, the output's shape and dtype
# under a trace; no autograd kernel: the module path calls it only where no
# gradient is needed.
_LIB = torch.library.Library("kpnerf", "FRAGMENT")
_LIB.define("dense_act(Tensor[] xs, Tensor w, Tensor bias, bool softplus, "
            "ScalarType out_dtype) -> Tensor")
_LIB.impl("dense_act", _launch, "CUDA")
_LIB.impl("dense_act", dense_act_plain, "CPU")


@torch.library.register_fake("kpnerf::dense_act", lib=_LIB)
def _(xs, w, bias, softplus, out_dtype):
    return xs[0].new_empty((*xs[0].shape[:-1], w.shape[0]), dtype=out_dtype)


_OP = torch.ops.kpnerf.dense_act.default


def fused_dense_act(xs: Sequence[torch.Tensor], w: torch.Tensor, bias: torch.Tensor,
                    softplus: bool, out_dtype: torch.dtype) -> torch.Tensor:
    """One dense layer at inference: input blocks `xs` ((..., k_b) bf16 or
    f32), w (n_out, sum k_b) and bias (n_out,) f32; softplus100 when
    `softplus`; the output (..., n_out) in `out_dtype`. CUDA tensors go to
    the kernel (counted in `fused_dense_act.launches`; widths that `takes`
    refuses raise), CPU tensors to `dense_act_plain`, both through the registered
    op. Not differentiable: the module path calls it only where no gradient
    is needed."""
    xs = list(xs)
    _check(xs, w, bias, out_dtype)
    if w.device.type not in ("cuda", "cpu"):
        raise ValueError(f"no kernel for device {w.device}")
    return _OP(xs, w, bias, softplus, out_dtype)


fused_dense_act.launches = 0
