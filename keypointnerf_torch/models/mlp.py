"""Geometry MLP stack: weight-norm linears, skip-injected per-view MLP,
masked cross-view pooling, and the fused geometry head.

Port of `keypointnerf_tpu/models/mlp.py` with the original KeypointNeRF
state_dict layout: every layer is a `layers.{i}.linear` holding
`weight_v`/`weight_g`/`bias` (weight norm, dim 0) or `weight`/`bias`
(the last layer). `AttentionPool` is not ported yet. Everything here is
differentiable; the training step holds its gradients against `jax.grad`.

Numerics follow the JAX `WNDense`: the weight norm w = v * g / (||v|| +
1e-12) is computed in f32 from f32 parameters; a skip concat is never
formed, each input block is contracted with its row block of w and the
partial products are summed in order; the result is f32 plus an f32 bias.
With a bf16 compute dtype the inputs and w are rounded to bf16 first and
the sum is kept in f32 (`dot_f32`).
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F


def abs_sel(x):
    """|x| with `jnp.abs`'s gradient: +1 at x == 0 (torch's `abs` passes
    0 there). A loss term |pred - target| meets exact zeros, e.g. an empty
    ray's black pixel against the black background."""
    return torch.where(x >= 0, x, -x)


def softplus100(x):
    """Softplus with beta=100 in the overflow-safe form
    max(y, 0) + log1p(exp(-|y|)), y = 100 x, scaled back by 0.01.

    The gradient at y == 0 is JAX's, 0: there `jnp.maximum` passes 0.5 and
    `jnp.abs` +1, so the two terms' 0.5 and -0.5 cancel; torch's `relu`
    and `abs` each pass 0. With zero biases at init, y == 0 does occur."""
    y = 100.0 * x
    return (torch.relu(y) + torch.log1p(torch.exp(-y.abs()))) * 0.01


_NL = {
    "softplus": softplus100,
    "relu": F.relu,
    "elu": F.elu,
    "leakyrelu": lambda x: F.leaky_relu(x, 0.2),
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
    "none": None,
    "": None,
    None: None,
}


def get_nl(name):
    if name not in _NL:
        raise NotImplementedError(f"unsupported nl layer {name}")
    return _NL[name]


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
    needs_grad = torch.is_grad_enabled() and (x.requires_grad or w.requires_grad)
    if dtype == torch.bfloat16 and x.is_cuda and not needs_grad:
        a = x.to(dtype).reshape(-1, x.shape[-1])
        out = torch.mm(a, w.to(dtype).T, out_dtype=torch.float32)
        return out.reshape(x.shape[:-1] + (w.shape[0],))
    return F.linear(x.to(dtype).float(), w.to(dtype).float())


class WNLinear(nn.Module):
    """The parameters of the reference's `weight_norm(nn.Linear)`."""

    def __init__(self, n_in, n_out):
        super().__init__()
        self.weight_v = nn.Parameter(torch.empty(n_out, n_in))
        self.weight_g = nn.Parameter(torch.empty(n_out, 1))
        self.bias = nn.Parameter(torch.empty(n_out))

    @property
    def weight(self):
        norm = torch.linalg.norm(self.weight_v, dim=1, keepdim=True)
        return self.weight_v * (self.weight_g / (norm + 1e-12))


class LinearSlot(nn.Module):
    """One reference `layers.{i}` entry: a `linear`, weight-normed or plain.

    Called with an array or a tuple of arrays whose widths sum to n_in
    (the skip concat, folded into the contraction).
    """

    def __init__(self, n_in, n_out, weight_norm, dtype=torch.float32):
        super().__init__()
        self.linear = WNLinear(n_in, n_out) if weight_norm else nn.Linear(n_in, n_out)
        self.dtype = dtype

    def forward(self, x):
        xs = x if isinstance(x, (list, tuple)) else (x,)
        w = self.linear.weight
        out, off = None, 0
        for a in xs:
            d = dot_f32(a, w[:, off : off + a.shape[-1]], self.dtype)
            off += a.shape[-1]
            out = d if out is None else out + d
        return out + self.linear.bias


class MLP(nn.Module):
    """Plain MLP with optional input re-concat skips; the last layer has no
    nonlinearity and no weight norm."""

    def __init__(self, dims: Sequence[int], skip_layers: Sequence[int] = (),
                 nl_layer="softplus", weight_norm=True, last_op=None,
                 dtype=torch.float32):
        super().__init__()
        self.skip_layers = tuple(skip_layers)
        self.nl = get_nl(nl_layer)
        self.last_nl = get_nl(last_op)
        n = len(dims) - 1
        self.layers = nn.ModuleList(
            LinearSlot(dims[i] + (dims[0] if i in self.skip_layers else 0),
                       dims[i + 1], weight_norm and i < n - 1, dtype)
            for i in range(n)
        )

    def forward(self, x):
        x0 = x
        n = len(self.layers)
        for i, layer in enumerate(self.layers):
            if i in self.skip_layers:
                x = (x, x0)
            x = layer(x)
            if i < n - 1 and self.nl is not None:
                x = self.nl(x)
        return self.last_nl(x) if self.last_nl is not None else x


class MLPUNet(nn.Module):
    """MLP with image-feature skip injection: at each layer in
    `skip_layers` the matching feature enters the contraction beside the
    activations."""

    def __init__(self, dims: Sequence[int], skip_dims: Sequence[int],
                 skip_layers: Sequence[int], nl_layer="softplus",
                 weight_norm=True, dtype=torch.float32):
        super().__init__()
        if len(skip_dims) != len(skip_layers):
            raise ValueError("skip_dims and skip_layers differ in length")
        self.skip_idx = {layer: i for i, layer in enumerate(skip_layers)}
        self.nl = get_nl(nl_layer)
        n = len(dims) - 1
        self.layers = nn.ModuleList(
            LinearSlot(
                dims[i] + (skip_dims[self.skip_idx[i]] if i in self.skip_idx else 0),
                dims[i + 1], weight_norm and i < n - 1, dtype,
            )
            for i in range(n)
        )

    def forward(self, x, feats):
        n = len(self.layers)
        for i, layer in enumerate(self.layers):
            if i in self.skip_idx:
                x = (x, feats[self.skip_idx[i]])
            x = layer(x)
            if i < n - 1 and self.nl is not None:
                x = self.nl(x)
        return x


def masked_pool(x, mask, weight=None, pool_types=("mean", "var")):
    """Masked weighted mean/var pooling across the view axis.

    x: (V, N, C); mask: (V, N, 1); weight: (V, N, 1) normalized pixel
    weights (mask / sum when None). Returns pooled (N, len(pool_types) * C)
    in the order max, mean, var, and valid (N, 1) bool (any view valid).
    """
    a_sum = mask.sum(dim=0)
    if weight is None:
        weight = mask / (a_sum[None] + 1e-6)
    outs = []
    if "max" in pool_types:
        outs.append(x.amax(dim=0))
    mean = (weight * x).sum(dim=0)
    if "mean" in pool_types:
        outs.append(mean)
    if "var" in pool_types:
        outs.append((weight * (x - mean[None]) ** 2).sum(dim=0))
    return torch.cat(outs, dim=-1), a_sum > 0.0


class GeoFusionMLP(nn.Module):
    """Per-view skip-injected MLP (`layers1`) -> masked mean/var pool ->
    fusion MLP (`layers2`)."""

    def __init__(self, dims1, dims2, skip_dims, skip_layers, nl_layer="softplus",
                 weight_norm=True, pool_types=("mean", "var"), pool_mode="",
                 dtype=torch.float32):
        super().__init__()
        if pool_mode:
            raise NotImplementedError(
                f"pool_mode={pool_mode!r}: AttentionPool is not ported yet "
                "(ROADMAP Queue 1 item 2)"
            )
        self.pool_types = tuple(pool_types)
        self.layers1 = MLPUNet(dims1, skip_dims, skip_layers, nl_layer,
                               weight_norm, dtype)
        self.layers2 = MLP(dims2, (), nl_layer, weight_norm, dtype=dtype)

    def forward(self, sp_feat, im_feats, mask, weight):
        """sp_feat (V, N, D_sp); im_feats list of (V, N, C_i); mask, weight
        (V, N, 1). Returns out (N, dims2[-1]), valid (N, 1), latent_view
        (V, N, dims1[-1]) and latent_fused (N, dims2[0])."""
        latent_view = self.layers1(sp_feat, im_feats)
        latent_fused, valid = masked_pool(latent_view, mask, weight, self.pool_types)
        out = self.layers2(latent_fused)
        return out, valid, latent_view, latent_fused
