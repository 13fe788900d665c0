"""Geometry MLP stack: weight-norm linears, skip-injected per-view MLP,
masked cross-view pooling, and the fused geometry head.

Port of `keypointnerf_tpu/models/mlp.py` with the original KeypointNeRF
state_dict layout: every layer is a `layers.{i}.linear` holding
`weight_v`/`weight_g`/`bias` (weight norm, dim 0) or `weight`/`bias`
(the last layer). The attention pools (`pool_mode`) are `mlp_geo.pool`,
an `AttentionPool` (see its docstring for its keys). Everything here is
differentiable; the training step holds its gradients against `jax.grad`.

Numerics follow the JAX `WNDense`: the weight norm w = v * g / (||v|| +
1e-12) is computed in f32 from f32 parameters; a skip concat is never
formed, each input block is contracted with its row block of w and the
partial products are summed in order; the result is f32 plus an f32 bias.
With a bf16 compute dtype the inputs and w are rounded to bf16 first and
the sum is kept in f32 (`dot_f32`).

At inference (no gradient needed) with a bf16 compute dtype, `MLPUNet` and
`MLP` run each layer as one call of `ops.fused_dense_act` (on the card a
hand-written kernel: the product, the bias, softplus100 and the store in
one launch, hidden outputs stored in bf16, which the next layer rounds
them to anyway) where the widths fit the kernel and the nonlinearity is
softplus100 or none; elsewhere, and always under autograd, layer by layer
as above.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.dense import dot_f32, linear_blocks, softplus100  # noqa: F401  (the model's numerics)
from ..ops.dense_act import fused_dense_act, takes


def abs_sel(x):
    """|x| with `jnp.abs`'s gradient: +1 at x == 0 (torch's `abs` passes
    0 there). A loss term |pred - target| meets exact zeros, e.g. an empty
    ray's black pixel against the black background."""
    return torch.where(x >= 0, x, -x)


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
        return linear_blocks(xs, self.linear.weight, self.linear.bias, self.dtype)


def _fusable(slots, in_widths, nl, dtype) -> bool:
    """Whether every layer of a stack can run as `ops.fused_dense_act`: bf16
    products, softplus100 or no nonlinearity, widths the kernel takes
    (hidden outputs in bf16, the last in f32)."""
    if dtype != torch.bfloat16 or nl not in (softplus100, None):
        return False
    n = len(slots)
    return all(takes(widths, slot.linear.bias.shape[0],
                     torch.bfloat16 if i < n - 1 else torch.float32)
               for i, (slot, widths) in enumerate(zip(slots, in_widths)))


def _needs_grad(module, tensors) -> bool:
    return torch.is_grad_enabled() and (
        any(t.requires_grad for t in tensors) or
        any(p.requires_grad for p in module.parameters()))


def _layer(slot, x, last: bool, nl, fused: bool):
    """One layer and its nonlinearity (none after the last layer); `fused`:
    both in one `ops.fused_dense_act` call, a hidden layer's output in bf16."""
    if fused:
        xs = list(x) if isinstance(x, (list, tuple)) else [x]
        return fused_dense_act(xs, slot.linear.weight, slot.linear.bias,
                               not last and nl is not None,
                               torch.float32 if last else torch.bfloat16)
    x = slot(x)
    return x if last or nl is None else nl(x)


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
        self.fusable = _fusable(self.layers, [
            (dims[i], dims[0]) if i in self.skip_layers else (dims[i],) for i in range(n)],
            self.nl, dtype)

    def forward(self, x):
        x0 = x
        n = len(self.layers)
        fused = self.fusable and not _needs_grad(self, (x,))
        for i, layer in enumerate(self.layers):
            if i in self.skip_layers:
                x = (x, x0)
            x = _layer(layer, x, i == n - 1, self.nl, fused)
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
        self.fusable = _fusable(self.layers, [
            (dims[i], skip_dims[self.skip_idx[i]]) if i in self.skip_idx else (dims[i],)
            for i in range(n)], self.nl, dtype)

    def forward(self, x, feats):
        n = len(self.layers)
        fused = self.fusable and not _needs_grad(self, (x, *feats))
        for i, layer in enumerate(self.layers):
            if i in self.skip_idx:
                x = (x, feats[self.skip_idx[i]])
            x = _layer(layer, x, i == n - 1, self.nl, fused)
        return x


def pool_ops(x, pool_types, weight):
    """Weighted pooling over the view axis in the order max, mean, var
    (JAX `pool_ops`). x (V, N, C); weight (V, N, 1) or (V, N, C)."""
    outs = []
    if "max" in pool_types:
        outs.append(x.amax(dim=0))
    mean = (weight * x).sum(dim=0)
    if "mean" in pool_types:
        outs.append(mean)
    if "var" in pool_types:
        outs.append((weight * (x - mean[None]) ** 2).sum(dim=0))
    return torch.cat(outs, dim=-1)


def masked_pool(x, mask, weight=None, pool_types=("mean", "var")):
    """Masked weighted mean/var pooling across the view axis.

    x: (V, N, C); mask: (V, N, 1); weight: (V, N, 1) normalized pixel
    weights (mask / sum when None). Returns pooled (N, len(pool_types) * C)
    in the order max, mean, var, and valid (N, 1) bool (any view valid).
    """
    a_sum = mask.sum(dim=0)
    if weight is None:
        weight = mask / (a_sum[None] + 1e-6)
    return pool_ops(x, pool_types, weight), a_sum > 0.0


class AttentionPool(nn.Module):
    """The attention-weighted cross-view pool of the reference PoolModule
    (src/utils.py:589-647), JAX `AttentionPool` with its arithmetic:

      * attention_v0: the pixel weights times exp(att(x)), a Linear(C, 1)
        per (view, point), renormalised over the views (+1e-6);
      * attention_v1: a query q_proj(pool_ops(x, [max, mean], mask /
        (a_sum + 1e-6))), Linear(2C, C), reshaped (N, D, H) (D first) and
        keys k_proj(x), Linear(C, C), reshaped (V, N, D, H); the logits
        q . k / D**2 (not sqrt(D)), exponentiated and spread over each
        head's D channels, reweight the pixel weights, renormalised as v0.

    With one view neither mode reweights. `valid` is a_sum > 1 for
    pool_types ("var",), a_sum > 0 otherwise. The Linears run in f32 (the
    Flax Dense has no compute dtype; the latents are f32).

    Keys: `att` (v0), `q_proj` and `k_proj` (v1), under the GeoFusionMLP's
    `pool` (the reference's PoolModule slot). The reference source is not
    in this repository, so these are the port's own names for the
    PoolModule's layers; `utils/convert.py` carries the Flax Dense leaves
    (`AttentionPool_0/Dense_0`, `Dense_1`) onto them.
    """

    MODES = ("attention_v0", "attention_v1")

    def __init__(self, n_ch, pool_types=("mean", "var"), pool_mode="attention_v0",
                 n_heads=1):
        super().__init__()
        if pool_mode not in self.MODES:
            raise ValueError(f"unknown pool_mode {pool_mode!r}; expected one of {self.MODES}")
        if n_ch % n_heads:
            raise ValueError(f"{n_ch} channels do not split into {n_heads} heads")
        self.pool_types = tuple(pool_types)
        self.pool_mode = pool_mode
        self.n_heads = n_heads
        if pool_mode == "attention_v0":
            self.att = nn.Linear(n_ch, 1)
        else:
            self.q_proj = nn.Linear(2 * n_ch, n_ch)
            self.k_proj = nn.Linear(n_ch, n_ch)

    def forward(self, x, mask, weight=None):
        """x (V, N, C), mask (V, N, 1), weight (V, N, 1) or None. Returns
        pooled (N, len(pool_types) * C) and valid (N, 1) bool."""
        V, N, C = x.shape
        a_sum = mask.sum(dim=0)
        if weight is None:
            weight = mask / (a_sum[None] + 1e-6)
        w = weight
        if V > 1:
            if self.pool_mode == "attention_v0":
                att = torch.exp(self.att(x.float()))                       # (V, N, 1)
            else:
                H = self.n_heads
                D = C // H
                qin = pool_ops(x, ("max", "mean"), mask / (a_sum[None] + 1e-6))
                q = self.q_proj(qin.float()).reshape(N, D, H)
                k = self.k_proj(x.float()).reshape(V, N, D, H)
                logits = torch.einsum("ndh,vndh->vnh", q, k) / (D ** 2)
                att = torch.exp(logits)[..., None, :].expand(V, N, D, H).reshape(V, N, C)
            w = w * att
            w = w / (w.sum(dim=0, keepdim=True) + 1e-6)
        pooled = pool_ops(x, self.pool_types, w)
        valid = a_sum > (1.0 if self.pool_types == ("var",) else 0.0)
        return pooled, valid


class GeoFusionMLP(nn.Module):
    """Per-view skip-injected MLP (`layers1`) -> masked mean/var pool, or
    with `pool_mode` the attention pool (`pool`) -> fusion MLP
    (`layers2`)."""

    def __init__(self, dims1, dims2, skip_dims, skip_layers, nl_layer="softplus",
                 weight_norm=True, pool_types=("mean", "var"), pool_mode="",
                 dtype=torch.float32):
        super().__init__()
        self.pool_types = tuple(pool_types)
        self.layers1 = MLPUNet(dims1, skip_dims, skip_layers, nl_layer,
                               weight_norm, dtype)
        # registered between the two MLPs, where the JAX module builds it
        self.pool = (AttentionPool(dims1[-1], pool_types, pool_mode) if pool_mode
                     else None)
        self.layers2 = MLP(dims2, (), nl_layer, weight_norm, dtype=dtype)

    def forward(self, sp_feat, im_feats, mask, weight):
        """sp_feat (V, N, D_sp); im_feats list of (V, N, C_i); mask, weight
        (V, N, 1). Returns out (N, dims2[-1]), valid (N, 1), latent_view
        (V, N, dims1[-1]) and latent_fused (N, dims2[0])."""
        latent_view = self.layers1(sp_feat, im_feats)
        if self.pool is not None:
            latent_fused, valid = self.pool(latent_view, mask, weight)
        else:
            latent_fused, valid = masked_pool(latent_view, mask, weight, self.pool_types)
        out = self.layers2(latent_fused)
        return out, valid, latent_view, latent_fused
