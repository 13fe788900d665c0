"""Convolutional feature encoders (NCHW inside, NHWC at the model's edge).

Port of `keypointnerf_tpu/models/cnn.py` in the original KeypointNeRF
state_dict layout (reference HGFilterV2 and ResBlkEncoder):

  * HGFilter — stacked-hourglass geometry encoder: (V, 3, H, W) in [-1, 1]
    -> [coarse (V, out_ch, H/4, W/4), hires (V, out_ch_hd, H, W)].
  * ResBlkEncoder — texture encoder-decoder: 8-ch output at H/2.

The conventions the JAX package matches to torch: symmetric padding
(k-1)//2, ConvTranspose2d(k3, s2, p1, output_padding=1), bicubic
align_corners=True 2x upsample, GroupNorm eps 1e-5 with min(32, C)
groups, replication padding, 2x2 average pooling.

Layers compute in their input's dtype with f32 parameters cast at use;
the upsample is the JAX package's pair of f32 interpolation products. The
normalizations follow Flax's GroupNorm: statistics in f32 with the
one-pass variance E[x^2] - E[x]^2 clipped at 0 (torch's own GroupNorm
takes two passes, and the deep tex encoder's instance norms amplify the
difference past the parity bar), output in f32 cast back to the input
dtype.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..device import cached
from ..ops.dense import autograd_records


class Conv2d(nn.Conv2d):
    def forward(self, x):
        b = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), b)


class ConvTranspose2d(nn.ConvTranspose2d):
    def forward(self, x):
        b = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv_transpose2d(
            x, self.weight.to(x.dtype), b, self.stride, self.padding,
            self.output_padding, self.groups, self.dilation)


def _flax_group_norm(x, groups, weight, bias, eps):
    """Flax GroupNorm numerics on an NCHW tensor (see module docstring)."""
    n, c = x.shape[:2]
    xg = x.float().reshape(n, groups, -1)
    mean = xg.mean(dim=-1, keepdim=True)
    var = (xg * xg).mean(dim=-1, keepdim=True) - mean * mean
    var = torch.maximum(var, torch.zeros_like(var))      # jnp.maximum's gradient at 0
    mul = torch.rsqrt(var + eps)
    shape = (1, c) + (1,) * (x.dim() - 2)
    y = (xg - mean).reshape(x.shape)
    mul = mul.expand(n, groups, c // groups).reshape((n, c) + (1,) * (x.dim() - 2))
    if weight is not None:
        mul = mul * weight.reshape(shape)
    y = y * mul
    if bias is not None:
        y = y + bias.reshape(shape)
    return y.to(x.dtype)


class GroupNorm(nn.GroupNorm):
    def forward(self, x):
        return _flax_group_norm(x, self.num_groups, self.weight, self.bias, self.eps)


class InstanceNorm2d(nn.InstanceNorm2d):
    """InstanceNorm2d(affine=False): one group per channel, no scale/bias."""

    def forward(self, x):
        return _flax_group_norm(x, x.shape[1], None, None, self.eps)


def _strip_sum(g, dim, start, length):
    """The `length` slices of `g` along `dim` from `start`, added one after
    another in index order (keepdim)."""
    out = g.narrow(dim, start, 1)
    for i in range(start + 1, start + length):
        out = out + g.narrow(dim, i, 1)
    return out


def _fold_border(g, dim, before, after, n):
    """The gradient of replicating the edges of a size-`n` axis `dim` by
    `before` and `after`: each edge's strip added onto it in index order."""
    if before == 0 and after == 0:
        return g
    if n == 1:
        return _strip_sum(g, dim, 0, before + 1 + after)
    head = _strip_sum(g, dim, 0, before + 1)
    tail = _strip_sum(g, dim, before + n - 1, after + 1)
    return torch.cat([head, g.narrow(dim, before + 1, n - 2), tail], dim)


class _ReplicationPad(torch.autograd.Function):
    """Replication padding (left, right, top, bottom) of the last two axes
    with a backward in a fixed order: in f32, the width's border strips
    added in index order, then the height's, rounded once to the gradient's
    dtype. torch's CUDA backward adds with atomics; in deterministic mode
    torch pads by indexing in f32 instead (`_replication_pad`), whose
    backward is the same sum in the same order through a sorting
    index_put_ (18 ms of the zju step on an H100)."""

    @staticmethod
    def forward(ctx, x, pad):
        ctx.pad, ctx.size = pad, x.shape[-2:]
        return torch.ops.aten.replication_pad2d(x, pad)

    @staticmethod
    def backward(ctx, g):
        left, right, top, bottom = ctx.pad
        H, W = ctx.size
        gf = _fold_border(g.float(), -1, left, right, W)
        return _fold_border(gf, -2, top, bottom, H).to(g.dtype), None


class ReplicationPad2d(nn.ReplicationPad2d):
    """nn.ReplicationPad2d whose backward runs in a fixed order
    (`_ReplicationPad`) where a gradient is taken; without one (a render,
    an export's trace) it pads as torch does."""

    def forward(self, x):
        if autograd_records(x):
            return _ReplicationPad.apply(x, tuple(self.padding))
        return super().forward(x)


def group_norm(ch):
    return GroupNorm(min(32, ch), ch, eps=1e-5)


def avg_pool2(x):
    return F.avg_pool2d(x, 2)


def _upmat_values(n: int) -> np.ndarray:
    """The (2n, n) matrix of the 2x bicubic align_corners interpolation
    along one axis: torch's cubic convolution (a = -0.75), taps clamped
    at the border, a clamped tap's weight added onto the edge pixel."""
    m = 2 * n
    A = np.zeros((m, n), np.float32)
    a = -0.75

    def cubic(t):
        t = abs(t)
        if t <= 1.0:
            return (a + 2) * t**3 - (a + 3) * t**2 + 1
        if t < 2.0:
            return a * t**3 - 5 * a * t**2 + 8 * a * t - 4 * a
        return 0.0

    for i in range(m):
        src = i * (n - 1) / (m - 1) if m > 1 else 0.0
        i0 = int(np.floor(src))
        t = src - i0
        for k in range(-1, 3):
            A[i, min(max(i0 + k, 0), n - 1)] += cubic(k - t)
    return A


@cached
def upmat(n: int, device) -> torch.Tensor:
    """`_upmat_values(n)` as an f32 tensor on `device`, made once a (n,
    device) outside a trace (`device.cached`)."""
    return torch.from_numpy(_upmat_values(n)).to(device)


def upsample2x_bicubic_align_corners(x):
    """2x bicubic upsample with align_corners=True, the JAX package's
    formula: two dense f32 interpolation products out = A x Aᵀ, cast back
    to the input dtype. x (..., H, W). Its backward is two products too
    (torch's bicubic backward kernel accumulates with atomics)."""
    H, W = x.shape[-2:]
    y = torch.matmul(upmat(H, x.device), x.float())
    return torch.matmul(y, upmat(W, x.device).T).to(x.dtype)


class ConvBlock(nn.Module):
    """Pre-activation multi-scale residual block: three 3x3 convs at C/2,
    C/4, C/4 concatenated, plus a 1x1-projected residual when widths
    differ. `bn4` is registered twice (also as `downsample.0`), as in the
    reference, so both key spellings appear in the state_dict."""

    def __init__(self, in_ch, out_ch):
        super().__init__()
        self.bn1 = group_norm(in_ch)
        self.conv1 = Conv2d(in_ch, out_ch // 2, 3, padding=1, bias=False)
        self.bn2 = group_norm(out_ch // 2)
        self.conv2 = Conv2d(out_ch // 2, out_ch // 4, 3, padding=1, bias=False)
        self.bn3 = group_norm(out_ch // 4)
        self.conv3 = Conv2d(out_ch // 4, out_ch // 4, 3, padding=1, bias=False)
        if in_ch != out_ch:
            self.bn4 = group_norm(in_ch)
            self.downsample = nn.Sequential(
                self.bn4, nn.ReLU(), Conv2d(in_ch, out_ch, 1, bias=False))
        else:
            self.downsample = None

    def forward(self, x):
        h1 = self.conv1(F.relu(self.bn1(x)))
        h2 = self.conv2(F.relu(self.bn2(h1)))
        h3 = self.conv3(F.relu(self.bn3(h2)))
        res = x if self.downsample is None else self.downsample(x)
        return torch.cat([h1, h2, h3], dim=1) + res


class HourGlass(nn.Module):
    """Recursive hourglass with the reference's flat level-suffixed
    modules (b1_L, b2_L, b3_L, b2_plus_1)."""

    def __init__(self, depth, features):
        super().__init__()
        self.depth = depth
        for lvl in range(depth, 0, -1):
            self.add_module(f"b1_{lvl}", ConvBlock(features, features))
            self.add_module(f"b2_{lvl}", ConvBlock(features, features))
            self.add_module(f"b3_{lvl}", ConvBlock(features, features))
        self.add_module("b2_plus_1", ConvBlock(features, features))

    def _run(self, lvl, x):
        up1 = self._modules[f"b1_{lvl}"](x)
        low = self._modules[f"b2_{lvl}"](avg_pool2(x))
        if lvl > 1:
            low = self._run(lvl - 1, low)
        else:
            low = self._modules["b2_plus_1"](low)
        low = self._modules[f"b3_{lvl}"](low)
        return up1 + upsample2x_bicubic_align_corners(low)

    def forward(self, x):
        return self._run(self.depth, x)


class HGFilter(nn.Module):
    """Stacked-hourglass geometry encoder (reference HGFilterV2 layout)."""

    def __init__(self, n_stack=1, n_downsample=4, out_ch=64, out_ch_hd=8):
        super().__init__()
        self.n_stack = n_stack
        self.conv1 = Conv2d(3, 64, 7, stride=2, padding=3)
        self.bn1 = group_norm(64)
        self.conv2 = ConvBlock(64, 128)
        self.unpack1 = nn.Module()
        self.unpack1.conv = ConvTranspose2d(128, 32, 3, stride=2, padding=1,
                                            output_padding=1, bias=False)
        self.unpack1.norm = group_norm(32)
        self.conv_out = Conv2d(32, out_ch_hd, 5, padding=2)
        self.conv3 = ConvBlock(128, 128)
        self.conv4 = ConvBlock(128, 256)
        for i in range(n_stack):
            self.add_module(f"m{i}", HourGlass(n_downsample, 256))
            self.add_module(f"top_m_{i}", ConvBlock(256, 256))
            self.add_module(f"conv_last{i}", Conv2d(256, 256, 1))
            self.add_module(f"bn_end{i}", group_norm(256))
            self.add_module(f"l{i}", Conv2d(256, out_ch, 1))
            if i < n_stack - 1:
                self.add_module(f"bl{i}", Conv2d(256, 256, 1))
                self.add_module(f"al{i}", Conv2d(out_ch, 256, 1))

    def forward(self, x):
        m = self._modules
        x = F.relu(self.bn1(self.conv1(x)))
        x = self.conv2(x)
        hd = F.relu(self.unpack1.norm(self.unpack1.conv(x)))
        x_hd = self.conv_out(hd)
        x = self.conv4(self.conv3(avg_pool2(x)))
        previous, out = x, None
        for i in range(self.n_stack):
            ll = m[f"top_m_{i}"](m[f"m{i}"](previous))
            ll = F.relu(m[f"bn_end{i}"](m[f"conv_last{i}"](ll)))
            out = m[f"l{i}"](ll)
            if i < self.n_stack - 1:
                previous = previous + m[f"bl{i}"](ll) + m[f"al{i}"](out)
        return [out, x_hd]


class ResBlk(nn.Module):
    """Replication-padded residual block with InstanceNorm."""

    def __init__(self, ch):
        super().__init__()
        self.layers = nn.Sequential(
            ReplicationPad2d(1), Conv2d(ch, ch, 3), InstanceNorm2d(ch),
            nn.ReLU(), ReplicationPad2d(1), Conv2d(ch, ch, 3),
            InstanceNorm2d(ch),
        )

    def forward(self, x):
        return x + self.layers(x)


class ResBlkEncoder(nn.Module):
    """Texture encoder-decoder, the reference's flat `layers` Sequential."""

    def __init__(self, out_ch=8, ngf=64, n_downsample=3, n_blocks=4, n_upsample=2):
        super().__init__()
        L = [ReplicationPad2d(3), Conv2d(3, ngf, 7), InstanceNorm2d(ngf), nn.ReLU()]
        for i in range(n_downsample):
            m = 2**i
            L += [Conv2d(ngf * m, ngf * m * 2, 3, stride=2, padding=1),
                  InstanceNorm2d(ngf * m * 2), nn.ReLU()]
        m = 2**n_downsample
        L += [ResBlk(ngf * m) for _ in range(n_blocks)]
        for i in range(n_upsample):
            m = 2 ** (n_downsample - i)
            L += [ConvTranspose2d(ngf * m, ngf * m // 2, 3, stride=2, padding=1,
                                  output_padding=1),
                  InstanceNorm2d(ngf * m // 2), nn.ReLU()]
        if n_upsample > 0:
            L += [ReplicationPad2d(3),
                  Conv2d(ngf * 2 ** (n_downsample - n_upsample + 1) // 2, out_ch, 7)]
        self.layers = nn.Sequential(*L)

    def forward(self, x):
        return self.layers(x)
